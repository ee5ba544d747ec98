"""The physics step, the picker and the coverage reward of
flingbot_tpu_torch held against flingbot_tpu on the CPU.

The JAX side runs the XLA mirror of the production pallas path
(spring_mode="chebyshev", contact_mode="sort"), which tests/test_pallas.py
holds against the Pallas kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flingbot_tpu.engine.picker import picker_step as jax_picker_step
from flingbot_tpu.engine.picker import release_all as jax_release_all
from flingbot_tpu.engine.solver import step as jax_step
from flingbot_tpu.engine.state import SolverParams as JParams
from flingbot_tpu.env.coverage import get_current_covered_area as jax_cov
from flingbot_tpu_torch.engine.picker import picker_step, release_all
from flingbot_tpu_torch.engine.solver import step
from flingbot_tpu_torch.engine.state import SolverParams
from flingbot_tpu_torch.env.coverage import get_current_covered_area
from tests.test_torch_common import (
    canonical, lat_index, make_pair, port_state, stack, t)

MAX_DIM = 16
KW = dict(substeps=4, iterations=16, contact_iterations=4, contact_every=2,
          contact_window=12)


def test_solver_defaults_match():
    jp = JParams()
    tp = SolverParams()
    for f in ("dt", "damping", "dynamic_friction", "particle_friction",
              "picker_friction", "radius", "collision_distance",
              "relaxation_factor", "max_acceleration", "chebyshev_rho"):
        assert np.float32(getattr(tp, f)) == np.float32(getattr(jp, f)), f
    np.testing.assert_array_equal(np.float32(tp.gravity),
                                  np.asarray(jp.gravity))


@pytest.mark.parametrize("dims", [((16, 16), (16, 16)),
                                  ((14, 12), (16, 10))])
def test_step_matches_jax_with_active_picker(dims):
    """Two frames, contacts every 2nd substep, picker 0 grasping particle
    0 with its sphere pressing on the cloth."""
    rng = np.random.default_rng(5)
    jstates, jtopos, tstate, topo = make_pair(dims, MAX_DIM, rng)
    grabbed = []
    for s in jstates:
        grab = np.asarray(s.positions[0]) + np.array([0.0, 0.02, 0.0])
        grabbed.append(s.replace(
            picker_pos=jnp.asarray([grab, [-10.0, -10.0, -10.0]],
                                   jnp.float32),
            picked_idx=jnp.asarray([0, -1], jnp.int32),
            inv_mass=s.inv_mass.at[0].set(0.0)))
    jstate = stack(grabbed)
    tstate = port_state(jstate, topo)
    jp = JParams()
    f = jax.jit(jax.vmap(lambda s, tp: jax_step(
        s, tp, jp, spring_mode="chebyshev", contact_mode="sort", **KW)))
    jtopo = stack(jtopos)
    for _ in range(2):
        jstate = f(jstate, jtopo)
        tstate = step(tstate, topo, SolverParams(), **KW)
        # test_pallas.py:233,268-270: positions 1e-5, velocities 1e-3 over
        # 1-2 frames (a 1e-6 difference grows ~10x per frame after that)
        np.testing.assert_allclose(
            canonical(tstate.positions, topo, jstate.positions),
            np.asarray(jstate.positions), atol=1e-5)
        np.testing.assert_allclose(
            canonical(tstate.velocities, topo, jstate.velocities),
            np.asarray(jstate.velocities), atol=1e-3)
    assert float(jnp.abs(jstate.positions - stack(grabbed).positions).max()) \
        > 1e-3


def test_picker_step_and_release_match_jax():
    rng = np.random.default_rng(2)
    jstates, _, tstate, topo = make_pair(((12, 10), (16, 16)), MAX_DIM, rng,
                                         height=0.0, noise=2e-3)
    jstate = stack(jstates)
    # picker 0 just above particle 5, picker 1 above the far corner
    p0 = np.asarray(jstate.positions[:, 5]) + [0.0, 0.01, 0.0]
    p1 = np.asarray(jstate.positions[:, 100]) + [0.0, 0.015, 0.0]
    jstate = jstate.replace(picker_pos=jnp.asarray(np.stack([p0, p1], 1),
                                                   jnp.float32))
    tstate = port_state(jstate, topo)
    actions = [np.array([[0.0, 0.01, 0.0, 1.0], [0.01, 0.0, 0.0, 1.0]]),
               np.array([[0.0, 0.02, 0.01, 1.0], [0.0, 0.0, 0.0, 0.0]]),
               np.array([[0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])]
    fj = jax.jit(jax.vmap(lambda s, a: jax_picker_step(s, a, dt=0.01)))
    for a in actions:
        ab = np.stack([a, a]).astype(np.float32)
        jstate = fj(jstate, jnp.asarray(ab))
        tstate = picker_step(tstate, torch.tensor(ab), dt=0.01)
        np.testing.assert_array_equal(
            lat_index(t(jstate.picked_idx, torch.int64), topo).numpy(),
            tstate.picked_idx.numpy())
        for name in ("positions", "velocities"):
            np.testing.assert_array_equal(
                canonical(getattr(tstate, name), topo,
                          getattr(jstate, name)),
                np.asarray(getattr(jstate, name)))
        np.testing.assert_array_equal(
            canonical(tstate.inv_mass[:, None], topo,
                      jstate.inv_mass[:, :, None])[..., 0],
            np.asarray(jstate.inv_mass))
    assert (tstate.picked_idx >= 0).any()
    jstate = jax.vmap(jax_release_all)(jstate)
    tstate = release_all(tstate)
    assert (tstate.picked_idx == -1).all()
    np.testing.assert_array_equal(
        canonical(tstate.inv_mass[:, None], topo,
                  jstate.inv_mass[:, :, None])[..., 0],
        np.asarray(jstate.inv_mass))


def test_coverage_equals_jax():
    rng = np.random.default_rng(7)
    dims = ((16, 16), (14, 12), (10, 16))
    jstates, _, tstate, topo = make_pair(dims, MAX_DIM, rng)
    jstate = stack(jstates)
    # crumpled-looking clouds: random folds of the flat grid, plus a
    # tight wad that takes the degenerate-AABB branch
    P = np.asarray(jstate.positions).copy()
    P[0, :, 0] = np.abs(P[0, :, 0]) - 0.02
    P[1] += rng.normal(0, 0.01, P[1].shape)
    P[2] *= 0.02
    jstate = jstate.replace(positions=jnp.asarray(P, jnp.float32))
    tstate = port_state(jstate, topo)
    ref = np.asarray(jax.vmap(jax_cov)(jstate.positions, jstate.active))
    out = get_current_covered_area(tstate.positions, tstate.active).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (ref > 0).all()
