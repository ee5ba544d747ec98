"""Aerodynamics of flingbot_tpu_torch held against flingbot_tpu on the
CPU: the grid normals and the drag / lift / wind acceleration, one grid
frame through the aero launch of the substeps kernel (the port's plain
version on the CPU; the JAX package's Pallas kernel in interpret mode),
and the refusal of drag, lift and picker friction on layered shirts,
which the port has not ported."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flingbot_tpu.engine.aero import aero_accel as jax_aero_accel
from flingbot_tpu.engine.aero import grid_normals as jax_grid_normals
from flingbot_tpu.engine.solver import step as jax_step
from flingbot_tpu.engine.state import SolverParams as JParams
from flingbot_tpu_torch.engine import kernels
from flingbot_tpu_torch.engine.aero import aero_accel, grid_normals
from flingbot_tpu_torch.engine.solver import step
from flingbot_tpu_torch.engine.state import SolverParams
from flingbot_tpu_torch.engine.topology import lattice_valid
from flingbot_tpu_torch.env.scene import make_batch, shirt_task
from flingbot_tpu_torch.env.shirts import write_shirt_obj
from tests.test_torch_common import canonical, make_pair, stack

MAX_DIM = 16
KW = dict(substeps=4, iterations=16, contact_iterations=4, contact_every=2,
          contact_window=12)
AERO = dict(drag=8.0, lift=4.0, wind=(0.5, 0.0, -0.25))


def _jparams(**kw):
    return JParams(**{k: jnp.asarray(v, jnp.float32) for k, v in kw.items()})


def test_grid_normals_and_aero_accel_match_jax():
    """On two wrinkled lattices (one not filling the lattice) with seeded
    velocities: 1e-6."""
    rng = np.random.default_rng(0)
    _, _, state, topo = make_pair(((16, 16), (12, 14)), MAX_DIM, rng,
                                  noise=2e-2)
    P = state.positions.view(2, 3, MAX_DIM, MAX_DIM)
    V = torch.tensor(rng.normal(0, 0.5, P.shape), dtype=torch.float32)
    valid = lattice_valid(topo.dimx, topo.dimy, MAX_DIM, MAX_DIM)
    moving = valid.clone()
    moving[:, 0, 0] = False
    params = SolverParams(**AERO)
    n = grid_normals(P, valid)
    a = aero_accel(V, n, params, moving)
    jp = _jparams(**AERO)
    for b in range(2):
        jn = jax_grid_normals(jnp.asarray(P[b].numpy()),
                              jnp.asarray(valid[b].numpy()))
        ja = jax_aero_accel(jnp.asarray(V[b].numpy()), jn, jp,
                            jnp.asarray(moving[b].numpy()))
        np.testing.assert_allclose(n[b].numpy(), np.asarray(jn), atol=1e-6)
        np.testing.assert_allclose(a[b].numpy(), np.asarray(ja), atol=1e-6)
    assert float(a.abs().max()) > 1.0


def test_aero_grid_frame_matches_pallas():
    """One frame of two falling grid cloths with drag, lift and wind set:
    the port's aero path (one substeps launch per substep, the kick
    between launches, contacts every 2nd substep) against the JAX
    package's (_step_grid_pallas's aero branch, Pallas in interpret mode):
    2e-5 in P and 2e-2 in V, tests/test_pallas.py:291-323's bounds (the
    two Chebyshev loops round differently; V = dP / dt_sub amplifies
    that 400x)."""
    rng = np.random.default_rng(4)
    jstates, jtopos, state, topo = make_pair(((16, 16), (14, 12)), MAX_DIM,
                                             rng, height=0.3)
    jstate = stack(jstates)
    jp = _jparams(**AERO)
    f = jax.jit(jax.vmap(lambda s, tp: jax_step(
        s, tp, jp, backend="pallas", pallas_interpret=True, aero=True,
        **KW)))
    ref = f(jstate, stack(jtopos))
    before = dict(kernels.LAUNCHES)
    out = step(state, topo, SolverParams(**AERO), **KW)
    assert kernels.LAUNCHES == before  # plain versions on the CPU
    np.testing.assert_allclose(
        canonical(out.positions, topo, ref.positions),
        np.asarray(ref.positions), atol=2e-5)
    np.testing.assert_allclose(
        canonical(out.velocities, topo, ref.velocities),
        np.asarray(ref.velocities), atol=2e-2)
    # the aero pass is on: the frame differs from one without it
    plain = step(state, topo, SolverParams(), **KW)
    assert float((plain.velocities - out.velocities).abs().max()) > 1e-3


@pytest.mark.parametrize("knob,match", [
    ({"drag": 1.0}, "aero"), ({"lift": 0.5}, "aero"),
    ({"picker_friction": 0.75}, "picker_friction")])
def test_unported_knobs_on_a_layered_batch_raise(knob, match, tmp_path):
    """Layered shirts raised NotImplementedError for aero and picker
    friction until the mesh normals and the picker friction were ported:
    now each knob acts on the frame (tests/test_torch_mesh.py holds them
    against the JAX _step_layered), never as a silent no-op.  The name
    is that of the refusal this test held until then."""
    path = str(tmp_path / "shirt_processed.obj")
    write_shirt_obj(path, body_w=0.1, body_h=0.1, sleeve_l=0.04,
                    sleeve_h=0.04, collar_w=0.04, spacing=0.0125)
    topo, state = make_batch([shirt_task(path)], device="cpu")
    # the shirt moving through the air, so that drag and lift act
    v = torch.tensor([0.5, -1.0, 0.2]).view(1, 3, 1)
    state = state.replace(velocities=torch.where(state.active[:, None], v,
                                                 0.0))
    if match == "picker_friction":  # a picker pressing on the shirt
        i = int(torch.nonzero(state.active[0])[0])
        pick = state.picker_pos.clone()
        pick[0, 0] = state.positions[0, :, i] + torch.tensor([0.0, 0.015,
                                                              0.0])
        state = state.replace(picker_pos=pick)
    out = step(state, topo, SolverParams(**knob), **KW)
    plain = step(state, topo, SolverParams(), **KW)
    assert bool(torch.isfinite(out.positions).all())
    assert float((out.velocities - plain.velocities).abs().max()) > 1e-4
    # wind alone exerts nothing (it acts through drag and lift)
    windy = step(state, topo, SolverParams(wind=(1.0, 0.0, 0.0)), **KW)
    assert torch.equal(windy.positions, plain.positions)
