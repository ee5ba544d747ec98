"""The Jacobi and no-self-collision configurations of flingbot_tpu_torch
held against flingbot_tpu on the CPU: spring_mode="jacobi" (the plain
Jacobi loop of the substeps kernel, pallas_kernels.py:229-233) and
self_collision=False (one fused launch of all substeps with its last
picker push, solver.py:646-657), on grid cloths against the pallas
backend in interpret mode and on layered shirts against the XLA path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flingbot_tpu.engine import solver as jsolver
from flingbot_tpu.engine.pallas_kernels import (
    pack_sub_params as jax_pack, pallas_substeps)
from flingbot_tpu.engine.solver import step as jax_step
from flingbot_tpu.engine.state import SolverParams as JParams
from flingbot_tpu.engine.topology import build_grid_topology as jax_topology
from flingbot_tpu_torch.engine import kernels
from flingbot_tpu_torch.engine.kernels import pack_sub_params
from flingbot_tpu_torch.engine.solver import step
from flingbot_tpu_torch.engine.state import SolverParams
from flingbot_tpu_torch.engine.topology import (
    build_grid_topology, compute_layered_spec)
from flingbot_tpu_torch.env.scene import shirt_task
from tests.test_torch_common import canonical, make_pair, port_state, stack
from tests.test_torch_kernels import DIM, FAR, _lattice
from tests.test_torch_shirts import (  # noqa: F401  (small_obj: a fixture)
    _grasped, eval_tasks, jax_scene, small_obj)

KW = dict(substeps=4, iterations=16, contact_iterations=4, contact_every=2,
          contact_window=12)


@pytest.mark.parametrize("dims,picker,n_sub,picker_last", [
    ((16, 16), FAR, 2, False),  # full grid, a contact group's launch
    ((12, 14), [[0.04, 0.1, 0.04], [-10.0] * 3], 4, True),  # no contacts
])
def test_substeps_jacobi_match_pallas(dims, picker, n_sub, picker_last):
    """substeps_plain(cheb=False) against pallas_substeps(cheb=False,
    interpret=True) at 16x16, with the substeps tolerances of
    tests/test_pallas.py:76-81 (P, prev 3e-6; V 3e-3: V = dP / dt_sub)."""
    P, V, w = _lattice(seed=1)
    jp = JParams()
    jt = jax_topology(dims[0], dims[1], max_dimx=DIM, max_dimy=DIM)
    jvec = jax_pack(jp, jt, jnp.asarray(picker, jnp.float32), 0.02,
                    jp.dt / 4, jsolver.CHEBYSHEV_RHO)
    kw = dict(n_sub=n_sub, iterations=16, picker_last=picker_last)
    jout = pallas_substeps(jvec[None], jnp.asarray(P)[None],
                           jnp.asarray(V)[None], jnp.asarray(w)[None],
                           cheb=False, interpret=True, **kw)
    topo = build_grid_topology(dims[0], dims[1], max_dimx=DIM, max_dimy=DIM,
                               device="cpu")
    pvec = pack_sub_params(SolverParams(), topo,
                           torch.tensor([picker], dtype=torch.float32), 0.02,
                           np.float32(0.01) / np.float32(4))
    args = [torch.tensor(a)[None] for a in (P, V, w)]
    tout = kernels.substeps(pvec, *args, cheb=False, **kw)
    for name, j, t, tol in zip(("P", "V", "prev"), jout, tout,
                               (3e-6, 3e-3, 3e-6)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol,
                                   err_msg=name)
    # the plain loop differs from the accelerated one
    cheb = kernels.substeps(pvec, *args, **kw)
    assert float((cheb[0] - tout[0]).abs().max()) > 1e-6


def _grasping_pair(dims, seed):
    """Port and JAX batches of two grid cloths, picker 0 grasping particle
    0 of each with its sphere pressing on the cloth."""
    rng = np.random.default_rng(seed)
    jstates, jtopos, _, topo = make_pair(dims, 16, rng)
    grabbed = []
    for s in jstates:
        grab = np.asarray(s.positions[0]) + np.array([0.0, 0.02, 0.0])
        grabbed.append(s.replace(
            picker_pos=jnp.asarray([grab, [-10.0, -10.0, -10.0]],
                                   jnp.float32),
            picked_idx=jnp.asarray([0, -1], jnp.int32),
            inv_mass=s.inv_mass.at[0].set(0.0)))
    jstate = stack(grabbed)
    return jstate, stack(jtopos), port_state(jstate, topo), topo


@pytest.mark.parametrize("knobs", [
    dict(spring_mode="jacobi"),
    dict(self_collision=False),
    dict(spring_mode="jacobi", self_collision=False),
])
def test_grid_step_matches_pallas_step(knobs):
    """Two frames of solver.step with the knobs against the JAX
    solver.step(backend="pallas", pallas_interpret=True) with the same
    knobs: positions 1e-5, velocities 1e-3 (test_torch_step.py's
    bounds)."""
    jstate, jtopo, tstate, topo = _grasping_pair(((16, 16), (14, 12)), 5)
    start = jstate.positions
    jp = JParams()
    f = jax.jit(jax.vmap(lambda s, tp: jax_step(
        s, tp, jp, backend="pallas", pallas_interpret=True, **KW,
        **knobs)))
    for _ in range(2):
        jstate = f(jstate, jtopo)
        tstate = step(tstate, topo, SolverParams(), **KW, **knobs)
        np.testing.assert_allclose(
            canonical(tstate.positions, topo, jstate.positions),
            np.asarray(jstate.positions), atol=1e-5)
        np.testing.assert_allclose(
            canonical(tstate.velocities, topo, jstate.velocities),
            np.asarray(jstate.velocities), atol=1e-3)
    assert float(jnp.abs(jstate.positions - start).max()) > 1e-3


@pytest.mark.parametrize("knobs,source", [
    (dict(spring_mode="jacobi"), "small"),
    (dict(self_collision=False), "eval"),
])
def test_layered_step_knobs_match_jax(knobs, source, small_obj):
    """One layered frame with the knobs against the JAX _step_layered
    with the same knobs, picker 0 holding vertex 0: positions 1e-5,
    velocities 1e-3.  Jacobi on two small shirts; no self-collision on a
    crumpled eval shirt, whose contact groups fire when they run."""
    if source == "small":
        rng = np.random.default_rng(4)
        tasks = []
        for mass in (0.5, 0.9):
            t = shirt_task(small_obj, cloth_mass=mass)
            pp = t.particle_pos.reshape(-1, 4).copy()
            pp[:, :3] += rng.normal(0, 1e-3, (len(pp), 3))
            t.particle_pos = pp.reshape(-1)
            tasks.append(t)
    else:
        tasks = eval_tasks(1)
    spec = compute_layered_spec([t.mesh_arrays() for t in tasks])
    topo, state, jstates = _grasped(tasks, spec)
    jtopo = jax_scene(tasks[0], spec).topo
    f = jax.jit(lambda s: jax_step(
        s, jtopo, JParams(), contact_mode="sort", backend="xla",
        **dict(dict(spring_mode="chebyshev"), **knobs), **KW))
    out = step(state, topo, SolverParams(), **KW, **knobs)
    for b, js in enumerate(jstates):
        ref = f(js)
        np.testing.assert_allclose(out.positions[b].numpy().T,
                                   np.asarray(ref.positions), atol=1e-5)
        np.testing.assert_allclose(out.velocities[b].numpy().T,
                                   np.asarray(ref.velocities), atol=1e-3)
    # the knob changes the frame
    base = step(state, topo, SolverParams(), **KW).positions
    assert float((out.positions - base).abs().max()) > 1e-6


def test_step_refuses_an_unknown_spring_mode():
    _, _, tstate, topo = make_pair(((4, 4),), 4, np.random.default_rng(0))
    with pytest.raises(ValueError, match="spring_mode"):
        step(tstate, topo, SolverParams(), spring_mode="gauss", **KW)
