"""The xla backend of flingbot_tpu_torch against the JAX package's on the
CPU: the grid spring solves (2-colour Gauss-Seidel, Jacobi, Chebyshev),
the Morton sweep order, the four contact modes (block, sweep, table and
the plain sorted window) on the same sorted inputs, the per-env re-sort
cache across a reload, and one xla grid frame per contact mode.

Small sizes: 16x16 lattices, cloths of 12-16 a side, compressed so that
contacts fire."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flingbot_tpu.engine import collisions as jcol
from flingbot_tpu.engine import solver as jsolver
from flingbot_tpu.engine.state import SolverParams as JParams
from flingbot_tpu_torch.engine import collisions, kernels
from flingbot_tpu_torch.engine.solver import (
    solve_springs_grid, step)
from flingbot_tpu_torch.engine.state import SolverParams
from flingbot_tpu_torch.engine.topology import lattice_valid
from tests.test_torch_common import (
    canonical, make_pair, port_state, stack, t)

DIMS = [(16, 16), (13, 15), (12, 16)]
MAX_DIM = 16
# one spring pass: float32 rounding of the same formula in another order
SPRING_TOL = 2e-7
# contact passes on the same sorted inputs (m): sums over pairs in another
# order, then 8 iterations
CONTACT_TOL = 2e-6
# one frame (m, m/s): 4 substeps of 30 Gauss-Seidel passes and a contact
# pass each; V = dP / dt_sub multiplies a position difference by 400
FRAME_TOL_P, FRAME_TOL_V = 2e-6, 2e-3
# two frames: the second amplifies the first's last-place differences
# through dense contacts (measured 1.0e-5 m)
TWO_FRAME_TOL_P, TWO_FRAME_TOL_V = 5e-5, 2e-2
FRAME_KW = dict(substeps=4, iterations=30, contact_every=1,
                contact_iterations=8, contact_window=16)


def compressed_pair(rng, squeeze=0.6, dims=DIMS):
    """The same compressed, wrinkled cloths on both sides: lattice
    neighbours two apart come within the contact radius."""
    jstates, jtopos, state, topo = make_pair(dims, MAX_DIM, rng,
                                             height=0.03, noise=0.0)
    out = []
    for js in jstates:
        p = np.array(js.positions)
        n = int(np.asarray(js.active).sum())
        p[:n, 0] *= squeeze
        p[:n, 2] *= squeeze
        p[:n, 1] += 0.006 * np.sin(p[:n, 0] * 400.0) + 0.004 * rng.random(n)
        out.append(js.replace(positions=jnp.asarray(p)))
    return out, jtopos, port_state(out, topo), topo


def lattice_inputs(state, topo):
    B, H, W = state.batch, topo.max_dimy, topo.max_dimx
    valid = lattice_valid(topo.dimx, topo.dimy, H, W)
    w = torch.where(valid, state.inv_mass.view(B, H, W), 0.0)
    return state.positions.view(B, 3, H, W), w, valid


def jax_lattice(jstates, jtopos):
    """Per env: (P (3, H, W), w (H, W), valid (H, W)) of the JAX step."""
    out = []
    for js, jt in zip(jstates, jtopos):
        P, valid = jsolver.gather_to_lattice(js.positions, jt)
        w, _ = jsolver.gather_to_lattice(js.inv_mass, jt)
        out.append((P, jnp.where(valid, w, 0.0), valid))
    return out


@pytest.mark.parametrize("mode", ["gs", "jacobi", "chebyshev"])
def test_grid_springs(mode):
    """One spring pass of the xla grid step: the coloured Gauss-Seidel
    phases in class order (gs) or the Jacobi average (jacobi, chebyshev's
    iterate)."""
    rng = np.random.default_rng(0)
    jstates, jtopos, state, topo = compressed_pair(rng, squeeze=1.1)
    P, w, valid = lattice_inputs(state, topo)
    out = solve_springs_grid(P, w, valid, topo, 1.0, mode)
    for b, (jP, jw, jv) in enumerate(jax_lattice(jstates, jtopos)):
        ref = jsolver.solve_springs_grid(jP, jw, jv, jtopos[b],
                                         jnp.float32(1.0), mode)
        assert float(np.abs(np.asarray(ref) - np.asarray(jP)).max()) > 1e-5
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref),
                                   rtol=0, atol=SPRING_TOL)


@pytest.mark.parametrize("with_inactive", [False, True])
def test_sweep_order_bit_equal(with_inactive):
    """The Morton order and its inverse equal the JAX sweep_order's,
    ties in slot order."""
    rng = np.random.default_rng(1)
    P = (rng.random((3, 3, 400)) * 0.2).astype(np.float32)
    P[:, :, ::7] = P[:, :, 3:4]  # exact ties
    active = np.ones((3, 400), bool)
    if with_inactive:
        active[:, rng.random(400) < 0.3] = False
    perm, inv = collisions.sweep_order(t(P), t(active), 0.01125)
    for b in range(3):
        jp, ji = jcol.sweep_order(jnp.asarray(P[b]), jnp.asarray(active[b]),
                                  jnp.float32(0.01125))
        assert np.array_equal(perm[b].numpy(), np.asarray(jp))
        assert np.array_equal(inv[b].numpy(), np.asarray(ji))


def contact_inputs(rng, mesh):
    """Compressed cloths after one frame (so `prev` differs from P) as flat
    (B, 3, N) port arrays and per-env JAX arrays: P, prev, w, moving,
    active; with mesh=True the rest pose of a flat lattice too."""
    jstates, jtopos, state, topo = compressed_pair(rng)
    prev = state.positions
    moved = step(state, topo, SolverParams(), backend="xla",
                 self_collision=False, substeps=1, iterations=4)
    B, H, W = state.batch, topo.max_dimy, topo.max_dimx
    valid = lattice_valid(topo.dimx, topo.dimy, H, W).reshape(B, -1)
    w = torch.where(valid, state.inv_mass, 0.0)
    w[:, 0] = 0.0  # one grasped particle
    moving = valid & (w > 0)
    rest = None
    if mesh:
        iy, ix = np.divmod(np.arange(H * W), W)
        rest = np.stack([ix * 0.00625, np.zeros(H * W), iy * 0.00625])
        rest = t(np.broadcast_to(rest, (B, 3, H * W)).astype(np.float32))
    return moved.positions, prev, w, moving, valid, rest, W


@pytest.mark.parametrize("filt", ["lattice", "rest"])
@pytest.mark.parametrize("mode", ["block", "sweep", "table", "sort"])
def test_contact_modes_on_sorted_inputs(mode, filt):
    """Each contact mode on the same inputs, with the lattice-neighbour or
    the rest-pose filter, against the JAX function: block and sweep in
    the same Morton order, table through its neighbour table, sort through
    contact_group(backend="xla") (the plain sorted window of
    kernels.contacts_plain against _contacts_sorted_flat)."""
    rng = np.random.default_rng(2)
    mesh = filt == "rest"
    P, prev, w, moving, valid, rest, W = contact_inputs(rng, mesh)
    params, jparams = SolverParams(), JParams()
    r = params.radius
    lat = None if mesh else W
    perm, inv = collisions.sweep_order(P, valid, r)
    rest_sorted = None if rest is None else collisions._take(rest, perm)
    if mode == "block":
        out = collisions.solve_contacts_block(
            P, w, moving, perm, inv, params, rest_dist=r, iterations=8,
            lattice_w=lat, rest_sorted=rest_sorted, active=valid, prev=prev)
    elif mode == "sweep":
        out = collisions.solve_contacts_sweep(
            P, w, moving, perm, inv, params, rest_dist=r, lattice_w=lat,
            rest_sorted=rest_sorted, active=valid, prev=prev)
    elif mode == "table":
        nbr, mask = (collisions.find_neighbors_hash(P, moving, r, rest)
                     if mesh else
                     collisions.find_neighbors_grid(P, moving, W, r))
        out = collisions.solve_contacts(P, w, moving, nbr, mask,
                                        rest_dist=r)
    else:
        before = dict(kernels.LAUNCHES)
        out = collisions.contact_group(
            P, prev, w, valid, params, rest_dist=r, lattice_w=lat,
            rest_positions=rest, window=16, iterations=8, backend="xla")
        assert kernels.LAUNCHES == before  # the xla backend launches none
    moved = float((out - P).abs().max())
    assert moved > 1e-4, "no contact fired"
    for b in range(P.shape[0]):
        jP, jprev = jnp.asarray(P[b].numpy()), jnp.asarray(prev[b].numpy())
        jw, jm = jnp.asarray(w[b].numpy()), jnp.asarray(moving[b].numpy())
        jv = jnp.asarray(valid[b].numpy())
        jperm, jinv = jnp.asarray(perm[b].numpy()), jnp.asarray(inv[b].numpy())
        jrest = None if rest is None else jnp.asarray(rest[b].numpy())
        jrs = None if rest is None else jrest[:, jperm]
        if mode == "block":
            ref = jcol.solve_contacts_block(
                jP, jw, jm, jperm, jinv, jparams, rest_dist=jparams.radius,
                iterations=8, lattice_w=lat, rest_sorted=jrs, active=jv,
                prev=jprev)
        elif mode == "sweep":
            ref = jcol.solve_contacts_sweep(
                jP, jw, jm, jperm, jinv, jparams, rest_dist=jparams.radius,
                lattice_w=lat, rest_sorted=jrs, active=jv, prev=jprev)
        elif mode == "table":
            nbr_j = (jcol.find_neighbors_hash(jP, jm, jparams.radius, jrest)
                     if mesh else jcol.find_neighbors_grid(
                         jP, jm, W, jparams.radius))
            assert np.array_equal(nbr[b].numpy(), np.asarray(nbr_j[0]))
            assert np.array_equal(mask[b].numpy(), np.asarray(nbr_j[1]))
            ref = jcol.solve_contacts(jP, jw, jm, *nbr_j,
                                      rest_dist=jparams.radius)
        else:
            ref = jcol.contact_group(
                jP, jprev, jw, jv, jparams, rest_dist=jparams.radius,
                lattice_w=lat, rest_positions=jrest, window=16,
                iterations=8, backend="xla")
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), rtol=0,
                                   atol=CONTACT_TOL)


def jax_frame(jstates, jtopos, jparams, **kw):
    f = jax.jit(jax.vmap(lambda s, tp: jsolver.step(s, tp, jparams, **kw)))
    return f(stack(jstates), stack(jtopos))


def assert_frame(out, ref, topo, tol_p=FRAME_TOL_P, tol_v=FRAME_TOL_V):
    P = canonical(out.positions, topo, ref.positions)
    V = canonical(out.velocities, topo, ref.velocities)
    np.testing.assert_allclose(P, np.asarray(ref.positions), rtol=0,
                               atol=tol_p)
    np.testing.assert_allclose(V, np.asarray(ref.velocities), rtol=0,
                               atol=tol_v)


@pytest.mark.parametrize("mode", ["block", "sweep", "table", "sort"])
def test_xla_grid_frame(mode):
    """One frame of the xla grid step with Gauss-Seidel springs and each
    contact mode, a picker holding each cloth with picker friction, on
    compressed cloths; the time and step count advance."""
    rng = np.random.default_rng(3)
    jstates, jtopos, state, topo = compressed_pair(rng)
    pick = np.array([[0.0, 0.06, 0.0], [-10.0, -10.0, -10.0]], np.float32)
    jstates = [s.replace(picker_pos=jnp.asarray(pick)) for s in jstates]
    state = state.replace(picker_pos=t(np.broadcast_to(
        pick, (state.batch, 2, 3)).copy()))
    params = SolverParams(picker_friction=0.5)
    out = step(state, topo, params, backend="xla", contact_mode=mode,
               spring_mode="gs", **FRAME_KW)
    ref = jax_frame(jstates, jtopos,
                    JParams().replace(picker_friction=jnp.float32(0.5)),
                    backend="xla", contact_mode=mode, spring_mode="gs",
                    **FRAME_KW)
    assert_frame(out, ref, topo)
    assert torch.equal(out.step_count, torch.ones(state.batch,
                                                  dtype=torch.int64))
    np.testing.assert_array_equal(out.time.numpy(), np.asarray(ref.time))
    if mode in ("block", "sweep"):
        assert np.array_equal(out.sweep_perm.numpy(),
                              np.asarray(ref.sweep_perm))


def test_resort_cache_across_a_reload():
    """The cached Morton order is per env: envs at a multiple of
    resort_interval re-sort, the others keep their order; a reloaded
    slot restarts at step 0 and re-sorts while its neighbours keep
    theirs.  Two frames of the block mode against the JAX step, whose
    step_count is per env under vmap."""
    rng = np.random.default_rng(4)
    jstates, jtopos, state, topo = compressed_pair(rng)
    kw = dict(FRAME_KW, iterations=8, contact_iterations=4)
    jkw = dict(kw, backend="xla", contact_mode="block", spring_mode="gs")
    # frame 1 from step 0 everywhere: all re-sort
    out = step(state, topo, SolverParams(), **jkw)
    ref = jax_frame(jstates, jtopos, JParams(), **jkw)
    assert np.array_equal(out.sweep_perm.numpy(), np.asarray(ref.sweep_perm))
    # reload env 1: a fresh state at step 0, the others at step 1
    fresh, _, fresh_state, _ = compressed_pair(np.random.default_rng(5),
                                               dims=[DIMS[1]])
    idx = torch.tensor([1])
    state2 = out.set_slots(idx, fresh_state)
    assert state2.step_count.tolist() == [1, 0, 1]
    jb = jax.tree_util.tree_map(
        lambda a, f: a.at[1].set(f[0]), ref, stack(fresh))
    out2 = step(state2, topo, SolverParams(), resort_interval=4, **jkw)
    ref2 = jax.jit(jax.vmap(lambda s, tp: jsolver.step(
        s, tp, JParams(), resort_interval=4, **jkw)))(jb, stack(jtopos))
    assert np.array_equal(out2.sweep_perm.numpy(),
                          np.asarray(ref2.sweep_perm))
    # envs 0 and 2 kept the order of frame 1; env 1 took a fresh one
    assert torch.equal(out2.sweep_perm[[0, 2]], out.sweep_perm[[0, 2]])
    fresh_perm, _ = collisions.sweep_order(state2.positions[1:2],
                                           state2.active[1:2],
                                           SolverParams().radius)
    assert torch.equal(out2.sweep_perm[1], fresh_perm[0])
    assert out2.step_count.tolist() == [2, 1, 2]
    assert_frame(out2, ref2, topo, TWO_FRAME_TOL_P, TWO_FRAME_TOL_V)
