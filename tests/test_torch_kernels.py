"""The port's kernel modules: the two that have Pallas counterparts held
against the Pallas kernels (the contacts kernel in grid and in mesh mode),
and the grid path's contact epilogue (contact_apply) held against the
chain of solver functions it replaced.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
the Pallas kernels in interpret mode, as tests/test_pallas.py does.  The
CUDA kernels themselves are compared with the plain versions on the card
(`cuda`-marked tests here, and chip_smoke.py).  A card's machine may lack
the JAX package's dependencies (flax, h5py): there run only
`pytest -m cuda`, whose tests need neither."""

import os

import numpy as np
import pytest
import torch

from flingbot_tpu_torch.engine import collisions, kernels
from flingbot_tpu_torch.engine.constraints import (
    add_delta_clamped, solve_picker_spheres, solve_plane)
from flingbot_tpu_torch.engine.kernels import pack_sub_params
from flingbot_tpu_torch.engine.picker import DEFAULT_PICKER_RADIUS
from flingbot_tpu_torch.engine.solver import step
from flingbot_tpu_torch.engine.state import ClothState, SolverParams
from flingbot_tpu_torch.engine.topology import (
    build_grid_topology, grid_positions, lattice_valid)

try:  # the JAX package, for the tests against it
    import jax.numpy as jnp

    from flingbot_tpu.engine import solver as jsolver
    from flingbot_tpu.engine.collisions import (
        _contacts_sorted_flat, contact_group as jax_contact_group)
    from flingbot_tpu.engine.pallas_kernels import (
        pack_sub_params as jax_pack, pallas_contacts, pallas_substeps)
    from flingbot_tpu.engine.state import SolverParams as JParams
    from flingbot_tpu.engine.topology import (
        build_grid_topology as jax_topology)
    import tests.test_torch_common  # noqa: F401  (CPU platform, 2 threads)
    from tools.host_rounding import substeps_spread
except ImportError:
    jnp = None

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DIM = 16
FAR = [[-10.0] * 3] * 2


def _lattice(seed=0):
    rng = np.random.default_rng(seed)
    pos = grid_positions(DIM, DIM, lower=(0.0, 0.1, 0.0)).reshape(DIM, DIM, 3)
    pos += rng.normal(0, 1e-3, pos.shape)
    P = np.ascontiguousarray(np.moveaxis(pos, -1, 0), np.float32)
    V = rng.normal(0, 1e-2, (3, DIM, DIM)).astype(np.float32)
    w = np.full((DIM, DIM), DIM * DIM / 0.5, np.float32)
    return P, V, w


@pytest.mark.parametrize("dims,picker,picker_last", [
    ((16, 16), FAR, True),  # full grid
    ((12, 14), FAR, True),  # non-full grid: dimx < max_dimx
    ((16, 16), [[0.04, 0.1, 0.04], [-10.0] * 3], False),  # active picker
])
def test_substeps_match_pallas(dims, picker, picker_last):
    P, V, w = _lattice()
    jp = JParams()
    jt = jax_topology(dims[0], dims[1], max_dimx=DIM, max_dimy=DIM)
    jvec = jax_pack(jp, jt, jnp.asarray(picker, jnp.float32), 0.02,
                    jp.dt / 4, jsolver.CHEBYSHEV_RHO)
    kw = dict(n_sub=2, iterations=16, picker_last=picker_last)
    jout = pallas_substeps(jvec[None], jnp.asarray(P)[None],
                           jnp.asarray(V)[None], jnp.asarray(w)[None],
                           cheb=True, interpret=True, **kw)
    topo = build_grid_topology(dims[0], dims[1], max_dimx=DIM, max_dimy=DIM,
                               device="cpu")
    pvec = pack_sub_params(SolverParams(), topo,
                           torch.tensor([picker], dtype=torch.float32), 0.02,
                           np.float32(0.01) / np.float32(4))
    np.testing.assert_array_equal(pvec[0].numpy(), np.asarray(jvec))
    tout = kernels.substeps(pvec, torch.tensor(P)[None],
                            torch.tensor(V)[None], torch.tensor(w)[None], **kw)
    # tolerances of tests/test_pallas.py:76-81: float reassociation over 32
    # Chebyshev iterations; V = dP / dt_sub amplifies a position error 400x
    tols = (3e-6, 3e-3, 3e-6)
    if not picker_last:
        # the picker push is discontinuous (a particle is inside the sphere
        # or not), so the reference itself moves further than that under
        # its host's rounding: hold the port to the JAX-vs-JAX spread under
        # 1-ulp input noise where that is larger (tools/host_rounding.py:
        # P 1.70e-5, V 2.56e-4, prev 5.51e-7 on an AVX-512 host)
        spread = substeps_spread(n_noise=2, case=dict(
            dim=DIM, picker=picker, n_sub=2, iterations=16,
            picker_last=picker_last))
        tols = tuple(max(tol, spread[f"substeps_spread_{name}"])
                     for name, tol in zip(("P", "V", "prev"), tols))
    for name, j, t, tol in zip(("P", "V", "prev"), jout, tout, tols):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol,
                                   err_msg=name)
    if dims[0] < DIM:  # slots outside the cloth never move
        np.testing.assert_array_equal(tout[0][0, :, :, dims[0]:].numpy(),
                                      P[:, :, dims[0]:])


def _contact_inputs(seed=0, n=256):
    rng = np.random.default_rng(seed)
    # clumped points so contacts fire
    P = rng.normal(0, 0.01, (3, n)).astype(np.float32)
    prev = P + rng.normal(0, 1e-3, (3, n)).astype(np.float32)
    w = np.full(n, 100.0, np.float32)
    w[[3, 50]] = 0.0  # grasped -> immobile
    active = np.arange(n) < n - 7  # tail slots are not cloth
    return P, prev, w, active


def test_contacts_match_pallas_on_sorted_arrays():
    P, prev, w, active = _contact_inputs()
    params = SolverParams()
    order, srt = collisions.sort_particles(
        torch.tensor(P)[None], torch.tensor(prev)[None],
        torch.tensor(w)[None], torch.tensor(active)[None],
        rest_dist=params.radius, lattice_w=16)
    cp = kernels.contact_params(params, params.radius, 1, "cpu")
    out = kernels.contacts(cp, *srt, window=8, iterations=4)
    jp = JParams()
    arrs = [jnp.asarray(a[0].numpy()) for a in srt]
    ref_flat = _contacts_sorted_flat(jp, jp.radius, *arrs, window=8,
                                     iterations=4)
    pv = jnp.asarray(cp.numpy())
    R, C = 16, 16  # pallas_contacts' folded layout
    ref_pal = pallas_contacts(pv, *[a.reshape(R, C)[None] for a in arrs],
                              window=8, iterations=4, interpret=True)
    for c in range(3):
        # sums in another order: tests/test_pallas.py:158 tolerance
        np.testing.assert_allclose(out[c][0].numpy(),
                                   np.asarray(ref_flat[c]), atol=1e-6)
        np.testing.assert_allclose(out[c][0].numpy(),
                                   np.asarray(ref_pal[c][0]).reshape(-1),
                                   atol=1e-6)
    assert max(float((o - s).abs().max()) for o, s in zip(out, srt)) > 1e-4


def test_contact_group_matches_and_passes_through():
    P, prev, w, active = _contact_inputs(seed=1)
    jp = JParams()
    ref = jax_contact_group(jnp.asarray(P), jnp.asarray(prev),
                            jnp.asarray(w), jnp.asarray(active), jp,
                            rest_dist=jp.radius, lattice_w=16, window=8,
                            iterations=4, backend="xla")
    out = collisions.contact_group(
        torch.tensor(P)[None], torch.tensor(prev)[None],
        torch.tensor(w)[None], torch.tensor(active)[None], SolverParams(),
        rest_dist=SolverParams().radius, lattice_w=16, window=8,
        iterations=4)[0].numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-6)
    # immobile and inactive particles pass through exactly
    fixed = (w == 0) | ~active
    np.testing.assert_array_equal(out[:, fixed], P[:, fixed])
    assert np.abs(out - P).max() > 1e-4


def _shirt_contact_inputs(seed=0):
    """A crumpled eval shirt (data/shirt_eval_16.hdf5, 96 x 56 lattice)
    with seeded previous positions and two grasped vertices, Morton-sorted
    in mesh mode: the 7 sorted arrays and the 3 sorted rest coordinates."""
    from tests.test_torch_shirts import eval_tasks
    from flingbot_tpu_torch.env.scene import make_batch

    topo, state = make_batch(eval_tasks(1), device="cpu")
    rng = np.random.default_rng(seed)
    P = state.positions
    prev = P + torch.tensor(rng.normal(0, 1e-3, P.shape), dtype=P.dtype)
    w = torch.where(state.active, state.inv_mass, 0.0)
    w[0, topo.mesh_slot[0, :2]] = 0.0
    order, srt = collisions.sort_particles(
        P, prev, w, state.active, rest_dist=SolverParams().radius,
        rest_positions=topo.rest_positions)
    return (P, prev, w, state.active, topo), order, srt


@pytest.mark.parametrize("iterations,tol", [(1, 1e-6), (4, 1e-5)])
def test_mesh_contacts_match_pallas_and_xla_on_a_shirt(iterations, tol):
    """(c) the mesh mode (rest-pose filter) of the plain contacts on sorted
    shirt inputs against pallas_contacts(rests=..., interpret=True) and
    _contacts_sorted_flat(rest=...).  The JAX package tests only the grid
    mode of its kernel (tests/test_pallas.py:148-159).

    One iteration: 1e-6, the grid mode's bound.  Four (production): 1e-5.
    On the CPU, XLA contracts a * b + c into FMAs and rounds rsqrt unlike
    1 / sqrt (in 29% of f32 inputs), so the port and the JAX package
    differ by 1.5e-8 after one iteration; the contact count is
    discontinuous, and on this input one pair flips in the second
    iteration (measured 5.0e-6, then 2.9e-6 after four).  The two JAX
    forms agree bit for bit, and a 1e-7 perturbation of their own input
    moves them by 1.3e-4 to 7.3e-4 after four iterations."""
    _, _, srt = _shirt_contact_inputs()
    params = SolverParams()
    cp = kernels.contact_params(params, params.radius, 1, "cpu")
    kw = dict(window=12, iterations=iterations)
    out = kernels.contacts(cp, *srt[:7], rests=srt[7:], **kw)
    jp = JParams()
    arrs = [jnp.asarray(a[0].numpy()) for a in srt]
    ref_flat = _contacts_sorted_flat(jp, jp.radius, *arrs[:7],
                                     rest=jnp.stack(arrs[7:]), **kw)
    n = arrs[0].shape[0]
    R, C = 16, n // 16  # pallas_contacts' folded layout, no padding
    assert R * C == n
    fold = [a.reshape(R, C)[None] for a in arrs]
    ref_pal = pallas_contacts(jnp.asarray(cp.numpy()), *fold[:7],
                              rests=fold[7:], interpret=True, **kw)
    for c in range(3):
        np.testing.assert_allclose(out[c][0].numpy(),
                                   np.asarray(ref_flat[c]), atol=tol)
        np.testing.assert_allclose(out[c][0].numpy(),
                                   np.asarray(ref_pal[c][0]).reshape(-1),
                                   atol=tol)
    assert max(float((o - s).abs().max()) for o, s in zip(out, srt)) > 1e-4
    # the rest filter drops pairs that the grid mode's lattice test, on
    # the same packed ids, would keep
    grid = kernels.contacts_plain(cp, *srt[:7], **kw)
    assert max(float((a - b).abs().max()) for a, b in zip(out, grid)) > 0


def test_mesh_contact_group_matches_and_passes_through():
    """The whole mesh-mode contact group (sort, rest coordinates in sorted
    order, kernel, inverse scatter) against collisions.contact_group(
    rest_positions=...) of the JAX package."""
    (P, prev, w, active, topo), _, _ = _shirt_contact_inputs(seed=1)
    params = SolverParams()
    out = collisions.contact_group(
        P, prev, w, active, params, rest_dist=params.radius,
        rest_positions=topo.rest_positions, window=12, iterations=4)
    jp = JParams()
    ref = jax_contact_group(
        jnp.asarray(P[0].numpy()), jnp.asarray(prev[0].numpy()),
        jnp.asarray(w[0].numpy()), jnp.asarray(active[0].numpy()), jp,
        rest_dist=jp.radius,
        rest_positions=jnp.asarray(topo.rest_positions[0].numpy()),
        window=12, iterations=4, backend="xla")
    # four iterations: 1e-5, as in the test above (XLA's CPU rounding;
    # measured 3.0e-6)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), atol=1e-5)
    fixed = ((w == 0) | ~active)[0].numpy()
    np.testing.assert_array_equal(out[0].numpy()[:, fixed],
                                  P[0].numpy()[:, fixed])
    with pytest.raises(ValueError, match="exactly one"):
        collisions.contact_group(P, prev, w, active, params,
                                 rest_dist=params.radius, lattice_w=64,
                                 rest_positions=topo.rest_positions)


def _tail_inputs(n=1500, inactive=600, seed=2):
    """A clumped cloud of n slots (not a multiple of the contact tile)
    whose last `inactive` slots are not cloth, Morton-sorted in grid
    mode: the cparams and the 7 sorted arrays."""
    rng = np.random.default_rng(seed)
    P = rng.normal(0, 0.02, (1, 3, n)).astype(np.float32)
    prev = P + rng.normal(0, 1e-3, P.shape).astype(np.float32)
    w = np.full((1, n), 100.0, np.float32)
    w[0, [3, 50, 700]] = 0.0
    active = np.arange(n)[None] < n - inactive
    params = SolverParams()
    _, srt = collisions.sort_particles(
        *(torch.tensor(a) for a in (P, prev, w, active)),
        rest_dist=params.radius, lattice_w=64)
    return kernels.contact_params(params, params.radius, 1, "cpu"), srt


def _tiled_plain(cp, srt, rests, window, iterations):
    """contacts_plain run tile by tile on the slices [s - halo, e + halo)
    of kernels.contact_tiles, the owned ranges [s, e) stitched."""
    N = srt[0].shape[1]
    tile, halo, n_tiles = kernels.contact_tiles(N, window, iterations)
    out = [torch.empty_like(srt[0]) for _ in range(3)]
    skipped = 0
    for ti in range(n_tiles):
        s, e = ti * tile, min(N, (ti + 1) * tile)
        lo, hi = max(0, s - halo), min(N, e + halo)
        cut = lambda arrs: [a[:, lo:hi].contiguous() for a in arrs]  # noqa
        o = kernels.contacts_plain(cp, *cut(srt),
                                   cut(rests) if rests else None,
                                   window=window, iterations=iterations)
        for c in range(3):
            out[c][:, s:e] = o[c][:, s - lo:e - lo]
        if (srt[6][0, s] >> kernels.PACK_INACTIVE_BIT) & 1:
            # the kernel copies such a tile through: so does the plain one
            skipped += 1
            for c in range(3):
                assert torch.equal(out[c][:, s:e], srt[c][:, s:e])
    return out, n_tiles, skipped


@pytest.mark.parametrize("mode,window,iterations", [
    ("grid", 12, 4),  # the production knobs: halo 48
    ("grid", 16, 8),  # the flex-parity knobs: halo 128
    ("mesh", 12, 4),  # a crumpled eval shirt: 5376 slots, 11 tiles
])
def test_contact_tiles_stitch_to_the_whole(mode, window, iterations):
    """The contacts kernel's halo tiling: contacts_plain run tile by tile
    on the slices the wrapper's geometry cuts, owned ranges stitched,
    equals contacts_plain on the whole sorted array exactly, an N that is
    not a multiple of the tile and an inactive tail included."""
    if mode == "grid":
        cp, srt = _tail_inputs()
        rests = None
    else:
        _, _, arrs = _shirt_contact_inputs()
        cp = kernels.contact_params(SolverParams(), SolverParams().radius,
                                    1, "cpu")
        srt, rests = arrs[:7], arrs[7:]
    kw = dict(window=window, iterations=iterations)
    whole = kernels.contacts_plain(cp, *srt, rests, **kw)
    tiled, n_tiles, skipped = _tiled_plain(cp, srt, rests, **kw)
    N = srt[0].shape[1]
    assert n_tiles >= 3 and N % kernels.CONTACT_TILE != 0 and skipped >= 1
    for a, b in zip(tiled, whole):
        assert torch.equal(a, b)
    assert max(float((o - s).abs().max()) for o, s in zip(whole, srt)) > 1e-4


def _obj_shirt_contact_inputs():
    """Two shirts of data/shirts/shirt_00_processed.obj pressed to 40% of
    their width with a 1 cm wrinkle, one layered frame on, Morton-sorted
    in mesh mode (no HDF5 reader needed): the cparams, the 7 sorted
    arrays and the 3 sorted rest coordinates."""
    from flingbot_tpu_torch.env.scene import make_batch, shirt_task

    path = os.path.join(ROOT, "data", "shirts", "shirt_00_processed.obj")
    topo, state = make_batch([shirt_task(path)] * 2, device="cpu")
    P = state.positions.clone()
    P[:, 0] *= 0.4
    P[:, 2] *= 0.4
    P[:, 1] += 0.01 * torch.sin(P[:, 0] * 150.0) + 0.02
    state = state.replace(positions=torch.where(state.active[:, None], P,
                                                state.positions))
    params = SolverParams()
    moved = step(state, topo, params, substeps=2, iterations=4,
                 contact_every=2, contact_iterations=2, contact_window=12)
    w = torch.where(state.active, state.inv_mass, 0.0)
    _, srt = collisions.sort_particles(
        moved.positions, state.positions, w, state.active,
        rest_dist=params.radius, rest_positions=topo.rest_positions)
    cp = kernels.contact_params(params, params.radius, 2, "cpu")
    return cp, srt[:7], srt[7:]


# the contact epilogue's batches: an inactive tail (dimx < DIM) first, then
# a full cloth and another tail
APPLY_DIMS = ((12, 14), (16, 16), (9, 16))
APPLY_DT = np.float32(0.01) / np.float32(4)  # dt_sub at the default knobs


def _apply_batch(B, seed=0):
    """B envs of APPLY_DIMS on the DIM lattice in lattice order, built so
    that every branch of the contact epilogue fires: heights from 0 to
    2 cm around the collision distance, grasped slots (w = 0), contact
    outputs that push some particles below the plane and others fast
    enough for the speed-up clamp (pushes from 1e-6 to 3e-3 m at dt_sub
    2.5 ms: |dv| up to 1.2 m/s against dv_max 0.25), and both picker
    spheres inside env 0's cloth (picker 1 parked in the others).  Returns
    (topo, P, prev, V, w, valid, contact output, picker_pos) on the CPU,
    per-slot arrays (B, N)."""
    rng = np.random.default_rng(seed)
    N = DIM * DIM
    dims = APPLY_DIMS[:B]
    topo = build_grid_topology([d[0] for d in dims], [d[1] for d in dims],
                               max_dimx=DIM, max_dimy=DIM, device="cpu")
    valid = lattice_valid(topo.dimx, topo.dimy, DIM, DIM).reshape(B, N)
    P = np.repeat(grid_positions(DIM, DIM).T[None], B, 0)
    P[:, 1] = rng.uniform(0.0, 0.02, (B, N))
    prev = P + rng.normal(0, 1e-3, P.shape)
    V = rng.normal(0, 0.05, P.shape)
    w = np.where(valid.numpy(), DIM * DIM / 0.5, 0.0)
    w[:, [0, 37, 100]] = 0.0  # grasped
    moving = valid.numpy() & (w > 0)
    push = rng.normal(0, 1, P.shape) * 10 ** rng.uniform(-6, -2.5, P.shape)
    out = np.where(moving[:, None], P + push, P)
    picker = np.full((B, 2, 3), -10.0)
    picker[:, 0] = P[:, :, 5 * DIM + 5] + [0.0, 0.01, 0.0]
    picker[0, 1] = P[0, :, 7 * DIM + 8] + [0.0, 0.005, 0.0]
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return topo, t(P), t(prev), t(V), t(w), valid, t(out), t(picker)


# the default solver constants (dv_max = 0.25, a power of two, scales
# exactly), and a max acceleration whose dv_max does not, so that the
# reciprocal-then-product of a host float over a tensor shows
APPLY_PARAMS = (SolverParams(), SolverParams(max_acceleration=37.0,
                                             dynamic_friction=0.3))


def _apply_inputs(batch, seed=0, params=APPLY_PARAMS[0]):
    """contact_apply's arguments from a lattice-order batch: a seeded
    permutation stands in for the Morton order, the sorted arrays and the
    contact output are gathered through it."""
    topo, P, prev, V, w, valid, out, picker = batch
    B, _, N = P.shape
    gen = torch.Generator().manual_seed(seed)
    order = torch.argsort(torch.rand(B, N, generator=gen), dim=1)
    packed = kernels.pack_lattice_ids(N, DIM, valid, w <= 0)
    gather = lambda a: torch.gather(a, 1, order).contiguous()  # noqa: E731
    srt = [gather(P[:, c]) for c in range(3)] + [
        gather(prev[:, c]) for c in range(3)] + [gather(packed)]
    pvec = pack_sub_params(params, topo, picker, DEFAULT_PICKER_RADIUS,
                           APPLY_DT)
    return pvec, order, srt, tuple(gather(out[:, c]) for c in range(3)), V


def _old_apply_chain(order, out, P, prev, V, moving, picker, params):
    """The grid step's contact epilogue as it was written inline: the
    scatter back, then plane, clamped velocity add and picker spheres with
    host floats and a 0-dim dt, as solver._step_grid called them."""
    P2 = torch.empty_like(P)
    for c, o in enumerate(out):
        P2[:, c].scatter_(1, order, o)
    P2 = solve_plane(P2, prev, params.collision_distance,
                     params.dynamic_friction, moving)
    dv_max = np.float32(params.max_acceleration) * APPLY_DT
    R = float(np.float32(DEFAULT_PICKER_RADIUS)
              + np.float32(params.collision_distance))
    P, V = add_delta_clamped(P, P2, V, torch.tensor(APPLY_DT), float(dv_max),
                             moving)
    return solve_picker_spheres(P, picker, R, moving), V


@pytest.mark.parametrize("B,seed,params", [
    (1, 0, APPLY_PARAMS[0]), (3, 1, APPLY_PARAMS[0]),
    (3, 2, APPLY_PARAMS[1])])
def test_contact_apply_plain_is_the_old_chain(B, seed, params):
    batch = _apply_batch(B, seed)
    _, P, prev, V, w, valid, out, picker = batch
    moving = valid & (w > 0)
    args = _apply_inputs(batch, seed, params)
    # every branch fires: the plane, the clamp on and off, both spheres
    cd = np.float32(params.collision_distance)
    assert ((out[:, 1] < cd) & moving).any()
    assert ((out[:, 1] > cd) & moving).any()
    dv = (out - P) / float(APPLY_DT)
    dv_norm = dv.norm(dim=1)
    speeding = (V + dv).norm(dim=1) > V.norm(dim=1)
    dv_max = params.max_acceleration * float(APPLY_DT)
    assert (speeding & (dv_norm > dv_max) & moving).any()
    assert (speeding & (dv_norm < dv_max) & moving).any()
    assert (~speeding & moving).any()
    for k in range(2):
        near = (out - picker[:, k, :, None]).norm(dim=1) < 0.025
        assert (near[0] & moving[0]).any()
    assert ((w == 0) & valid).any() and (~valid).any()
    want_P, want_V = _old_apply_chain(args[1], args[3], P, prev, V, moving,
                                      picker, params)
    got_P, got_V = kernels.contact_apply_plain(*args)
    assert torch.equal(got_P, want_P) and torch.equal(got_V, want_V)
    before = dict(kernels.LAUNCHES)
    wrap_P, wrap_V = kernels.contact_apply(*args)
    assert kernels.LAUNCHES == before  # the plain version on the CPU
    assert torch.equal(wrap_P, want_P) and torch.equal(wrap_V, want_V)


SORT_RD = SolverParams().radius


def _sort_inputs(mode, seed=0):
    """Two envs of DIM x DIM slots for the contact group's sort: clouds
    clumped into 27 Morton cells (~10 particles a cell, so keys tie), a
    few on cell boundaries where a division by the reciprocal of rest_dist
    would floor to another cell, a few far enough out for the cell clamp;
    inactive slots (a tail in env 0, scattered in env 1) and immobile ones
    (w = 0, some of them inactive too).  Returns (P, prev, w, active,
    sort keywords) on the CPU; mesh mode adds seeded rest positions."""
    rng = np.random.default_rng(seed)
    B, N = 2, DIM * DIM
    rd = np.float32(SORT_RD)
    cells = rng.integers(-1, 2, (B, 3, N))
    P = ((cells + rng.random((B, 3, N))) * rd).astype(np.float32)
    # boundaries: x = k * rd in float32 and its neighbours up to 3 ulps
    # away, kept where floor(x / rd) and floor(x * (1 / rd)) differ
    base = np.arange(-512, 512, dtype=np.float32) * rd
    x = [base]
    for d in (np.inf, -np.inf):
        near = base
        for _ in range(3):
            near = np.nextafter(near, np.float32(d))
            x.append(near)
    x = np.concatenate(x)
    x = x[np.floor(x / rd) != np.floor(x * (np.float32(1) / rd))]
    assert x.size >= 16, x.size
    P[:, 0, :x.size] = x
    # past the 1024-cell clamp, and past int32 (the cast saturates)
    P[0, :, -4:] = [[30.0, -30.0, 0.0, 1e9]] * 3
    prev = (P + rng.normal(0, 1e-3, P.shape)).astype(np.float32)
    w = np.full((B, N), 100.0, np.float32)
    w[:, [3, 50, 77, N - 30]] = 0.0
    active = np.ones((B, N), bool)
    active[0, N - 20:-4] = False
    active[1] = rng.random(N) > 0.1
    t = torch.tensor
    kw = dict(lattice_w=DIM)
    if mode == "mesh":
        kw = dict(rest_positions=t(rng.normal(0, 0.05, (B, 3, N))
                                   .astype(np.float32)))
    return t(P), t(prev), t(w), t(active), kw


def _old_sort_chain(P, prev, w, active, lattice_w=None, rest_positions=None):
    """sort_particles as written before its two kernels, the Morton code
    and the packed ids inline: (keys, order, the sorted arrays)."""
    def part1by2(x):
        x = x & 0x3FF
        for shift, mask in ((16, 0x30000FF), (8, 0x300F00F), (4, 0x30C30C3),
                            (2, 0x9249249)):
            x = (x | (x << shift)) & mask
        return x

    rd = torch.tensor(SORT_RD, dtype=torch.float32)
    cell = torch.clamp(torch.floor(P / rd).to(torch.int32) + 512, 0, 1023)
    code = (part1by2(cell[:, 0]) | (part1by2(cell[:, 1]) << 1)
            | (part1by2(cell[:, 2]) << 2))
    keys = torch.where(active, code, torch.tensor(2 ** 30, dtype=torch.int32))
    i = torch.arange(P.shape[2], dtype=torch.int32)
    ids = i if lattice_w is None else (i % lattice_w) | ((i // lattice_w) << 8)
    packed = (ids[None] | ((w <= 0).to(torch.int32) << 20)
              | ((~active).to(torch.int32) << 21))
    arrays = [P[:, 0], P[:, 1], P[:, 2], prev[:, 0], prev[:, 1], prev[:, 2],
              packed]
    if rest_positions is not None:
        arrays += [rest_positions[:, c] for c in range(3)]
    _, order = torch.sort(keys, dim=1, stable=True)
    return keys, order, [torch.gather(a, 1, order) for a in arrays]


@pytest.mark.parametrize("mode", ["grid", "mesh"])
def test_contact_sort_plain_is_the_old_chain(mode):
    """contact_keys_plain, torch.sort and contact_gather_plain against the
    sort as it was written before them, bit for bit: keys, order and every
    sorted array; then sort_particles on both backends, which on the CPU
    run that plain chain and launch nothing."""
    P, prev, w, active, kw = _sort_inputs(mode)
    want_keys, want_order, want = _old_sort_chain(P, prev, w, active, **kw)
    keys = kernels.contact_keys_plain(P, active, SORT_RD)
    assert torch.equal(keys, want_keys)
    live = keys[active]
    assert live.unique().numel() * 4 < live.numel()  # keys tie
    assert (keys == 2 ** 30).sum() == (~active).sum()
    _, order = torch.sort(keys, dim=1, stable=True)
    assert torch.equal(order, want_order)
    got = kernels.contact_gather_plain(order, P, prev, w, active, **kw)
    assert len(got) == (10 if mode == "mesh" else 7)
    for a, b in zip(got, want):
        assert a.is_contiguous() and torch.equal(a, b)
    # every flag of the packed ids occurs
    packed = got[6]
    for bit in (kernels.PACK_IMMOBILE_BIT, kernels.PACK_INACTIVE_BIT):
        assert ((packed >> bit) & 1).any()
    before = dict(kernels.LAUNCHES)
    assert torch.equal(kernels.contact_keys(P, active, SORT_RD), want_keys)
    for backend in ("xla", "pallas"):
        o, srt = collisions.sort_particles(P, prev, w, active,
                                           rest_dist=SORT_RD,
                                           backend=backend, **kw)
        assert torch.equal(o, want_order)
        assert all(torch.equal(a, b) for a, b in zip(srt, want))
    assert kernels.LAUNCHES == before  # the plain versions on the CPU
    with pytest.raises(ValueError, match="unknown backend"):
        collisions.sort_particles(P, prev, w, active, rest_dist=SORT_RD,
                                  backend="tpu", **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    P, V, w = _lattice()
    topo = build_grid_topology([16, 12], [16, 14], max_dimx=DIM,
                               max_dimy=DIM, device=cuda_device)
    picker = torch.tensor([[[0.04, 0.1, 0.04], [-10.0] * 3]] * 2,
                          device=cuda_device)
    pvec = pack_sub_params(SolverParams(), topo, picker, 0.02, 0.0025)
    args = [torch.tensor(np.stack([a, a]), device=cuda_device)
            for a in (P, V, w)]
    kw = dict(n_sub=2, iterations=16, picker_last=False)
    before = kernels.LAUNCHES["substeps"]
    out_k = kernels.substeps(pvec, *args, **kw)
    out_p = kernels.substeps_plain(pvec, *args, **kw)
    assert kernels.LAUNCHES["substeps"] == before + 1
    for a, b, tol in zip(out_k, out_p, (1e-5, 4e-3, 1e-5)):
        assert float((a - b).abs().max()) <= tol
    Pc, prevc, wc, activec = _contact_inputs()
    order, srt = collisions.sort_particles(
        *(torch.tensor(a, device=cuda_device)[None]
          for a in (Pc, prevc, wc, activec)),
        rest_dist=SolverParams().radius, lattice_w=16)
    cp = kernels.contact_params(SolverParams(), SolverParams().radius, 1,
                                cuda_device)
    ok = kernels.contacts(cp, *srt, window=8, iterations=4)
    op = kernels.contacts_plain(cp, *srt, window=8, iterations=4)
    for a, b in zip(ok, op):
        assert float((a - b).abs().max()) <= 2e-6


@pytest.mark.cuda
def test_cuda_mesh_contacts_match_plain(cuda_device):
    """The mesh mode of csrc/contacts.cu against its plain version on two
    pressed OBJ shirts (6144 slots on the 96x64 lattice): the contacts
    tolerance, in effect bit-equality under -fmad=false."""
    cp, srt, rests = _obj_shirt_contact_inputs()
    cp, srt, rests = (cp.to(cuda_device), [a.to(cuda_device) for a in srt],
                      [a.to(cuda_device) for a in rests])
    before = dict(kernels.LAUNCHES)
    ok = kernels.contacts(cp, *srt, rests=rests, window=12, iterations=4)
    op = kernels.contacts_plain(cp, *srt, rests=rests, window=12,
                                iterations=4)
    assert kernels.LAUNCHES["contacts_mesh"] == before["contacts_mesh"] + 1
    assert kernels.LAUNCHES["contacts"] == before["contacts"] + 1
    for a, b in zip(ok, op):
        assert float((a - b).abs().max()) <= 2e-6


def _cloths(dims, H, device, seed=0):
    """pvec, P, V, w of len(dims) cloths of (dimx, dimy) on an H x H
    lattice: a flat grid raised 0.1 m with 1 mm noise, 1 cm/s velocities,
    uniform inverse masses but for a pinned corner, picker 0 touching it."""
    rng = np.random.default_rng(seed)
    B = len(dims)
    pos = grid_positions(H, H, lower=(0.0, 0.1, 0.0)).reshape(H, H, 3)
    P = np.moveaxis(pos[None] + rng.normal(0, 1e-3, (B, H, H, 3)), -1, 1)
    V = rng.normal(0, 1e-2, (B, 3, H, H))
    w = np.full((B, H, H), H * H / 0.5)
    w[:, 0, 0] = 0.0
    topo = build_grid_topology([d[0] for d in dims], [d[1] for d in dims],
                               max_dimx=H, max_dimy=H, device=device)
    picker = np.stack([P[:, :, 0, 0] + [0.0, 0.002, 0.0],
                       np.full((B, 3), -10.0)], 1)
    picker = torch.tensor(picker, dtype=torch.float32, device=device)
    pvec = pack_sub_params(SolverParams(), topo, picker, 0.02, 0.0025)
    return [pvec] + [torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                  device=device) for a in (P, V, w)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(n_sub=2, picker_last=False),  # the fused launch
    dict(n_sub=1, picker_last=False),  # the aero launch
    dict(n_sub=4, cheb=False, picker_last=True),  # jacobi, no contacts
    dict(n_sub=4, picker_last=True),  # no self-collision
])
@pytest.mark.parametrize("H,dims", [
    # full, partial and empty bands (5 rows over 8 CTAs: 2, 2, 1, 0, ...)
    (DIM, [(16, 16), (12, 14), (7, 5)]),
    # a band of 13 rows in strips of 5, 5, 3 (narrower cloths take
    # shorter strips), laid end to end across warps mid-row (104, 64, 33
    # columns); a cloth narrower than a warp's 29 columns, one of 2 rows
    # a band
    (104, [(104, 104), (64, 97), (33, 71), (20, 104), (104, 9)]),
    # the large set's lattice: strips of 6 rows, one CTA an SM
    (128, [(128, 128), (113, 127)]),
])
def test_cuda_substeps_configurations(cuda_device, kw, H, dims):
    """Each launch configuration of csrc/substeps.cu against its plain
    version on envs whose dims end bands, strips and warps at every
    place the layout allows, on the 16, 104 and 128 lattices: the
    substeps tolerances, in effect bit-equality under -fmad=false."""
    pvec, *args = _cloths(dims, H, cuda_device)
    kw = dict(kw, iterations=16)
    out_k = kernels.substeps(pvec, *args, **kw)
    out_p = kernels.substeps_plain(pvec, *args, **kw)
    for a, b, tol in zip(out_k, out_p, (1e-5, 4e-3, 1e-5)):
        assert float((a - b).abs().max()) <= tol


def test_substeps_band_geometry():
    """The substeps kernel's layout at the lattices its callers launch:
    the band, the strip height and the shared memory a CTA (all under a
    Hopper block's limit; two CTAs an SM up to 104), and the spring
    evaluations a spring of one Jacobi iteration, computed from the
    layout: at the hard eval set's dims (rect-hard.physics) under 1.6,
    where evaluating both ends of every spring at each slot made 2.04."""
    want = {64: (8, 2, 46080), 100: (13, 4, 106000), 104: (13, 5, 110240),
            128: (16, 6, 161792)}
    for H, (band, strip, smem) in want.items():
        assert kernels.substeps_band(H, H) == (band, strip, smem)
        assert smem <= kernels._SMEM_LIMIT
        assert -(-band // strip) * H <= (kernels.SUBSTEPS_WARPS
                                         * kernels.SUBSTEPS_WARP_COLUMNS)
    # two CTAs an SM at 104: an SM's 228 KB, 1 KB of it reserved a CTA
    assert 2 * (kernels.substeps_band(104, 104)[2] + 1024) <= 233472
    with np.load(os.path.join(ROOT, "data_r3/rect_eval_hard_100.npz")) as z:
        dims = [tuple(int(v) for v in z[k]) for k in z.files
                if k.endswith("/cloth_size")]
    assert len(dims) == 100
    share = kernels.substeps_evals_per_spring(dims, 104, 104)
    assert 1.0 < share < 1.6
    # one 104 x 104 cloth: 8 CTAs of 13 rows in strips of 5, 5, 3; of 11
    # warps, 8 walk 5 rows and 3 walk 3, each with 5 springs from the 2
    # rows above: 32 x (8 x 35 + 3 x 23) evaluations a CTA
    springs = 2 * 104 * 103 + 2 * 104 * 102 + 2 * 103 * 103
    assert kernels.substeps_evals_per_spring([(104, 104)], 104, 104) == \
        8 * 32 * (8 * 35 + 3 * 23) / springs
    # a lattice row wider than the CTA's owning lanes has no layout
    assert kernels.substeps_band(600, 600)[1] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode,window,iterations", [
    ("grid", 12, 4), ("grid", 16, 8), ("mesh", 12, 4)])
def test_cuda_contact_tiles_match_plain(cuda_device, mode, window,
                                        iterations):
    """The halo-tiled contacts kernel against contacts_plain at one or two
    envs (a few blocks: most SMs idle), with an N that is not a multiple
    of the tile and an inactive tail: the contacts tolerance."""
    if mode == "grid":
        cp, srt = _tail_inputs()
        rests = None
    else:
        cp, srt, rests = _obj_shirt_contact_inputs()
    to = lambda arrs: [a.to(cuda_device) for a in arrs]  # noqa: E731
    cp, srt = cp.to(cuda_device), to(srt)
    rests = to(rests) if rests else None
    kw = dict(window=window, iterations=iterations)
    ok = kernels.contacts(cp, *srt, rests, **kw)
    op = kernels.contacts_plain(cp, *srt, rests, **kw)
    for a, b in zip(ok, op):
        assert float((a - b).abs().max()) <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("B,seed,params", [
    (1, 0, APPLY_PARAMS[0]), (3, 1, APPLY_PARAMS[0]),
    (3, 2, APPLY_PARAMS[1])])
def test_cuda_contact_apply_matches_plain(cuda_device, B, seed, params):
    """csrc/contact_apply.cu against contact_apply_plain on the card, on
    the batch whose every branch fires: bit-equal under -fmad=false."""
    args = _apply_inputs(_apply_batch(B, seed), seed, params)
    pvec, order, srt, out, V = args
    to = lambda arrs: [a.to(cuda_device) for a in arrs]  # noqa: E731
    args = (pvec.to(cuda_device), order.to(cuda_device), to(srt), to(out),
            V.to(cuda_device))
    before = kernels.LAUNCHES["contact_apply"]
    got = kernels.contact_apply(*args)
    assert kernels.LAUNCHES["contact_apply"] == before + 1
    want = kernels.contact_apply_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _grid_frame_batch(device):
    """The three APPLY_DIMS cloths of _apply_batch as a ClothState and its
    topology on `device`."""
    _, P, _, V, w, valid, _, picker = _apply_batch(3)
    topo = build_grid_topology([d[0] for d in APPLY_DIMS],
                               [d[1] for d in APPLY_DIMS], max_dimx=DIM,
                               max_dimy=DIM, device=device)
    t = lambda a: a.to(device)  # noqa: E731
    state = ClothState(
        positions=t(P), velocities=t(V), inv_mass=t(w), rest_inv_mass=t(w),
        active=t(valid), picker_pos=t(picker),
        picked_idx=torch.full((3, 2), -1, dtype=torch.int64, device=device))
    return state, topo


@pytest.mark.cuda
def test_cuda_grid_frame_with_the_apply_kernel_is_the_plain_frame(
        cuda_device, monkeypatch):
    """One solver.step grid frame on the card (production knobs, both
    pickers in env 0's cloth) launches contact_apply once a contact group,
    and equals the same frame with the plain epilogue bit for bit."""
    state, topo = _grid_frame_batch(cuda_device)
    before = kernels.LAUNCHES["contact_apply"]
    got = step(state, topo, SolverParams())
    assert kernels.LAUNCHES["contact_apply"] == before + 2
    monkeypatch.setattr(kernels, "contact_apply",
                        kernels.contact_apply_plain)
    want = step(state, topo, SolverParams())
    assert kernels.LAUNCHES["contact_apply"] == before + 2
    assert torch.equal(got.positions, want.positions)
    assert torch.equal(got.velocities, want.velocities)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["grid", "mesh"])
def test_cuda_sort_kernels_match_plain(cuda_device, mode):
    """csrc/contact_sort.cu against contact_keys_plain and
    contact_gather_plain on _sort_inputs' two envs (ties, cell boundaries,
    the clamp, inactive and immobile slots): keys, order and every sorted
    array bit for bit, and sort_particles' two backends equal."""
    P, prev, w, active, kw = _sort_inputs(mode)
    P, prev, w, active = (a.to(cuda_device) for a in (P, prev, w, active))
    kw = {k: v.to(cuda_device) if torch.is_tensor(v) else v
          for k, v in kw.items()}
    before = dict(kernels.LAUNCHES)
    keys = kernels.contact_keys(P, active, SORT_RD)
    assert torch.equal(keys, kernels.contact_keys_plain(P, active, SORT_RD))
    _, order = torch.sort(keys, dim=1, stable=True)
    got = kernels.contact_gather(order, P, prev, w, active, **kw)
    want = kernels.contact_gather_plain(order, P, prev, w, active, **kw)
    assert len(got) == len(want) == (10 if mode == "mesh" else 7)
    for a, b in zip(got, want):
        assert a.is_contiguous() and a.dtype == b.dtype and torch.equal(a, b)
    mesh = int(mode == "mesh")
    assert kernels.LAUNCHES["contact_keys"] == before["contact_keys"] + 1
    assert kernels.LAUNCHES["contact_gather"] == before["contact_gather"] + 1
    assert kernels.LAUNCHES["contact_gather_mesh"] == \
        before["contact_gather_mesh"] + mesh
    o_k, s_k = collisions.sort_particles(P, prev, w, active,
                                         rest_dist=SORT_RD, **kw)
    o_p, s_p = collisions.sort_particles(P, prev, w, active,
                                         rest_dist=SORT_RD, backend="xla",
                                         **kw)
    assert torch.equal(o_k, o_p) and torch.equal(o_k, order)
    assert all(torch.equal(a, b) for a, b in zip(s_k, s_p))
    assert kernels.LAUNCHES["contact_keys"] == before["contact_keys"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["grid", "mesh"])
def test_cuda_frame_with_the_sort_kernels_is_the_plain_frame(
        cuda_device, monkeypatch, mode):
    """One solver.step frame on the card launches both sort kernels once a
    contact group and equals the same frame with their plain versions bit
    for bit: the grid frame at the production knobs, and a layered frame
    of two OBJ shirts (mesh mode) at _obj_shirt_contact_inputs' knobs."""
    from flingbot_tpu_torch.env.scene import make_batch, shirt_task

    if mode == "grid":
        state, topo = _grid_frame_batch(cuda_device)
        kw, groups = {}, 2
    else:
        path = os.path.join(ROOT, "data", "shirts", "shirt_00_processed.obj")
        topo, state = make_batch([shirt_task(path)] * 2, device=cuda_device)
        kw = dict(substeps=2, iterations=4, contact_every=2,
                  contact_iterations=2, contact_window=12)
        groups = 1
    before = dict(kernels.LAUNCHES)
    got = step(state, topo, SolverParams(), **kw)
    for name in ("contact_keys", "contact_gather"):
        assert kernels.LAUNCHES[name] == before[name] + groups
    assert kernels.LAUNCHES["contact_gather_mesh"] == \
        before["contact_gather_mesh"] + (groups if mode == "mesh" else 0)
    monkeypatch.setattr(kernels, "contact_keys", kernels.contact_keys_plain)
    monkeypatch.setattr(kernels, "contact_gather",
                        kernels.contact_gather_plain)
    want = step(state, topo, SolverParams(), **kw)
    assert torch.equal(got.positions, want.positions)
    assert torch.equal(got.velocities, want.velocities)
