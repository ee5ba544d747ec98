"""Self-collision (counterpart of flingbot_tpu/engine/collisions.py).

The sort-based contact group (contact_mode "sort", the production path):
key every particle by the Morton code of its cell (cell = rest_dist),
stable-sort, gather positions / previous positions / packed ids (and, for
meshes, rest positions) into sorted order, run the windowed pair
projection, and scatter the result back through the sort permutation.  The
JAX package sorts twice (a multi-operand forward sort and an inverse sort
keyed by slot index) because a TPU gathers slowly; here torch.sort of the
keys returns the permutation, the sorted arrays are one gather through it
and the inverse is one scatter.  On the pallas backend the keys and the
gather are two kernels (`kernels.contact_keys`, `kernels.contact_gather`)
and the projection is the contacts kernel (`kernels.contacts`); on the
xla backend all three are their plain versions, the counterpart of the
JAX package's XLA code (`_contacts_sorted_flat` for the projection).  The
grid step of the pallas backend takes the group without its scatter
(`sort_and_project`) and scatters in its epilogue kernel
(`kernels.contact_apply`).

The xla backend's other contact modes, plain PyTorch on every device:
  sweep  +-window pairs in a cached Morton order (solve_contacts_sweep)
  block  every pair of a 16-slot half-block with itself and the next one
         in that order (solve_contacts_block)
  table  a hash-grid neighbour table of K_NEIGHBORS per particle, built
         once per step (find_neighbors_grid / _hash, solve_contacts)
All arrays are batched: positions (B, 3, N), per-particle (B, N).
"""

from __future__ import annotations

import torch

from flingbot_tpu_torch.engine import kernels
from flingbot_tpu_torch.engine.constraints import EPS, dot3, solve_plane
from flingbot_tpu_torch.engine.kernels import INT32_BIG, morton_code
from flingbot_tpu_torch.engine.state import SolverParams
from flingbot_tpu_torch.utils import trace


def sort_particles(P, prev, w, active, *, rest_dist, lattice_w=None,
                   rest_positions=None, backend: str = "pallas"):
    """Morton-sort one contact group's inputs.  P, prev (B, 3, N); w
    (B, N); active (B, N) bool; exactly one of lattice_w (grid mode) and
    rest_positions (B, 3, N) (mesh mode).  Returns (order (B, N), [xs, ys,
    zs, pxs, pys, pzs, packed] + [rx, ry, rz] in mesh mode) with every
    array in sorted order.  The sort is stable, as jax.lax.sort: Morton
    keys tie often, and tie order decides which pairs fall inside the
    window.

    torch.sort orders the keys on both backends.  Around it, backend
    "pallas" launches two kernels: kernels.contact_keys (every key in one
    pass) and kernels.contact_gather (every sorted array in one pass);
    "xla" runs their plain versions on any device."""
    if (lattice_w is None) == (rest_positions is None):
        raise ValueError("pass exactly one of lattice_w / rest_positions")
    if backend == "pallas":
        keys_fn, gather_fn = kernels.contact_keys, kernels.contact_gather
        # the kernels read contiguous arrays (no copy where they are)
        P, prev, w, active = (a.contiguous() for a in (P, prev, w, active))
        if rest_positions is not None:
            rest_positions = rest_positions.contiguous()
    elif backend == "xla":
        keys_fn = kernels.contact_keys_plain
        gather_fn = kernels.contact_gather_plain
    else:
        raise ValueError(f"unknown backend {backend!r}")
    _, order = torch.sort(keys_fn(P, active, rest_dist), dim=1, stable=True)
    return order, gather_fn(order, P, prev, w, active, lattice_w=lattice_w,
                            rest_positions=rest_positions)


def sort_and_project(P, prev, w, active, params: SolverParams, *,
                     rest_dist, lattice_w=None, rest_positions=None,
                     window: int = 12, iterations: int = 4,
                     backend: str = "pallas"):
    """The sort and the projection of a contact group, left in sorted
    order: (order (B, N), srt, (ox, oy, oz)), srt the sorted arrays of
    sort_particles and (ox, oy, oz) the projected positions.  The
    arguments are contact_group's.  The grid step hands the result to
    kernels.contact_apply, which scatters it back in its epilogue."""
    if backend not in ("pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    with trace.span("solver.contacts.sort"):
        order, srt = sort_particles(P, prev, w, active, rest_dist=rest_dist,
                                    lattice_w=lattice_w,
                                    rest_positions=rest_positions,
                                    backend=backend)
    with trace.span("solver.contacts.project"):
        cp = kernels.contact_params(params, rest_dist, P.shape[0], P.device)
        project = kernels.contacts if backend == "pallas" \
            else kernels.contacts_plain
        out = project(cp, *srt[:7], rests=srt[7:] or None, window=window,
                      iterations=iterations)
    return order, srt, out


def contact_group(P, prev, w, active, params: SolverParams, *, rest_dist,
                  lattice_w=None, rest_positions=None, window: int = 12,
                  iterations: int = 4, backend: str = "pallas"):
    """Full self-collision pass on lattice-ordered particles.

    P, prev (B, 3, N); w (B, N); active (B, N) bool.  Returns P' (B, 3, N).
    Assumes uniform particle mass (every flingbot scene); grasped particles
    (w == 0) are immobile.  SelfCollideFilter: pass lattice_w for grid
    cloths (lattice neighbours dropped by their packed ids) or
    rest_positions (B, 3, N) for meshes (pairs closer than rest_dist in the
    rest pose dropped: the kernel's mesh mode; the rest coordinates take
    the same sort).  backend "pallas" sorts with the two sort kernels
    (sort_particles) and projects with the contacts kernel, "xla" runs
    their plain versions on any device (contact_group(backend="xla") ->
    _contacts_sorted_flat, collisions.py:399-402)."""
    order, _, projected = sort_and_project(
        P, prev, w, active, params, rest_dist=rest_dist, lattice_w=lattice_w,
        rest_positions=rest_positions, window=window, iterations=iterations,
        backend=backend)
    with trace.span("solver.contacts.apply"):
        out = torch.empty_like(P)
        for c, o in enumerate(projected):
            out[:, c].scatter_(1, order, o)
    return out


# --------------------------------------------------------------------------
# the xla backend's cached-order modes: sweep and block
# --------------------------------------------------------------------------

SWEEP_WINDOW = 10
BLOCK_HALF = 16


def sweep_order(P, active, cell_size):
    """The Morton order of the sweep and block modes (sweep_order,
    collisions.py:175-186): P (B, 3, N), active (B, N).  Returns (perm,
    inv_perm), (B, N) i64 each; inactive particles sort last, ties keep
    slot order (a stable sort, as jnp.argsort)."""
    cs = torch.as_tensor(cell_size, dtype=torch.float32, device=P.device)
    cell = torch.clamp(torch.floor(P / cs).to(torch.int32) + 512, 0, 1023)
    key = torch.where(active, morton_code(cell),
                      torch.tensor(INT32_BIG, dtype=torch.int32,
                                   device=P.device))
    _, perm = torch.sort(key, dim=1, stable=True)
    inv = torch.empty_like(perm)
    inv.scatter_(1, perm, torch.arange(perm.shape[1], device=P.device)
                 .expand_as(perm).contiguous())
    return perm, inv


def _take(a, idx):
    """a (B, ..., N) gathered along its last axis at idx (B, M)."""
    lead = a.shape[1:-1]
    i = idx.view((idx.shape[0],) + (1,) * len(lead) + (idx.shape[-1],))
    return torch.gather(a, -1, i.expand(a.shape[:-1] + idx.shape[-1:]))


def _rest_filter_ok(ids_a, ids_b, rest_a, rest_b, lattice_w, rest_dist):
    """Pairs the SelfCollideFilter keeps: lattice ids more than one apart
    on an axis (grid), or rest positions at least rest_dist apart
    (mesh)."""
    ok = True
    if lattice_w is not None:
        ok = ~((torch.abs(ids_a // lattice_w - ids_b // lattice_w) <= 1)
               & (torch.abs(ids_a % lattice_w - ids_b % lattice_w) <= 1))
    if rest_a is not None:
        rd = rest_a - rest_b
        ok = ok & (dot3(rd, rd) >= rest_dist * rest_dist)
    return ok


def solve_contacts_sweep(P, w, moving, perm, inv_perm, params: SolverParams,
                         *, rest_dist, window: int = SWEEP_WINDOW,
                         iterations: int = 8, lattice_w=None,
                         rest_sorted=None, active=None, prev=None):
    """Iterated contact projection in Morton order (solve_contacts_sweep,
    collisions.py:415-514): pairs (i, i + k), 0 < |k| <= window, of the
    sorted slots, minus the SelfCollideFilter (lattice_w for grids, or
    rest_sorted (B, 3, N), the rest pose in sorted order, for meshes);
    each side pushes itself out by its mass share with PBD particle
    friction on the pair's motion since `prev`; Jacobi average by contact
    count; the ground plane after every pass.  P (B, 3, N); w, moving,
    active (B, N); perm, inv_perm (B, N)."""
    n = P.shape[2]
    ws = _take(w, perm)
    act_s = _take(moving if active is None else active, perm)
    ms = _take(moving, perm)
    idx = torch.arange(n, device=P.device)[None]
    mu_p = params.particle_friction * params.dynamic_friction
    Ps = _take(P, perm)
    prev_s = _take(prev, perm) if prev is not None else Ps
    ks = list(range(1, window + 1)) + list(range(-window, 0))
    static = []
    for k in ks:
        ok = ((idx + k >= 0) & (idx + k < n) & act_s
              & torch.roll(act_s, -k, 1))
        ok = ok & _rest_filter_ok(
            perm, torch.roll(perm, -k, 1), rest_sorted,
            None if rest_sorted is None else torch.roll(rest_sorted, -k, 2),
            lattice_w, rest_dist)
        static.append((k, ok, torch.roll(ws, -k, 1),
                       prev_s - torch.roll(prev_s, -k, 2)))
    for _ in range(iterations):
        delta = torch.zeros_like(Ps)
        count = torch.zeros_like(ws)
        for k, ok0, wn, dprev in static:
            d = Ps - torch.roll(Ps, -k, 2)
            dist = torch.sqrt(dot3(d, d) + EPS)
            pen = rest_dist - dist
            wsum = ws + wn
            ok = ok0 & (pen > 0) & (wsum > 0)
            s = torch.where(ok, pen / ((wsum + EPS) * dist), 0.0)
            delta = delta + (ws * s)[:, None] * d
            count = count + ok.to(count.dtype)
            rel = d - dprev
            nhat = d / dist[:, None]
            rel_n = dot3(rel, nhat)
            t = rel - rel_n[:, None] * nhat
            t_norm = torch.sqrt(dot3(t, t) + EPS)
            fr = torch.clamp(mu_p * pen / t_norm, max=1.0)
            fscale = torch.where(ok, (ws / (wsum + EPS)) * fr, 0.0)
            delta = delta - fscale[:, None] * t
        Ps = Ps + torch.where(ms[:, None], delta / torch.clamp(
            count, min=1.0)[:, None], 0.0)
        Ps = solve_plane(Ps, prev_s, params.collision_distance,
                         params.dynamic_friction, ms)
    return torch.where(moving[:, None], _take(Ps, inv_perm), P)


class BlockContactContext:
    """The per-step constants of the block mode (BlockContactContext,
    collisions.py:562-609): its pair set and the sorted masses.

    Sorted slot i of half-block m = i // 16 pairs with every slot j != i
    of half-blocks m, m + 1 and m - 1, that is every pair inside a 32-slot
    window made of a half-block and the next one, counted once for each
    side; both must take part (`participate`) and pass the
    SelfCollideFilter.  The window columns are ordered as the JAX folded
    layout sums them: half-blocks m and m + 1 (32 columns), then m - 1
    (16).  The (16, M) folded layout and its rolls are not ported."""

    def __init__(self, perm, inv_perm, w, participate, moving,
                 params: SolverParams, rest_dist, lattice_w=None,
                 rest_sorted=None):
        B, n = w.shape
        if n % BLOCK_HALF:
            raise ValueError("particle capacity must be a multiple of 16")
        dev = w.device
        self.perm, self.inv_perm = perm, inv_perm
        self.rest_dist = rest_dist
        self.params = params
        i = torch.arange(n, device=dev).view(n, 1)
        c = torch.arange(3 * BLOCK_HALF, device=dev).view(1, -1)
        base = (i // BLOCK_HALF) * BLOCK_HALF
        j = torch.where(c < 2 * BLOCK_HALF, base + c,
                        base - BLOCK_HALF + (c - 2 * BLOCK_HALF))
        inside = (j >= 0) & (j < n) & (j != i)
        self.j = torch.clamp(j, 0, n - 1).reshape(1, -1).expand(B, -1)
        self.ws = _take(w, perm)
        self.wj = _take(self.ws, self.j).view(B, n, -1)
        self.ms = _take(moving, perm)
        act = _take(participate, perm)
        ok = inside[None] & act[..., None] & _take(act, self.j).view(B, n, -1)
        ids = perm[..., None]
        ids_j = _take(perm, self.j).view(B, n, -1)
        ra = rb = None
        if rest_sorted is not None:
            ra = rest_sorted[..., None]
            rb = _take(rest_sorted, self.j).view(B, 3, n, -1)
        self.static_ok = ok & _rest_filter_ok(ids, ids_j, ra, rb, lattice_w,
                                              rest_dist)


def solve_contacts_block(P, w, moving, perm, inv_perm, params: SolverParams,
                         *, rest_dist, iterations: int = 8, lattice_w=None,
                         rest_sorted=None, active=None, prev=None,
                         ctx: BlockContactContext | None = None):
    """Iterated contact projection over the block pair set with PBD
    particle friction, then the ground plane, every pass
    (solve_contacts_block, collisions.py:612-696): the same contract as
    solve_contacts_sweep.  Pass the step's `ctx` to reuse its pair set."""
    if ctx is None:
        ctx = BlockContactContext(
            perm, inv_perm, w, moving if active is None else active, moving,
            params, rest_dist, lattice_w=lattice_w, rest_sorted=rest_sorted)
    B, _, n = P.shape
    mu_p = params.particle_friction * params.dynamic_friction
    ws = ctx.ws[..., None]
    wsum = ws + ctx.wj
    Y = _take(P, ctx.perm)
    prev_s = _take(prev, ctx.perm) if prev is not None else Y
    h = 2 * BLOCK_HALF
    for _ in range(iterations):
        Dx = Y - prev_s
        d = Y[..., None] - _take(Y, ctx.j).view(B, 3, n, -1)
        dist = torch.sqrt(dot3(d, d) + EPS)
        pen = rest_dist - dist
        ok = ctx.static_ok & (pen > 0) & (wsum > 0)
        s = torch.where(ok, pen / ((wsum + EPS) * dist), 0.0)
        r = Dx[..., None] - _take(Dx, ctx.j).view(B, 3, n, -1)
        inv_d = 1.0 / dist
        rel_n = dot3(r, d) * inv_d * inv_d
        t = r - rel_n[:, None] * d
        t_norm = torch.sqrt(dot3(t, t) + EPS)
        fr = torch.clamp(mu_p * pen / t_norm, max=1.0)
        fsc = torch.where(ok, (ws / (wsum + EPS)) * fr, 0.0)
        g = (ws * s)[:, None] * d - fsc[:, None] * t
        delta = g[..., :h].sum(-1) + g[..., h:].sum(-1)
        okf = ok.to(Y.dtype)
        count = okf[..., :h].sum(-1) + okf[..., h:].sum(-1)
        Y = Y + torch.where(ctx.ms[:, None], delta / torch.clamp(
            count, min=1.0)[:, None], 0.0)
        Y = solve_plane(Y, prev_s, params.collision_distance,
                        params.dynamic_friction, ctx.ms)
    return torch.where(moving[:, None], _take(Y, ctx.inv_perm), P)


# --------------------------------------------------------------------------
# the xla backend's table mode: hash-grid neighbour table
# --------------------------------------------------------------------------

HASH_BITS = 13
HASH_SIZE = 1 << HASH_BITS
K_CELL = 4  # candidates taken per probed cell
K_NEIGHBORS = 8  # contacts kept per particle
_P1, _P2, _P3 = 73856093, 19349663, 83492791
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def _cell_hash(cx, cy, cz):
    """Spatial hash of integer cells (_cell_hash, collisions.py:36-38).
    In 64 bits: the low HASH_BITS bits equal those of the JAX package's
    wrapping 32-bit products."""
    return ((cx * _P1) ^ (cy * _P2) ^ (cz * _P3)) & (HASH_SIZE - 1)


def _gather_candidates(pos, active, cell_size):
    """pos (B, 3, N) -> (cand_idx (B, C, N) i64, cand_ok (B, C, N)) with
    C = 27 * K_CELL: for each of the 27 cells around a particle's, the
    first K_CELL particles of that hash in hash-sorted order
    (_gather_candidates, collisions.py:41-60)."""
    B, _, n = pos.shape
    cs = torch.as_tensor(cell_size, dtype=torch.float32, device=pos.device)
    cell = torch.floor(pos / cs).to(torch.int64)
    h = _cell_hash(cell[:, 0], cell[:, 1], cell[:, 2])
    key = torch.where(active, h, HASH_SIZE)
    skey, order = torch.sort(key, dim=1, stable=True)
    ks = torch.arange(K_CELL, device=pos.device).view(1, K_CELL, 1)
    cand_idx, cand_ok = [], []
    for ox, oy, oz in _OFFSETS:
        hq = _cell_hash(cell[:, 0] + ox, cell[:, 1] + oy, cell[:, 2] + oz)
        start = torch.searchsorted(skey, hq)
        slots = torch.clamp(start[:, None] + ks, max=n - 1).reshape(B, -1)
        cand_ok.append((_take(skey, slots) == hq.repeat(1, K_CELL))
                       .view(B, K_CELL, n))
        cand_idx.append(_take(order, slots).view(B, K_CELL, n))
    return torch.cat(cand_idx, 1), torch.cat(cand_ok, 1)


def _select_k_nearest(pos, active, cand_idx, cand_ok, radius, rest_filter):
    """Keep the K_NEIGHBORS nearest candidates within radius that are not
    the particle itself and pass the filter (_select_k_nearest,
    collisions.py:63-82); ties keep the lower candidate (lax.top_k's
    order, here a stable descending sort).  Returns (nbr_idx, nbr_mask)
    (B, K, N)."""
    B, C, n = cand_idx.shape
    flat = cand_idx.reshape(B, -1)
    d = pos[..., None, :] - _take(pos, flat).view(B, 3, C, n)
    dist2 = dot3(d, d)
    me = torch.arange(n, device=pos.device).view(1, 1, n)
    ok = (cand_ok & _take(active, flat).view(B, C, n) & active[:, None]
          & (cand_idx != me) & (dist2 < radius * radius) & ~rest_filter)
    score = torch.where(ok, -dist2, float("-inf"))
    top, pos_k = torch.sort(score, dim=1, descending=True, stable=True)
    top, pos_k = top[:, :K_NEIGHBORS], pos_k[:, :K_NEIGHBORS]
    return torch.gather(cand_idx, 1, pos_k), top > float("-inf")


def find_neighbors_grid(pos, active, lattice_w: int, radius):
    """Neighbour table of grid cloths in lattice order; the filter drops
    lattice neighbours (find_neighbors_grid, collisions.py:85-97)."""
    cand_idx, cand_ok = _gather_candidates(pos, active, radius)
    me = torch.arange(pos.shape[2], device=pos.device).view(1, 1, -1)
    rest_filter = ((torch.abs(cand_idx // lattice_w - me // lattice_w) <= 1)
                   & (torch.abs(cand_idx % lattice_w - me % lattice_w) <= 1))
    return _select_k_nearest(pos, active, cand_idx, cand_ok, radius,
                             rest_filter)


def find_neighbors_hash(pos, active, radius, rest_positions):
    """Neighbour table of meshes; the filter drops pairs closer than radius
    in the rest pose (find_neighbors_hash, collisions.py:100-109)."""
    cand_idx, cand_ok = _gather_candidates(pos, active, radius)
    B, C, n = cand_idx.shape
    rd = rest_positions[..., None, :] - _take(
        rest_positions, cand_idx.reshape(B, -1)).view(B, 3, C, n)
    rest_filter = dot3(rd, rd) < radius * radius
    return _select_k_nearest(pos, active, cand_idx, cand_ok, radius,
                             rest_filter)


def solve_contacts(P, w, moving, nbr_idx, nbr_mask, *, rest_dist):
    """One Jacobi pass of contacts from a neighbour table (solve_contacts,
    collisions.py:112-137): each particle pushes itself out of each live
    neighbour by its mass share, averaged over its live contacts.  P
    (B, 3, N); w, moving (B, N); nbr_idx, nbr_mask (B, K, N)."""
    B, K, n = nbr_idx.shape
    flat = nbr_idx.reshape(B, -1)
    d = P[..., None, :] - _take(P, flat).view(B, 3, K, n)
    dist = torch.sqrt(dot3(d, d) + EPS)
    pen = rest_dist - dist
    wsum = w[:, None] + _take(w, flat).view(B, K, n)
    ok = nbr_mask & (pen > 0) & (wsum > 0)
    s = torch.where(ok, pen / ((wsum + EPS) * dist), 0.0)
    delta = ((w[:, None] * s)[:, None] * d).sum(2)
    cnt = ok.sum(1)
    delta = delta / torch.clamp(cnt, min=1)[:, None]
    return torch.where(moving[:, None], P + delta, P)
