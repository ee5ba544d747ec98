"""The port's CUDA kernels: ctypes wrappers, launch counters, launch
geometry and plain PyTorch versions (counterpart of
flingbot_tpu/engine/pallas_kernels.py).

  substeps       csrc/substeps.cu       <- _substeps_kernel / pallas_substeps
                                           (Chebyshev or plain Jacobi springs)
  contacts       csrc/contacts.cu       <- _contacts_kernel / pallas_contacts
                                           (grid mode, and mesh mode with
                                           rests=)
  contact_apply  csrc/contact_apply.cu  <- no TPU kernel: the grid path's
                                           contact epilogue, which the JAX
                                           package leaves to XLA
  contact_keys,  csrc/contact_sort.cu   <- no TPU kernel: the contact
  contact_gather                           group's Morton keys and sorted
                                           arrays, around torch.sort (XLA's
                                           multi-operand sort in the JAX
                                           package)

A wrapper takes its plain version only for tensors on the CPU.  For a CUDA
tensor it launches the kernel or raises; it never falls back.  Each launch
adds one to LAUNCHES[name]; a mesh-mode launch of the contacts kernel also
adds one to LAUNCHES["contacts_mesh"], and one of contact_gather to
LAUNCHES["contact_gather_mesh"].  The launch geometry (the substeps
kernel's row bands, the contacts kernel's tiles) is computed here, so the
CPU tests reach it.  So are the kernels' parameter blocks: pack_sub_params
and contact_params build them, the SUB_* and CON_* constants name their
columns, and no other module indexes them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from flingbot_tpu_torch.engine import build as _build
from flingbot_tpu_torch.engine.constraints import (
    EPS, add_delta_clamped, clamp_finalize, grid_jacobi, integrate,
    picker_push_sequential, solve_picker_spheres, solve_plane,
    spring_coefficients, spring_loop)
from flingbot_tpu_torch.engine.state import SolverParams, device_constant
from flingbot_tpu_torch.engine.topology import GridTopology, lattice_valid
from flingbot_tpu_torch.utils import trace

SOURCES = ("substeps", "contacts", "contact_apply", "contact_sort")
KERNELS = ("substeps", "contacts", "contact_apply", "contact_keys",
           "contact_gather")
LAUNCHES = trace.LAUNCHES  # the tracer's drain() reports them
LAUNCHES.update(dict.fromkeys(KERNELS + ("contacts_mesh",
                                         "contact_gather_mesh"), 0))

# Columns of the substeps kernel's (B, SUB_PARAM_LEN) f32 block, as the C
# sources read them: SUB_STIFFNESS starts 3 (stretch, bend, shear) and
# SUB_PICKERS 6 (two xyz); SUB_PICKER_R = picker radius + collision distance
SUB_DT, SUB_GRAVITY_Y, SUB_DAMPING, SUB_FRICTION, SUB_COLDIST = range(5)
SUB_RELAX, SUB_SPACING, SUB_STIFFNESS, SUB_DIMX, SUB_DIMY = 5, 6, 7, 10, 11
SUB_PICKER_R, SUB_CHEB_RHO2, SUB_PICKERS, SUB_MAX_ACCEL = 12, 13, 14, 20
SUB_PARAM_LEN = 21

# Columns of the contacts kernel's (B, CONTACT_PARAM_LEN) f32 block; the C
# ABI reads all 8, the last 3 unused
CON_REST_DIST, CON_W_UNIFORM, CON_MU_PAIR, CON_MU_PLANE, CON_COLDIST = \
    range(5)
CONTACT_PARAM_LEN = 8
# the mesh mode keeps its filter as one bit per window offset
MAX_MESH_WINDOW = 32

PACK_IMMOBILE_BIT = 20
PACK_INACTIVE_BIT = 21
# the Morton key of an inactive slot: after every cloth slot in the sort
INT32_BIG = 2 ** 30

_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use

# substeps: one env across a cluster of SUBSTEPS_CLUSTER CTAs, each owning
# a band of the env's rows; kCluster of csrc/substeps.cu, which launches
# them (8, two CTAs per SM, ran faster than 4 at the rect path's shapes on
# an H100: PERF.md).  In a CTA, SUBSTEPS_WARPS warps of which lanes 2..30
# (SUBSTEPS_WARP_COLUMNS) own a column of a strip each; a strip is at most
# SUBSTEPS_MAX_STRIP rows (kThreads / 32, kOwnLanes, kMaxStrip of the
# source)
SUBSTEPS_CLUSTER = 8
SUBSTEPS_WARPS = 14
SUBSTEPS_WARP_COLUMNS = 29
SUBSTEPS_MAX_STRIP = 6
# contacts: owned slots per tile; 512 gives the 16-shirt path 192 blocks
CONTACT_TILE = 512


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_libs: dict = {}  # the loaded libraries, by source name


def build():
    """Compile (in parallel) and load every kernel source, once; returns
    the libraries, by source name, with their C signatures set."""
    if _libs:
        return _libs
    libs = _build.build(SOURCES)
    p = ctypes.c_void_p
    i = ctypes.c_int
    sub, con = libs["substeps"], libs["contacts"]
    app, srt = libs["contact_apply"], libs["contact_sort"]
    sub.flingbot_substeps.argtypes = [p] * 7 + [i] * 10 + [p]
    sub.flingbot_substeps_max_clusters.argtypes = [i, p]
    con.flingbot_contacts.argtypes = [p] * 14 + [i] * 8 + [p]
    app.flingbot_contact_apply.argtypes = [p] * 15 + [i] * 2 + [p]
    srt.flingbot_contact_keys.argtypes = [p, p, ctypes.c_float, p, i, i, p]
    srt.flingbot_contact_gather.argtypes = [p] * 6 + [i] + [p] * 2 + [i] * 2 \
        + [p]
    for fn in (sub.flingbot_substeps, sub.flingbot_substeps_max_clusters,
               con.flingbot_contacts, app.flingbot_contact_apply,
               srt.flingbot_contact_keys, srt.flingbot_contact_gather):
        fn.restype = i
    for lib in libs.values():
        lib.flingbot_error_string.argtypes = [i]
        lib.flingbot_error_string.restype = ctypes.c_char_p
    _libs.update(libs)
    return _libs


def _check(t: torch.Tensor, name: str, shape, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")


def _raise_on(lib, err: int, what: str):
    if err != 0:
        msg = lib.flingbot_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def _launch(lib, fn, args, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    _raise_on(lib, err, f"{fn.__name__} launch")


# --------------------------------------------------------------------------
# kernel 1: fused substeps
# --------------------------------------------------------------------------

def substeps_band(H: int, W: int):
    """(band, strip, smem bytes) of the substeps kernel on an H x W
    lattice split over SUBSTEPS_CLUSTER CTAs.  band = the most rows one
    CTA owns (an env of dimy rows gives each CTA max(2, ceil(dimy /
    SUBSTEPS_CLUSTER)); at least 2, the stencil's reach, so every halo row
    has one owner).  strip = the most rows one thread walks: the fewest
    that let one column of each of the band's strips fit in the CTA's
    SUBSTEPS_WARPS x SUBSTEPS_WARP_COLUMNS owning lanes (0 where a row of W
    does not fit); a narrower or shorter env takes the fewest rows that
    fit its own columns.  Each CTA holds two ping-pong buffers of float4
    (x, y, z, w) over band + 4 rows (a 2-row halo above and below), the 6
    per-class spring coefficients over band + 2 rows (the constraint
    starts that its slots read), and 3 words for each owned slot: its
    substep-start x and z and its relaxation factor."""
    band = max(2, -(-H // SUBSTEPS_CLUSTER))
    strips = SUBSTEPS_WARPS * SUBSTEPS_WARP_COLUMNS // W
    strip = -(-band // strips) if strips else 0
    return band, strip, 4 * W * (8 * (band + 4) + 6 * (band + 2) + 3 * band)


def substeps_evals_per_spring(dims, H: int, W: int) -> float:
    """Spring evaluations the substeps kernel makes in one Jacobi
    iteration over the envs of `dims` ((dimx, dimy) each) on an H x W
    lattice, per spring of those cloths: every lane of a warp that owns a
    position evaluates 6 springs a row for each of the warp's rows (its
    owning lanes' longest strip) and 5 more from the 2 rows above its
    strip.  1.0 would evaluate each spring once."""
    _, strip, _ = substeps_band(H, W)
    C, cols = SUBSTEPS_CLUSTER, SUBSTEPS_WARP_COLUMNS
    evals = springs = 0
    for dimx, dimy in dims:
        rows = max(2, -(-dimy // C))
        fit = SUBSTEPS_WARPS * cols // dimx  # strips of the env a CTA holds
        for rank in range(C):
            s = min(dimy, rank * rows)
            e = min(dimy, s + rows)
            r = min(strip, max(1, -(-(e - s) // fit)))
            total = -(-(e - s) // r) * dimx
            for p0 in range(0, total, cols):
                hw = max(min(r, e - s - (p // dimx) * r)
                         for p in range(p0, min(p0 + cols, total)))
                evals += 32 * (6 * hw + 5)
        springs += sum(max(0, dimx - dx) * max(0, dimy - dy)
                       for dy, dx in ((0, 1), (1, 0), (0, 2), (2, 0), (1, 1),
                                      (1, 1)))
    return evals / springs


@functools.lru_cache(maxsize=None)
def substeps_max_clusters(device_index: int, smem: int) -> int:
    """cudaOccupancyMaxActiveClusters of the substeps kernel at this
    shared memory per CTA: clusters the card runs at once."""
    lib = build()["substeps"]
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.flingbot_substeps_max_clusters(smem, ctypes.byref(out))
    _raise_on(lib, err, "cudaOccupancyMaxActiveClusters")
    return out.value


def substeps(pvec, P, V, w, *, n_sub: int, iterations: int,
             cheb: bool = True, picker_last: bool = True):
    """n_sub fused XPBD substeps per env (pallas_substeps,
    pallas_kernels.py:296-329).

    pvec (B, 21) f32; P, V (B, 3, H, W) f32; w (B, H, W) f32.  Returns
    (P', V', prev_last), prev_last the positions at the start of the last
    substep.  cheb=False runs plain Jacobi iterations (spring_mode
    "jacobi").  picker_last=False omits the last substep's picker push so
    the caller can run the contact group first."""
    if P.device.type == "cpu":
        return substeps_plain(pvec, P, V, w, n_sub=n_sub,
                              iterations=iterations, cheb=cheb,
                              picker_last=picker_last)
    B, _, H, W = P.shape
    _check(pvec, "pvec", (B, SUB_PARAM_LEN))
    _check(P, "P", (B, 3, H, W))
    _check(V, "V", (B, 3, H, W))
    _check(w, "w", (B, H, W))
    band, strip, smem = substeps_band(H, W)
    if smem > _SMEM_LIMIT or not 0 < strip <= SUBSTEPS_MAX_STRIP:
        raise ValueError(f"lattice {H}x{W} exceeds the kernel's capacity "
                         f"at {SUBSTEPS_CLUSTER} CTAs per env")
    dev = P.device.index if P.device.index is not None else \
        torch.cuda.current_device()
    if substeps_max_clusters(dev, smem) == 0:
        raise RuntimeError(f"the card cannot run a cluster of "
                           f"{SUBSTEPS_CLUSTER} CTAs with {smem} bytes of "
                           f"shared memory each")
    lib = build()["substeps"]
    out_P = torch.empty_like(P)
    out_V = torch.empty_like(V)
    out_prev = torch.empty_like(P)
    _launch(lib, lib.flingbot_substeps, [
        pvec.data_ptr(), P.data_ptr(), V.data_ptr(), w.data_ptr(),
        out_P.data_ptr(), out_V.data_ptr(), out_prev.data_ptr(), B, H, W,
        int(n_sub), int(iterations), int(bool(cheb)),
        int(bool(picker_last)), band, strip, smem], P.device)
    LAUNCHES["substeps"] += 1
    return out_P, out_V, out_prev


def substeps_plain(pvec, P, V, w, *, n_sub: int, iterations: int,
                   cheb: bool = True, picker_last: bool = True):
    """Plain PyTorch version of `substeps`, built from the constraint
    pieces (the substep loop of solver._run_substeps in the kernel's
    formulation)."""
    B, _, H, W = P.shape
    col = lambda k: pvec[:, k].view(B, 1, 1)  # noqa: E731
    dt, gravity_y, damping = col(SUB_DT), col(SUB_GRAVITY_Y), col(SUB_DAMPING)
    mu, coldist, a_max = col(SUB_FRICTION), col(SUB_COLDIST), \
        col(SUB_MAX_ACCEL)
    dimx = pvec[:, SUB_DIMX].to(torch.int64)
    dimy = pvec[:, SUB_DIMY].to(torch.int64)
    valid = lattice_valid(dimx, dimy, H, W)
    w = torch.where(valid, w, 0.0)
    moving = valid & (w > 0)
    classes, invc = spring_coefficients(
        w, valid, dimx, dimy, pvec[:, SUB_STIFFNESS:SUB_STIFFNESS + 3],
        pvec[:, SUB_SPACING], pvec[:, SUB_RELAX])
    rho2 = col(SUB_CHEB_RHO2)[:, None] if cheb else None
    pickers = pvec[:, SUB_PICKERS:SUB_PICKERS + 6].reshape(B, 2, 3)
    R = col(SUB_PICKER_R)
    prev = P
    for s in range(n_sub):
        P, V, prev = integrate(P, V, dt, gravity_y, damping, moving)
        P = spring_loop(
            P, lambda Q: grid_jacobi(Q, classes, invc), iterations,
            lambda Q: solve_plane(Q, prev, coldist, mu, moving), rho2)
        V = clamp_finalize(P, V, prev, dt, a_max, moving)
        if s < n_sub - 1 or picker_last:
            P = picker_push_sequential(P, pickers, R, moving)
    return P, V, prev


def pack_sub_params(params: SolverParams, topo: GridTopology,
                    picker_pos: torch.Tensor, picker_radius: float,
                    dt_sub) -> torch.Tensor:
    """SolverParams + topology + pickers -> the (B, SUB_PARAM_LEN) f32
    block of `substeps` and `contact_apply`, columns in SUB_* order
    (layout of pack_sub_params, pallas_kernels.py:70-75,332-353)."""
    B = topo.batch
    f = np.float32
    rho = f(params.chebyshev_rho)
    scal = [f(dt_sub), f(params.gravity[1]), f(params.damping),
            f(params.dynamic_friction), f(params.collision_distance),
            f(params.relaxation_factor), f(topo.spacing)]
    head = device_constant(scal, dtype=torch.float32,
                           device=picker_pos.device)
    tail = device_constant(
        [f(picker_radius) + f(params.collision_distance), rho * rho],
        dtype=torch.float32, device=picker_pos.device)
    return torch.cat([
        head.expand(B, -1),
        topo.stiffness.to(torch.float32),
        topo.dimx.to(torch.float32)[:, None],
        topo.dimy.to(torch.float32)[:, None],
        tail.expand(B, -1),
        picker_pos[:, :2].reshape(B, 6).to(torch.float32),
        torch.full((B, 1), f(params.max_acceleration), dtype=torch.float32,
                   device=picker_pos.device),
    ], 1).contiguous()


# --------------------------------------------------------------------------
# kernel 2: windowed contacts on Morton-sorted particles
# --------------------------------------------------------------------------

def contact_tiles(N: int, window: int, iterations: int):
    """(tile, halo, n_tiles) of the contacts kernel.  After `iterations`
    passes a particle depends only on the sorted slots within
    halo = window * iterations of it, so each tile of tile = CONTACT_TILE
    owned slots [s, e) runs every pass on [s - halo, e + halo) alone and
    keeps [s, e)."""
    return CONTACT_TILE, window * iterations, -(-N // CONTACT_TILE)


def contact_smem(tile: int, halo: int) -> int:
    """Shared memory bytes of one contacts tile: three float4 planes (two
    ping-pong position buffers holding the packed ids, and the previous
    positions with the mesh filter bits) over tile + 2 * halo slots."""
    return 3 * 16 * (tile + 2 * halo)


def contact_params(params: SolverParams, rest_dist: float, batch: int,
                   device) -> torch.Tensor:
    """The (B, CONTACT_PARAM_LEN) f32 block of `contacts`, columns in CON_*
    order (pallas_kernels.py:360-361)."""
    f = np.float32
    row = device_constant(
        [f(rest_dist), 1.0, f(params.particle_friction)
         * f(params.dynamic_friction), f(params.dynamic_friction),
         f(params.collision_distance), 0.0, 0.0, 0.0],
        dtype=torch.float32, device=device)
    return row.expand(batch, -1).contiguous()


def contacts(cparams, xs, ys, zs, pxs, pys, pzs, packed, rests=None, *,
             window: int, iterations: int):
    """Self-collision projection on Morton-sorted (B, N) arrays
    (pallas_contacts, pallas_kernels.py:546-574).  Grid mode: packed holds
    the lattice ids and immobile / inactive bits, and lattice neighbours
    are not paired.  Mesh mode, rests = (rx, ry, rz) sorted rest
    coordinates: packed holds the flat slot index and the same bits, and
    pairs closer than rest_dist in the rest pose are not paired.  Returns
    (xs', ys', zs')."""
    if xs.device.type == "cpu":
        return contacts_plain(cparams, xs, ys, zs, pxs, pys, pzs, packed,
                              rests, window=window, iterations=iterations)
    B, N = xs.shape
    mesh = rests is not None
    _check(cparams, "cparams", (B, CONTACT_PARAM_LEN))
    coords = [xs, ys, zs, pxs, pys, pzs] + (list(rests) if mesh else [])
    for name, a in zip(("xs", "ys", "zs", "pxs", "pys", "pzs", "rx", "ry",
                        "rz"), coords):
        _check(a, name, (B, N))
    _check(packed, "packed", (B, N), torch.int32)
    if mesh and window > MAX_MESH_WINDOW:
        raise ValueError(f"mesh mode supports window <= {MAX_MESH_WINDOW}")
    tile, halo, n_tiles = contact_tiles(N, window, iterations)
    smem = contact_smem(tile, halo)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"window {window} x {iterations} iterations: a "
                         f"tile's halo exceeds shared memory")
    lib = build()["contacts"]
    ox, oy, oz = (torch.empty_like(xs) for _ in range(3))
    rest_ptrs = [a.data_ptr() for a in coords[6:]] if mesh else [None] * 3
    _launch(lib, lib.flingbot_contacts, [cparams.data_ptr()]
            + [a.data_ptr() for a in coords[:6]] + [packed.data_ptr()]
            + rest_ptrs + [ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), B,
                           N, int(window), int(iterations), tile, halo,
                           n_tiles, smem], xs.device)
    LAUNCHES["contacts"] += 1
    if mesh:
        LAUNCHES["contacts_mesh"] += 1
    return ox, oy, oz


def contacts_plain(cparams, X, Y, Z, PX, PY, PZ, packed, rests=None, *,
                   window: int, iterations: int):
    """Plain PyTorch version of `contacts`: _contacts_sorted_flat
    (collisions.py:221-316) with a batch axis.  Pair (i, i+k) for
    k = 1..window, SelfCollideFilter (lattice neighbours, or rest-pose
    distance under rest_dist in mesh mode), PBD Coulomb particle friction
    against the substep's relative motion, mass-share split, Jacobi
    average by contact count, then the ground plane.

    Two roles: the reference the kernel is held to, and, under
    backend="xla" (collisions.contact_group), the counterpart of the JAX
    package's XLA code _contacts_sorted_flat on every device.  That is
    not a fallback from the kernel: the xla backend launches no kernel,
    and `contacts` never takes this path for a CUDA tensor."""
    B, n = X.shape
    col = lambda k: cparams[:, k].view(B, 1)  # noqa: E731
    rest_d, w_uni, mu_p, mu_plane, coldist = (
        col(k) for k in (CON_REST_DIST, CON_W_UNIFORM, CON_MU_PAIR,
                         CON_MU_PLANE, CON_COLDIST))
    lat_x = packed & 0xFF
    lat_y = (packed >> 8) & 0xFFF
    immobile = ((packed >> PACK_IMMOBILE_BIT) & 1) > 0
    inactive = ((packed >> PACK_INACTIVE_BIT) & 1) > 0
    active = ~inactive
    w = torch.where(immobile | inactive, 0.0, w_uni)
    ms_f = (active & ~immobile).to(X.dtype)
    i = torch.arange(n, device=X.device)[None]

    def fwd(a, k):  # a[i + k] (wraparound masked by in_range)
        return torch.roll(a, -k, dims=1)

    static_k = []
    for k in range(1, window + 1):
        if rests is None:
            nbr = ((torch.abs(fwd(lat_x, k) - lat_x) <= 1)
                   & (torch.abs(fwd(lat_y, k) - lat_y) <= 1))
        else:
            rd0, rd1, rd2 = (r - fwd(r, k) for r in rests)
            nbr = rd0 * rd0 + rd1 * rd1 + rd2 * rd2 < rest_d * rest_d
        wn = fwd(w, k)
        wsum = w + wn
        ok = (i < n - k) & active & fwd(active, k) & ~nbr & (wsum > 0)
        coef = torch.where(ok, 1.0 / (wsum + EPS), 0.0)
        static_k.append((k, ok, coef, wn, PX - fwd(PX, k), PY - fwd(PY, k),
                         PZ - fwd(PZ, k)))

    for _ in range(iterations):
        acc_x = torch.zeros_like(X)
        acc_y = torch.zeros_like(X)
        acc_z = torch.zeros_like(X)
        cnt = torch.zeros_like(X)
        for k, ok, coef, wn, dpx, dpy, dpz in static_k:
            d0 = X - fwd(X, k)
            d1 = Y - fwd(Y, k)
            d2 = Z - fwd(Z, k)
            sq = d0 * d0 + d1 * d1 + d2 * d2 + EPS
            r = torch.rsqrt(sq)
            pen = rest_d - sq * r
            live = pen > 0
            s = torch.where(live, coef * pen * r, 0.0)
            live_f = (live & ok).to(X.dtype)
            r0 = d0 - dpx
            r1 = d1 - dpy
            r2 = d2 - dpz
            rel_n = (r0 * d0 + r1 * d1 + r2 * d2) * (r * r)
            t0 = r0 - rel_n * d0
            t1 = r1 - rel_n * d1
            t2 = r2 - rel_n * d2
            tn_r = torch.rsqrt(t0 * t0 + t1 * t1 + t2 * t2 + EPS)
            fr = torch.clamp(mu_p * torch.clamp(pen, min=0.0) * tn_r,
                             max=1.0)
            fsc = torch.where(live, coef * fr, 0.0)
            gx = s * d0 - fsc * t0
            gy = s * d1 - fsc * t1
            gz = s * d2 - fsc * t2
            acc_x = acc_x + w * gx - torch.roll(wn * gx, k, dims=1)
            acc_y = acc_y + w * gy - torch.roll(wn * gy, k, dims=1)
            acc_z = acc_z + w * gz - torch.roll(wn * gz, k, dims=1)
            cnt = cnt + live_f + torch.roll(live_f, k, dims=1)
        inv_cnt = ms_f / torch.clamp(cnt, min=1.0)
        X = X + acc_x * inv_cnt
        Y = Y + acc_y * inv_cnt
        Z = Z + acc_z * inv_cnt
        pen = coldist - Y
        contact_f = torch.where(pen > 0, ms_f, 0.0)
        dx_ = X - PX
        dz_ = Z - PZ
        t_norm = torch.sqrt(dx_ * dx_ + dz_ * dz_ + EPS)
        f = contact_f * torch.clamp(
            mu_plane * torch.clamp(pen, min=0.0) / t_norm, max=1.0)
        X, Y, Z = X - dx_ * f, Y + contact_f * pen, Z - dz_ * f
    return X, Y, Z


# --------------------------------------------------------------------------
# kernel 3: the grid path's contact epilogue
# --------------------------------------------------------------------------

def contact_apply(pvec, order, srt, out, V):
    """The contact group's epilogue on the grid path (the contacts
    closure of _step_grid_pallas, flingbot_tpu/engine/solver.py:600-615):
    scatter the contacts kernel's output back to slot order, then the
    ground plane, the velocity add under the speed-up-only clamp and the
    picker spheres.

    pvec (B, 21) f32, the substeps kernel's parameters (dt_sub, friction,
    collision distance, picker radius, the two pickers, max acceleration);
    order (B, N) i64 and srt, the 7 sorted arrays of
    collisions.sort_particles in grid mode (pre-contact positions, the
    substep's previous positions, the packed ids); out = (ox, oy, oz), the
    contacts kernel's output in sorted order; V (B, 3, N) f32 in slot
    order.  Returns (P', V'), (B, 3, N) each."""
    if V.device.type == "cpu":
        return contact_apply_plain(pvec, order, srt, out, V)
    B, N = order.shape
    _check(pvec, "pvec", (B, SUB_PARAM_LEN))
    _check(order, "order", (B, N), torch.int64)
    if len(srt) != 7 or len(out) != 3:
        raise ValueError("expected the 7 sorted arrays of the grid mode and "
                         "the 3 planes of the contacts kernel's output")
    for name, a in zip(("xs", "ys", "zs", "pxs", "pys", "pzs", "ox", "oy",
                        "oz"), list(srt[:6]) + list(out)):
        _check(a, name, (B, N))
    _check(srt[6], "packed", (B, N), torch.int32)
    _check(V, "V", (B, 3, N))
    lib = build()["contact_apply"]
    P_out = torch.empty_like(V)
    V_out = torch.empty_like(V)
    _launch(lib, lib.flingbot_contact_apply, [
        pvec.data_ptr(), order.data_ptr()]
        + [a.data_ptr() for a in list(srt) + list(out)]
        + [V.data_ptr(), P_out.data_ptr(), V_out.data_ptr(), B, N], V.device)
    LAUNCHES["contact_apply"] += 1
    return P_out, V_out


def contact_apply_plain(pvec, order, srt, out, V):
    """Plain PyTorch version of `contact_apply`: the scatter back through
    `order`, then solve_plane, add_delta_clamped and
    solve_picker_spheres.  Moving slots are those whose packed id has
    neither the immobile nor the inactive bit.  pvec's scalar columns are
    the same in every row (pack_sub_params); dv_max is taken from row 0 as
    a host float, as the grid step always passed it: PyTorch divides a
    host float by a tensor through the tensor's reciprocal
    (Tensor.__rdiv__), which rounds unlike a division by a tensor."""
    B, N = order.shape

    def back(arrays):  # sorted order -> slot order, (B, len(arrays), N)
        res = torch.empty((B, len(arrays), N), dtype=arrays[0].dtype,
                          device=order.device)
        for c, a in enumerate(arrays):
            res[:, c].scatter_(1, order, a)
        return res

    P2, P, prev = back(out), back(srt[:3]), back(srt[3:6])
    packed = back(srt[6:])[:, 0]
    moving = (((packed >> PACK_IMMOBILE_BIT) & 1) == 0) & (
        ((packed >> PACK_INACTIVE_BIT) & 1) == 0)
    col = lambda k: pvec[:, k].view(B, 1)  # noqa: E731
    P2 = solve_plane(P2, prev, col(SUB_COLDIST), col(SUB_FRICTION), moving)
    dv_max = float(pvec[0, SUB_MAX_ACCEL] * pvec[0, SUB_DT])
    P, V = add_delta_clamped(P, P2, V, col(SUB_DT).view(B, 1, 1), dv_max,
                             moving)
    pickers = pvec[:, SUB_PICKERS:SUB_PICKERS + 6].reshape(B, 2, 3)
    return solve_picker_spheres(P, pickers, col(SUB_PICKER_R), moving), V


# --------------------------------------------------------------------------
# kernels 4 and 5: the contact group's Morton keys and sorted arrays
# --------------------------------------------------------------------------

def contact_keys(P, active, rest_dist):
    """The Morton keys of one contact group (collisions.contact_group,
    flingbot_tpu/engine/collisions.py:336-341).  P (B, 3, N) f32, active
    (B, N) bool.  Returns (B, N) i32: the Morton code of each slot's cell
    (cell = rest_dist, clamped to 1024 a side around the origin), and
    INT32_BIG for inactive slots, so that they sort last."""
    if P.device.type == "cpu":
        return contact_keys_plain(P, active, rest_dist)
    B, _, N = P.shape
    _check(P, "P", (B, 3, N))
    _check(active, "active", (B, N), torch.bool)
    lib = build()["contact_sort"]
    keys = torch.empty((B, N), dtype=torch.int32, device=P.device)
    # ctypes rounds rest_dist to the nearest float32, as the plain
    # version's upload does: the kernel divides by exactly that float
    _launch(lib, lib.flingbot_contact_keys, [
        P.data_ptr(), active.data_ptr(), float(rest_dist), keys.data_ptr(),
        B, N], P.device)
    LAUNCHES["contact_keys"] += 1
    return keys


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_code(cell: torch.Tensor) -> torch.Tensor:
    """cell (B, 3, N) int32 in [0, 1024) -> (B, N) int32 Morton codes."""
    return (_part1by2(cell[:, 0]) | (_part1by2(cell[:, 1]) << 1)
            | (_part1by2(cell[:, 2]) << 2))


def contact_keys_plain(P, active, rest_dist):
    """Plain PyTorch version of `contact_keys`, and the xla backend's keys
    on every device."""
    # divide by a device tensor: a CUDA division by a host scalar
    # multiplies by its reciprocal and can move a particle across a cell
    rd = device_constant(rest_dist, dtype=torch.float32, device=P.device)
    cell = torch.clamp(torch.floor(P / rd).to(torch.int32) + 512, 0, 1023)
    return torch.where(active, morton_code(cell),
                       device_constant(INT32_BIG, dtype=torch.int32,
                                       device=P.device))


def contact_gather(order, P, prev, w, active, *, lattice_w=None,
                   rest_positions=None):
    """One contact group's inputs in sorted order (the payload of
    jax.lax.sort in collisions.contact_group,
    flingbot_tpu/engine/collisions.py:342-364).  order (B, N) i64, the
    sort's permutation; P, prev (B, 3, N) f32; w (B, N) f32; active (B, N)
    bool; exactly one of lattice_w (grid mode) and rest_positions (B, 3, N)
    f32 (mesh mode).  Returns [xs, ys, zs, pxs, pys, pzs, packed] + [rx,
    ry, rz] in mesh mode, each (B, N) and contiguous: the positions, the
    previous positions, the packed ids (pack_lattice_ids, or pack_slot_ids
    in mesh mode) and the rest positions of slot order[b, j] at [b, j]."""
    if (lattice_w is None) == (rest_positions is None):
        raise ValueError("pass exactly one of lattice_w / rest_positions")
    if P.device.type == "cpu":
        return contact_gather_plain(order, P, prev, w, active,
                                    lattice_w=lattice_w,
                                    rest_positions=rest_positions)
    B, _, N = P.shape
    mesh = rest_positions is not None
    _check(order, "order", (B, N), torch.int64)
    _check(P, "P", (B, 3, N))
    _check(prev, "prev", (B, 3, N))
    _check(w, "w", (B, N))
    _check(active, "active", (B, N), torch.bool)
    if mesh:
        _check(rest_positions, "rest_positions", (B, 3, N))
        if N >= 1 << PACK_IMMOBILE_BIT:
            raise ValueError("mesh packed ids support < 2^20 particles")
    elif not 0 < lattice_w <= 256:
        raise ValueError("packed lattice ids support max_dimx <= 256")
    lib = build()["contact_sort"]
    out = torch.empty((9 if mesh else 6, B, N), dtype=torch.float32,
                      device=P.device)
    packed = torch.empty((B, N), dtype=torch.int32, device=P.device)
    _launch(lib, lib.flingbot_contact_gather, [
        order.data_ptr(), P.data_ptr(), prev.data_ptr(), w.data_ptr(),
        active.data_ptr(), rest_positions.data_ptr() if mesh else None,
        0 if mesh else int(lattice_w), out.data_ptr(), packed.data_ptr(), B,
        N], P.device)
    LAUNCHES["contact_gather"] += 1
    if mesh:
        LAUNCHES["contact_gather_mesh"] += 1
    return list(out[:6]) + [packed] + list(out[6:])


def pack_lattice_ids(n: int, lattice_w: int, active: torch.Tensor,
                     immobile: torch.Tensor) -> torch.Tensor:
    """(B, n) int32 per-slot packed id: lattice x (bits 0-7), lattice y
    (bits 8-19), immobile flag (bit 20), inactive flag (bit 21)."""
    assert lattice_w <= 256, "packed lattice ids support max_dimx <= 256"
    i = torch.arange(n, dtype=torch.int32, device=active.device)
    iy = i // lattice_w
    ix = i % lattice_w
    return ((ix | (iy << 8))[None]
            | (immobile.to(torch.int32) << PACK_IMMOBILE_BIT)
            | ((~active).to(torch.int32) << PACK_INACTIVE_BIT))


def pack_slot_ids(n: int, active: torch.Tensor,
                  immobile: torch.Tensor) -> torch.Tensor:
    """(B, n) int32 packed id of the mesh mode: flat slot index (bits
    0-19), immobile flag (bit 20), inactive flag (bit 21)."""
    if n >= 1 << PACK_IMMOBILE_BIT:
        raise ValueError("mesh packed ids support < 2^20 particles")
    i = torch.arange(n, dtype=torch.int32, device=active.device)
    return (i[None] | (immobile.to(torch.int32) << PACK_IMMOBILE_BIT)
            | ((~active).to(torch.int32) << PACK_INACTIVE_BIT))


def contact_gather_plain(order, P, prev, w, active, *, lattice_w=None,
                         rest_positions=None):
    """Plain PyTorch version of `contact_gather`, and the xla backend's
    gathers on every device: the packed ids in slot order, then one
    torch.gather through order per array."""
    n = P.shape[2]
    arrays = [P[:, 0], P[:, 1], P[:, 2], prev[:, 0], prev[:, 1], prev[:, 2]]
    if rest_positions is None:
        arrays.append(pack_lattice_ids(n, lattice_w, active, w <= 0))
    else:
        arrays.append(pack_slot_ids(n, active, w <= 0))
        arrays += [rest_positions[:, 0], rest_positions[:, 1],
                   rest_positions[:, 2]]
    return [torch.gather(a, 1, order).contiguous() for a in arrays]
