"""The port's two CUDA kernels: ctypes wrappers, launch counters and plain
PyTorch versions (counterpart of flingbot_tpu/engine/pallas_kernels.py).

  substeps  csrc/substeps.cu  <- _substeps_kernel / pallas_substeps
  contacts  csrc/contacts.cu  <- _contacts_kernel / pallas_contacts
                                 (grid mode, and mesh mode with rests=)

A wrapper takes its plain version only for tensors on the CPU.  For a CUDA
tensor it launches the kernel or raises; it never falls back.  Each launch
adds one to LAUNCHES[name]; a mesh-mode launch of the contacts kernel also
adds one to LAUNCHES["contacts_mesh"].
"""

from __future__ import annotations

import ctypes

import torch

from flingbot_tpu_torch.engine import build as _build

KERNELS = ("substeps", "contacts")
LAUNCHES = {name: 0 for name in KERNELS + ("contacts_mesh",)}

SUB_PARAM_LEN = 21
# [0]=dt_sub [1]=gravity_y [2]=damping [3]=dynamic_friction
# [4]=collision_distance [5]=relaxation [6]=spacing
# [7..9]=stiffness(stretch,bend,shear) [10]=dimx [11]=dimy
# [12]=picker_R (radius+coldist) [13]=cheb_rho2
# [14..16]=picker0 xyz [17..19]=picker1 xyz [20]=max_acceleration

CONTACT_PARAM_LEN = 8
# [0]=rest_dist [1]=w_uniform [2]=mu_pair [3]=mu_plane
# [4]=collision_distance [5..7]=unused
# the mesh mode keeps its filter as one bit per window offset
MAX_MESH_WINDOW = 32

PACK_IMMOBILE_BIT = 20
PACK_INACTIVE_BIT = 21

# one block of 1024 threads per env, each thread owning <= 11 particles
MAX_PARTICLES = 1024 * 11
_EPS = 1e-9
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_libs: dict = {}  # the loaded libraries, by kernel name


def build():
    """Compile (in parallel) and load every kernel, once; returns the
    libraries with their C signatures set."""
    if _libs:
        return _libs
    libs = _build.build(KERNELS)
    p = ctypes.c_void_p
    i = ctypes.c_int
    libs["substeps"].flingbot_substeps.argtypes = [p] * 8 + [i] * 6 + [p]
    libs["substeps"].flingbot_substeps.restype = i
    libs["contacts"].flingbot_contacts.argtypes = [p] * 11 + [i] * 4 + [p]
    libs["contacts"].flingbot_contacts.restype = i
    libs["contacts"].flingbot_contacts_mesh.argtypes = (
        [p] * 14 + [i] * 4 + [p])
    libs["contacts"].flingbot_contacts_mesh.restype = i
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


def _launch(lib, fn, args, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = lib.flingbot_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} launch failed: {msg} ({err})")


# --------------------------------------------------------------------------
# kernel 1: fused substeps
# --------------------------------------------------------------------------

def substeps(pvec, P, V, w, *, n_sub: int, iterations: int,
             picker_last: bool = True):
    """n_sub fused XPBD substeps per env (pallas_substeps,
    pallas_kernels.py:296-329).

    pvec (B, 21) f32; P, V (B, 3, H, W) f32; w (B, H, W) f32.  Returns
    (P', V', prev_last), prev_last the positions at the start of the last
    substep.  picker_last=False omits the last substep's picker push so
    the caller can run the contact group first."""
    if P.device.type == "cpu":
        return substeps_plain(pvec, P, V, w, n_sub=n_sub,
                              iterations=iterations, picker_last=picker_last)
    B, _, H, W = P.shape
    _check(pvec, "pvec", (B, SUB_PARAM_LEN))
    _check(P, "P", (B, 3, H, W))
    _check(V, "V", (B, 3, H, W))
    _check(w, "w", (B, H, W))
    if H * W > MAX_PARTICLES or 5 * H * W * 4 > _SMEM_LIMIT:
        raise ValueError(f"lattice {H}x{W} exceeds the kernel's capacity")
    lib = build()["substeps"]
    out_P = torch.empty_like(P)
    out_V = torch.empty_like(V)
    out_prev = torch.empty_like(P)
    cheb = torch.empty_like(P)  # Chebyshev previous iterate (scratch)
    _launch(lib, lib.flingbot_substeps, [
        pvec.data_ptr(), P.data_ptr(), V.data_ptr(), w.data_ptr(),
        out_P.data_ptr(), out_V.data_ptr(), out_prev.data_ptr(),
        cheb.data_ptr(), B, H, W, int(n_sub), int(iterations),
        int(bool(picker_last))], P.device)
    LAUNCHES["substeps"] += 1
    return out_P, out_V, out_prev


def substeps_plain(pvec, P, V, w, *, n_sub: int, iterations: int,
                   picker_last: bool = True):
    """Plain PyTorch version of `substeps`, built from the solver
    functions (the substep loop of solver._substep/_run_substeps in the
    kernel's formulation)."""
    from flingbot_tpu_torch.engine import solver as S
    from flingbot_tpu_torch.engine.topology import lattice_valid

    B, _, H, W = P.shape
    col = lambda k: pvec[:, k].view(B, 1, 1)  # noqa: E731
    dt, gravity_y, damping = col(0), col(1), col(2)
    mu, coldist, a_max = col(3), col(4), col(20)
    dimx = pvec[:, 10].to(torch.int64)
    dimy = pvec[:, 11].to(torch.int64)
    valid = lattice_valid(dimx, dimy, H, W)
    w = torch.where(valid, w, 0.0)
    moving = valid & (w > 0)
    classes, invc = S.spring_coefficients(
        w, valid, dimx, dimy, pvec[:, 7:10], pvec[:, 6], pvec[:, 5])
    rho2 = col(13)[:, None]
    prev = P
    for s in range(n_sub):
        P, V, prev = S.integrate(P, V, dt, gravity_y, damping, moving)
        P = S.chebyshev_loop(
            P, lambda Q: S.grid_jacobi(Q, classes, invc), iterations,
            lambda Q: S.solve_plane(Q, prev, coldist, mu, moving), rho2)
        V = S.clamp_finalize(P, V, prev, dt, a_max, moving)
        if s < n_sub - 1 or picker_last:
            P = S.picker_push_sequential(P, pvec, moving)
    return P, V, prev


# --------------------------------------------------------------------------
# kernel 2: windowed contacts on Morton-sorted particles
# --------------------------------------------------------------------------

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
    # shared memory: sorted x, y, z and packed ids, plus the mesh mode's
    # per-particle filter bits
    if N > MAX_PARTICLES or (5 if mesh else 4) * N * 4 > _SMEM_LIMIT:
        raise ValueError(f"{N} particles exceed the kernel's capacity")
    if mesh and window > MAX_MESH_WINDOW:
        raise ValueError(f"mesh mode supports window <= {MAX_MESH_WINDOW}")
    lib = build()["contacts"]
    ox, oy, oz = (torch.empty_like(xs) for _ in range(3))
    fn = lib.flingbot_contacts_mesh if mesh else lib.flingbot_contacts
    _launch(lib, fn, [cparams.data_ptr()] + [a.data_ptr() for a in coords[:6]]
            + [packed.data_ptr()] + [a.data_ptr() for a in coords[6:]]
            + [ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), B, N,
               int(window), int(iterations)], xs.device)
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
    average by contact count, then the ground plane."""
    B, n = X.shape
    col = lambda k: cparams[:, k].view(B, 1)  # noqa: E731
    rest_d, w_uni, mu_p, mu_plane, coldist = (col(k) for k in range(5))
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
        coef = torch.where(ok, 1.0 / (wsum + _EPS), 0.0)
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
            sq = d0 * d0 + d1 * d1 + d2 * d2 + _EPS
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
            tn_r = torch.rsqrt(t0 * t0 + t1 * t1 + t2 * t2 + _EPS)
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
        t_norm = torch.sqrt(dx_ * dx_ + dz_ * dz_ + _EPS)
        f = contact_f * torch.clamp(
            mu_plane * torch.clamp(pen, min=0.0) / t_norm, max=1.0)
        X, Y, Z = X - dx_ * f, Y + contact_f * pen, Z - dz_ * f
    return X, Y, Z
