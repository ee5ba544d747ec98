"""Plain reference of the cloth physics: one XPBD frame of grid cloths and
of layered-lattice shirts, the picker, and one step of the primitive
interpreter.

A frozen copy of the plain PyTorch arithmetic the simulator is held to
(the XPBD step of FleX as flingbot uses it: 6-class grid springs or the
layered lattice's offset classes, Chebyshev-accelerated Jacobi with local
relaxation, the ground plane with Coulomb friction, the speed-up-only
maxAcceleration clamp, the picker spheres, and the Morton-sorted windowed
self-collision), written for one purpose: to judge what the program
computed.  It imports nothing of the program and takes no table the
program built: the topology is worked out from the task file here
(`topology.py`).  Every function runs in the dtype of its inputs, so the
same code is the low-precision control (bfloat16).

Layouts: grid state (B, 3, H, W) on an H x W lattice; flat state
(B, 3, N); per-particle arrays (B, N).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

EPS = 1e-9
CHEBYSHEV_DELAY = 2
INT32_BIG = 2 ** 30
PACK_IMMOBILE_BIT = 20
PACK_INACTIVE_BIT = 21
PICKER_RADIUS = 0.02
PICK_THRESHOLD = 0.005
PARTICLE_RADIUS = 0.00625
SQRT2 = float(np.sqrt(2.0))
# (dy, dx, rest in spacings, stiffness class: 0 stretch, 1 bend, 2 shear)
GRID_STENCIL_CLASSES = ((0, 1, 1.0, 0), (1, 0, 1.0, 0), (0, 2, 2.0, 1),
                        (2, 0, 2.0, 1), (1, 1, SQRT2, 2), (1, -1, SQRT2, 2))


def f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Params:
    """The solver constants of the production operating point
    (utils/config.py defaults; FleX scene constants as flingbot sets
    them)."""

    dt: float = f32(1.0 / 100.0)
    gravity: tuple = (0.0, -9.8, 0.0)
    damping: float = 1.0
    dynamic_friction: float = f32(0.1)
    particle_friction: float = 1.0
    picker_friction: float = 0.0
    radius: float = f32(PARTICLE_RADIUS * 1.8)
    collision_distance: float = f32(0.005)
    relaxation_factor: float = 1.0
    max_acceleration: float = 100.0
    chebyshev_rho: float = f32(0.992)


@dataclasses.dataclass
class State:
    positions: torch.Tensor  # (B, 3, N)
    velocities: torch.Tensor
    inv_mass: torch.Tensor  # (B, N)
    rest_inv_mass: torch.Tensor
    active: torch.Tensor  # (B, N) bool
    picker_pos: torch.Tensor  # (B, 2, 3)
    picked_idx: torch.Tensor  # (B, 2) i64

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


def where_state(mask, a: State, b: State) -> State:
    out = {}
    for f in dataclasses.fields(State):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        out[f.name] = torch.where(mask.view((-1,) + (1,) * (va.dim() - 1)),
                                  va, vb)
    return State(**out)


# --------------------------------------------------------------------------
# lattice helpers
# --------------------------------------------------------------------------

def shift2d(a, dy: int, dx: int, fill=0):
    """out[..., y, x] = a[..., y + dy, x + dx]; out of range -> fill."""
    H, W = a.shape[-2], a.shape[-1]
    out = torch.full_like(a, fill)
    if abs(dy) >= H or abs(dx) >= W:
        return out
    out[..., max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)] = \
        a[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)]
    return out


def lattice_valid(dimx, dimy, H: int, W: int):
    dev = dimx.device
    iy = torch.arange(H, device=dev).view(1, H, 1)
    ix = torch.arange(W, device=dev).view(1, 1, W)
    return (iy < dimy.view(-1, 1, 1)) & (ix < dimx.view(-1, 1, 1))


# --------------------------------------------------------------------------
# springs, plane, clamps, pickers
# --------------------------------------------------------------------------

def spring_coefficients(w, valid, dimx, dimy, stiffness, spacing, relax):
    """Per-class coefficient planes of the grid's Jacobi spring solve and
    relax / constraint count."""
    B, H, W = w.shape
    dev, dt = w.device, w.dtype
    iy = torch.arange(H, device=dev).view(1, H, 1)
    ix = torch.arange(W, device=dev).view(1, 1, W)
    dimx = dimx.view(-1, 1, 1).to(torch.int64)
    dimy = dimy.view(-1, 1, 1).to(torch.int64)
    spacing = spacing.to(dt).reshape(-1, 1, 1)
    classes = []
    count = torch.zeros_like(w)
    for dy, dx, rest_k, cls in GRID_STENCIL_CLASSES:
        rest = spacing * f32(rest_k)
        stiff = stiffness[:, cls].view(-1, 1, 1)
        wb = shift2d(w, dy, dx)
        nbr_ok = ((iy + dy >= 0) & (iy + dy < dimy)
                  & (ix + dx >= 0) & (ix + dx < dimx))
        denom = w + wb
        live = valid & nbr_ok & (denom > 0)
        inv = stiff / (denom + EPS)
        gA = torch.where(live, w * inv, 0.0)
        gB = torch.where(live, wb * inv, 0.0)
        live_f = live.to(dt)
        count = count + live_f + shift2d(live_f, -dy, -dx)
        classes.append((dy, dx, rest, gA, gB))
    relax = relax.to(dt).reshape(-1, 1, 1)
    return classes, relax / torch.clamp(count, min=1.0)


def grid_jacobi(P, classes, invc):
    acc = torch.zeros_like(P)
    for dy, dx, rest, gA, gB in classes:
        d = shift2d(P, dy, dx) - P
        r = torch.rsqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                        + d[:, 2] * d[:, 2] + EPS)
        e = 1.0 - rest * r
        a = (gA * e)[:, None]
        b = (gB * e)[:, None]
        acc = acc + a * d - shift2d(b * d, -dy, -dx)
    return P + invc[:, None] * acc


def spring_loop(P, iterate_fn, iterations: int, plane_fn, rho2=None):
    """`iterations` spring passes each followed by the plane; Chebyshev
    semi-iterative acceleration (Wang 2015) after CHEBYSHEV_DELAY plain
    passes when rho2 is given."""
    if rho2 is None:
        for _ in range(iterations):
            P = plane_fn(iterate_fn(P))
        return P
    P_prev = P
    for _ in range(min(CHEBYSHEV_DELAY, iterations)):
        P_prev, P = P, plane_fn(iterate_fn(P))
    if iterations <= CHEBYSHEV_DELAY:
        return P
    omega = 2.0 / (2.0 - rho2)
    P_acc = omega * (iterate_fn(P) - P_prev) + P_prev
    P_prev, P = P, plane_fn(P_acc)
    for _ in range(CHEBYSHEV_DELAY + 1, iterations):
        omega = 4.0 / (4.0 - rho2 * omega)
        P_acc = omega * (iterate_fn(P) - P_prev) + P_prev
        P_prev, P = P, plane_fn(P_acc)
    return P


def solve_plane(P, prev, coldist, mu, moving):
    pen = coldist - P[:, 1]
    contact = (pen > 0) & moving
    dy = torch.where(contact, pen, 0.0)
    dx_ = P[:, 0] - prev[:, 0]
    dz_ = P[:, 2] - prev[:, 2]
    t_norm = torch.sqrt(dx_ * dx_ + dz_ * dz_ + EPS)
    scale = torch.clamp(mu * torch.clamp(pen, min=0.0) / t_norm, max=1.0)
    f = torch.where(contact, scale, 0.0)
    return torch.stack([P[:, 0] - dx_ * f, P[:, 1] + dy, P[:, 2] - dz_ * f],
                       1)


def integrate(P, V, dt, gravity_y, damping, moving):
    mm = moving[:, None]
    V = torch.stack([V[:, 0], V[:, 1] + dt * gravity_y, V[:, 2]], 1)
    V = V * torch.clamp(1.0 - damping * dt, min=0.0)[:, None]
    V = torch.where(mm, V, 0.0)
    return torch.where(mm, P + dt[:, None] * V, P), V, P


def clamp_finalize(P, V, prev, dt, a_max, moving):
    """Velocity finalize, rsqrt form: only speed-increasing changes are
    capped at a_max * dt."""
    V_new = (P - prev) / dt[:, None]
    dv = V_new - V
    r = torch.rsqrt(dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1]
                    + dv[:, 2] * dv[:, 2] + EPS)
    speeding = (V_new[:, 0] * V_new[:, 0] + V_new[:, 1] * V_new[:, 1]
                + V_new[:, 2] * V_new[:, 2]
                > V[:, 0] * V[:, 0] + V[:, 1] * V[:, 1] + V[:, 2] * V[:, 2])
    sc = torch.where(speeding, torch.clamp(a_max * dt * r, max=1.0), 1.0)
    return torch.where(moving[:, None], V + dv * sc[:, None], V)


def finalize_velocity(P, V, prev, dt, dv_max, moving):
    """Velocity finalize, sqrt / divide form (the substep loop of layered
    shirts)."""
    V_new = (P - prev) / dt
    dv = V_new - V
    dv_norm = torch.sqrt(dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1]
                         + dv[:, 2] * dv[:, 2] + EPS)
    speeding = (V_new[:, 0] * V_new[:, 0] + V_new[:, 1] * V_new[:, 1]
                + V_new[:, 2] * V_new[:, 2]
                > V[:, 0] * V[:, 0] + V[:, 1] * V[:, 1] + V[:, 2] * V[:, 2])
    scale = torch.where(speeding, torch.clamp(dv_max / dv_norm, max=1.0),
                        1.0)
    return torch.where(moving[:, None], V + dv * scale[:, None], V)


def add_delta_clamped(P, P2, V, dt, dv_max, moving):
    dv = (P2 - P) / dt
    V_new = V + dv
    dv_norm = torch.sqrt(dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1]
                         + dv[:, 2] * dv[:, 2] + EPS)
    speeding = (V_new[:, 0] * V_new[:, 0] + V_new[:, 1] * V_new[:, 1]
                + V_new[:, 2] * V_new[:, 2]
                > V[:, 0] * V[:, 0] + V[:, 1] * V[:, 1] + V[:, 2] * V[:, 2])
    scale = torch.where(speeding, torch.clamp(dv_max / dv_norm, max=1.0),
                        1.0)
    return P2, torch.where(moving[:, None], V + dv * scale[:, None], V)


def picker_spheres(P, picker_pos, R, moving, prev=None, mu=0.0):
    """Every gripper sphere pushes particles out from the same P; with
    picker friction mu > 0 each contact also removes tangential slip."""
    tail = (1,) * (P.dim() - 2)
    delta = torch.zeros_like(P)
    for k in range(picker_pos.shape[1]):
        d = P - picker_pos[:, k].view((-1, 3) + tail)
        dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                          + d[:, 2] * d[:, 2] + EPS)
        pen = R - dist
        contact = (pen > 0) & moving
        push = torch.where(contact, pen / dist, 0.0)
        delta = delta + d * push[:, None]
        if prev is not None and mu != 0.0:
            slip = P - prev
            n = d / dist[:, None]
            sn = (slip[:, 0] * n[:, 0] + slip[:, 1] * n[:, 1]
                  + slip[:, 2] * n[:, 2])
            t = slip - sn[:, None] * n
            t_norm = torch.sqrt(t[:, 0] * t[:, 0] + t[:, 1] * t[:, 1]
                                + t[:, 2] * t[:, 2] + EPS)
            scale = torch.clamp(mu * torch.clamp(pen, min=0.0) / t_norm,
                                max=1.0)
            delta = delta - t * torch.where(contact, scale, 0.0)[:, None]
    return P + delta


def picker_push_sequential(P, pickers, R, moving):
    """The spheres applied one after the other (rsqrt form), as the grid
    substep loop pushes."""
    for k in range(2):
        c = pickers[:, k].reshape(-1, 3, 1, 1)
        d = P - c
        sq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] + EPS
        r = torch.rsqrt(sq)
        pen = R - sq * r
        push = torch.where((pen > 0) & moving, pen * r, 0.0)
        P = P + d * push[:, None]
    return P


# --------------------------------------------------------------------------
# self-collision: Morton sort and the windowed pair projection
# --------------------------------------------------------------------------

def _part1by2(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def contact_group(P, prev, w, active, params: Params, *, window: int,
                  iterations: int, lattice_w=None, rest_positions=None):
    """Stable Morton sort (cell = rest distance) of the particles, the
    windowed pair projection on the sorted arrays (pairs (i, i + k) for
    k <= window, minus the SelfCollideFilter: lattice neighbours, or pairs
    closer than the rest distance in the rest pose), PBD particle
    friction, the mass-share split, the Jacobi average by count, the
    ground plane; scattered back to slot order.  P, prev (B, 3, N)."""
    B, _, n = P.shape
    dev = P.device
    rest_dist = params.radius
    rd = torch.tensor(rest_dist, dtype=P.dtype, device=dev)
    cell = torch.clamp(torch.floor(P / rd).to(torch.int32) + 512, 0, 1023)
    code = (_part1by2(cell[:, 0]) | (_part1by2(cell[:, 1]) << 1)
            | (_part1by2(cell[:, 2]) << 2))
    keys = torch.where(active, code, torch.tensor(INT32_BIG,
                                                  dtype=torch.int32,
                                                  device=dev))
    _, order = torch.sort(keys, dim=1, stable=True)
    take = lambda a: torch.gather(a, 1, order)  # noqa: E731
    X, Y, Z = take(P[:, 0]), take(P[:, 1]), take(P[:, 2])
    PX, PY, PZ = take(prev[:, 0]), take(prev[:, 1]), take(prev[:, 2])
    immobile = take(w <= 0)
    act = take(active)
    slot = order
    if rest_positions is not None:
        rests = [take(rest_positions[:, c]) for c in range(3)]
    else:
        lat_x, lat_y = slot % lattice_w, slot // lattice_w
    dt = X.dtype
    w_uni = 1.0
    wv = torch.where(immobile | ~act, 0.0, torch.ones_like(X) * w_uni)
    ms_f = (act & ~immobile).to(dt)
    mu_p = f32(params.particle_friction) * f32(params.dynamic_friction)
    i = torch.arange(n, device=dev)[None]

    def fwd(a, k):
        return torch.roll(a, -k, dims=1)

    rest_sq = f32(np.float32(rest_dist) * np.float32(rest_dist))
    static_k = []
    for k in range(1, window + 1):
        if rest_positions is None:
            nbr = ((torch.abs(fwd(lat_x, k) - lat_x) <= 1)
                   & (torch.abs(fwd(lat_y, k) - lat_y) <= 1))
        else:
            rd0, rd1, rd2 = (r - fwd(r, k) for r in rests)
            nbr = rd0 * rd0 + rd1 * rd1 + rd2 * rd2 < rest_sq
        wn = fwd(wv, k)
        wsum = wv + wn
        ok = (i < n - k) & act & fwd(act, k) & ~nbr & (wsum > 0)
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
            pen = rest_dist - sq * r
            live = pen > 0
            s = torch.where(live, coef * pen * r, 0.0)
            live_f = (live & ok).to(dt)
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
            acc_x = acc_x + wv * gx - torch.roll(wn * gx, k, dims=1)
            acc_y = acc_y + wv * gy - torch.roll(wn * gy, k, dims=1)
            acc_z = acc_z + wv * gz - torch.roll(wn * gz, k, dims=1)
            cnt = cnt + live_f + torch.roll(live_f, k, dims=1)
        inv_cnt = ms_f / torch.clamp(cnt, min=1.0)
        X = X + acc_x * inv_cnt
        Y = Y + acc_y * inv_cnt
        Z = Z + acc_z * inv_cnt
        pen = f32(params.collision_distance) - Y
        contact_f = torch.where(pen > 0, ms_f, 0.0)
        dx_ = X - PX
        dz_ = Z - PZ
        t_norm = torch.sqrt(dx_ * dx_ + dz_ * dz_ + EPS)
        f = contact_f * torch.clamp(
            f32(params.dynamic_friction) * torch.clamp(pen, min=0.0)
            / t_norm, max=1.0)
        X, Y, Z = X - dx_ * f, Y + contact_f * pen, Z - dz_ * f
    out = torch.empty_like(P)
    for c, o in enumerate((X, Y, Z)):
        out[:, c].scatter_(1, order, o)
    return out


# --------------------------------------------------------------------------
# the frame
# --------------------------------------------------------------------------

def grid_frame(state: State, topo, params: Params, knobs: dict) -> State:
    """One frame of grid cloths: per group of contact_every substeps,
    integrate -> springs with the plane -> clamp -> picker push (the
    group's last push deferred past its contact group), then contacts ->
    plane -> velocity add under the clamp -> picker push."""
    substeps, iterations = knobs["substeps"], knobs["iterations"]
    every = knobs["contact_every"]
    B, H, W = state.positions.shape[0], topo.H, topo.W
    dt_ = state.positions.dtype
    P = state.positions.view(B, 3, H, W)
    V = state.velocities.view(B, 3, H, W)
    valid = lattice_valid(topo.dimx, topo.dimy, H, W)
    w = torch.where(valid, state.inv_mass.view(B, H, W), 0.0)
    moving = valid & (w > 0)
    dt_sub = f32(np.float32(params.dt) / np.float32(substeps))
    tens = lambda v: torch.full((B, 1, 1), v, dtype=dt_,  # noqa: E731
                                device=P.device)
    dt, grav, damp = tens(dt_sub), tens(f32(params.gravity[1])), tens(
        f32(params.damping))
    mu, coldist = tens(f32(params.dynamic_friction)), tens(
        f32(params.collision_distance))
    a_max = tens(f32(params.max_acceleration))
    dv_max = float(np.float32(params.max_acceleration) * np.float32(dt_sub))
    R = f32(np.float32(PICKER_RADIUS) + np.float32(params.collision_distance))
    pickers = state.picker_pos.to(dt_)
    classes, invc = spring_coefficients(
        w, valid, topo.dimx, topo.dimy, topo.stiffness.to(dt_),
        torch.full((B,), topo.spacing, device=P.device),
        torch.full((B,), f32(params.relaxation_factor), device=P.device))
    rho = np.float32(params.chebyshev_rho)
    rho2 = tens(f32(rho * rho))[:, None]
    flat_valid = valid.reshape(B, -1)
    dt_t = torch.tensor(dt_sub, dtype=dt_, device=P.device)
    if knobs.get("self_collision", True):
        n_groups, n_sub = substeps // every, every
    else:
        n_groups, n_sub = 1, substeps
    for _ in range(n_groups):
        prev = P
        for s in range(n_sub):
            P, V, prev = integrate(P, V, dt, grav, damp, moving)
            P = spring_loop(P, lambda Q: grid_jacobi(Q, classes, invc),
                            iterations,
                            lambda Q: solve_plane(Q, prev, coldist, mu,
                                                  moving), rho2)
            V = clamp_finalize(P, V, prev, dt, a_max, moving)
            if s < n_sub - 1 or not knobs.get("self_collision", True):
                P = picker_push_sequential(P, pickers, R, moving)
        if knobs.get("self_collision", True):
            P2 = contact_group(
                P.reshape(B, 3, -1), prev.reshape(B, 3, -1),
                w.reshape(B, -1), flat_valid, params,
                window=knobs["contact_window"],
                iterations=knobs["contact_iterations"],
                lattice_w=W).view(B, 3, H, W)
            P2 = solve_plane(P2, prev, f32(params.collision_distance),
                             f32(params.dynamic_friction), moving)
            P, V = add_delta_clamped(P, P2, V, dt_t, dv_max, moving)
            P = picker_spheres(P, pickers, R, moving)
    return state.replace(positions=P.reshape(B, 3, -1),
                         velocities=V.reshape(B, 3, -1))


def solve_springs_layered(P, w, planes, relax):
    B, _, N = P.shape
    K = planes["stiff"].shape[1]
    d = P[:, :, planes["nbr"]].view(B, 3, K, N) - P[:, :, None]
    dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                      + d[:, 2] * d[:, 2] + EPS)
    C = dist - planes["rest"]
    s = torch.where(planes["live"],
                    planes["stiff"] * C / (planes["den"] * dist), 0.0)
    dA = (w[:, None] * s)[:, None] * d
    dB = (-(planes["wb"] * s))[:, None] * d
    dB = torch.cat([dB.reshape(B, 3, K * N), dB.new_zeros(B, 3, 1)], 2)
    acc = dA.sum(2) + dB[:, :, planes["inv"]].view(B, 3, K, N).sum(2)
    return P + relax * acc / planes["count"][:, None]


def layered_frame(state: State, topo, params: Params, knobs: dict) -> State:
    """One frame of layered-lattice shirts: per substep, gravity, damping,
    predict, the offset-class springs with the plane (Chebyshev), the
    velocity finalize under the clamp, every contact_every-th substep the
    sorted contact group in mesh mode (rest-pose filter) -> plane ->
    velocity add under the clamp, then the picker spheres with picker
    friction against the substep's entry positions."""
    substeps, iterations = knobs["substeps"], knobs["iterations"]
    every = knobs["contact_every"]
    P, V = state.positions, state.velocities
    dt_ = P.dtype
    w = torch.where(state.active, state.inv_mass, 0.0)
    moving = state.active & (w > 0)
    mm = moving[:, None]
    planes = topo.planes(w)
    relax = f32(params.relaxation_factor)
    # the program's own expressions, so that every constant rounds alike
    dt = f32(params.dt) / np.float32(substeps)
    dv_max = float(np.float32(params.max_acceleration) * dt)
    damp = float(max(np.float32(0.0), np.float32(1.0)
                     - np.float32(params.damping) * dt))
    g_dt = dt * torch.tensor(params.gravity, dtype=torch.float32,
                             device=P.device).view(1, 3, 1)
    g_dt = g_dt.to(dt_)
    rho2 = np.float32(params.chebyshev_rho) * np.float32(
        params.chebyshev_rho)
    R = f32(np.float32(PICKER_RADIUS) + np.float32(params.collision_distance))
    dt_t = torch.as_tensor(dt, dtype=dt_, device=P.device)
    pickers = state.picker_pos.to(dt_)
    rest_pos = topo.rest_positions.to(dt_)

    def plane(Q, prev):
        return solve_plane(Q, prev, f32(params.collision_distance),
                           f32(params.dynamic_friction), moving)

    for i in range(substeps):
        P_in = P
        V = V + g_dt
        V = torch.where(mm, V * damp, 0.0)
        prev = P
        P = torch.where(mm, P + float(dt) * V, P)
        P = spring_loop(P, lambda Q: solve_springs_layered(Q, w, planes,
                                                           relax),
                        iterations, lambda Q: plane(Q, prev), rho2)
        V = finalize_velocity(P, V, prev, dt_t, dv_max, moving)
        if knobs.get("self_collision", True) and (i + 1) % every == 0:
            P2 = plane(contact_group(
                P, prev, w, state.active, params,
                window=knobs["contact_window"],
                iterations=knobs["contact_iterations"],
                rest_positions=rest_pos), prev)
            P, V = add_delta_clamped(P, P2, V, dt_t, dv_max, moving)
        P = picker_spheres(P, pickers, R, moving, prev=P_in,
                           mu=params.picker_friction)
    return state.replace(positions=P, velocities=V)


def frame(state: State, topo, params: Params, knobs: dict) -> State:
    """One solver frame of either topology (topology.GridTopo or
    topology.LayeredTopo)."""
    fn = layered_frame if getattr(topo, "layered", False) else grid_frame
    return fn(state, topo, params, knobs)


# --------------------------------------------------------------------------
# the picker
# --------------------------------------------------------------------------

def _take(x, idx):
    if x.dim() == 2:
        return x.gather(1, idx[:, None])[:, 0]
    return x.gather(2, idx.view(-1, 1, 1).expand(-1, x.shape[1], 1))[..., 0]


def _put(x, idx, val):
    x = x.clone()
    if x.dim() == 2:
        x.scatter_(1, idx[:, None], val[:, None].to(x.dtype))
    else:
        x.scatter_(2, idx.view(-1, 1, 1).expand(-1, x.shape[1], 1),
                   val[..., None].to(x.dtype))
    return x


def picker_step(state: State, action, dt: float) -> State:
    """Per picker: unpick -> move -> grasp the nearest free particle in
    range -> co-move the grasped particle (inverse mass 0, the picker's
    velocity).  action (B, 2, 4): dx, dy, dz, pick flag."""
    B, N = state.inv_mass.shape
    positions, velocities = state.positions, state.velocities
    inv_mass = state.inv_mass
    picker_pos = state.picker_pos.clone()
    picked_idx = state.picked_idx.clone()
    grasp_range = PICK_THRESHOLD + PICKER_RADIUS + PARTICLE_RADIUS
    slots = torch.arange(N, device=positions.device)[None]
    for i in range(picker_pos.shape[1]):
        delta = action[:, i, :3]
        flag = action[:, i, 3] > 0.5
        cur = picked_idx[:, i]
        has = cur >= 0
        safe = cur.clamp(0, N - 1)
        release = ~flag & has
        inv_mass = _put(inv_mass, safe, torch.where(
            release, _take(state.rest_inv_mass, safe), _take(inv_mass, safe)))
        cur = torch.where(release, -1, cur)
        has = cur >= 0
        picker_pos[:, i] = picker_pos[:, i] + delta
        d = positions - picker_pos[:, i, :, None]
        dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                          + d[:, 2] * d[:, 2])
        taken = torch.zeros_like(state.active)
        for j in range(picker_pos.shape[1]):
            if j != i:
                oid = picked_idx[:, j:j + 1]
                taken = taken | ((slots == oid) & (oid >= 0))
        eligible = state.active & ~taken & (dist <= grasp_range)
        dist_masked = torch.where(eligible, dist, float("inf"))
        nearest = torch.argmin(dist_masked, dim=1)
        can_pick = flag & ~has & torch.isfinite(_take(dist_masked, nearest))
        cur = torch.where(can_pick, nearest, cur)
        has = cur >= 0
        move = flag & has
        safe = cur.clamp(0, N - 1)
        tgt = _take(positions, safe) + delta
        positions = _put(positions, safe, torch.where(
            move[:, None], tgt, _take(positions, safe)))
        inv_mass = _put(inv_mass, safe, torch.where(
            move, 0.0, _take(inv_mass, safe)))
        velocities = _put(velocities, safe, torch.where(
            move[:, None], delta / dt, _take(velocities, safe)))
        picked_idx[:, i] = cur
    return state.replace(positions=positions, velocities=velocities,
                         inv_mass=inv_mass, picker_pos=picker_pos,
                         picked_idx=picked_idx)


def release_all(state: State) -> State:
    N = state.inv_mass.shape[1]
    inv_mass = state.inv_mass
    for i in range(state.picked_idx.shape[1]):
        idx = state.picked_idx[:, i]
        safe = idx.clamp(0, N - 1)
        inv_mass = _put(inv_mass, safe, torch.where(
            idx >= 0, _take(state.rest_inv_mass, safe),
            _take(inv_mass, safe)))
    return state.replace(inv_mass=inv_mass,
                         picked_idx=torch.full_like(state.picked_idx, -1))
