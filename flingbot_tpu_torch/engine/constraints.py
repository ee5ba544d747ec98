"""The plain constraint pieces of an XPBD substep, on (B, 3, ...) positions
and velocities and (B, ...) masks: what both the kernels' plain versions
(engine/kernels.py) and the solver's substep loop are built from.  Two
forms of a piece that round differently stay apart: the substeps kernel's
rsqrt forms (grid_jacobi, clamp_finalize, picker_push_sequential) and the
JAX package's sqrt / divide forms (solver.grid_jacobi_xla,
finalize_velocity, solve_picker_spheres).
"""

from __future__ import annotations

import numpy as np
import torch

from flingbot_tpu_torch.engine.topology import GRID_STENCIL_CLASSES, shift2d

EPS = 1e-9
CHEBYSHEV_DELAY = 2  # plain Jacobi warm-up iterations


def dot3(a, b):
    """Per-particle dot product of (B, 3, ...) tensors, summed x, y, z."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def integrate(P, V, dt, gravity_y, damping, moving):
    """Gravity + damping on moving particles, then predict positions.
    P, V (B, 3, H, W); dt, gravity_y, damping (B, 1, 1).  Returns
    (P, V, prev)."""
    mm = moving[:, None]
    V = torch.stack([V[:, 0], V[:, 1] + dt * gravity_y, V[:, 2]], 1)
    V = V * torch.clamp(1.0 - damping * dt, min=0.0)[:, None]
    V = torch.where(mm, V, 0.0)
    return torch.where(mm, P + dt[:, None] * V, P), V, P


def spring_coefficients(w, valid, dimx, dimy, stiffness, spacing, relax):
    """Per-class constant coefficient planes of the Jacobi spring solve.

    w, valid (B, H, W); dimx, dimy (B,); stiffness (B, 3); spacing, relax
    (B,) or scalars.  Returns ([(dy, dx, rest, gA, gB)], invc) with
    gA = stiff*w/(w+wb), gB = stiff*wb/(w+wb) at the constraint's start
    slot and invc = relax / constraint count (eNvFlexRelaxationLocal)."""
    B, H, W = w.shape
    dev = w.device
    iy = torch.arange(H, device=dev).view(1, H, 1)
    ix = torch.arange(W, device=dev).view(1, 1, W)
    dimx = dimx.view(-1, 1, 1).to(torch.int64)
    dimy = dimy.view(-1, 1, 1).to(torch.int64)
    spacing = torch.as_tensor(spacing, dtype=torch.float32,
                              device=dev).reshape(-1, 1, 1)
    classes = []
    count = torch.zeros_like(w)
    for dy, dx, rest_k, cls in GRID_STENCIL_CLASSES:
        rest = spacing * float(np.float32(rest_k))
        stiff = stiffness[:, cls].view(-1, 1, 1)
        wb = shift2d(w, dy, dx)
        nbr_ok = ((iy + dy >= 0) & (iy + dy < dimy)
                  & (ix + dx >= 0) & (ix + dx < dimx))
        denom = w + wb
        live = valid & nbr_ok & (denom > 0)
        inv = stiff / (denom + EPS)
        gA = torch.where(live, w * inv, 0.0)
        gB = torch.where(live, wb * inv, 0.0)
        live_f = live.to(w.dtype)
        count = count + live_f + shift2d(live_f, -dy, -dx)
        classes.append((dy, dx, rest, gA, gB))
    relax = torch.as_tensor(relax, dtype=torch.float32,
                            device=dev).reshape(-1, 1, 1)
    return classes, relax / torch.clamp(count, min=1.0)


def grid_jacobi(P, classes, invc):
    """One Jacobi pass over the six stencil classes from the same P,
    accumulated and divided by the per-particle constraint count."""
    acc = torch.zeros_like(P)
    for dy, dx, rest, gA, gB in classes:
        d = shift2d(P, dy, dx) - P
        r = torch.rsqrt(dot3(d, d) + EPS)
        e = 1.0 - rest * r
        a = (gA * e)[:, None]
        b = (gB * e)[:, None]
        acc = acc + a * d - shift2d(b * d, -dy, -dx)
    return P + invc[:, None] * acc


def chebyshev_loop(P, iterate_fn, iterations: int, plane_fn, rho2):
    """Chebyshev semi-iterative acceleration (Wang 2015, gamma = 1) of a
    Jacobi iteration, as _chebyshev_loop (solver.py:229-273):
    P_{k+1} = plane(omega_k * (iterate(P_k) - P_{k-1}) + P_{k-1}),
    after CHEBYSHEV_DELAY plain iterations."""
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


def spring_loop(P, iterate_fn, iterations: int, plane_fn, rho2=None):
    """`iterations` spring passes, each followed by the ground plane:
    Chebyshev-accelerated (chebyshev_loop) with rho2 given, else plain
    Jacobi, P_{k+1} = plane(iterate(P_k)) (spring_mode "jacobi": the
    fori_loop of _substep, solver.py:418-424, and of the substeps kernel,
    pallas_kernels.py:229-233)."""
    if rho2 is not None:
        return chebyshev_loop(P, iterate_fn, iterations, plane_fn, rho2)
    for _ in range(iterations):
        P = plane_fn(iterate_fn(P))
    return P


def solve_plane(P, prev, coldist, mu, moving):
    """Ground plane y >= collision_distance with PBD Coulomb friction
    (solve_plane, solver.py:329).  P, prev (B, 3, ...); moving (B, ...)."""
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


def clamp_finalize(P, V, prev, dt, a_max, moving):
    """Velocity finalize with the speed-up-only maxAcceleration clamp
    (solver.py:409-437, rsqrt form of the substeps kernel): only
    speed-increasing changes are capped.  dt, a_max (B, 1, 1)."""
    V_new = (P - prev) / dt[:, None]
    dv = V_new - V
    r = torch.rsqrt(dot3(dv, dv) + EPS)
    sc = torch.where(dot3(V_new, V_new) > dot3(V, V),
                     torch.clamp(a_max * dt * r, max=1.0), 1.0)
    return torch.where(moving[:, None], V + dv * sc[:, None], V)


def _add_clamped(V, V_new, dv, dv_max, moving):
    """V + dv on moving particles, dv cut to length dv_max where
    V_new = V + dv is faster than V (sqrt / divide form)."""
    dv_norm = torch.sqrt(dot3(dv, dv) + EPS)
    scale = torch.where(dot3(V_new, V_new) > dot3(V, V),
                        torch.clamp(dv_max / dv_norm, max=1.0), 1.0)
    return torch.where(moving[:, None], V + dv * scale[:, None], V)


def finalize_velocity(P, V, prev, dt, dv_max, moving):
    """Velocity finalize with the speed-up-only maxAcceleration clamp in the
    sqrt / divide form of _substep (solver.py:437-444); the substeps
    kernel's rsqrt form (clamp_finalize) rounds differently, and the clamp
    is discontinuous.  dt: a float or a 0-dim tensor (solver._per_dt)."""
    V_new = (P - prev) / dt
    return _add_clamped(V, V_new, V_new - V, dv_max, moving)


def add_delta_clamped(P, P2, V, dt, dv_max, moving):
    """Apply a projection P -> P2 with its velocity contribution under the
    speed-up-only clamp (_add_delta_clamped, solver.py:454).  dt: a float
    or a tensor that broadcasts against P (see solver._per_dt)."""
    dv = (P2 - P) / dt
    return P2, _add_clamped(V, V + dv, dv, dv_max, moving)


def solve_picker_spheres(P, picker_pos, R, moving, prev=None, mu=0.0):
    """Push particles out of the gripper spheres (solve_picker_spheres,
    solver.py:346-388).  P (B, 3, ...); picker_pos (B, K, 3); R = radius +
    collision distance.  Every sphere pushes from the same P.  With `prev`
    (the substep's entry positions) and picker friction mu > 0, each
    contact also removes the tangential slip P - prev up to mu times its
    penetration; mu = 0 is the position-only push."""
    tail = (1,) * (P.dim() - 2)
    delta = torch.zeros_like(P)
    for k in range(picker_pos.shape[1]):
        d = P - picker_pos[:, k].view((-1, 3) + tail)
        dist = torch.sqrt(dot3(d, d) + EPS)
        pen = R - dist
        contact = (pen > 0) & moving
        push = torch.where(contact, pen / dist, 0.0)
        delta = delta + d * push[:, None]
        if prev is not None and mu != 0.0:
            slip = P - prev
            n = d / dist[:, None]
            sn = dot3(slip, n)
            t = slip - sn[:, None] * n
            t_norm = torch.sqrt(dot3(t, t) + EPS)
            scale = torch.clamp(mu * torch.clamp(pen, min=0.0) / t_norm,
                                max=1.0)
            delta = delta - t * torch.where(contact, scale, 0.0)[:, None]
    return P + delta


def picker_push_sequential(P, pickers, R, moving):
    """The substeps kernel's picker push: spheres applied one after the
    other, rsqrt form (picker_push, pallas_kernels.py:240-256).  P
    (B, 3, H, W); pickers (B, 2, 3), the two centres; R (B, 1, 1), radius
    + collision distance."""
    for k in range(2):
        c = pickers[:, k].reshape(-1, 3, 1, 1)
        d = P - c
        sq = dot3(d, d) + EPS
        r = torch.rsqrt(sq)
        pen = R - sq * r
        push = torch.where((pen > 0) & moving, pen * r, 0.0)
        P = P + d * push[:, None]
    return P
