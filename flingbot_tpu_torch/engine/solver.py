"""XPBD grid-cloth step (counterpart of the grid path of
flingbot_tpu/engine/solver.py, production knobs: Chebyshev-accelerated
Jacobi springs, sorted-window contacts).

Plain PyTorch functions on batched lattices, P (B, 3, H, W).  The hot loop
runs in the two CUDA kernels of engine/kernels.py; the functions here are
the pieces of their plain versions and the glue between launches.

One frame = `substeps` substeps in groups of `contact_every`.  A group is
one `kernels.substeps` launch (integrate -> springs + plane iterations ->
speed-up-only velocity clamp -> picker push, the last picker push
deferred), then one contact group: contacts -> plane -> velocity add under
the same clamp -> picker push (the pallas ordering of _step_grid_pallas,
solver.py:571-660).
"""

from __future__ import annotations

import numpy as np
import torch

from flingbot_tpu_torch.engine import collisions, kernels
from flingbot_tpu_torch.engine.picker import (
    DEFAULT_PICKER_RADIUS as PICKER_RADIUS)
from flingbot_tpu_torch.engine.state import ClothState, SolverParams
from flingbot_tpu_torch.engine.topology import (
    GRID_STENCIL_CLASSES, GridTopology, lattice_valid)

_EPS = 1e-9
CHEBYSHEV_DELAY = 2  # plain Jacobi warm-up iterations


def shift2d(a: torch.Tensor, dy: int, dx: int, fill=0) -> torch.Tensor:
    """out[..., y, x] = a[..., y + dy, x + dx]; out of range -> fill."""
    H, W = a.shape[-2], a.shape[-1]
    out = torch.full_like(a, fill)
    if abs(dy) >= H or abs(dx) >= W:
        return out
    out[..., max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)] = \
        a[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)]
    return out


def _col(pvec: torch.Tensor, k: int) -> torch.Tensor:
    return pvec[:, k].view(-1, 1, 1)


# --------------------------------------------------------------------------
# springs (kernel formulation of _grid_jacobi, solver.py:178-201)
# --------------------------------------------------------------------------

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
        inv = stiff / (denom + _EPS)
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
        r = torch.rsqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                        + d[:, 2] * d[:, 2] + _EPS)
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


# --------------------------------------------------------------------------
# ground plane, picker spheres, velocity finalize
# --------------------------------------------------------------------------

def solve_plane(P, prev, coldist, mu, moving):
    """Ground plane y >= collision_distance with PBD Coulomb friction
    (solve_plane, solver.py:329).  P, prev (B, 3, ...); moving (B, ...)."""
    pen = coldist - P[:, 1]
    contact = (pen > 0) & moving
    dy = torch.where(contact, pen, 0.0)
    dx_ = P[:, 0] - prev[:, 0]
    dz_ = P[:, 2] - prev[:, 2]
    t_norm = torch.sqrt(dx_ * dx_ + dz_ * dz_ + _EPS)
    scale = torch.clamp(mu * torch.clamp(pen, min=0.0) / t_norm, max=1.0)
    f = torch.where(contact, scale, 0.0)
    return torch.stack([P[:, 0] - dx_ * f, P[:, 1] + dy, P[:, 2] - dz_ * f],
                       1)


def solve_picker_spheres(P, picker_pos, R, moving):
    """Push particles out of the gripper spheres, position only
    (solve_picker_spheres, solver.py:346; no picker friction).
    P (B, 3, H, W); picker_pos (B, K, 3); R = radius + collision
    distance.  Every sphere pushes from the same P."""
    delta = torch.zeros_like(P)
    for k in range(picker_pos.shape[1]):
        d = P - picker_pos[:, k].view(-1, 3, 1, 1)
        dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                          + d[:, 2] * d[:, 2] + _EPS)
        pen = R - dist
        push = torch.where((pen > 0) & moving, pen / dist, 0.0)
        delta = delta + d * push[:, None]
    return P + delta


def picker_push_sequential(P, pvec, moving):
    """The substeps kernel's picker push: spheres applied one after the
    other, rsqrt form (picker_push, pallas_kernels.py:240-256)."""
    R = _col(pvec, 12)
    for k in range(2):
        c = pvec[:, 14 + 3 * k:17 + 3 * k].reshape(-1, 3, 1, 1)
        d = P - c
        sq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] + _EPS
        r = torch.rsqrt(sq)
        pen = R - sq * r
        push = torch.where((pen > 0) & moving, pen * r, 0.0)
        P = P + d * push[:, None]
    return P


def integrate(P, V, dt, gravity_y, damping, moving):
    """Gravity + damping on moving particles, then predict positions.
    P, V (B, 3, H, W); dt, gravity_y, damping (B, 1, 1).  Returns
    (P, V, prev)."""
    mm = moving[:, None]
    V = torch.stack([V[:, 0], V[:, 1] + dt * gravity_y, V[:, 2]], 1)
    V = V * torch.clamp(1.0 - damping * dt, min=0.0)[:, None]
    V = torch.where(mm, V, 0.0)
    return torch.where(mm, P + dt[:, None] * V, P), V, P


def clamp_finalize(P, V, prev, dt, a_max, moving):
    """Velocity finalize with the speed-up-only maxAcceleration clamp
    (solver.py:409-437, rsqrt form of the substeps kernel): only
    speed-increasing changes are capped.  dt, a_max (B, 1, 1)."""
    V_new = (P - prev) / dt[:, None]
    dv = V_new - V
    r = torch.rsqrt(dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1]
                    + dv[:, 2] * dv[:, 2] + _EPS)
    speeding = (V_new[:, 0] * V_new[:, 0] + V_new[:, 1] * V_new[:, 1]
                + V_new[:, 2] * V_new[:, 2]
                > V[:, 0] * V[:, 0] + V[:, 1] * V[:, 1] + V[:, 2] * V[:, 2])
    sc = torch.where(speeding, torch.clamp(a_max * dt * r, max=1.0), 1.0)
    return torch.where(moving[:, None], V + dv * sc[:, None], V)


def add_delta_clamped(P, P2, V, dt, dv_max, moving):
    """Apply a projection P -> P2 with its velocity contribution under the
    speed-up-only clamp (_add_delta_clamped, solver.py:454)."""
    dv = (P2 - P) / dt
    V_new = V + dv
    dv_norm = torch.sqrt(dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1]
                         + dv[:, 2] * dv[:, 2] + _EPS)
    speeding = (V_new[:, 0] * V_new[:, 0] + V_new[:, 1] * V_new[:, 1]
                + V_new[:, 2] * V_new[:, 2]
                > V[:, 0] * V[:, 0] + V[:, 1] * V[:, 1] + V[:, 2] * V[:, 2])
    scale = torch.where(speeding, torch.clamp(dv_max / dv_norm, max=1.0),
                        1.0)
    return P2, torch.where(moving[:, None], V + dv * scale[:, None], V)


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

def pack_sub_params(params: SolverParams, topo: GridTopology,
                    picker_pos: torch.Tensor, picker_radius: float,
                    dt_sub) -> torch.Tensor:
    """SolverParams + topology + pickers -> (B, 21) f32 kernel parameters
    (layout of pack_sub_params, pallas_kernels.py:70-75,332-353)."""
    B = topo.batch
    f = np.float32
    rho = f(params.chebyshev_rho)
    scal = [f(dt_sub), f(params.gravity[1]), f(params.damping),
            f(params.dynamic_friction), f(params.collision_distance),
            f(params.relaxation_factor), f(topo.spacing)]
    head = torch.tensor(scal, dtype=torch.float32, device=picker_pos.device)
    tail = torch.tensor(
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


def step(state: ClothState, topo: GridTopology, params: SolverParams, *,
         substeps: int = 4, iterations: int = 16, contact_every: int = 2,
         contact_iterations: int = 4,
         contact_window: int = 12) -> ClothState:
    """Advance every env one frame (dt split into `substeps` substeps of
    `iterations` Chebyshev iterations, self-collision every
    `contact_every` substeps): the production grid step of
    solver.step(backend="pallas", spring_mode="chebyshev")."""
    B, H, W = state.batch, topo.max_dimy, topo.max_dimx
    P = state.positions.view(B, 3, H, W)
    V = state.velocities.view(B, 3, H, W)
    valid = lattice_valid(topo.dimx, topo.dimy, H, W)
    w = torch.where(valid, state.inv_mass.view(B, H, W), 0.0).contiguous()
    moving = valid & (w > 0)
    dt_sub = np.float32(params.dt) / np.float32(substeps)
    dv_max = np.float32(params.max_acceleration) * dt_sub
    pvec = pack_sub_params(params, topo, state.picker_pos, PICKER_RADIUS,
                           dt_sub)
    assert substeps % contact_every == 0, \
        "substeps must be divisible by contact_every"
    R = float(np.float32(PICKER_RADIUS) + np.float32(
        params.collision_distance))
    flat_valid = valid.reshape(B, -1)
    for _ in range(substeps // contact_every):
        P, V, prevL = kernels.substeps(
            pvec, P.contiguous(), V.contiguous(), w, n_sub=contact_every,
            iterations=iterations, picker_last=False)
        P2 = collisions.contact_group(
            P.reshape(B, 3, -1), prevL.reshape(B, 3, -1), w.reshape(B, -1),
            flat_valid, params, rest_dist=params.radius, lattice_w=W,
            window=contact_window,
            iterations=contact_iterations).view(B, 3, H, W)
        P2 = solve_plane(P2, prevL, params.collision_distance,
                         params.dynamic_friction, moving)
        P, V = add_delta_clamped(P, P2, V, float(dt_sub), float(dv_max),
                                 moving)
        P = solve_picker_spheres(P, state.picker_pos, R, moving)
    return state.replace(positions=P.reshape(B, 3, -1),
                         velocities=V.reshape(B, 3, -1))
