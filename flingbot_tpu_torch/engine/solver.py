"""XPBD cloth step (counterpart of flingbot_tpu/engine/solver.py on its
pallas backend: Chebyshev-accelerated or plain Jacobi springs, sorted-window
contacts or none), for grid cloths and layered-lattice shirts.

Grid cloths: plain PyTorch functions on batched lattices, P (B, 3, H, W).
The hot loop runs in the two CUDA kernels of engine/kernels.py; the
functions here are the pieces of their plain versions and the glue between
launches.  One frame = `substeps` substeps in groups of `contact_every`.  A
group is one `kernels.substeps` launch (integrate -> springs + plane
iterations -> speed-up-only velocity clamp -> picker push, the last picker
push deferred), then one contact group: contacts -> plane -> velocity add
under the same clamp -> picker push (the pallas ordering of
_step_grid_pallas, solver.py:571-660).  Without self-collision, one
launch of all substeps.  With drag or lift set, one launch per substep
with the aero kick between launches (solver.py:617-644).

Layered shirts: flat state P (B, 3, N) on the layered lattice; the spring
solve gathers every offset class at once through a neighbour table, and
the contact groups run the contacts kernel in mesh mode (_step_layered,
solver.py:751-806).
"""

from __future__ import annotations

import numpy as np
import torch

from flingbot_tpu_torch.engine import aero, collisions, kernels
from flingbot_tpu_torch.engine.picker import (
    DEFAULT_PICKER_RADIUS as PICKER_RADIUS)
from flingbot_tpu_torch.engine.state import ClothState, SolverParams
from flingbot_tpu_torch.engine.topology import (
    GRID_STENCIL_CLASSES, GridTopology, LayeredGridTopology, lattice_valid,
    layered_neighbours, shift2d)

_EPS = 1e-9
CHEBYSHEV_DELAY = 2  # plain Jacobi warm-up iterations


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
    P (B, 3, ...); picker_pos (B, K, 3); R = radius + collision
    distance.  Every sphere pushes from the same P."""
    tail = (1,) * (P.dim() - 2)
    delta = torch.zeros_like(P)
    for k in range(picker_pos.shape[1]):
        d = P - picker_pos[:, k].view((-1, 3) + tail)
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


def _per_dt(dt, like: torch.Tensor):
    """dt as a 0-dim tensor on `like`'s device: a CUDA division by a host
    scalar multiplies by its reciprocal, which rounds unlike the CPU's (and
    the JAX package's) true division."""
    return torch.as_tensor(dt, dtype=torch.float32, device=like.device)


def add_delta_clamped(P, P2, V, dt, dv_max, moving):
    """Apply a projection P -> P2 with its velocity contribution under the
    speed-up-only clamp (_add_delta_clamped, solver.py:454).  dt: a float
    or a 0-dim tensor (see _per_dt)."""
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


def _aero_on(params: SolverParams) -> bool:
    """Drag / lift set: the aero pass runs (wind acts only through them)."""
    return params.drag != 0.0 or params.lift != 0.0


SPRING_MODES = ("chebyshev", "gs", "jacobi")


def step(state: ClothState, topo, params: SolverParams, *,
         substeps: int = 4, iterations: int = 16, contact_every: int = 2,
         contact_iterations: int = 4, contact_window: int = 12,
         spring_mode: str = "chebyshev",
         self_collision: bool = True) -> ClothState:
    """Advance every env one frame: dt split into `substeps` substeps of
    `iterations` spring iterations, self-collision every `contact_every`
    substeps (solver.step(backend="pallas", contact_mode="sort")).
    spring_mode "chebyshev" (or "gs", which the pallas backend maps to
    it) accelerates the Jacobi iterations; "jacobi" runs them plain
    (solver.py:593).  self_collision=False runs no contact group.
    Dispatches on the topology as solver.py:529-550 does: grid cloths,
    layered shirts."""
    if spring_mode not in SPRING_MODES:
        raise ValueError(f"unknown spring_mode {spring_mode!r}")
    if self_collision and substeps % contact_every:
        raise ValueError("substeps must be divisible by contact_every")
    kw = dict(substeps=substeps, iterations=iterations,
              contact_every=contact_every,
              contact_iterations=contact_iterations,
              contact_window=contact_window,
              cheb=spring_mode != "jacobi", self_collision=self_collision)
    if isinstance(topo, GridTopology):
        return _step_grid(state, topo, params, **kw)
    if isinstance(topo, LayeredGridTopology):
        return _step_layered(state, topo, params, **kw)
    raise TypeError(f"no solver step for {type(topo).__name__}")


def _step_grid(state, topo, params, *, substeps, iterations, contact_every,
               contact_iterations, contact_window, cheb, self_collision):
    """The grid step of _step_grid_pallas (solver.py:562-660).  Without
    aero: one fused `kernels.substeps` launch per group of `contact_every`
    substeps, the group's last picker push deferred past its contact
    group; without self-collision, one launch of all substeps with its
    last picker push (solver.py:646-657).  With drag or lift set
    (solver.py:617-644): one launch per substep, the aero kick on the
    post-gravity velocity applied between launches (the kernel integrates
    gravity and damping itself), and a contact group after every
    `contact_every`-th substep."""
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
    R = float(np.float32(PICKER_RADIUS) + np.float32(
        params.collision_distance))
    flat_valid = valid.reshape(B, -1)
    dt_t = _per_dt(dt_sub, P)

    def contacts(P, V, prevL):
        # contacts -> plane -> velocity add under the speed-up-only clamp
        # -> picker push (the kernel already clamped the spring phase)
        P2 = collisions.contact_group(
            P.reshape(B, 3, -1), prevL.reshape(B, 3, -1), w.reshape(B, -1),
            flat_valid, params, rest_dist=params.radius, lattice_w=W,
            window=contact_window,
            iterations=contact_iterations).view(B, 3, H, W)
        P2 = solve_plane(P2, prevL, params.collision_distance,
                         params.dynamic_friction, moving)
        P, V = add_delta_clamped(P, P2, V, dt_t, float(dv_max), moving)
        return solve_picker_spheres(P, state.picker_pos, R, moving), V

    if _aero_on(params):
        g_dt = dt_sub * torch.tensor(params.gravity, dtype=torch.float32,
                                     device=P.device).view(1, 3, 1, 1)
        for s in range(substeps):
            kick = aero.aero_accel(V + g_dt, aero.grid_normals(P, valid),
                                   params, moving)
            V = V + dt_sub * kick
            contact_now = self_collision and (s + 1) % contact_every == 0
            P, V, prevL = kernels.substeps(
                pvec, P.contiguous(), V.contiguous(), w, n_sub=1,
                iterations=iterations, cheb=cheb,
                picker_last=not contact_now)
            if contact_now:
                P, V = contacts(P, V, prevL)
    else:
        n_sub = contact_every if self_collision else substeps
        for _ in range(substeps // n_sub):
            P, V, prevL = kernels.substeps(
                pvec, P.contiguous(), V.contiguous(), w, n_sub=n_sub,
                iterations=iterations, cheb=cheb,
                picker_last=not self_collision)
            if self_collision:
                P, V = contacts(P, V, prevL)
    return state.replace(positions=P.reshape(B, 3, -1),
                         velocities=V.reshape(B, 3, -1))


# --------------------------------------------------------------------------
# layered shirts (_step_layered, solver.py:751-806)
# --------------------------------------------------------------------------

def layered_spring_planes(w, topo: LayeredGridTopology):
    """The per-frame constants of solve_springs_layered for inverse masses
    w (B, N): each class's rest, stiffness, neighbour mass, live mask and
    denominator, (B, K, N) each, with the topology's neighbour tables."""
    B, N = w.shape
    K = len(topo.offsets)
    nbr, nbr_ok, inv, inv_ok = layered_neighbours(topo.offsets, topo.H,
                                                  topo.W, w.device)
    stiff = topo.stiff.reshape(B, K, N)
    wb = torch.where(nbr_ok, w[:, nbr], 0.0)
    wsum = w[:, None] + wb
    # dB of class k lands on slot s from base inv[k, s]: an index into the
    # flattened (K * N) planes, with one zero column past the end for the
    # slots no class-k spring ends at
    k_base = torch.arange(K, device=w.device).view(K, 1) * N
    inv_flat = torch.where(inv_ok, inv + k_base, K * N).reshape(-1)
    return dict(nbr=nbr.reshape(-1), inv=inv_flat, stiff=stiff,
                rest=topo.rest.reshape(B, K, N), wb=wb,
                live=(stiff > 0) & (wsum > 0), den=wsum + _EPS,
                count=torch.clamp(topo.count.reshape(B, N), min=1.0))


def solve_springs_layered(P, w, planes, relax):
    """One Jacobi pass with local relaxation over the layered lattice
    (solve_springs_layered, solver.py:300-326).  P (B, 3, N); w (B, N);
    planes from layered_spring_planes.  All K classes are gathered at once
    through the neighbour table; each base slot keeps dA = w s d and its
    neighbour gets dB = -w_b s d through the inverse table.  The sum over
    classes runs in another order than the JAX loop's."""
    B, _, N = P.shape
    K = planes["stiff"].shape[1]
    d = P[:, :, planes["nbr"]].view(B, 3, K, N) - P[:, :, None]
    dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                      + d[:, 2] * d[:, 2] + _EPS)
    C = dist - planes["rest"]
    s = torch.where(planes["live"],
                    planes["stiff"] * C / (planes["den"] * dist), 0.0)
    dA = (w[:, None] * s)[:, None] * d
    dB = (-(planes["wb"] * s))[:, None] * d
    dB = torch.cat([dB.reshape(B, 3, K * N), dB.new_zeros(B, 3, 1)], 2)
    acc = dA.sum(2) + dB[:, :, planes["inv"]].view(B, 3, K, N).sum(2)
    return P + relax * acc / planes["count"][:, None]


def finalize_velocity(P, V, prev, dt, dv_max, moving):
    """Velocity finalize with the speed-up-only maxAcceleration clamp in the
    sqrt / divide form of _substep (solver.py:437-444); the substeps
    kernel's rsqrt form (clamp_finalize) rounds differently, and the clamp
    is discontinuous.  dt: a float or a 0-dim tensor (see _per_dt)."""
    V_new = (P - prev) / dt
    dv = V_new - V
    dv_norm = torch.sqrt(dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1]
                         + dv[:, 2] * dv[:, 2] + _EPS)
    speeding = (V_new[:, 0] * V_new[:, 0] + V_new[:, 1] * V_new[:, 1]
                + V_new[:, 2] * V_new[:, 2]
                > V[:, 0] * V[:, 0] + V[:, 1] * V[:, 1] + V[:, 2] * V[:, 2])
    scale = torch.where(speeding, torch.clamp(dv_max / dv_norm, max=1.0),
                        1.0)
    return torch.where(moving[:, None], V + dv * scale[:, None], V)


def _step_layered(state, topo, params, *, substeps, iterations,
                  contact_every, contact_iterations, contact_window, cheb,
                  self_collision):
    """Layered-lattice shirt step (_step_layered + _run_substeps +
    _substep, solver.py:395-487,751-806) on flat (B, 3, N) state.  Each
    substep: integrate -> springs + plane (Chebyshev, or plain Jacobi
    without cheb) -> velocity finalize -> (with self-collision, every
    `contact_every`-th substep) contact group in mesh mode -> plane ->
    velocity add under the clamp; then the picker push, after every
    substep (position only: picker_friction = 0, as in production)."""
    if _aero_on(params):
        # layered aero needs the mesh normals' scatter-add (aero.py:43-69),
        # which the port does not have yet
        raise NotImplementedError(
            "drag / lift on layered shirts: aero is ported for grid cloths "
            "only")
    if params.picker_friction != 0.0:
        # the JAX layered path applies picker friction against the
        # substep's entry positions (solver.py:486-487); the port has the
        # production push only
        raise NotImplementedError(
            "picker_friction on layered shirts is not ported")
    P, V = state.positions, state.velocities
    w = torch.where(state.active, state.inv_mass, 0.0)
    moving = state.active & (w > 0)
    mm = moving[:, None]
    f = np.float32
    dt = f(params.dt) / f(substeps)
    dv_max = f(params.max_acceleration) * dt
    damp = float(max(f(0.0), f(1.0) - f(params.damping) * dt))
    g_dt = dt * torch.tensor(params.gravity, dtype=torch.float32,
                             device=P.device).view(1, 3, 1)
    rho2 = f(params.chebyshev_rho) * f(params.chebyshev_rho) if cheb \
        else None
    R = float(f(PICKER_RADIUS) + f(params.collision_distance))
    planes = layered_spring_planes(w, topo)
    dt_t = _per_dt(dt, P)
    relax = float(f(params.relaxation_factor))
    for i in range(substeps):
        V = torch.where(mm, (V + g_dt) * damp, 0.0)
        prev = P
        P = torch.where(mm, P + float(dt) * V, P)
        P = spring_loop(
            P, lambda Q: solve_springs_layered(Q, w, planes, relax),
            iterations,
            lambda Q: solve_plane(Q, prev, params.collision_distance,
                                  params.dynamic_friction, moving), rho2)
        V = finalize_velocity(P, V, prev, dt_t, float(dv_max), moving)
        if self_collision and (i + 1) % contact_every == 0:
            P2 = collisions.contact_group(
                P, prev, w, state.active, params, rest_dist=params.radius,
                rest_positions=topo.rest_positions, window=contact_window,
                iterations=contact_iterations)
            P2 = solve_plane(P2, prev, params.collision_distance,
                             params.dynamic_friction, moving)
            P, V = add_delta_clamped(P, P2, V, dt_t, float(dv_max), moving)
        P = solve_picker_spheres(P, state.picker_pos, R, moving)
    return state.replace(positions=P, velocities=V)
