"""XPBD cloth step (counterpart of flingbot_tpu/engine/solver.py): grid
cloths, layered-lattice shirts and generic meshes, on the pallas backend
(the port's CUDA kernels) or the xla backend (plain PyTorch).

Grid cloths, pallas backend: batched lattices, P (B, 3, H, W).  The hot
loop runs in the CUDA kernels of engine/kernels.py, which owns their
parameter blocks; this module holds the glue between launches.  The plain
pieces that both the kernels' plain versions and the substep loop below
are built from are in engine/constraints.py.  One frame = `substeps` substeps
in groups of `contact_every`.  A group is one `kernels.substeps` launch
(integrate -> springs + plane iterations -> speed-up-only velocity clamp
-> picker push, the last picker push deferred), then one contact group:
the Morton sort (`kernels.contact_keys`, torch.sort,
`kernels.contact_gather`), the contacts kernel, and one
`kernels.contact_apply` launch (scatter back -> plane -> velocity add
under the same clamp -> picker push; the pallas ordering of
_step_grid_pallas, solver.py:571-660).  Without self-collision, one
launch of all substeps.
With drag or lift set, one launch per substep with the aero kick between
launches (solver.py:617-644).

Every other step is the substep loop of _run_substeps / _substep
(solver.py:395-491) in plain PyTorch: gravity -> aero -> damping ->
predict -> spring iterations with the plane -> velocity finalize under
the clamp -> (every `contact_every`-th substep) a contact pass -> plane ->
velocity add under the clamp -> picker push with friction against the
substep's entry positions.
  * layered shirts (_step_layered, solver.py:751-806): flat state
    (B, 3, N) on the layered lattice, every offset class gathered at once;
    the contact group runs the contacts kernel in mesh mode (pallas) or
    its plain version (xla);
  * generic meshes (_step_mesh, solver.py:809-885): the vertex-centric
    incidence tables of a MeshTopology; any contact mode;
  * grid cloths on the xla backend (_step_grid, solver.py:687-748): the
    six stencil classes as shifted lattices, 2-colour Gauss-Seidel for
    spring_mode "gs", Jacobi for "jacobi" and "chebyshev"; any contact
    mode.  The xla backend is the plain counterpart of the JAX package's
    kernel-free backend: it launches no kernel on any device.
Springs are Chebyshev-accelerated for "chebyshev", and on meshes and
layered shirts for "gs" too (solver.py:737, 800, 878).

Spans (utils/trace.py, recorded while tracing is on): every step is one
solver.step; inside it the grid step on the pallas backend records
solver.prep, solver.substeps (each launch), and per contact group
solver.contacts.sort, .project and .apply (the contact_apply launch);
the other paths' contact groups record the same three, .apply around
the scatter back.  The per-frame constants come from
state.device_constant: a frame records a counted solver.sync
(trace.upload) only for a value this process has not uploaded before.
"""

from __future__ import annotations

import numpy as np
import torch

from flingbot_tpu_torch.engine import aero, collisions, kernels
from flingbot_tpu_torch.engine.constraints import (
    EPS, add_delta_clamped, dot3, finalize_velocity, solve_picker_spheres,
    solve_plane, spring_loop)
from flingbot_tpu_torch.engine.picker import (
    DEFAULT_PICKER_RADIUS as PICKER_RADIUS)
from flingbot_tpu_torch.engine.state import (
    ClothState, SolverParams, device_constant, f32)
from flingbot_tpu_torch.engine.topology import (
    GRID_STENCIL_CLASSES, GridTopology, LayeredGridTopology, MeshTopology,
    lattice_valid, layered_neighbours, shift2d)
from flingbot_tpu_torch.utils import trace


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

def _aero_on(params: SolverParams) -> bool:
    """Drag / lift set: the aero pass runs (wind acts only through them)."""
    return params.drag != 0.0 or params.lift != 0.0


SPRING_MODES = ("chebyshev", "gs", "jacobi")
CONTACT_MODES = ("sort", "sweep", "block", "table")
BACKENDS = ("pallas", "xla")


def step(state: ClothState, topo, params: SolverParams, *,
         substeps: int = 4, iterations: int = 16, contact_every: int = 2,
         contact_iterations: int = 4, contact_window: int = 12,
         spring_mode: str = "chebyshev", self_collision: bool = True,
         backend: str = "pallas", contact_mode: str = "sort",
         resort_interval: int = 4) -> ClothState:
    """Advance every env one frame: dt split into `substeps` substeps of
    `iterations` spring iterations, self-collision after every
    `contact_every`-th substep (solver.step, solver.py:494-548, with the
    production knobs as defaults: backend "pallas", contact_mode "sort").
    spring_mode "chebyshev" accelerates the Jacobi iterations, "jacobi"
    runs them plain, and "gs" is Chebyshev on the pallas backend, on
    meshes and on layered shirts, and 2-colour Gauss-Seidel on grids on
    the xla backend.  contact_mode: "sort" (a fresh Morton sort per
    contact pass; the only mode of the pallas grid step and of layered
    shirts), "sweep" / "block" (a Morton order cached in the state and
    re-sorted where step_count % resort_interval == 0) or "table" (a
    hash-grid neighbour table).  self_collision=False runs no contact
    pass.  Dispatches on the topology; every env's time and step_count
    advance."""
    if spring_mode not in SPRING_MODES:
        raise ValueError(f"unknown spring_mode {spring_mode!r}")
    if contact_mode not in CONTACT_MODES:
        raise ValueError(f"unknown contact_mode {contact_mode!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    kw = dict(substeps=substeps, iterations=iterations,
              contact_every=contact_every,
              contact_iterations=contact_iterations,
              contact_window=contact_window, self_collision=self_collision)
    with trace.span("solver.step"):
        if isinstance(topo, GridTopology) and backend == "pallas":
            if self_collision and substeps % contact_every:
                raise ValueError("substeps must be divisible by contact_every")
            out = _step_grid(state, topo, params, cheb=spring_mode != "jacobi",
                             **kw)
        elif isinstance(topo, GridTopology):
            out = _step_grid_xla(state, topo, params, spring_mode=spring_mode,
                                 contact_mode=contact_mode,
                                 resort_interval=resort_interval, **kw)
        elif isinstance(topo, LayeredGridTopology):
            if self_collision and contact_mode != "sort":
                raise ValueError("layered topology supports "
                                 "contact_mode='sort' only (got "
                                 f"{contact_mode!r})")
            out = _step_layered(state, topo, params, spring_mode=spring_mode,
                                backend=backend, **kw)
        elif isinstance(topo, MeshTopology):
            out = _step_mesh(state, topo, params, spring_mode=spring_mode,
                             backend=backend, contact_mode=contact_mode,
                             resort_interval=resort_interval, **kw)
        else:
            raise TypeError(f"no solver step for {type(topo).__name__}")
        return out.replace(time=state.time + f32(params.dt),
                           step_count=state.step_count + 1)


def _step_grid(state, topo, params, *, substeps, iterations, contact_every,
               contact_iterations, contact_window, cheb, self_collision):
    """The grid step of _step_grid_pallas (solver.py:562-660).  Without
    aero: one fused `kernels.substeps` launch per group of `contact_every`
    substeps, the group's last picker push deferred past its contact
    group, whose epilogue is one `kernels.contact_apply` launch; without
    self-collision, one launch of all substeps with its last picker push
    (solver.py:646-657).  With drag or lift set
    (solver.py:617-644): one launch per substep, the aero kick on the
    post-gravity velocity applied between launches (the kernel integrates
    gravity and damping itself), and a contact group after every
    `contact_every`-th substep."""
    B, H, W = state.batch, topo.max_dimy, topo.max_dimx
    P = state.positions.view(B, 3, H, W)
    V = state.velocities.view(B, 3, H, W)
    with trace.span("solver.prep"):
        valid = lattice_valid(topo.dimx, topo.dimy, H, W)
        w = torch.where(valid, state.inv_mass.view(B, H, W),
                        0.0).contiguous()
        moving = valid & (w > 0)
        dt_sub = np.float32(params.dt) / np.float32(substeps)
        pvec = kernels.pack_sub_params(params, topo, state.picker_pos,
                                       PICKER_RADIUS, dt_sub)
        flat_valid = valid.reshape(B, -1)

    def contacts(P, V, prevL):
        # contacts -> (one epilogue kernel) scatter back, plane, velocity
        # add under the speed-up-only clamp, picker push (the substeps
        # kernel already clamped the spring phase)
        order, srt, out = collisions.sort_and_project(
            P.reshape(B, 3, -1), prevL.reshape(B, 3, -1), w.reshape(B, -1),
            flat_valid, params, rest_dist=params.radius, lattice_w=W,
            window=contact_window, iterations=contact_iterations)
        with trace.span("solver.contacts.apply"):
            P, V = kernels.contact_apply(pvec, order, srt, out,
                                         V.reshape(B, 3, -1))
            return P.view(B, 3, H, W), V.view(B, 3, H, W)

    if _aero_on(params):
        g_dt = dt_sub * device_constant(params.gravity, dtype=torch.float32,
                                        device=P.device).view(1, 3, 1, 1)
        for s in range(substeps):
            kick = aero.aero_accel(V + g_dt, aero.grid_normals(P, valid),
                                   params, moving)
            V = V + dt_sub * kick
            contact_now = self_collision and (s + 1) % contact_every == 0
            with trace.span("solver.substeps"):
                P, V, prevL = kernels.substeps(
                    pvec, P.contiguous(), V.contiguous(), w, n_sub=1,
                    iterations=iterations, cheb=cheb,
                    picker_last=not contact_now)
            if contact_now:
                P, V = contacts(P, V, prevL)
    else:
        n_sub = contact_every if self_collision else substeps
        for _ in range(substeps // n_sub):
            with trace.span("solver.substeps"):
                P, V, prevL = kernels.substeps(
                    pvec, P.contiguous(), V.contiguous(), w, n_sub=n_sub,
                    iterations=iterations, cheb=cheb,
                    picker_last=not self_collision)
            if self_collision:
                P, V = contacts(P, V, prevL)
    return state.replace(positions=P.reshape(B, 3, -1),
                         velocities=V.reshape(B, 3, -1))


# --------------------------------------------------------------------------
# the substep loop of the xla backend, layered shirts and meshes
# (_substep / _run_substeps, solver.py:395-491)
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
                live=(stiff > 0) & (wsum > 0), den=wsum + EPS,
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
    dist = torch.sqrt(dot3(d, d) + EPS)
    C = dist - planes["rest"]
    s = torch.where(planes["live"],
                    planes["stiff"] * C / (planes["den"] * dist), 0.0)
    dA = (w[:, None] * s)[:, None] * d
    dB = (-(planes["wb"] * s))[:, None] * d
    dB = torch.cat([dB.reshape(B, 3, K * N), dB.new_zeros(B, 3, 1)], 2)
    acc = dA.sum(2) + dB[:, :, planes["inv"]].view(B, 3, K, N).sum(2)
    return P + relax * acc / planes["count"][:, None]


def _per_dt(dt, like: torch.Tensor):
    """dt as a 0-dim tensor on `like`'s device: a CUDA division by a host
    scalar multiplies by its reciprocal, which rounds unlike the CPU's (and
    the JAX package's) true division."""
    return device_constant(dt, dtype=torch.float32, device=like.device)


def _run_substeps(P, V, w, moving, params: SolverParams, picker_pos, *,
                  substeps, iterations, solve_fn, contact_fn, contact_every,
                  chebyshev, normals_fn=None):
    """`substeps` XPBD substeps on P, V (B, 3, ...) with inverse masses and
    the moving mask (B, ...).  Each: gravity, the aero kick (normals_fn)
    on the post-gravity velocity, damping, predict; `iterations` spring
    passes solve_fn, each followed by the plane (Chebyshev-accelerated
    with `chebyshev`); velocity finalize under the speed-up-only clamp;
    after every contact_every-th substep, contact_fn(P, prev) -> plane ->
    velocity add under the same clamp; then the picker push with picker
    friction against the substep's entry positions."""
    mm = moving[:, None]
    dt = f32(params.dt) / np.float32(substeps)
    dv_max = float(np.float32(params.max_acceleration) * dt)
    damp = float(max(np.float32(0.0), np.float32(1.0)
                     - np.float32(params.damping) * dt))
    g_dt = dt * device_constant(params.gravity, dtype=torch.float32,
                                device=P.device).view(
                                    (1, 3) + (1,) * (P.dim() - 2))
    rho2 = np.float32(params.chebyshev_rho) * np.float32(
        params.chebyshev_rho) if chebyshev else None
    R = float(np.float32(PICKER_RADIUS) + np.float32(
        params.collision_distance))
    dt_t = _per_dt(dt, P)

    def plane(Q, prev):
        return solve_plane(Q, prev, params.collision_distance,
                           params.dynamic_friction, moving)

    for i in range(substeps):
        P_in = P
        V = V + g_dt
        if normals_fn is not None:
            V = V + float(dt) * aero.aero_accel(V, normals_fn(P), params,
                                                moving)
        V = torch.where(mm, V * damp, 0.0)
        prev = P
        P = torch.where(mm, P + float(dt) * V, P)
        P = spring_loop(P, solve_fn, iterations,
                        lambda Q: plane(Q, prev), rho2)
        V = finalize_velocity(P, V, prev, dt_t, dv_max, moving)
        if contact_fn is not None and (i + 1) % contact_every == 0:
            P2 = plane(contact_fn(P, prev), prev)
            P, V = add_delta_clamped(P, P2, V, dt_t, dv_max, moving)
        P = solve_picker_spheres(P, picker_pos, R, moving, prev=P_in,
                                 mu=params.picker_friction)
    return P, V


def cached_sweep_order(state: ClothState, P, participate, radius,
                       resort_interval: int):
    """The Morton order of the sweep and block modes, re-sorted per env
    (_cached_sweep_order, solver.py:553-568): envs whose step_count is a
    multiple of resort_interval take the fresh order of P (B, 3, N), the
    others keep the one cached in the state."""
    perm, inv = collisions.sweep_order(P, participate, radius)
    need = (state.step_count % resort_interval == 0)[:, None]
    return (torch.where(need, perm, state.sweep_perm),
            torch.where(need, inv, state.sweep_inv))


def _cached_contacts(state, P, w, moving, participate, params, mode,
                     contact_iterations, resort_interval, lattice_w=None,
                     rest_positions=None):
    """The contact pass of the sweep and block modes on flat (B, 3, N)
    arrays, over the step's cached Morton order.  Returns (contact_fn,
    perm, inv_perm)."""
    perm, inv = cached_sweep_order(state, P, participate, params.radius,
                                   resort_interval)
    rest_sorted = None if rest_positions is None else \
        collisions._take(rest_positions, perm)
    if mode == "block":
        ctx = collisions.BlockContactContext(
            perm, inv, w, participate, moving, params, params.radius,
            lattice_w=lattice_w, rest_sorted=rest_sorted)
        return (lambda Q, prev: collisions.solve_contacts_block(
            Q, w, moving, perm, inv, params, rest_dist=params.radius,
            prev=prev, iterations=contact_iterations, ctx=ctx)), perm, inv
    return (lambda Q, prev: collisions.solve_contacts_sweep(
        Q, w, moving, perm, inv, params, rest_dist=params.radius,
        lattice_w=lattice_w, rest_sorted=rest_sorted, active=participate,
        prev=prev)), perm, inv


def _sorted_mesh_contacts(state, topo, params, w, window, iterations,
                          backend):
    """The sorted contact group in mesh mode (rest-pose filter against
    topo.rest_positions) of the layered and generic mesh steps, as a
    contact_fn(Q, prev) of _run_substeps."""
    def contact_fn(Q, prev):
        return collisions.contact_group(
            Q, prev, w, state.active, params, rest_dist=params.radius,
            rest_positions=topo.rest_positions, window=window,
            iterations=iterations, backend=backend)
    return contact_fn


def _mesh_normals_fn(state, topo, params):
    """normals_fn(Q) of _run_substeps through the mesh normals of topo's
    triangles, or None where the aero pass is off."""
    if not _aero_on(params):
        return None
    return lambda Q: aero.mesh_normals(Q, topo.triangles, topo.tri_mask,
                                       state.active, topo.vert_tri,
                                       topo.vert_tri_mask)


# --------------------------------------------------------------------------
# layered shirts (_step_layered, solver.py:751-806)
# --------------------------------------------------------------------------

def _step_layered(state, topo, params, *, substeps, iterations,
                  contact_every, contact_iterations, contact_window,
                  spring_mode, self_collision, backend):
    """Layered-lattice shirt step on flat (B, 3, N) state: the stencil
    springs of solve_springs_layered in the substep loop, the sorted
    contact group in mesh mode (the contacts kernel on the pallas backend,
    its plain version on the xla one), the aero kick through the mesh
    normals of the layered triangles, picker friction."""
    w = torch.where(state.active, state.inv_mass, 0.0)
    moving = state.active & (w > 0)
    planes = layered_spring_planes(w, topo)
    relax = float(f32(params.relaxation_factor))
    contact_fn = _sorted_mesh_contacts(
        state, topo, params, w, contact_window, contact_iterations,
        backend) if self_collision else None
    P, V = _run_substeps(
        state.positions, state.velocities, w, moving, params,
        state.picker_pos, substeps=substeps, iterations=iterations,
        solve_fn=lambda Q: solve_springs_layered(Q, w, planes, relax),
        contact_fn=contact_fn, contact_every=contact_every,
        chebyshev=spring_mode != "jacobi",
        normals_fn=_mesh_normals_fn(state, topo, params))
    return state.replace(positions=P, velocities=V)


# --------------------------------------------------------------------------
# generic meshes (_step_mesh, solver.py:809-885)
# --------------------------------------------------------------------------

def solve_springs_mesh(P, w, topo: MeshTopology, relax):
    """One Jacobi pass with local relaxation over a mesh's springs, vertex
    by vertex (solve_springs_mesh, solver.py:276-297): every vertex pulls
    its <= D incident neighbours through the incidence tables and sums its
    own corrections; the sum divides by its degree.  P (B, 3, N); w
    (B, N)."""
    B, _, N = P.shape
    D = topo.nbr_idx.shape[1]
    flat = topo.nbr_idx.reshape(B, 1, D * N)
    pn = torch.gather(P, 2, flat.expand(B, 3, D * N)).view(B, 3, D, N)
    wn = torch.gather(w, 1, flat[:, 0]).view(B, D, N)
    d = pn - P[:, :, None]
    dist = torch.sqrt(dot3(d, d) + EPS)
    C = dist - topo.nbr_rest
    wsum = w[:, None] + wn
    s = torch.where(topo.nbr_mask & (wsum > 0),
                    topo.nbr_stiff * C / ((wsum + EPS) * dist), 0.0)
    acc = ((w[:, None] * s)[:, None] * d).sum(2)
    return P + relax * acc / torch.clamp(topo.degree, min=1.0)[:, None]


def _step_mesh(state, topo, params, *, substeps, iterations, contact_every,
               contact_iterations, contact_window, spring_mode,
               self_collision, backend, contact_mode, resort_interval):
    """Generic-mesh step on (B, 3, N) state in mesh vertex order: the
    springs of solve_springs_mesh in the substep loop, contacts of any
    mode with the rest-pose SelfCollideFilter (sort: the contacts kernel's
    mesh mode on the pallas backend, its plain version on the xla one),
    the aero kick through mesh_normals, picker friction."""
    P = state.positions
    w = torch.where(state.active, state.inv_mass, 0.0)
    moving = state.active & (w > 0)
    relax = float(f32(params.relaxation_factor))
    contact_fn = perm = inv = None
    if self_collision and contact_mode == "sort":
        contact_fn = _sorted_mesh_contacts(
            state, topo, params, w, contact_window, contact_iterations,
            backend)
    elif self_collision and contact_mode in ("sweep", "block"):
        contact_fn, perm, inv = _cached_contacts(
            state, P, w, moving, state.active, params, contact_mode,
            contact_iterations, resort_interval,
            rest_positions=topo.rest_positions)
    elif self_collision:
        nbr, mask = collisions.find_neighbors_hash(
            P, moving, params.radius, topo.rest_positions)

        def contact_fn(Q, prev):
            return collisions.solve_contacts(Q, w, moving, nbr, mask,
                                             rest_dist=params.radius)
    P, V = _run_substeps(
        P, state.velocities, w, moving, params, state.picker_pos,
        substeps=substeps, iterations=iterations,
        solve_fn=lambda Q: solve_springs_mesh(Q, w, topo, relax),
        contact_fn=contact_fn, contact_every=contact_every,
        chebyshev=spring_mode != "jacobi",
        normals_fn=_mesh_normals_fn(state, topo, params))
    out = state.replace(positions=P, velocities=V)
    if perm is not None:
        out = out.replace(sweep_perm=perm, sweep_inv=inv)
    return out


# --------------------------------------------------------------------------
# grid cloths on the xla backend (_step_grid, solver.py:687-748)
# --------------------------------------------------------------------------

def _grid_class_terms(P, w, valid, dy, dx, rest, stiff):
    """(d, s-numerator C, wsum, pair_ok) of one stencil class: the pairs
    (y, x) - (y + dy, x + dx) inside the cloth."""
    Pb = shift2d(P, dy, dx)
    wb = shift2d(w, dy, dx)
    pair_ok = valid & shift2d(valid, dy, dx, fill=False)
    d = Pb - P
    dist = torch.sqrt(dot3(d, d) + EPS)
    return d, dist, dist - rest, w + wb, wb, pair_ok


def _class_constants(topo: GridTopology, cls: int, rest_k: float):
    """(rest length, per-env stiffness (B, 1, 1)) of a stencil class."""
    stiff = topo.stiffness[:, cls].view(-1, 1, 1)
    return f32(f32(topo.spacing) * f32(rest_k)), stiff


def grid_phase(P, w, valid, dy, dx, color, rest, stiff, relax):
    """One coloured Gauss-Seidel phase of one stencil class (_grid_phase,
    solver.py:143-175): the constraints whose start slot has parity
    `color` (by x for (0, 1), by y for (1, 0) and the diagonals, by x // 2
    and y // 2 for the bends) touch no particle twice, so both endpoint
    updates apply at once."""
    H, W = P.shape[-2], P.shape[-1]
    iy = torch.arange(H, device=P.device).view(1, H, 1)
    ix = torch.arange(W, device=P.device).view(1, 1, W)
    if (dy, dx) == (0, 1):
        sel = (ix % 2) == color
    elif (dy, dx) == (1, 0):
        sel = (iy % 2) == color
    elif (dy, dx) == (0, 2):
        sel = ((ix // 2) % 2) == color
    elif (dy, dx) == (2, 0):
        sel = ((iy // 2) % 2) == color
    else:  # the diagonals (1, 1) and (1, -1)
        sel = (iy % 2) == color
    d, dist, C, wsum, wb, pair_ok = _grid_class_terms(P, w, valid, dy, dx,
                                                      rest, stiff)
    s = torch.where(sel & pair_ok & (wsum > 0),
                    relax * stiff * C / ((wsum + EPS) * dist), 0.0)
    dA = (w * s)[:, None] * d
    dB = (-(wb * s))[:, None] * d
    return P + dA + shift2d(dB, -dy, -dx)


def grid_jacobi_xla(P, w, valid, topo: GridTopology, relax):
    """All six stencil classes from the same P, summed and divided by each
    particle's constraint count (_grid_jacobi, solver.py:178-201)."""
    acc = torch.zeros_like(P)
    count = torch.zeros_like(w)
    for dy, dx, rest_k, cls in GRID_STENCIL_CLASSES:
        rest, stiff = _class_constants(topo, cls, rest_k)
        d, dist, C, wsum, wb, pair_ok = _grid_class_terms(
            P, w, valid, dy, dx, rest, stiff)
        s = torch.where(pair_ok & (wsum > 0),
                        stiff * C / ((wsum + EPS) * dist), 0.0)
        dA = (w * s)[:, None] * d
        dB = (-(wb * s))[:, None] * d
        acc = acc + dA + shift2d(dB, -dy, -dx)
        cnt = pair_ok.to(P.dtype)
        count = count + cnt + shift2d(cnt, -dy, -dx)
    return P + relax * acc / torch.clamp(count, min=1.0)[:, None]


def solve_springs_grid(P, w, valid, topo: GridTopology, relax,
                       mode: str):
    """One spring pass of the xla grid step (solve_springs_grid,
    solver.py:204-214): "gs" runs every class's two colour phases in
    class order, each against the positions the previous phase left;
    "jacobi" and "chebyshev" run grid_jacobi_xla."""
    if mode in ("jacobi", "chebyshev"):
        return grid_jacobi_xla(P, w, valid, topo, relax)
    for dy, dx, rest_k, cls in GRID_STENCIL_CLASSES:
        rest, stiff = _class_constants(topo, cls, rest_k)
        for color in (0, 1):
            P = grid_phase(P, w, valid, dy, dx, color, rest, stiff, relax)
    return P


def _step_grid_xla(state, topo, params, *, substeps, iterations,
                   contact_every, contact_iterations, contact_window,
                   spring_mode, self_collision, contact_mode,
                   resort_interval):
    """Grid step of the xla backend on lattices P (B, 3, H, W): the
    stencil springs of solve_springs_grid (Chebyshev only for
    spring_mode "chebyshev", solver.py:737) in the substep loop, contacts
    of any mode with the lattice-neighbour filter, the aero kick through
    grid_normals, picker friction."""
    B, H, W = state.batch, topo.max_dimy, topo.max_dimx
    N = H * W
    P = state.positions.view(B, 3, H, W)
    valid = lattice_valid(topo.dimx, topo.dimy, H, W)
    w = torch.where(valid, state.inv_mass.view(B, H, W), 0.0)
    moving = valid & (w > 0)
    flat_valid = valid.reshape(B, N)
    flat_w, flat_moving = w.reshape(B, N), moving.reshape(B, N)
    relax = float(f32(params.relaxation_factor))
    contact_fn = perm = inv = None
    if self_collision and contact_mode == "sort":
        def contact_fn(Q, prev):
            return collisions.contact_group(
                Q.reshape(B, 3, N), prev.reshape(B, 3, N), flat_w,
                flat_valid, params, rest_dist=params.radius, lattice_w=W,
                window=contact_window, iterations=contact_iterations,
                backend="xla").view(B, 3, H, W)
    elif self_collision and contact_mode in ("sweep", "block"):
        flat_fn, perm, inv = _cached_contacts(
            state, state.positions, flat_w, flat_moving, flat_valid, params,
            contact_mode, contact_iterations, resort_interval, lattice_w=W)

        def contact_fn(Q, prev):
            return flat_fn(Q.reshape(B, 3, N),
                           prev.reshape(B, 3, N)).view(B, 3, H, W)
    elif self_collision:
        nbr, mask = collisions.find_neighbors_grid(
            state.positions, flat_moving, W, params.radius)

        def contact_fn(Q, prev):
            return collisions.solve_contacts(
                Q.reshape(B, 3, N), flat_w, flat_moving, nbr, mask,
                rest_dist=params.radius).view(B, 3, H, W)
    normals_fn = None
    if _aero_on(params):
        def normals_fn(Q):
            return aero.grid_normals(Q, valid)
    P, V = _run_substeps(
        P, state.velocities.view(B, 3, H, W), w, moving, params,
        state.picker_pos, substeps=substeps, iterations=iterations,
        solve_fn=lambda Q: solve_springs_grid(Q, w, valid, topo, relax,
                                              spring_mode),
        contact_fn=contact_fn, contact_every=contact_every,
        chebyshev=spring_mode == "chebyshev", normals_fn=normals_fn)
    out = state.replace(positions=P.reshape(B, 3, N),
                        velocities=V.reshape(B, 3, N))
    if perm is not None:
        out = out.replace(sweep_perm=perm, sweep_inv=inv)
    return out
