"""Scene construction: task arrays -> batched (GridTopology, ClothState)
(counterpart of the grid path of flingbot_tpu/env/scene.py), and a seeded
lift-and-drop crumple that makes start states without task files.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.engine.picker import (
    picker_step, release_all, set_picker_positions)
from flingbot_tpu_torch.engine.solver import step as solver_step
from flingbot_tpu_torch.engine.state import (
    MAX_GRID_DIM, NUM_PICKERS, PARTICLE_RADIUS, ClothState, SolverParams)
from flingbot_tpu_torch.engine.topology import (
    GridTopology, build_grid_topology, grid_positions)

DEFAULT_STIFFNESS = (0.8, 1.0, 0.9)  # (stretch, bend, shear), scene default
PARK_PICKERS = ((0.5, 0.5, -0.5), (-0.5, 0.5, -0.5))


@dataclasses.dataclass
class Task:
    """The arrays of one grid-cloth task that a scene needs (the fields of
    flingbot_tpu.env.tasks.Task read by set_scene)."""

    cloth_size: Sequence[int]
    particle_pos: Optional[np.ndarray] = None  # (n*4,) x y z invMass
    particle_vel: Optional[np.ndarray] = None  # (n*3,)
    cloth_mass: float = 0.5
    cloth_stiff: Sequence[float] = DEFAULT_STIFFNESS
    cloth_pos: Sequence[float] = (0.0, 2.0, 0.0)


def _to_lattice(x: np.ndarray, dimx: int, dimy: int, H: int, W: int,
                fill=0.0) -> np.ndarray:
    """Canonical (dimx*dimy, ...) -> lattice (H*W, ...)."""
    out = np.full((H, W) + x.shape[1:], fill, dtype=x.dtype)
    out[:dimy, :dimx] = x.reshape((dimy, dimx) + x.shape[1:])
    return out.reshape((H * W,) + x.shape[1:])


def make_batch(tasks: Sequence[Task], max_grid_dim: int = MAX_GRID_DIM,
               device="cuda"):
    """Build one batched topology + state from grid-cloth tasks
    (make_scene + apply_state, scene.py:53-199).  Pickers start parked.
    The batch lives on `device`: CUDA unless the caller asks for the CPU."""
    dev = resolve_device(device)
    H = W = max_grid_dim
    pos_l, vel_l, inv_l, act_l = [], [], [], []
    for t in tasks:
        dimx, dimy = (int(v) for v in t.cloth_size)
        n = dimx * dimy
        cp = np.asarray(t.cloth_pos, np.float32)
        pos = grid_positions(dimx, dimy, lower=(float(cp[0]), -float(cp[1]),
                                                float(cp[2])))
        inv = np.full(n, n / float(t.cloth_mass), np.float32)
        vel = np.zeros((n, 3), np.float32)
        if t.particle_pos is not None and np.size(t.particle_pos):
            pp = np.asarray(t.particle_pos, np.float32).reshape(-1, 4)
            pos[:len(pp)] = pp[:, :3]
            inv[:len(pp)] = pp[:, 3]
        if t.particle_vel is not None and np.size(t.particle_vel):
            pv = np.asarray(t.particle_vel, np.float32).reshape(-1, 3)
            vel[:len(pv)] = pv
        pos_l.append(_to_lattice(pos, dimx, dimy, H, W).T)
        vel_l.append(_to_lattice(vel, dimx, dimy, H, W).T)
        inv_l.append(_to_lattice(inv, dimx, dimy, H, W))
        act_l.append(_to_lattice(np.ones(n, bool), dimx, dimy, H, W, False))
    B = len(tasks)
    topo = build_grid_topology(
        [t.cloth_size[0] for t in tasks], [t.cloth_size[1] for t in tasks],
        stiffness=np.stack([np.asarray(t.cloth_stiff, np.float32)
                            for t in tasks]),
        max_dimx=W, max_dimy=H, device=dev)
    inv = torch.as_tensor(np.stack(inv_l), device=dev)
    state = ClothState(
        positions=torch.as_tensor(np.stack(pos_l), device=dev),
        velocities=torch.as_tensor(np.stack(vel_l), device=dev),
        inv_mass=inv, rest_inv_mass=inv.clone(),
        active=torch.as_tensor(np.stack(act_l), device=dev),
        picker_pos=torch.tensor(PARK_PICKERS, dtype=torch.float32,
                                device=dev).expand(B, -1, -1).clone(),
        picked_idx=torch.full((B, NUM_PICKERS), -1, dtype=torch.int64,
                              device=dev))
    return topo, state


def flat_tasks(sizes, cloth_mass: float = 0.5) -> list:
    """Flat rectangular cloths centred at the origin one particle radius
    above the floor (set_to_flatten layout, scene.py:202-214)."""
    tasks = []
    for dimx, dimy in sizes:
        px = np.linspace(0, dimx * PARTICLE_RADIUS, dimx)
        pz = np.linspace(0, dimy * PARTICLE_RADIUS, dimy)
        zz, xx = np.meshgrid(pz, px, indexing="ij")
        pos = np.stack([xx, np.full_like(xx, PARTICLE_RADIUS), zz],
                       -1).reshape(-1, 3)
        pos[:, [0, 2]] -= pos[:, [0, 2]].mean(0, keepdims=True)
        n = dimx * dimy
        pp = np.concatenate([pos, np.full((n, 1), n / cloth_mass)], 1)
        tasks.append(Task(cloth_size=(dimx, dimy),
                          particle_pos=pp.astype(np.float32).reshape(-1),
                          cloth_mass=cloth_mass))
    return tasks


def _still(state: ClothState) -> bool:
    """Every env's max |v| component over active particles is < tol."""
    v = torch.where(state.active[:, None], state.velocities, 0.0)
    return bool((v.abs().amax((1, 2)) < STILL_TOL).all())


# lift-and-drop crumple: lift 0.5 m at 1 cm per step drifting up to 0.3 m
# sideways, hold <= 40 steps, settle <= 200 steps, stillness tested every
# 20 steps as max |v| < 1e-2 (wait_until_stable's tolerance)
CRUMPLE_LIFT, CRUMPLE_SPEED, CRUMPLE_DRIFT = 0.5, 0.01, 0.3
CRUMPLE_HOLD, CRUMPLE_SETTLE, CRUMPLE_CHECK, STILL_TOL = 40, 200, 20, 1e-2


def crumple(state: ClothState, topo: GridTopology, params: SolverParams,
            generator: torch.Generator, sim_kw: dict) -> ClothState:
    """Seeded lift-and-drop crumple: picker 0 grabs one random particle per
    env, lifts it while drifting sideways, holds it until the cloth hangs
    still, releases, and the cloth settles (in the spirit of
    _crumple_hard_batch, tasks.py:517).  Every loop has a hard step cap."""
    B, dev = state.batch, state.device
    u = torch.rand(B, 4, generator=generator).to(dev)
    iy = torch.minimum((u[:, 0] * topo.dimy.to(torch.float32)).long(),
                       topo.dimy - 1)
    ix = torch.minimum((u[:, 1] * topo.dimx.to(torch.float32)).long(),
                       topo.dimx - 1)
    slot = iy * topo.max_dimx + ix
    grab = state.positions.gather(
        2, slot.view(-1, 1, 1).expand(-1, 3, 1))[..., 0]
    state = set_picker_positions(state, torch.tensor(
        PARK_PICKERS, dtype=torch.float32, device=dev))
    pp = state.picker_pos.clone()
    pp[:, 0] = grab
    state = state.replace(picker_pos=pp)
    n_lift = int(np.ceil(CRUMPLE_LIFT / CRUMPLE_SPEED))
    side = (u[:, 2:4] * 2 - 1) * (CRUMPLE_DRIFT / n_lift)
    action = torch.zeros(B, 2, 4, device=dev)
    action[:, 0, 1] = CRUMPLE_SPEED
    action[:, 0, 0] = side[:, 0]
    action[:, 0, 2] = side[:, 1]
    action[:, 0, 3] = 1.0
    for _ in range(n_lift):
        state = solver_step(picker_step(state, action, dt=params.dt), topo,
                            params, **sim_kw)
    hold = torch.zeros_like(action)
    hold[:, 0, 3] = 1.0
    for k in range(CRUMPLE_HOLD):
        state = solver_step(picker_step(state, hold, dt=params.dt), topo,
                            params, **sim_kw)
        if (k + 1) % CRUMPLE_CHECK == 0 and _still(state):
            break
    state = release_all(state)
    state = set_picker_positions(state, torch.tensor(
        PARK_PICKERS, dtype=torch.float32, device=dev))
    for k in range(CRUMPLE_SETTLE):
        state = solver_step(state, topo, params, **sim_kw)
        if (k + 1) % CRUMPLE_CHECK == 0 and _still(state):
            break
    return state
