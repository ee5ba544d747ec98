"""Scene construction: task arrays -> batched (topology, ClothState)
(counterpart of flingbot_tpu/env/scene.py: grid cloths, shirts on one
shared layered lattice, and other quad meshes through the generic mesh
path padded to one bucket of capacities) from task files (`scene_task`)
or from arrays, and a seeded lift-and-drop crumple that makes start
states without task files.
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
    MESH_KEYS, GridTopology, LayeredGridTopology, LayeredSpec, MeshTopology,
    build_grid_topology, build_layered_topology, build_mesh_topology,
    compute_layered_spec, grid_positions, load_cloth)

DEFAULT_STIFFNESS = (0.8, 1.0, 0.9)  # (stretch, bend, shear), scene default
# padded capacities of the generic mesh path (flingbot_tpu/env/scene.py:
# 34-42): the bucket of a scene built without one, and the ceilings of
# tasks.detect_mesh_caps; the spring incidence tables' width
MESH_VERT_CAPACITY = 8192
MESH_EDGE_CAPACITY = 65536
MESH_TRI_CAPACITY = 16384
MESH_DEGREE_CAPACITY = 24
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


@dataclasses.dataclass
class ShirtTask:
    """The arrays of one shirt (quad-mesh) task that a scene needs: the
    mesh arrays of flingbot_tpu.env.tasks.Task (flat, as in a task file)
    and its state in mesh vertex order."""

    mesh_verts: np.ndarray  # (V*3,) rest pose
    mesh_stretch_edges: np.ndarray  # (M*2,)
    mesh_bend_edges: np.ndarray
    mesh_shear_edges: np.ndarray
    mesh_faces: np.ndarray  # (T*3,)
    particle_pos: Optional[np.ndarray] = None  # (V*4,) x y z invMass
    particle_vel: Optional[np.ndarray] = None  # (V*3,)
    cloth_mass: float = 0.5
    cloth_stiff: Sequence[float] = DEFAULT_STIFFNESS
    cloth_pos: Sequence[float] = (0.0, 0.0, 0.0)

    def mesh_arrays(self) -> dict:
        return {k: getattr(self, k) for k in MESH_KEYS}


# a shirt task's start pose: the garment flat, this far above the floor
# (the JAX package's mesh task generator, tasks.py:404-406)
SHIRT_LIFT = 0.1


def shirt_task(path: str, **kw) -> ShirtTask:
    """A shirt task from a quad-mesh OBJ, lying flat SHIRT_LIFT m up.
    kw: cloth_mass, cloth_stiff."""
    verts, tri, se, be, she = load_cloth(path)
    n = len(verts)
    task = ShirtTask(mesh_verts=verts.reshape(-1), mesh_stretch_edges=se,
                     mesh_bend_edges=be, mesh_shear_edges=she,
                     mesh_faces=tri, **kw)
    pos = verts.astype(np.float32) + np.float32([0.0, SHIRT_LIFT, 0.0])
    inv = np.full((n, 1), n / task.cloth_mass, np.float32)
    task.particle_pos = np.concatenate([pos, inv], 1).reshape(-1)
    return task


def scene_task(task):
    """A task read from a task file (env.tasks.Task) -> the scene's Task
    (grid cloth) or ShirtTask (mesh), with its saved state: what the JAX
    _load_scene passes to set_scene as get_config() / get_state()
    (batch_env.py:336-345)."""
    common = dict(particle_pos=task.particle_pos,
                  particle_vel=task.particle_vel, cloth_mass=task.cloth_mass,
                  cloth_stiff=task.cloth_stiff, cloth_pos=task.cloth_pos)
    if np.size(task.mesh_verts) > 0:
        return ShirtTask(**{k: getattr(task, k) for k in MESH_KEYS},
                         **common)
    return Task(cloth_size=tuple(int(v) for v in task.cloth_size), **common)


def _to_lattice(x: np.ndarray, dimx: int, dimy: int, H: int, W: int,
                fill=0.0) -> np.ndarray:
    """Canonical (dimx*dimy, ...) -> lattice (H*W, ...)."""
    out = np.full((H, W) + x.shape[1:], fill, dtype=x.dtype)
    out[:dimy, :dimx] = x.reshape((dimy, dimx) + x.shape[1:])
    return out.reshape((H * W,) + x.shape[1:])


def make_batch(tasks, max_grid_dim: int = MAX_GRID_DIM, device="cuda",
               layered_spec: Optional[LayeredSpec] = None, mesh_caps=None):
    """Build one batched topology + state from grid-cloth Tasks or from
    ShirtTasks (make_scene + apply_state, scene.py:53-199).  Shirts share
    one layered lattice: `layered_spec`, or the spec computed over these
    tasks; with mesh_caps = (verts, edges, tris) they take the generic
    mesh path instead, padded to those capacities.  Pickers start parked.
    The batch lives on `device`: CUDA unless the caller asks for the
    CPU."""
    dev = resolve_device(device)
    if all(isinstance(t, ShirtTask) for t in tasks):
        if mesh_caps is not None:
            if layered_spec is not None:
                raise ValueError("pass either mesh_caps (the generic mesh "
                                 "path) or layered_spec")
            return _make_mesh_batch(tasks, mesh_caps, dev)
        return _make_shirt_batch(tasks, layered_spec, dev)
    if any(isinstance(t, ShirtTask) for t in tasks):
        raise ValueError("one batch holds grid cloths or shirts, not both")
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
    topo = build_grid_topology(
        [t.cloth_size[0] for t in tasks], [t.cloth_size[1] for t in tasks],
        stiffness=np.stack([np.asarray(t.cloth_stiff, np.float32)
                            for t in tasks]),
        max_dimx=W, max_dimy=H, device=dev)
    state = _parked_state(pos_l, vel_l, inv_l, act_l, dev)
    return topo, state


def _parked_state(pos, vel, inv, active, dev) -> ClothState:
    inv = torch.as_tensor(np.stack(inv), device=dev)
    B = inv.shape[0]
    return ClothState(
        positions=torch.as_tensor(np.stack(pos), device=dev),
        velocities=torch.as_tensor(np.stack(vel), device=dev),
        inv_mass=inv, rest_inv_mass=inv.clone(),
        active=torch.as_tensor(np.stack(active), device=dev),
        picker_pos=torch.tensor(PARK_PICKERS, dtype=torch.float32,
                                device=dev).expand(B, -1, -1).clone(),
        picked_idx=torch.full((B, NUM_PICKERS), -1, dtype=torch.int64,
                              device=dev))


def _make_shirt_batch(tasks, spec, dev):
    """Shirts on one layered lattice: make_scene's layered branch
    (scene.py:78-103; the spawn pose lower = (x, -y, z) of cloth_pos, as
    SoftgymCloth flips it, and inverse mass n / cloth_mass on real slots)
    and apply_state's scatter of a saved state in mesh vertex order
    through mesh_slot (scene.py:157-163)."""
    if spec is None:
        spec = compute_layered_spec([t.mesh_arrays() for t in tasks])
        if spec is None:
            raise ValueError("the shirts are not layered-lattice meshes")
    topos, pos_l, vel_l, inv_l, act_l = [], [], [], [], []
    for t in tasks:
        verts = np.asarray(t.mesh_verts, np.float32).reshape(-1, 3)
        n = len(verts)
        stiff = np.asarray(t.cloth_stiff, np.float32)
        # (stretch, bend, shear): the reference's order (flex_utils.py:281)
        topo = build_layered_topology(
            verts, t.mesh_stretch_edges, t.mesh_bend_edges,
            t.mesh_shear_edges, t.mesh_faces,
            stiffness=tuple(float(v) for v in stiff[:3]), spec=spec,
            device="cpu")
        topos.append(topo)
        slot = topo.mesh_slot[0, :n].numpy()
        cp = np.asarray(t.cloth_pos, np.float32)
        pos = np.zeros((spec.H * spec.W, 3), np.float32)
        pos[slot] = verts + np.array([cp[0], -cp[1], cp[2]], np.float32)
        inv = np.zeros(spec.H * spec.W, np.float32)
        inv[slot] = n / float(t.cloth_mass)
        vel = np.zeros_like(pos)
        if t.particle_pos is not None and np.size(t.particle_pos):
            pp = np.asarray(t.particle_pos, np.float32).reshape(-1, 4)
            pos[slot[:len(pp)]] = pp[:, :3]
            inv[slot[:len(pp)]] = pp[:, 3]
        if t.particle_vel is not None and np.size(t.particle_vel):
            pv = np.asarray(t.particle_vel, np.float32).reshape(-1, 3)
            vel[slot[:len(pv)]] = pv
        pos_l.append(pos.T)
        vel_l.append(vel.T)
        inv_l.append(inv)
        act_l.append(topo.active[0].reshape(-1).numpy())
    topo = LayeredGridTopology.cat(topos).to(dev)
    return topo, _parked_state(pos_l, vel_l, inv_l, act_l, dev)


def _mesh_positions(t: ShirtTask, n: int, cap: int):
    """(pos (cap, 3), vel (cap, 3), inv (cap,)) of a mesh task in vertex
    order: the rest pose at lower = (x, -y, z) of cloth_pos with inverse
    mass n / cloth_mass, then its saved state (make_scene's mesh branch and
    apply_state, scene.py:105-167)."""
    verts = np.asarray(t.mesh_verts, np.float32).reshape(-1, 3)
    cp = np.asarray(t.cloth_pos, np.float32)
    pos = np.zeros((cap, 3), np.float32)
    pos[:n] = verts + np.array([cp[0], -cp[1], cp[2]], np.float32)
    inv = np.zeros(cap, np.float32)
    inv[:n] = np.float32(n / float(t.cloth_mass))
    vel = np.zeros_like(pos)
    if t.particle_pos is not None and np.size(t.particle_pos):
        pp = np.asarray(t.particle_pos, np.float32).reshape(-1, 4)
        pos[:len(pp)] = pp[:, :3]
        inv[:len(pp)] = pp[:, 3]
    if t.particle_vel is not None and np.size(t.particle_vel):
        pv = np.asarray(t.particle_vel, np.float32).reshape(-1, 3)
        vel[:len(pv)] = pv
    return pos, vel, inv


def _make_mesh_batch(tasks, mesh_caps, dev):
    """Quad meshes through the generic mesh path, each padded to the bucket
    mesh_caps = (verts, edges, tris) (make_scene's mesh branch,
    scene.py:105-126): vertex order, the first n slots of each env
    active."""
    vcap, ecap, tcap = (int(c) for c in mesh_caps)
    topos, pos_l, vel_l, inv_l, act_l = [], [], [], [], []
    for t in tasks:
        verts = np.asarray(t.mesh_verts, np.float32).reshape(-1, 3)
        n = len(verts)
        stiff = np.asarray(t.cloth_stiff, np.float32)
        topos.append(build_mesh_topology(
            verts, t.mesh_stretch_edges, t.mesh_bend_edges,
            t.mesh_shear_edges, t.mesh_faces,
            stiffness=tuple(float(v) for v in stiff[:3]), capacity=vcap,
            edge_capacity=ecap, tri_capacity=tcap,
            degree_capacity=MESH_DEGREE_CAPACITY, device="cpu"))
        pos, vel, inv = _mesh_positions(t, n, vcap)
        pos_l.append(pos.T)
        vel_l.append(vel.T)
        inv_l.append(inv)
        act_l.append(np.arange(vcap) < n)
    topo = MeshTopology.cat(topos).to(dev)
    return topo, _parked_state(pos_l, vel_l, inv_l, act_l, dev)


def flatten_positions(dimx: int, dimy: int) -> np.ndarray:
    """(dimx * dimy, 3) float64 flat layout centred at the origin one
    particle radius up, canonical order (flatten_positions,
    scene.py:202-214: linspace over dim * radius)."""
    px = np.linspace(0, dimx * PARTICLE_RADIUS, dimx)
    pz = np.linspace(0, dimy * PARTICLE_RADIUS, dimy)
    zz, xx = np.meshgrid(pz, px, indexing="ij")
    pos = np.stack([xx, np.full_like(xx, PARTICLE_RADIUS), zz],
                   -1).reshape(-1, 3)
    pos[:, [0, 2]] -= pos[:, [0, 2]].mean(0, keepdims=True)
    return pos


def flat_tasks(sizes, cloth_mass: float = 0.5) -> list:
    """Flat rectangular cloths centred at the origin one particle radius
    above the floor (set_to_flatten layout, scene.py:202-214)."""
    tasks = []
    for dimx, dimy in sizes:
        pos = flatten_positions(dimx, dimy)
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


def _random_slot(state: ClothState, topo, u: torch.Tensor) -> torch.Tensor:
    """(B,) lattice slot of one random cloth particle per env from uniform
    draws u (B, 4): on a grid, row u0 and column u1 of the env's dims; on
    a layered lattice, the floor(u0 * n)-th of its n active slots."""
    if isinstance(topo, GridTopology):
        iy = torch.minimum((u[:, 0] * topo.dimy.to(torch.float32)).long(),
                           topo.dimy - 1)
        ix = torch.minimum((u[:, 1] * topo.dimx.to(torch.float32)).long(),
                           topo.dimx - 1)
        return iy * topo.max_dimx + ix
    n = state.active.sum(1)
    k = torch.minimum((u[:, 0] * n.to(torch.float32)).long(), n - 1)
    rank = torch.cumsum(state.active.long(), 1) - 1
    return torch.argmax((state.active & (rank == k[:, None])).long(), 1)


def crumple(state: ClothState, topo, params: SolverParams,
            generator: torch.Generator, sim_kw: dict) -> ClothState:
    """Seeded lift-and-drop crumple: picker 0 grabs one random particle per
    env, lifts it while drifting sideways, holds it until the cloth hangs
    still, releases, and the cloth settles (in the spirit of
    _crumple_hard_batch, tasks.py:517).  Every loop has a hard step cap."""
    B, dev = state.batch, state.device
    u = torch.rand(B, 4, generator=generator).to(dev)
    slot = _random_slot(state, topo, u)
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
