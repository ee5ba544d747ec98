"""Task model, task files and task generation (counterpart of
flingbot_tpu/env/tasks.py: Task, TaskLoader, the topology bucket
detection, write_task, the batched generator generate_tasks_batch and the
sequential generator generate_tasks).

The JAX package's task sets are flingbot-format HDF5 files; the port reads
them as the `.npz` archives that `tools/export_tasks_npz.py` writes (one
entry "<task key>/<dataset>" per dataset, "<task key>/@<attr>" per group
attribute), with numpy alone, and writes the sets it generates in the same
layout.  Tasks are served in sorted key order, as the JAX TaskLoader
serves the HDF5 groups.

Generate a set on the card (the configuration of
scripts/generate_sets_r3.py: the fused substeps kernel, sorted-window
contacts, Chebyshev springs):

    python -m flingbot_tpu_torch.env.tasks --path tasks.npz --num_tasks 64

or one task at a time with the sequential generator, which the shirt set
needs (solver.step's JAX defaults: the xla backend, Gauss-Seidel springs,
block contacts every substep):

    python -m flingbot_tpu_torch.env.tasks --path shirts.npz --num_tasks 16 \
        --cloth_type mesh --cloth_mesh_path data/shirts --seed 500
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import random
import shutil
import time
import zipfile
from typing import Dict, List, Optional

import numpy as np
import torch

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.engine.solver import step as solver_step
from flingbot_tpu_torch.engine.state import (
    FLEX_SCENE_FRICTION, PARTICLE_RADIUS, ClothState, SolverParams, f32,
    where_state)
from flingbot_tpu_torch.engine.topology import (
    MESH_KEYS, compute_layered_spec, grid_positions, load_cloth)
from flingbot_tpu_torch.env import scene
from flingbot_tpu_torch.env.coverage import get_current_covered_area
from flingbot_tpu_torch.env.scene import (
    MESH_EDGE_CAPACITY, MESH_TRI_CAPACITY, MESH_VERT_CAPACITY)

ATTR_PREFIX = "@"


class Task:
    """One manipulation task: a crumpled-cloth start state and its
    metadata.  Same constructor keywords, views and repr as
    flingbot_tpu.env.tasks.Task (tasks.py:40-156)."""

    def __init__(
        self,
        name: str,
        flatten_area: float,
        initial_coverage: float,
        task_difficulty: str,
        cloth_size: Optional[List] = None,
        flip_mesh: int = 0,
        particle_pos=(),
        particle_vel=(),
        shape_pos=(),
        mesh_verts=(),
        mesh_stretch_edges=(),
        mesh_bend_edges=(),
        mesh_shear_edges=(),
        mesh_faces=(),
        phase=(),
        cloth_stiff=(),
        cloth_mass: float = 0.5,
        cloth_pos=(0, 2, 0),
        **_unused,
    ):
        self.name = name
        self.flatten_area = float(flatten_area)
        self.initial_coverage = float(initial_coverage)
        self.task_difficulty = str(task_difficulty)
        self.cloth_mass = float(cloth_mass)
        self.cloth_size = np.array(
            cloth_size if cloth_size is not None else [-1, -1])
        self.particle_pos = np.array(particle_pos)
        self.particle_vel = np.array(particle_vel)
        self.shape_pos = np.array(shape_pos)
        self.phase = np.array(phase)
        self.cloth_pos = np.array(cloth_pos)
        self.cloth_stiff = np.array(cloth_stiff)
        self.flip_mesh = int(flip_mesh)
        self.mesh_verts = np.array(mesh_verts)
        if self.mesh_verts.size > 0:
            self.cloth_size = np.array([-1, -1])
        self.mesh_stretch_edges = np.array(mesh_stretch_edges)
        self.mesh_bend_edges = np.array(mesh_bend_edges)
        self.mesh_shear_edges = np.array(mesh_shear_edges)
        self.mesh_faces = np.array(mesh_faces)
        # top-down camera (tasks.py:87-91)
        self.camera_pos = np.array([0.0, 2.0, 0.0])
        self.camera_angle = np.array([np.pi * 0.5, -np.pi * 0.5, 0.0])
        self.camera_width = 720
        self.camera_height = 720

    def _camera_params(self) -> Dict:
        return {"default_camera": {
            "pos": self.camera_pos, "angle": self.camera_angle,
            "width": self.camera_width, "height": self.camera_height}}

    def get_config(self) -> Dict:
        return {
            "cloth_pos": self.cloth_pos,
            "cloth_size": self.cloth_size,
            "cloth_stiff": self.cloth_stiff,
            "cloth_mass": self.cloth_mass,
            "camera_name": "default_camera",
            "camera_params": self._camera_params(),
            "flip_mesh": self.flip_mesh,
            "flatten_area": self.flatten_area,
            "mesh_verts": self.mesh_verts,
            "mesh_stretch_edges": self.mesh_stretch_edges,
            "mesh_bend_edges": self.mesh_bend_edges,
            "mesh_shear_edges": self.mesh_shear_edges,
            "mesh_faces": self.mesh_faces,
        }

    def get_state(self) -> Dict:
        return {
            "particle_pos": self.particle_pos,
            "particle_vel": self.particle_vel,
            "shape_pos": self.shape_pos,
            "phase": self.phase,
            "camera_params": self._camera_params(),
        }

    def get_stats(self) -> Dict:
        return {
            "task_name": self.name,
            "cloth_mass": self.cloth_mass,
            "cloth_size": self.cloth_size,
            "cloth_stiff": self.cloth_stiff,
            "max_coverage": self.flatten_area,
            "task_difficulty": self.task_difficulty,
            "init_coverage": self.initial_coverage,
        }

    def __str__(self) -> str:
        pct = self.initial_coverage * 100 / max(self.flatten_area, 1e-9)
        return (
            f"[Task] {self.name}\n"
            f"\ttask_difficulty: {self.task_difficulty}\n"
            f"\tinitial_coverage (%): {pct:.02f}\n"
            f"\tcloth_mass (kg): {self.cloth_mass:.04f}\n"
            f"\tcloth_size: {self.cloth_size}\n"
            f"\tcloth_stiff: {self.cloth_stiff}\n"
            f"\tflatten_area (m^2): {self.flatten_area:.04f}\n"
        )


def read_task_arrays(npz_path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """{task key: {name: array}} of an exported task file; attributes keep
    their "@" prefix."""
    tasks: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(npz_path, allow_pickle=False) as z:
        for entry in z.files:
            key, name = entry.split("/", 1)
            tasks.setdefault(key, {})[name] = z[entry]
    return tasks


def _task_kwargs(arrays: Dict[str, np.ndarray]) -> Dict:
    """Task keywords of one group, as the JAX TaskLoader builds them:
    attributes as numpy scalars (strings as str), datasets as arrays."""
    kwargs = {}
    for name, a in arrays.items():
        if name.startswith(ATTR_PREFIX):
            v = a[()]
            kwargs[name[len(ATTR_PREFIX):]] = (
                str(v) if isinstance(v, np.str_) else v)
    kwargs.update({n: a for n, a in arrays.items()
                   if not n.startswith(ATTR_PREFIX)})
    return kwargs


class TaskLoader:
    """Sequential task reader over an exported task file (TaskLoader,
    tasks.py:159-186).  With repeat=False it raises StopIteration when
    exhausted; with repeat=True it starts over."""

    def __init__(self, npz_path: str, repeat: bool = True):
        self.npz_path = npz_path
        self.repeat = repeat
        self._tasks = read_task_arrays(npz_path)
        self.keys = sorted(self._tasks)
        print(f"[TaskLoader] Found {len(self.keys)} tasks from {npz_path}")
        self.curr_task_idx = 0

    def __len__(self):
        return len(self.keys)

    def get_next_task(self) -> Task:
        if self.curr_task_idx >= len(self.keys):
            if not self.repeat:
                raise StopIteration("[TaskLoader] Out of tasks")
            self.curr_task_idx = 0
        key = self.keys[self.curr_task_idx]
        self.curr_task_idx += 1
        return Task(name=key, **_task_kwargs(self._tasks[key]))


def _mesh_tasks(npz_path: str):
    """The mesh arrays of every task, or None when a task is a grid
    cloth."""
    tasks = []
    for key, arrays in sorted(read_task_arrays(npz_path).items()):
        if "mesh_verts" not in arrays or arrays["mesh_verts"].size == 0:
            return None
        tasks.append({n: arrays[n] for n in MESH_KEYS})
    return tasks or None


def detect_mesh_caps(npz_path: str):
    """None for grid task files; for mesh files the (verts, edges, tris)
    padding bucket of the generic mesh path, sized to the file's maxima
    and capped at the MESH_*_CAPACITY ceilings (tasks.py:189-223)."""
    tasks = _mesh_tasks(npz_path)
    if tasks is None:
        return None

    def roundup(v, m):
        return int((v + m - 1) // m * m)

    max_v = max(t["mesh_verts"].size // 3 for t in tasks)
    max_e = max(sum(t[n].size // 2 for n in MESH_KEYS[1:4]) for t in tasks)
    max_t = max(t["mesh_faces"].size // 3 for t in tasks)
    return (min(roundup(max_v, 256), MESH_VERT_CAPACITY),
            min(roundup(max_e, 1024), MESH_EDGE_CAPACITY),
            min(roundup(max_t, 256), MESH_TRI_CAPACITY))


def detect_layered_spec(npz_path: str):
    """The LayeredSpec of a mesh (shirt) task file whose every garment is a
    two-layer lattice; None for grid files or other meshes
    (tasks.py:226-245)."""
    tasks = _mesh_tasks(npz_path)
    return None if tasks is None else compute_layered_spec(tasks)


def detect_topology_buckets(npz_path: str) -> Dict:
    """BatchSimEnv keywords for a task file: grid files -> both None;
    lattice shirt files -> layered_spec; other meshes -> mesh_caps (the
    generic mesh path) (tasks.py:248-256)."""
    spec = detect_layered_spec(npz_path)
    if spec is not None:
        return {"mesh_caps": None, "layered_spec": spec}
    return {"mesh_caps": detect_mesh_caps(npz_path), "layered_spec": None}


# --------------------------------------------------------------------------
# task archives written by the port (write_task, tasks.py:259-273)
# --------------------------------------------------------------------------

def task_key(index: int) -> str:
    """The key of the index-th task of a file: write_task's
    sha1(str(len(f)))."""
    return hashlib.sha1(f"{index}".encode()).hexdigest()


def count_tasks(npz_path: str) -> int:
    """Tasks in a task archive; 0 when there is none."""
    if not os.path.exists(npz_path):
        return 0
    with np.load(npz_path, allow_pickle=False) as z:
        return len({entry.split("/", 1)[0] for entry in z.files})


def _task_entries(key: str, task: Dict) -> Dict[str, np.ndarray]:
    """Archive entries of one task: scalars as "<key>/@<name>" 0-d arrays
    (write_task's group attributes; strings as numpy unicode), arrays as
    "<key>/<name>"."""
    out = {}
    for name, v in task.items():
        if isinstance(v, (float, int, str, np.floating, np.integer)):
            out[f"{key}/{ATTR_PREFIX}{name}"] = np.asarray(v)
        else:
            out[f"{key}/{name}"] = np.asarray(v)
    return out


def append_tasks(npz_path: str, tasks: List[Dict]) -> int:
    """Append tasks to a task archive under the keys write_task gives them
    (the index of each task in the file), as np.savez_compressed entries.
    The archive is rewritten to a temporary file and moved over the old
    one, so an interrupted run leaves the previous archive whole.  Returns
    the number of tasks in the file."""
    count = count_tasks(npz_path)
    tmp = npz_path + ".tmp"
    if count:
        shutil.copyfile(npz_path, tmp)
    with zipfile.ZipFile(tmp, "a" if count else "w",
                         compression=zipfile.ZIP_DEFLATED) as zf:
        for task in tasks:
            for name, arr in _task_entries(task_key(count), task).items():
                with zf.open(name + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
            count += 1
    os.replace(tmp, npz_path)
    return count


# --------------------------------------------------------------------------
# task generation (generate_tasks_batch, tasks.py:685-918)
# --------------------------------------------------------------------------

# the generator's solver keywords (sim_kw, tasks.py:729-731, with
# solver.step's contact defaults, solver.py:504,511): 30 spring iterations
# where the env runs 16, contacts 8 x window 16 where the env runs 4 x 12
GEN_SIM_KW = dict(substeps=4, iterations=30, self_collision=True,
                  contact_every=2, contact_iterations=8, contact_window=16,
                  spring_mode="chebyshev")
# the sequential generator's: solver.step's own defaults
# (solver.py:494-512), which _sim_n leaves as they are (tasks.py:298)
SEQ_SIM_KW = dict(substeps=4, iterations=30, self_collision=True,
                  spring_mode="gs", contact_mode="block",
                  contact_iterations=8, contact_every=1, resort_interval=4,
                  backend="xla", contact_window=16)
# the sequential generator's frames (tasks.py:406, 443, 451-456, 460-466,
# 306-307): (mesh drop, hard sweep, hard hold checks of 10 frames, easy
# toss sweep, easy tosses, settle)
SEQ_SCHEDULE = (40, 200, 30, 100, 10, 300)
# the dynamic friction of the generator's entry points: the FleX scene's,
# at which the JAX package's committed sets were made (PARITY.md); at the
# production 0.1, SolverParams' default, the crumples come out near flat
GEN_FRICTION = FLEX_SCENE_FRICTION
# (sweep, hold, settle) frames and tosses of each difficulty
SCHEDULES = {"hard": (200, 120, 300, 10), "easy": (100, 0, 300, 10)}
SETTLE_TOL = 1e-2  # max |v| under which an env has settled (m/s)
MAX_TASK_HEIGHT = 0.4  # a task with a particle above it is dropped (m)
PARKED = -10.0  # picker positions of a generator state (ClothState.create)


@dataclasses.dataclass
class Draw:
    """The numpy draws of one generator batch, in the JAX generator's
    order: dims, stiffness and mass of every cloth, then per cloth its
    flat canonical positions and its pick (hard: one canonical index, its
    start and target; easy: `tosses` indices and displacements)."""

    dims: List[tuple]
    stiffs: List[np.ndarray]
    masses: List[float]
    flats: List[np.ndarray]
    picks: List  # hard: int; easy: (tosses,) int32
    starts: List[np.ndarray]  # hard: p0 (3,) f32
    targets: List[np.ndarray]  # hard: p1 (3,) f32; easy: (tosses, 3) f32


def draw_batch(rng: np.random.Generator, batch: int, min_cloth_size: int,
               max_cloth_size: int, strict_min_edge_length: int,
               task_difficulty: str, tosses: int) -> Draw:
    """One batch of draws, numpy call for call as generate_tasks_batch
    makes them (tasks.py:826-866): dims rejected while both edges are
    under strict_min_edge_length, stiffness U(0.85, 0.95)^3, mass
    U(0.2, 2.0); then per cloth the flat grid one particle radius up, centred
    in x and z, and a pick index with a lift height U(0.5, 1.5) (hard) or
    `tosses` pick indices with displacements U(-0.2, 0.2) in x and z and
    0.2 up (easy)."""
    d = Draw([], [], [], [], [], [], [])
    while len(d.dims) < batch:
        dx = int(rng.integers(min_cloth_size, max_cloth_size))
        dy = int(rng.integers(min_cloth_size, max_cloth_size))
        if dx < strict_min_edge_length and dy < strict_min_edge_length:
            continue
        d.dims.append((dx, dy))
        d.stiffs.append(rng.uniform(0.85, 0.95, 3))
        d.masses.append(float(rng.uniform(0.2, 2.0)))
    for dx, dy in d.dims:
        n = dx * dy
        flat = grid_positions(dx, dy, lower=(0.0, PARTICLE_RADIUS, 0.0))
        flat[:, [0, 2]] -= flat[:, [0, 2]].mean(axis=0, keepdims=True)
        d.flats.append(flat)
        if task_difficulty == "hard":
            pick = int(rng.integers(0, n))
            height = float(rng.random() * 1.0 + 0.5)
            p0 = flat[pick].copy()
            d.picks.append(pick)
            d.starts.append(p0)
            d.targets.append(np.array([p0[0], height, p0[2]], np.float32))
        else:
            d.picks.append(rng.integers(0, n, tosses).astype(np.int32))
            disp = rng.uniform(-0.2, 0.2, (tosses, 3)).astype(np.float32)
            disp[:, 1] = 0.2
            d.targets.append(disp)
    return d


def flat_batch(draw: Draw, max_grid_dim: int, device):
    """The batch's flat cloths on one lattice: inverse mass n / mass,
    pickers parked far away (the JAX generator's ClothState.create)."""
    tasks = []
    for (dx, dy), flat, stiff, mass in zip(draw.dims, draw.flats,
                                           draw.stiffs, draw.masses):
        n = dx * dy
        inv = np.full((n, 1), n / mass, np.float32)
        tasks.append(scene.Task(
            cloth_size=(dx, dy), cloth_mass=mass, cloth_stiff=stiff,
            particle_pos=np.concatenate([flat, inv], 1).reshape(-1)))
    topo, state = scene.make_batch(tasks, max_grid_dim=max_grid_dim,
                                   device=device)
    return topo, state.replace(
        picker_pos=torch.full_like(state.picker_pos, PARKED))


def lattice_slot(canonical_idx, dimx, max_dimx: int):
    """Canonical particle index y * dimx + x -> lattice slot
    y * max_dimx + x."""
    return (canonical_idx // dimx) * max_dimx + canonical_idx % dimx


def center(state: ClothState) -> ClothState:
    """Shift every env's cloth so that its mean x and z are 0 (_center,
    tasks.py:506-514)."""
    act = state.active[:, None]
    P = state.positions
    mean = torch.where(act, P, 0.0).sum(2) / torch.clamp(
        state.active.sum(1, keepdim=True), min=1)
    shift = torch.stack([mean[:, 0], torch.zeros_like(mean[:, 0]),
                         mean[:, 2]], 1)
    return state.replace(positions=torch.where(act, P - shift[..., None],
                                               P))


def _envs(state: ClothState) -> torch.Tensor:
    return torch.arange(state.batch, device=state.device)


def set_inv_mass(state: ClothState, slot: torch.Tensor,
                 w: torch.Tensor) -> ClothState:
    """Inverse mass of each env's particle `slot` (B,) set to w (B,)."""
    inv = state.inv_mass.clone()
    inv[_envs(state), slot] = w
    return state.replace(inv_mass=inv)


def owned(state: ClothState) -> ClothState:
    """The state with its own copies of the fields a chunk pins in place."""
    return state.replace(positions=state.positions.clone(),
                         velocities=state.velocities.clone(),
                         inv_mass=state.inv_mass.clone())


def pin_(state: ClothState, slot: torch.Tensor, p: torch.Tensor):
    """In place: each env's particle `slot` (B,) moved to p (B, 3) at
    rest."""
    b = _envs(state)
    state.positions[b, :, slot] = p
    state.velocities[b, :, slot] = 0.0


def fraction(a: int, b: int) -> float:
    """a / b rounded to float32, as a Python float: a tensor multiplied by
    it uses that float32 value, with no copy to the card."""
    return float(np.float32(a) / np.float32(b))


def anchored_chunk(state, topo, slot, p0, p1, s0: int, *, n_steps: int,
                   sweep_steps: int, params: SolverParams, sim_kw: dict):
    """Frames s0 .. s0 + n_steps - 1 of the hard schedule (_anchored_chunk,
    tasks.py:609-625): before each frame's step the anchor particle `slot`
    (B,) is set, at rest, to p0 + (p1 - p0) * min(s, sweep) / sweep, so it
    sweeps from p0 (B, 3) to p1 over sweep_steps frames and then holds.
    The caller pins its inverse mass to 0."""
    state = owned(state)
    for s in range(s0, s0 + n_steps):
        pin_(state, slot, p0 + (p1 - p0) * fraction(min(s, sweep_steps),
                                                    sweep_steps))
        state = solver_step(state, topo, params, **sim_kw)
    return state


def toss_chunk(state, topo, slots, disps, p0, p1, saved_w, s0: int, *,
               n_steps: int, sweep_steps: int, params: SolverParams,
               sim_kw: dict):
    """Frames s0 .. s0 + n_steps - 1 of the easy schedule (_toss_chunk,
    tasks.py:628-661): frame s is step j = s % sweep of toss t = s // sweep.
    At j == 0 a toss records its particle's inverse mass (saved_w), start
    p0 and target p1 = p0 + disps[:, t]; every frame it pins the particle
    (inverse mass 0) at p0 + (p1 - p0) * j / sweep at rest and steps; after
    the step of j == sweep - 1 it restores the inverse mass.  slots
    (B, tosses) lattice slots, disps (B, tosses, 3); p0, p1 (B, 3) and
    saved_w (B,) carry a toss across chunks.  Returns (state, p0, p1,
    saved_w)."""
    b = _envs(state)
    state = owned(state)
    for s in range(s0, s0 + n_steps):
        t, j = divmod(s, sweep_steps)
        slot = slots[:, t]
        if j == 0:
            saved_w = state.inv_mass[b, slot]
            p0 = state.positions[b, :, slot]
            p1 = p0 + disps[:, t]
        state.inv_mass[b, slot] = 0.0
        pin_(state, slot, p0 + (p1 - p0) * fraction(j, sweep_steps))
        state = solver_step(state, topo, params, **sim_kw)
        if j == sweep_steps - 1:
            state.inv_mass[b, slot] = saved_w
    return state, p0, p1, saved_w


def max_speed(state: ClothState) -> torch.Tensor:
    """(B,) largest |velocity component| over each env's cloth."""
    v = torch.where(state.active[:, None], state.velocities, 0.0)
    return v.abs().amax((1, 2))


def settle_chunk(state, topo, k, *, n_steps: int, max_settle: int,
                 tol: float, params: SolverParams, sim_kw: dict):
    """Up to n_steps settle frames with the per-env early exit
    (_settle_chunk, tasks.py:664-682): before each frame, an env steps
    only while k < max_settle and its max speed >= tol, and only then does
    its k advance; the others keep their state bit for bit (the batched
    while_loop's select).  Returns (state, k, max speed)."""
    for _ in range(n_steps):
        go = (k < max_settle) & (max_speed(state) >= tol)
        state = where_state(go, solver_step(state, topo, params, **sim_kw),
                            state)
        k = k + go.to(k.dtype)
    return state, k, max_speed(state)


def crumple_batch(state, topo, draw: Draw, task_difficulty: str, schedule,
                  params: SolverParams, sim_kw: dict, chunk_steps: int):
    """The crumpling rollout of one batch (crumple_chunked, tasks.py:
    753-811).  Hard: the anchor sweeps up to its target and holds with its
    inverse mass pinned to 0, then is released.  Easy: `tosses` tosses of
    one particle each.  Then the settle, whose early exit the host reads
    once per chunk of chunk_steps frames (0: once, after max settle).
    Returns (state, settle frames run)."""
    sweep, hold, settle, tosses = schedule
    dev, W = state.device, topo.max_dimx
    dimx = torch.tensor([d[0] for d in draw.dims], device=dev)
    if task_difficulty == "hard":
        slot = lattice_slot(torch.tensor(draw.picks, device=dev), dimx, W)
        saved_w = state.inv_mass[_envs(state), slot]
        state = set_inv_mass(state, slot, torch.zeros_like(saved_w))
        state = anchored_chunk(
            state, topo, slot, torch.tensor(np.stack(draw.starts), device=dev),
            torch.tensor(np.stack(draw.targets), device=dev), 0,
            n_steps=sweep + hold, sweep_steps=sweep, params=params,
            sim_kw=sim_kw)
        state = set_inv_mass(state, slot, saved_w)
    else:
        slots = lattice_slot(torch.tensor(np.stack(draw.picks).astype(
            np.int64), device=dev), dimx[:, None], W)
        zero3 = torch.zeros(state.batch, 3, device=dev)
        state = toss_chunk(
            state, topo, slots, torch.tensor(np.stack(draw.targets),
                                             device=dev),
            zero3, zero3, torch.zeros(state.batch, device=dev), 0,
            n_steps=tosses * sweep, sweep_steps=sweep, params=params,
            sim_kw=sim_kw)[0]
    k = torch.zeros(state.batch, dtype=torch.int64, device=dev)
    frames = 0
    K = chunk_steps or settle
    while frames < settle:
        n = min(K, settle - frames)
        state, k, vmax = settle_chunk(state, topo, k, n_steps=n,
                                      max_settle=settle, tol=SETTLE_TOL,
                                      params=params, sim_kw=sim_kw)
        frames += n
        if bool(((vmax < SETTLE_TOL) | (k >= settle)).all()):
            break
    return state, frames


def generate_tasks_batch(
    path: str,
    num_tasks: int,
    batch: int = 64,
    seed: int = 0,
    min_cloth_size: int = 64,
    max_cloth_size: int = 104,
    strict_min_edge_length: int = 64,
    task_difficulty: str = "hard",
    max_grid_dim: int = 104,
    backend: str = "pallas",
    spring_mode: str = "gs",
    contact_mode: str = "sort",
    log: bool = True,
    chunk_steps: int = 64,
    schedule=None,
    solver_params: Optional[SolverParams] = None,
    device="cuda",
) -> int:
    """Generate square-cloth tasks into the task archive `path` until it
    holds num_tasks (generate_tasks_batch, tasks.py:685-918), `batch`
    crumpling rollouts at a time as one batch of envs: 'hard' lifts one
    particle per cloth and drops it, 'easy' tosses 10 random particles.
    Resumable: an existing archive's tasks count, and the draws restart
    from seed + that count.  A task with a particle above MAX_TASK_HEIGHT
    after the settle is dropped.  schedule = (sweep, hold, settle[,
    tosses]) overrides the difficulty's (SCHEDULES).  backend,
    spring_mode and contact_mode go to solver.step (on the pallas backend
    "gs" runs as Chebyshev and every contact mode as "sort"); the batch
    runs on `device`, CUDA unless the caller asks for the CPU.  Returns
    the number of tasks in the file."""
    if task_difficulty not in SCHEDULES:
        raise ValueError(f"unknown task_difficulty {task_difficulty!r}")
    dev = resolve_device(device)
    params = solver_params if solver_params is not None else SolverParams()
    sim_kw = dict(GEN_SIM_KW, backend=backend, spring_mode=spring_mode,
                  contact_mode=contact_mode)
    sweep, hold, settle, tosses = SCHEDULES[task_difficulty]
    if schedule is not None:
        sweep, hold, settle = schedule[:3]
        tosses = schedule[3] if len(schedule) > 3 else tosses
    count = count_tasks(path)
    rng = np.random.default_rng(seed + count)
    if count and log:
        print(f"[generate_tasks_batch] resuming: {count} tasks exist",
              flush=True)
    while count < num_tasks:
        t0 = time.perf_counter()
        draw = draw_batch(rng, batch, min_cloth_size, max_cloth_size,
                          strict_min_edge_length, task_difficulty, tosses)
        topo, state = flat_batch(draw, max_grid_dim, dev)
        flat_areas = get_current_covered_area(state.positions,
                                              state.active).tolist()
        state, frames = crumple_batch(
            state, topo, draw, task_difficulty,
            (sweep, hold, settle, tosses), params, sim_kw, chunk_steps)
        state = center(state)
        coverages = get_current_covered_area(state.positions,
                                             state.active).tolist()
        H, W = topo.max_dimy, topo.max_dimx
        pos = state.positions.view(-1, 3, H, W).cpu().numpy()
        vel = state.velocities.view(-1, 3, H, W).cpu().numpy()
        inv = state.inv_mass.view(-1, H, W).cpu().numpy()
        tasks = []
        for i, (dx, dy) in enumerate(draw.dims):
            if count + len(tasks) >= num_tasks:
                break
            n = dx * dy
            # canonical order: the lattice's first dy rows, dx columns
            p = pos[i, :, :dy, :dx].reshape(3, n).T
            if p[:, 1].max() > MAX_TASK_HEIGHT:
                continue  # probably an error (tasks.py:893-894)
            tasks.append({
                "particle_pos": np.concatenate(
                    [p, inv[i, :dy, :dx].reshape(n, 1)], 1).reshape(-1),
                "particle_vel": vel[i, :, :dy, :dx].reshape(3, n).T
                .reshape(-1),
                "initial_coverage": float(coverages[i]),
                "shape_pos": np.zeros(2 * 14, np.float32),
                "phase": np.zeros(n, np.int32),
                "flatten_area": float(flat_areas[i]),
                "flip_mesh": 0,
                "cloth_size": np.array([dx, dy]),
                "cloth_stiff": draw.stiffs[i],
                "cloth_mass": draw.masses[i],
                "task_difficulty": task_difficulty,
                **{k: np.array([]) for k in MESH_KEYS},
            })
        count = append_tasks(path, tasks)
        if log:
            moves = sweep + hold if task_difficulty == "hard" \
                else tosses * sweep
            print(f"[generate_tasks_batch] {count}/{num_tasks} "
                  f"({len(tasks)} of {len(draw.dims)} kept; {moves} + "
                  f"{frames} settle frames in "
                  f"{time.perf_counter() - t0:.2f} s)", flush=True)
    return count


# --------------------------------------------------------------------------
# the sequential generator (generate_tasks, tasks.py:281-503, 921-949)
# --------------------------------------------------------------------------

def sim_n(state: ClothState, topo, params: SolverParams, n: int,
          anchor_slot: Optional[int] = None, anchor_pos=None,
          sim_kw: dict = SEQ_SIM_KW) -> ClothState:
    """n solver frames of a one-env batch; with an anchor, particle slot
    `anchor_slot` is set at rest to anchor_pos (3,) f32 before each frame
    (_sim_n, tasks.py:281-303: the generator's pickpoint)."""
    if anchor_slot is not None:
        state = owned(state)
    for _ in range(n):
        if anchor_slot is not None:
            state.positions[0, :, anchor_slot] = anchor_pos
            state.velocities[0, :, anchor_slot] = 0.0
        state = solver_step(state, topo, params, **sim_kw)
    return state


def wait_until_stable(state: ClothState, topo, params: SolverParams,
                      max_steps: int = 300, tolerance: float = 1e-2,
                      chunk: int = 10, sim_kw: dict = SEQ_SIM_KW):
    """Step in chunks of `chunk` frames until the largest |velocity
    component| is under tolerance (wait_until_stable, tasks.py:306-322).
    Returns (state, settled)."""
    for _ in range(max_steps // chunk):
        state = sim_n(state, topo, params, chunk, sim_kw=sim_kw)
        if float(max_speed(state)[0]) < tolerance:
            return state, True
    return state, False


def pick_obj(cloth_mesh_path: str) -> str:
    """The OBJ of a mesh task: Python's `random.choice` over the
    *_processed.obj files under cloth_mesh_path in Path.rglob order, as
    the JAX generator picks it (tasks.py:355-356; `random` is not seeded
    by the generator, so its caller seeds it for a reproducible pick)."""
    from pathlib import Path

    objs = list(Path(cloth_mesh_path).rglob("*_processed.obj"))
    return str(random.choice(objs))


def generate_randomization(
    rng: np.random.Generator,
    min_cloth_size: int = 64,
    max_cloth_size: int = 104,
    strict_min_edge_length: int = 64,
    task_difficulty: str = "hard",
    cloth_type: str = "square",
    cloth_mesh_path: Optional[str] = None,
    params: Optional[SolverParams] = None,
    max_grid_dim: int = 104,
    mesh_caps=None,
    schedule=SEQ_SCHEDULE,
    sim_kw: dict = SEQ_SIM_KW,
    device="cuda",
) -> Optional[Dict]:
    """One crumpled-cloth task, drawn and simulated on its own
    (generate_randomization, tasks.py:325-503), at solver.step's JAX
    defaults (SEQ_SIM_KW).  The numpy draws come in the JAX generator's
    order: the dims (rejected while both edges are under
    strict_min_edge_length; a mesh keeps -1, -1), stiffness U(0.85,
    0.95)^3, mass U(0.2, 2.0), then the pick.

    square: the cloth laid flat (flatten_positions); mesh: an OBJ picked
    by pick_obj, its rest pose lifted 0.1 m, then 40 frames of drop.  The
    cloth is centred; 'hard' sweeps one particle (inverse mass 0) to a
    height U(0.5, 1.5) over 200 frames and holds it, 10 frames at a time,
    until the largest velocity component is under 0.1 m/s (<= 300
    frames); 'easy' sweeps 10 particles by U(-0.2, 0.2) in x and z and 0.2
    up, 100 frames each.  Then wait_until_stable; a task with a particle
    above MAX_TASK_HEIGHT is dropped (None); the cloth is centred again.
    A mesh runs through the generic mesh path at mesh_caps (default: the
    MESH_*_CAPACITY ceilings); a square cloth on the max_grid_dim
    lattice.  schedule (SEQ_SCHEDULE) and sim_kw (SEQ_SIM_KW) default to
    the JAX generator's.  The state lives on `device`."""
    params = params or SolverParams()
    drop, sweep, hold_checks, toss_sweep, tosses, settle = schedule
    dev = resolve_device(device)
    dimx = int(rng.integers(min_cloth_size, max_cloth_size))
    dimy = int(rng.integers(min_cloth_size, max_cloth_size))
    if dimx < strict_min_edge_length and dimy < strict_min_edge_length:
        return None
    mesh = cloth_type == "mesh"
    if mesh:
        if cloth_mesh_path is None:
            raise ValueError("cloth_type 'mesh' needs cloth_mesh_path")
        verts, faces, se, be, she = load_cloth(pick_obj(cloth_mesh_path))
        mesh_arrays = dict(
            mesh_verts=verts.reshape(-1), mesh_stretch_edges=se.reshape(-1),
            mesh_bend_edges=be.reshape(-1), mesh_shear_edges=she.reshape(-1),
            mesh_faces=faces.reshape(-1))
        dimx, dimy = -1, -1
        num_particles = verts.shape[0]
        # flattened area ~ half the two-sided mesh area (tasks.py:367-374)
        tri = verts[faces]
        flattened_area = float(0.5 * np.linalg.norm(np.cross(
            tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
            axis=1).sum() / 2)
    elif cloth_type == "square":
        mesh_arrays = {k: np.array([]) for k in MESH_KEYS}
        num_particles = dimx * dimy
    else:
        raise ValueError(f"unknown cloth_type {cloth_type!r}")
    stiffness = rng.uniform(0.85, 0.95, 3)
    cloth_mass = float(rng.uniform(0.2, 2.0))
    common = dict(cloth_mass=cloth_mass, cloth_stiff=stiffness,
                  cloth_pos=(0.0, 1.0, 0.0))
    n = num_particles
    if mesh:
        pos = np.asarray(mesh_arrays["mesh_verts"], np.float32).reshape(-1, 3)
        pos[:, 1] += 0.1
        inv = np.full((n, 1), n / cloth_mass, np.float32)
        task = scene.ShirtTask(
            **{k: mesh_arrays[k] for k in MESH_KEYS},
            particle_pos=np.concatenate([pos, inv], 1).reshape(-1), **common)
        topo, state = scene.make_batch(
            [task], device=dev, mesh_caps=mesh_caps or (
                MESH_VERT_CAPACITY, MESH_EDGE_CAPACITY, MESH_TRI_CAPACITY))
        slots = np.arange(n)
    else:
        flat = scene.flatten_positions(dimx, dimy).astype(np.float32)
        inv = np.full((n, 1), n / cloth_mass, np.float32)
        task = scene.Task(cloth_size=(dimx, dimy), particle_pos=np.concatenate(
            [flat, inv], 1).reshape(-1), **common)
        topo, state = scene.make_batch([task], max_grid_dim=max_grid_dim,
                                       device=dev)
        slots = lattice_slot(np.arange(n), dimx, max_grid_dim)
    # the generator's states keep ClothState.create's pickers, far away
    state = state.replace(picker_pos=torch.full_like(state.picker_pos,
                                                     PARKED))
    if mesh:
        state = sim_n(state, topo, params, drop, sim_kw=sim_kw)
    else:
        flattened_area = float(get_current_covered_area(state.positions,
                                                        state.active)[0])
    state = center(state)

    def anchored_sweep(state, slot, start, target, n_move):
        """Drag particle `slot` from start to target over n_move frames
        with its inverse mass pinned to 0 (tasks.py:426-436)."""
        saved_w = float(state.inv_mass[0, slot])
        state = owned(state)
        state.inv_mass[0, slot] = 0.0
        for j in range(n_move):
            p = torch.tensor(start + (target - start) * (j / n_move),
                             dtype=torch.float32, device=dev)
            state = sim_n(state, topo, params, 1, anchor_slot=slot,
                          anchor_pos=p, sim_kw=sim_kw)
        return state, saved_w

    def restore(state, slot, w):
        state = owned(state)
        state.inv_mass[0, slot] = w
        return state

    def position(state, slot):
        return state.positions[0, :, slot].cpu().numpy()

    if task_difficulty == "hard":
        slot = int(slots[int(rng.integers(0, num_particles))])
        height = float(rng.random() * 1.0 + 0.5)
        start = position(state, slot)
        target = np.array([start[0], height, start[2]])
        state, saved_w = anchored_sweep(state, slot, start, target, sweep)
        hold = torch.tensor(target, dtype=torch.float32, device=dev)
        for _ in range(hold_checks):
            state = sim_n(state, topo, params, 10, anchor_slot=slot,
                          anchor_pos=hold, sim_kw=sim_kw)
            if float(max_speed(state)[0]) < 1e-1:
                break
        state = restore(state, slot, saved_w)
    elif task_difficulty == "easy":
        for _ in range(tosses):
            slot = int(slots[int(rng.integers(0, num_particles))])
            displacement = rng.uniform(-0.2, 0.2, 3)
            displacement[1] = 0.2
            start = position(state, slot)
            state, saved_w = anchored_sweep(state, slot, start,
                                            start + displacement, toss_sweep)
            state = restore(state, slot, saved_w)
    else:
        raise ValueError(f"unknown task_difficulty {task_difficulty!r}")
    state, _ = wait_until_stable(state, topo, params, max_steps=settle,
                                 sim_kw=sim_kw)
    heights = state.positions[0, 1][state.active[0]]
    if float(heights.max()) > MAX_TASK_HEIGHT:
        return None  # probably an error (tasks.py:473-475)
    state = center(state)
    coverage = float(get_current_covered_area(state.positions,
                                              state.active)[0])
    idx = torch.as_tensor(slots, device=dev)
    pos = state.positions[0][:, idx].T.cpu().numpy()
    inv = state.inv_mass[0][idx].cpu().numpy()
    return {
        "particle_pos": np.concatenate([pos, inv[:, None]], 1).reshape(-1),
        "particle_vel": state.velocities[0][:, idx].T.cpu().numpy()
        .reshape(-1),
        "initial_coverage": coverage,
        "shape_pos": np.zeros(2 * 14, np.float32),
        "phase": np.zeros(n, np.int32),
        "flatten_area": float(flattened_area),
        "flip_mesh": 0,
        "cloth_size": np.array([dimx, dimy]),
        "cloth_stiff": stiffness,
        "cloth_mass": cloth_mass,
        # shirts keep their own difficulty tag (tasks.py:478-482)
        "task_difficulty": "shirt" if mesh else task_difficulty,
        **mesh_arrays,
    }


def generate_tasks(path: str, num_tasks: int, seed: int = 0,
                   log: bool = True, **kwargs) -> int:
    """Generate tasks one at a time into the task archive `path` until it
    holds num_tasks (generate_tasks, tasks.py:921-949): resumable, the
    draws restart from np.random.default_rng(seed + the tasks already in
    the file); a rejected draw is skipped.  kwargs go to
    generate_randomization.  Returns the number of tasks in the file."""
    count = count_tasks(path)
    if count:
        print(f"[generate_tasks] resuming: {count} tasks exist", flush=True)
    rng = np.random.default_rng(seed + count)
    while count < num_tasks:
        t0 = time.perf_counter()
        task = generate_randomization(rng, **kwargs)
        if task is None:
            continue
        count = append_tasks(path, [task])
        if log:
            print(f"[generate_tasks] {count}/{num_tasks} "
                  f"({time.perf_counter() - t0:.2f} s)", flush=True)
    return count


def main(argv=None) -> int:
    """The task generation CLI (tasks.py:952-991)."""
    p = argparse.ArgumentParser(
        "python -m flingbot_tpu_torch.env.tasks",
        description="Generate tasks into a task archive (.npz, read by "
        "TaskLoader) on the card.  Square cloths go through the batched "
        "generator, whose defaults are the configuration "
        "scripts/generate_sets_r3.py runs (backend pallas, contact_mode "
        "sort, spring_mode gs, which the pallas step runs as Chebyshev), "
        "not the JAX CLI's xla / block; --sequential and --cloth_type "
        "mesh take the sequential generator at solver.step's JAX "
        "defaults.  Both run at the friction of the JAX package's "
        "committed rectangle sets (--gen_fric), not the production 0.1.")
    p.add_argument("--path", required=True)
    p.add_argument("--num_tasks", type=int, default=200)
    p.add_argument("--task_difficulty", default="hard",
                   choices=["hard", "easy"])
    p.add_argument("--cloth_type", default="square",
                   choices=["square", "mesh"])
    p.add_argument("--cloth_mesh_path", default=None,
                   help="directory searched for *_processed.obj meshes "
                   "(--cloth_type mesh)")
    p.add_argument("--min_cloth_size", type=int, default=64)
    p.add_argument("--max_cloth_size", type=int, default=104)
    p.add_argument("--strict_min_edge_length", type=int, default=64)
    p.add_argument("--max_grid_dim", type=int, default=104)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="pallas")
    p.add_argument("--spring_mode", default="gs")
    p.add_argument("--contact_mode", default="sort")
    p.add_argument("--gen_fric", type=float, default=GEN_FRICTION,
                   help="dynamic friction during generation (default "
                   "%(default)s)")
    p.add_argument("--sequential", action="store_true",
                   help="use the per-task generator (required for mesh)")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    params = SolverParams(dynamic_friction=f32(a.gen_fric))
    if a.sequential or a.cloth_type == "mesh":
        return generate_tasks(
            a.path, a.num_tasks, seed=a.seed,
            min_cloth_size=a.min_cloth_size,
            max_cloth_size=a.max_cloth_size,
            strict_min_edge_length=a.strict_min_edge_length,
            task_difficulty=a.task_difficulty, cloth_type=a.cloth_type,
            cloth_mesh_path=a.cloth_mesh_path, max_grid_dim=a.max_grid_dim,
            params=params, device=a.device)
    return generate_tasks_batch(
        a.path, a.num_tasks, batch=a.batch, seed=a.seed,
        min_cloth_size=a.min_cloth_size, max_cloth_size=a.max_cloth_size,
        strict_min_edge_length=a.strict_min_edge_length,
        task_difficulty=a.task_difficulty, max_grid_dim=a.max_grid_dim,
        backend=a.backend, spring_mode=a.spring_mode,
        contact_mode=a.contact_mode, solver_params=params, device=a.device)


if __name__ == "__main__":
    main()
