"""Task model and task files (counterpart of flingbot_tpu/env/tasks.py:
Task, TaskLoader and the topology bucket detection).

The eval task sets are flingbot-format HDF5 files; the port reads them as
the `.npz` archives that `tools/export_tasks_npz.py` writes (one entry
"<task key>/<dataset>" per dataset, "<task key>/@<attr>" per group
attribute), with numpy alone.  Tasks are served in sorted key order, as
the JAX TaskLoader serves the HDF5 groups.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from flingbot_tpu_torch.engine.topology import MESH_KEYS, compute_layered_spec

ATTR_PREFIX = "@"

# padded capacities of the generic mesh path (flingbot_tpu/env/scene.py:
# MESH_*_CAPACITY), the ceilings of detect_mesh_caps
MESH_VERT_CAPACITY = 8192
MESH_EDGE_CAPACITY = 65536
MESH_TRI_CAPACITY = 16384


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
    generic mesh path, which the port does not have) (tasks.py:248-256)."""
    spec = detect_layered_spec(npz_path)
    if spec is not None:
        return {"mesh_caps": None, "layered_spec": spec}
    return {"mesh_caps": detect_mesh_caps(npz_path), "layered_spec": None}
