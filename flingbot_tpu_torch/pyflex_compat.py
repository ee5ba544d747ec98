"""A `pyflex`-style module API over one cloth (counterpart of
flingbot_tpu/pyflex_compat.py).

The reference exposes its simulator as a global-state module, one scene
per process (`import pyflex; pyflex.init(); pyflex.set_scene(...);
pyflex.step()`).  This module offers the same functions over one
B = 1 ClothState, so that code written against pyflex ports mechanically:

    from flingbot_tpu_torch import pyflex_compat as pyflex
    pyflex.init(True, True, 720, 720)          # device="cuda" by default
    pyflex.set_scene(0, scene_params, ...)     # or set_scene_config(config)
    pyflex.step()
    pos = pyflex.get_positions()

Particle arrays go in and out in the reference's order (a grid cloth's
canonical y * dimx + x, a mesh's vertex order), flat, positions with the
inverse mass as a fourth column.  step() runs the JAX solver.step's
defaults (tasks.SEQ_SIM_KW: backend "xla", Gauss-Seidel springs, block
contacts), as the JAX module does.  Prefer env.scene and engine.solver for
new code.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.engine.solver import step as _solver_step
from flingbot_tpu_torch.engine.state import (
    MAX_GRID_DIM, ClothState, SolverParams)
from flingbot_tpu_torch.engine.topology import (
    GridTopology, grid_triangles_np)
from flingbot_tpu_torch.env.scene import (
    MESH_EDGE_CAPACITY, MESH_TRI_CAPACITY, MESH_VERT_CAPACITY, ShirtTask,
    Task, make_batch)
from flingbot_tpu_torch.env.tasks import SEQ_SIM_KW
from flingbot_tpu_torch.render.rasterizer import render_rgbd as _render_rgbd

PARKED = -10.0  # picker positions of a fresh scene (ClothState.create)


class _Sim:
    device: Optional[torch.device] = None
    topo = None
    state: Optional[ClothState] = None
    params = SolverParams()
    render_dim = 720
    sphere_count = 0
    slots: Optional[torch.Tensor] = None  # (n,) lattice slot of particle i


_sim = _Sim()


def init(headless: bool = True, render: bool = True, width: int = 720,
         height: int = 720, device="cuda"):
    """pyflex.init parity (pyflex.cpp:15-124): no GL context; the scene
    lives on `device`, CUDA unless the caller asks for the CPU."""
    _sim.device = resolve_device(device)
    _sim.render_dim = width


def set_scene(scene_idx=0, scene_params=None, vertices=(), stretch_edges=(),
              bend_edges=(), shear_edges=(), faces=(), thread_idx=0):
    """pyflex.set_scene parity: unpack the 19-float param vector
    (flex_utils.py:332-342 packing order) and the mesh arrays."""
    p = np.asarray(scene_params, np.float64).reshape(-1)
    set_scene_config({
        "cloth_pos": p[0:3],
        "cloth_size": [int(p[3]), int(p[4])],
        "cloth_stiff": p[5:8],
        "cloth_mass": float(p[17]) if len(p) > 17 else 0.5,
        "flip_mesh": int(p[18]) if len(p) > 18 else 0,
        "mesh_verts": np.asarray(vertices),
        "mesh_stretch_edges": np.asarray(stretch_edges),
        "mesh_bend_edges": np.asarray(bend_edges),
        "mesh_shear_edges": np.asarray(shear_edges),
        "mesh_faces": np.asarray(faces),
    })


def set_scene_config(config, state=None):
    """A scene from a task config (Task.get_config) and optionally its
    saved state (Task.get_state: particle_pos, particle_vel, shape_pos):
    set_scene parity (scene.py:186-199).  A mesh takes the generic mesh
    path at the JAX default capacities; pickers start at PARKED."""
    if _sim.device is None:
        raise RuntimeError("call init() first")
    state = state or {}
    common = dict(
        particle_pos=state.get("particle_pos"),
        particle_vel=state.get("particle_vel"),
        cloth_mass=float(config.get("cloth_mass", 0.5)),
        cloth_stiff=tuple(np.asarray(config.get("cloth_stiff",
                                                (0.8, 1.0, 0.9)))[:3]),
        cloth_pos=tuple(np.asarray(config.get("cloth_pos", (0, 0, 0)))))
    verts = np.asarray(config.get("mesh_verts", ()), np.float32).reshape(-1)
    if verts.size:
        task = ShirtTask(**{k: np.asarray(config[k]).reshape(-1) for k in (
            "mesh_stretch_edges", "mesh_bend_edges", "mesh_shear_edges",
            "mesh_faces")}, mesh_verts=verts, **common)
        topo, st = make_batch([task], device=_sim.device, mesh_caps=(
            MESH_VERT_CAPACITY, MESH_EDGE_CAPACITY, MESH_TRI_CAPACITY))
        slots = torch.arange(verts.size // 3)
    else:
        dimx, dimy = (int(v) for v in config["cloth_size"])
        topo, st = make_batch([Task(cloth_size=(dimx, dimy), **common)],
                              max_grid_dim=MAX_GRID_DIM, device=_sim.device)
        iy, ix = np.divmod(np.arange(dimx * dimy), dimx)
        slots = torch.as_tensor(iy * MAX_GRID_DIM + ix)
    picker = torch.full_like(st.picker_pos, PARKED)
    shape_pos = np.asarray(state.get("shape_pos", ()), np.float32)
    if shape_pos.size:
        sp = torch.as_tensor(shape_pos.reshape(-1, 14)[:, :3])
        k = min(sp.shape[0], picker.shape[1])
        picker[0, :k] = sp[:k].to(picker.device)
    _sim.topo = topo
    _sim.state = st.replace(picker_pos=picker)
    _sim.slots = slots.to(_sim.device)
    _sim.sphere_count = 0


def step():
    _sim.state = _solver_step(_sim.state, _sim.topo, _sim.params,
                              **SEQ_SIM_KW)


def render():
    """(flat RGBA uint8 (S * S * 4,), flat depth (S * S,)), bottom row
    first as pyflex returns them (callers flip them, flex_utils.py:421-422):
    the particles as disks (render_rgbd without faces)."""
    rgb, depth = _render_rgbd(_sim.state.positions, _sim.state.active,
                              image_size=_sim.render_dim)
    rgb = rgb[0].cpu().numpy()
    rgba = np.concatenate([rgb, np.ones(rgb.shape[:2] + (1,), np.float32)],
                          axis=-1)
    return (np.flip((rgba * 255).astype(np.uint8), 0).reshape(-1),
            np.flip(depth[0].cpu().numpy(), 0).reshape(-1))


def _particles(x: torch.Tensor) -> np.ndarray:
    """(C, N) lattice values of the one env -> (n, C) in particle order."""
    return x[:, _sim.slots].T.cpu().numpy()


def get_positions():
    st = _sim.state
    return np.concatenate([_particles(st.positions[0]),
                           _particles(st.inv_mass[0][None])], 1).reshape(-1)


def set_positions(flat):
    arr = torch.as_tensor(np.asarray(flat, np.float32).reshape(-1, 4),
                          device=_sim.device)
    idx = _sim.slots[:arr.shape[0]]
    pos = _sim.state.positions.clone()
    inv = _sim.state.inv_mass.clone()
    pos[0][:, idx] = arr[:, :3].T
    inv[0, idx] = arr[:, 3]
    _sim.state = _sim.state.replace(positions=pos, inv_mass=inv)


def get_velocities():
    return _particles(_sim.state.velocities[0]).reshape(-1)


def set_velocities(flat):
    arr = torch.as_tensor(np.asarray(flat, np.float32).reshape(-1, 3),
                          device=_sim.device)
    vel = _sim.state.velocities.clone()
    vel[0][:, _sim.slots[:arr.shape[0]]] = arr.T
    _sim.state = _sim.state.replace(velocities=vel)


def get_phases():
    return np.zeros(len(_sim.slots), np.int32)


def set_phases(phases):
    pass  # one cloth phase group


def get_faces():
    """The cloth's triangles in particle order, flat."""
    topo = _sim.topo
    if isinstance(topo, GridTopology):
        return grid_triangles_np(int(topo.dimx[0]),
                                 int(topo.dimy[0])).reshape(-1)
    tris = topo.triangles[0][topo.tri_mask[0]]
    return tris.cpu().numpy().reshape(-1)


def add_sphere(radius, position, quat):
    """Picker spheres (flex_utils.py:83)."""
    i = _sim.sphere_count
    pp = _sim.state.picker_pos
    if i < pp.shape[1]:
        pp = pp.clone()
        pp[0, i] = torch.as_tensor(np.asarray(position, np.float32),
                                   device=pp.device)
        _sim.state = _sim.state.replace(picker_pos=pp)
    _sim.sphere_count += 1


def get_shape_states():
    pp = _sim.state.picker_pos[0].cpu().numpy()
    out = np.zeros((pp.shape[0], 14), np.float32)
    out[:, :3] = pp
    out[:, 3:6] = pp
    out[:, 6] = 1.0
    out[:, 10] = 1.0
    return out.reshape(-1)


def set_shape_states(flat):
    sp = np.asarray(flat, np.float32).reshape(-1, 14)
    pp = _sim.state.picker_pos.clone()
    k = min(sp.shape[0], pp.shape[1])
    pp[0, :k] = torch.as_tensor(sp[:k, :3], device=pp.device)
    _sim.state = _sim.state.replace(picker_pos=pp)


def set_camera_params(params):
    pass  # fixed top-down camera; kept for API parity
