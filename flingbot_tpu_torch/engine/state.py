"""Cloth state and solver parameters (counterpart of
flingbot_tpu/engine/state.py).

`ClothState` is batched and kept in lattice order: particle slot
y * W + x of an (H, W) lattice, positions (B, 3, H*W).  Slots outside an
env's (dimy, dimx) cloth are inactive and never move.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PARTICLE_RADIUS = 0.00625
DEFAULT_DT = 1.0 / 100.0
DEFAULT_SUBSTEPS = 4
DEFAULT_ITERATIONS = 30
MAX_GRID_DIM = 104
NUM_PICKERS = 2
FLEX_SCENE_FRICTION = 0.75


def f32(x) -> float:
    """Round a Python number to float32 (the JAX package keeps every
    solver scalar as a float32 array)."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """XPBD solver parameters, shared by every env of a batch.  Defaults
    and meanings are those of flingbot_tpu.engine.state.SolverParams."""

    dt: float = f32(DEFAULT_DT)
    gravity: tuple = (0.0, -9.8, 0.0)
    damping: float = 1.0
    # behaviourally calibrated production friction (0.75 is the raw scene
    # constant, FLEX_SCENE_FRICTION)
    dynamic_friction: float = f32(0.1)
    particle_friction: float = 1.0
    picker_friction: float = 0.0
    radius: float = f32(PARTICLE_RADIUS * 1.8)
    collision_distance: float = f32(0.005)
    drag: float = 0.0
    lift: float = 0.0
    wind: tuple = (0.0, 0.0, 0.0)
    relaxation_factor: float = 1.0
    max_acceleration: float = 100.0
    chebyshev_rho: float = f32(0.992)

    def replace(self, **kw) -> "SolverParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class ClothState:
    """Batched per-env simulator state in lattice order.

      positions     (B, 3, N) f32   N = H * W lattice slots
      velocities    (B, 3, N) f32
      inv_mass      (B, N)    f32   0 => anchored (picked)
      rest_inv_mass (B, N)    f32   inverse mass before any grasp
      active        (B, N)    bool  slot holds a cloth particle
      picker_pos    (B, P, 3) f32   gripper sphere centres
      picked_idx    (B, P)    i64   grasped lattice slot, -1 if none
    """

    positions: torch.Tensor
    velocities: torch.Tensor
    inv_mass: torch.Tensor
    rest_inv_mass: torch.Tensor
    active: torch.Tensor
    picker_pos: torch.Tensor
    picked_idx: torch.Tensor

    @property
    def batch(self) -> int:
        return self.positions.shape[0]

    @property
    def num_particles(self) -> int:
        return self.positions.shape[2]

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def replace(self, **kw) -> "ClothState":
        return dataclasses.replace(self, **kw)

    def fields(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def index(self, idx) -> "ClothState":
        return ClothState(**{k: v[idx] for k, v in self.fields().items()})

    def to(self, device) -> "ClothState":
        return ClothState(**{k: v.to(device)
                             for k, v in self.fields().items()})


def where_state(mask: torch.Tensor, a: ClothState,
                b: ClothState) -> ClothState:
    """Per-env select: env i takes `a` where mask[i], else `b`."""
    out = {}
    for k, va in a.fields().items():
        vb = getattr(b, k)
        m = mask.view((-1,) + (1,) * (va.dim() - 1))
        out[k] = torch.where(m, va, vb)
    return ClothState(**out)

