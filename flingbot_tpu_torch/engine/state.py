"""Cloth state and solver parameters (counterpart of
flingbot_tpu/engine/state.py).

`ClothState` is batched.  Grid cloths keep lattice order: particle slot
y * W + x of an (H, W) lattice, positions (B, 3, H*W); slots outside an
env's (dimy, dimx) cloth are inactive and never move.  Layered shirts keep
their lattice's slots, generic meshes the mesh's vertex order padded to a
capacity.

The solver's per-frame constants (kernel parameters, substep length,
gravity, wind, the plain sort's scalars) come from `device_constant`,
which uploads each value once a process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.utils import trace

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


_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
                 torch.int32: np.int32}
_CONSTANTS: dict = {}  # (device, dtype, shape, bytes) -> device tensor


def device_constant(data, *, dtype, device) -> torch.Tensor:
    """`data` as a tensor of `dtype` on `device`, uploaded once a process
    for each value.  The solver uploads the same few constants on every
    frame, and on a card each upload from pageable host memory waits
    until the stream has drained; so the tensor made at the first call is
    kept and handed to every later call with the same value.  The key is
    the value's bytes in `dtype` (so -0.0, NaN and float32 rounding key
    exactly), its shape, dtype and device.  A miss uploads through
    trace.upload (counted under host_syncs, a solver.sync span); a hit
    counts const_hits.  The tensor is shared: callers view, expand or
    compute from it and never write into it."""
    array = np.asarray(data, dtype=_NUMPY_DTYPES[dtype])
    key = (torch.device(device), dtype, array.shape, array.tobytes())
    tensor = _CONSTANTS.get(key)
    if tensor is None:
        tensor = _CONSTANTS[key] = trace.upload(array, dtype=dtype,
                                                device=device)
    else:
        trace.count("const_hits")
    return tensor


def clear_device_constants():
    """Forget every kept constant, so that the next call of each value
    uploads again (tests start from a known count)."""
    _CONSTANTS.clear()


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
      time          (B,)      f32   sim time
      step_count    (B,)      i64   solver steps taken (a reload restarts
                                    its slot at 0)
      sweep_perm    (B, N)    i64   cached Morton order of the sweep and
      sweep_inv     (B, N)    i64   block contacts, and its inverse

    The last four default to step 0 and identity permutations, as
    ClothState.create starts them (flingbot_tpu/engine/state.py:139-207).
    """

    positions: torch.Tensor
    velocities: torch.Tensor
    inv_mass: torch.Tensor
    rest_inv_mass: torch.Tensor
    active: torch.Tensor
    picker_pos: torch.Tensor
    picked_idx: torch.Tensor
    time: torch.Tensor | None = None
    step_count: torch.Tensor | None = None
    sweep_perm: torch.Tensor | None = None
    sweep_inv: torch.Tensor | None = None

    def __post_init__(self):
        B, _, N = self.positions.shape
        dev = self.positions.device
        if self.time is None:
            self.time = torch.zeros(B, dtype=torch.float32, device=dev)
        if self.step_count is None:
            self.step_count = torch.zeros(B, dtype=torch.int64, device=dev)
        ident = torch.arange(N, device=dev).expand(B, N)
        if self.sweep_perm is None:
            self.sweep_perm = ident.clone()
        if self.sweep_inv is None:
            self.sweep_inv = ident.clone()

    @classmethod
    def create(cls, positions, inv_mass, capacity: int | None = None,
               num_pickers: int = NUM_PICKERS,
               device="cuda") -> "ClothState":
        """A batch-1 state from (n, 3) positions and (n,) inverse masses
        padded to `capacity` slots, at rest, pickers parked at -10, step 0
        (ClothState.create, flingbot_tpu/engine/state.py:176-207)."""
        pos = np.asarray(positions, np.float32).reshape(-1, 3)
        inv = np.asarray(inv_mass, np.float32).reshape(-1)
        n = len(pos)
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} particles")
        P = np.zeros((1, 3, cap), np.float32)
        P[0, :, :n] = pos.T
        w = np.zeros((1, cap), np.float32)
        w[0, :n] = inv
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        return cls(
            positions=t(P), velocities=t(np.zeros_like(P)), inv_mass=t(w),
            rest_inv_mass=t(w.copy()), active=t(np.arange(cap)[None] < n),
            picker_pos=t(np.full((1, num_pickers, 3), -10.0, np.float32)),
            picked_idx=t(np.full((1, num_pickers), -1, np.int64)))

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

    def set_slots(self, idx: torch.Tensor,
                  other: "ClothState") -> "ClothState":
        """This batch with env slots `idx` (K,) set from the K-env batch
        `other` (the JAX env's `b.at[idx].set(x)`, batch_env.py:672-677)."""
        return ClothState(**{k: v.index_copy(0, idx, getattr(other, k))
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

