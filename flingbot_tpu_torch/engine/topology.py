"""Grid cloth topology (counterpart of the grid part of
flingbot_tpu/engine/topology.py).

Grid springs are never materialized as edge lists: the solver walks the six
CreateSpringGrid stencil classes directly on the (H, W) lattice.  Dims are
per env, because the envs of one batch hold cloths of different sizes
(<= max_dimx x max_dimy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.engine.state import MAX_GRID_DIM, PARTICLE_RADIUS, f32

SQRT2 = float(np.sqrt(2.0))

# (dy, dx, rest_in_spacings, stiffness_class); classes 0=stretch 1=bend
# 2=shear (CreateSpringGrid, helpers.h:872-925)
GRID_STENCIL_CLASSES = (
    (0, 1, 1.0, 0),
    (1, 0, 1.0, 0),
    (0, 2, 2.0, 1),
    (2, 0, 2.0, 1),
    (1, 1, SQRT2, 2),
    (1, -1, SQRT2, 2),
)


@dataclasses.dataclass
class GridTopology:
    """Batched grid topology: dimx varies fastest (canonical flat index
    y * dimx + x; lattice slot y * max_dimx + x)."""

    dimx: torch.Tensor  # (B,) i64
    dimy: torch.Tensor  # (B,) i64
    stiffness: torch.Tensor  # (B, 3) f32: stretch, bend, shear
    spacing: float  # rest spacing between particles (float32 value)
    max_dimx: int = MAX_GRID_DIM
    max_dimy: int = MAX_GRID_DIM
    # every env has dimx == max_dimx and dimy == max_dimy: canonical and
    # lattice order coincide, so layout conversions are reshapes
    full_grid: bool = False

    @property
    def capacity(self) -> int:
        return self.max_dimx * self.max_dimy

    @property
    def batch(self) -> int:
        return self.dimx.shape[0]

    def index(self, idx) -> "GridTopology":
        return dataclasses.replace(
            self, dimx=self.dimx[idx], dimy=self.dimy[idx],
            stiffness=self.stiffness[idx])

    def to(self, device) -> "GridTopology":
        return dataclasses.replace(
            self, dimx=self.dimx.to(device), dimy=self.dimy.to(device),
            stiffness=self.stiffness.to(device))


def grid_positions(dimx: int, dimy: int, lower=(0.0, 0.0, 0.0),
                   spacing: float = PARTICLE_RADIUS) -> np.ndarray:
    """(dimx*dimy, 3) positions of a flat grid in the x-z plane, canonical
    flat index y * dimx + x (CreateSpringGrid layout)."""
    xs = np.arange(dimx) * spacing
    zs = np.arange(dimy) * spacing
    zz, xx = np.meshgrid(zs, xs, indexing="ij")
    pos = np.stack(
        [xx + lower[0], np.full_like(xx, lower[1]), zz + lower[2]], axis=-1)
    return pos.reshape(-1, 3).astype(np.float32)


def build_grid_topology(dimx, dimy, stiffness=(0.9, 1.0, 0.9),
                        spacing: float = PARTICLE_RADIUS,
                        max_dimx: int = MAX_GRID_DIM,
                        max_dimy: int = MAX_GRID_DIM,
                        device="cuda") -> GridTopology:
    """dimx, dimy: ints or per-env sequences; stiffness (3,) or (B, 3).
    The topology lives on `device`: CUDA unless the caller asks for the
    CPU."""
    device = resolve_device(device)
    dx = torch.as_tensor(np.atleast_1d(np.asarray(dimx, np.int64)))
    dy = torch.as_tensor(np.atleast_1d(np.asarray(dimy, np.int64)))
    B = max(dx.shape[0], dy.shape[0])
    dx = dx.expand(B).clone()
    dy = dy.expand(B).clone()
    assert int(dx.max()) <= max_dimx and int(dy.max()) <= max_dimy
    st = torch.as_tensor(np.asarray(stiffness, np.float32)).reshape(-1, 3)
    st = st.expand(B, 3).clone()
    full = bool((dx == max_dimx).all() and (dy == max_dimy).all())
    return GridTopology(
        dimx=dx.to(device), dimy=dy.to(device), stiffness=st.to(device),
        spacing=f32(spacing), max_dimx=max_dimx, max_dimy=max_dimy,
        full_grid=full)


def lattice_valid(dimx, dimy, H: int, W: int) -> torch.Tensor:
    """(B, H, W) bool: lattice slot lies inside the env's cloth."""
    dev = dimx.device
    iy = torch.arange(H, device=dev).view(1, H, 1)
    ix = torch.arange(W, device=dev).view(1, 1, W)
    return (iy < dimy.view(-1, 1, 1)) & (ix < dimx.view(-1, 1, 1))


def _canonical_of_lattice(topo: GridTopology):
    """(B, H*W) canonical flat index of each lattice slot, and validity."""
    H, W = topo.max_dimy, topo.max_dimx
    valid = lattice_valid(topo.dimx, topo.dimy, H, W)
    dev = topo.dimx.device
    iy = torch.arange(H, device=dev).view(1, H, 1)
    ix = torch.arange(W, device=dev).view(1, 1, W)
    flat = torch.where(valid, iy * topo.dimx.view(-1, 1, 1) + ix, 0)
    return flat.reshape(flat.shape[0], -1), valid.reshape(valid.shape[0], -1)


def gather_to_lattice(x: torch.Tensor, topo: GridTopology, fill=0.0):
    """Canonical (B, ..., N) -> lattice (B, ..., H*W); slots outside the
    cloth take `fill`.  (gather_to_lattice, solver.py:95-111.)"""
    if topo.full_grid:
        return x
    flat, valid = _canonical_of_lattice(topo)
    lead = x.shape[1:-1]
    idx = flat.view((flat.shape[0],) + (1,) * len(lead) + (-1,))
    idx = idx.expand(x.shape[:-1] + (flat.shape[1],))
    out = torch.gather(x, -1, idx)
    v = valid.view((valid.shape[0],) + (1,) * len(lead) + (-1,))
    return torch.where(v, out, torch.as_tensor(fill, dtype=x.dtype,
                                               device=x.device))


def scatter_from_lattice(lattice: torch.Tensor, x: torch.Tensor,
                         topo: GridTopology) -> torch.Tensor:
    """Lattice (B, ..., H*W) -> canonical (B, ..., N), keeping `x` where
    the canonical slot is padding.  (scatter_from_lattice, solver.py:
    113-136.)"""
    if topo.full_grid:
        return lattice
    flat, valid = _canonical_of_lattice(topo)
    n = x.shape[-1]
    lead = lattice.shape[1:-1]
    # slots outside the cloth land in one dropped extra column
    flat = torch.where(valid, flat, n)
    out = torch.cat([x, x[..., :1]], -1)
    idx = flat.view((flat.shape[0],) + (1,) * len(lead) + (-1,))
    out.scatter_(-1, idx.expand(lattice.shape), lattice)
    return out[..., :n]


def grid_triangles_dynamic(dimx, dimy, max_dimx: int, max_dimy: int):
    """Padded (B, T, 3) lattice-slot triangles + (B, T) mask of grid
    cloths with per-env dims; triangle t matches grid_triangles_dynamic
    (topology.py:602) with canonical ids replaced by lattice slots."""
    dev = dimx.device
    n_cells = (max_dimx - 1) * (max_dimy - 1)
    t = torch.arange(2 * n_cells, device=dev)
    cell = t // 2
    second = (t % 2) == 1
    cx = cell % (max_dimx - 1)
    cy = cell // (max_dimx - 1)
    ok = (cx[None] < dimx.view(-1, 1) - 1) & (cy[None] < dimy.view(-1, 1) - 1)
    a = cy * max_dimx + cx
    b = a + 1
    c = a + max_dimx + 1
    d = a + max_dimx
    tri = torch.where(second[:, None], torch.stack([a, c, d], 1),
                      torch.stack([a, b, c], 1))
    tri = torch.where(ok[..., None], tri[None], 0)
    return tri, ok
