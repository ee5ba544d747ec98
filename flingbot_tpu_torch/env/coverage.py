"""Top-down coverage metric, the reward (counterpart of
flingbot_tpu/env/coverage.py).

Discretize the particle AABB in the ground plane into a 100x100 grid, mark
every cell within +-radius of a particle (per-axis box test through index
rounding) and return covered_cells * cell_area
(get_current_covered_area, flex_utils.py:358-395).  Each particle stamps a
K_SPAN x K_SPAN block of ones into the grid.
"""

from __future__ import annotations

import torch

GRID = 100
K_SPAN = 15
_CHUNK_ELEMS = 1 << 25  # bound on stamp indices built at once


def get_current_covered_area(positions: torch.Tensor,
                             active: torch.Tensor | None = None,
                             particle_radius: float = 0.00625
                             ) -> torch.Tensor:
    """Covered area (B,) in m^2 of each env's masked particle cloud.
    positions (B, 3, N); active (B, N) bool or None."""
    B, _, N = positions.shape
    if active is None:
        active = torch.ones(B, N, dtype=torch.bool, device=positions.device)
    per = max(1, _CHUNK_ELEMS // max(1, N * K_SPAN * K_SPAN))
    return torch.cat([
        _covered(positions[s:s + per], active[s:s + per], particle_radius)
        for s in range(0, B, per)])


def _covered(p, active, r):
    B = p.shape[0]
    x, z = p[:, 0], p[:, 2]
    big = 1e9
    min_x = torch.where(active, x, big).amin(1, keepdim=True)
    max_x = torch.where(active, x, -big).amax(1, keepdim=True)
    min_z = torch.where(active, z, big).amin(1, keepdim=True)
    max_z = torch.where(active, z, -big).amax(1, keepdim=True)
    span_x = torch.clamp((max_x - min_x) / GRID, min=1e-6)
    span_z = torch.clamp((max_z - min_z) / GRID, min=1e-6)
    off_x = x - min_x
    off_z = z - min_z
    lo_x = torch.clamp(torch.round((off_x - r) / span_x).to(torch.int64),
                       min=0)
    hi_x = torch.clamp(torch.round((off_x + r) / span_x).to(torch.int64),
                       max=GRID)
    lo_z = torch.clamp(torch.round((off_z - r) / span_z).to(torch.int64),
                       min=0)
    hi_z = torch.clamp(torch.round((off_z + r) / span_z).to(torch.int64),
                       max=GRID)
    ks = torch.arange(K_SPAN, device=p.device)
    ix = torch.minimum(lo_x[..., None] + ks, hi_x[..., None])  # (B, N, K)
    iz = torch.minimum(lo_z[..., None] + ks, hi_z[..., None])
    cell = torch.clamp(ix[..., :, None] * GRID + iz[..., None, :], 0,
                       GRID * GRID - 1)
    cell = torch.where(active[..., None, None], cell, GRID * GRID)
    grid = torch.zeros(B, GRID * GRID + 1, device=p.device)
    grid.scatter_(1, cell.reshape(B, -1), 1.0)
    stamped = grid[:, :GRID * GRID].sum(1, keepdim=True) * span_x * span_z
    r2 = 2.0 * r
    degenerate = ((span_x * (K_SPAN - 2) < r2)
                  & (span_z * (K_SPAN - 2) < r2))
    aabb = (max_x - min_x + r2) * (max_z - min_z + r2)
    return torch.where(degenerate, aabb, stamped)[:, 0]
