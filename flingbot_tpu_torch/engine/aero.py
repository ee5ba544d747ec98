"""Cloth aerodynamics: drag / lift / wind on the cloth surface
(counterpart of flingbot_tpu/engine/aero.py, grid cloths).

NvFlexParams semantics (NvFlex.h:120-122): drag and lift act on the
surface against the relative wind.  flingbot scenes leave all three at
zero; the solver runs this pass only when drag or lift is set.

    v_rel = v - wind
    a = -(drag * (v_rel . n) n + lift * t) * |v_rel|,  t = tangential part

Per-particle normals of a lattice cloth come from central differences of
its two surface tangents.
"""

from __future__ import annotations

import torch

from flingbot_tpu_torch.engine.topology import shift2d

_EPS = 1e-9


def grid_normals(P: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Unit normals of lattice cloths P (B, 3, H, W); zero outside the
    cloth (valid (B, H, W))."""
    ty = shift2d(P, 1, 0) - shift2d(P, -1, 0)
    tx = shift2d(P, 0, 1) - shift2d(P, 0, -1)
    n0 = ty[:, 1] * tx[:, 2] - ty[:, 2] * tx[:, 1]
    n1 = ty[:, 2] * tx[:, 0] - ty[:, 0] * tx[:, 2]
    n2 = ty[:, 0] * tx[:, 1] - ty[:, 1] * tx[:, 0]
    norm = torch.sqrt(n0 * n0 + n1 * n1 + n2 * n2 + _EPS)
    n = torch.stack([n0, n1, n2], 1) / norm[:, None]
    return torch.where(valid[:, None], n, 0.0)


def aero_accel(V: torch.Tensor, normals: torch.Tensor, params,
               moving: torch.Tensor) -> torch.Tensor:
    """Acceleration from drag / lift / wind.  V, normals (B, 3, ...);
    moving (B, ...)."""
    wind = torch.tensor(params.wind, dtype=V.dtype, device=V.device).view(
        (1, 3) + (1,) * (V.dim() - 2))
    vr = V - wind
    speed = torch.sqrt(vr[:, 0] * vr[:, 0] + vr[:, 1] * vr[:, 1]
                       + vr[:, 2] * vr[:, 2] + _EPS)
    vn = (vr[:, 0] * normals[:, 0] + vr[:, 1] * normals[:, 1]
          + vr[:, 2] * normals[:, 2])
    normal_part = vn[:, None] * normals
    tangential = vr - normal_part
    f = -(params.drag * normal_part + params.lift * tangential) \
        * speed[:, None]
    return torch.where(moving[:, None], f, 0.0)
