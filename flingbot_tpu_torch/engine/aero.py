"""Cloth aerodynamics: drag / lift / wind on the cloth surface
(counterpart of flingbot_tpu/engine/aero.py).

NvFlexParams semantics (NvFlex.h:120-122): drag and lift act on the
surface against the relative wind.  flingbot scenes leave all three at
zero; the solver runs this pass only when drag or lift is set.

    v_rel = v - wind
    a = -(drag * (v_rel . n) n + lift * t) * |v_rel|,  t = tangential part

Per-particle normals of a lattice cloth come from central differences of
its two surface tangents; those of a mesh (a generic mesh or a layered
shirt) from the area-weighted normals of its incident triangles.
"""

from __future__ import annotations

import torch

from flingbot_tpu_torch.engine.state import device_constant
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


def mesh_normals(P: torch.Tensor, triangles: torch.Tensor,
                 tri_mask: torch.Tensor, active: torch.Tensor,
                 vert_tri: torch.Tensor,
                 vert_tri_mask: torch.Tensor) -> torch.Tensor:
    """Coherence-scaled vertex normals of meshes P (B, 3, N) (mesh_normals,
    aero.py:43-72): the sum of the area-weighted normals of a vertex's
    triangles over the sum of their areas, so |n| = 1 on a coherent
    surface and n -> 0 at a fold where the faces cancel.  triangles
    (B, T, 3), tri_mask (B, T); active (B, N).  The JAX package
    scatter-adds the faces to their corners; here each vertex gathers its
    faces through the incidence table vert_tri / vert_tri_mask
    (B, Dt, N), a fixed order on every device (a float scatter-add on the
    card sums in no fixed order)."""
    B, _, N = P.shape
    T = triangles.shape[1]
    idx = triangles.reshape(B, 1, T * 3).expand(B, 3, T * 3)
    corner = torch.gather(P, 2, idx).view(B, 3, T, 3)
    a, b, c = corner[..., 0], corner[..., 1], corner[..., 2]
    e1, e2 = b - a, c - a
    fn = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                      e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                      e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], 1)
    fn = torch.where(tri_mask[:, None], fn, 0.0)
    mag = torch.sqrt(fn[:, 0] * fn[:, 0] + fn[:, 1] * fn[:, 1]
                     + fn[:, 2] * fn[:, 2])
    D = vert_tri.shape[1]
    flat = vert_tri.reshape(B, 1, D * N)
    fv = torch.gather(fn, 2, flat.expand(B, 3, D * N)).view(B, 3, D, N)
    mv = torch.gather(mag, 1, flat[:, 0]).view(B, D, N)
    acc = torch.where(vert_tri_mask[:, None], fv, 0.0).sum(2)
    area = torch.where(vert_tri_mask, mv, 0.0).sum(1)
    n = acc / torch.clamp(area, min=1e-12)[:, None]
    return torch.where(active[:, None], n, 0.0)


def aero_accel(V: torch.Tensor, normals: torch.Tensor, params,
               moving: torch.Tensor) -> torch.Tensor:
    """Acceleration from drag / lift / wind.  V, normals (B, 3, ...);
    moving (B, ...)."""
    wind = device_constant(params.wind, dtype=V.dtype, device=V.device)
    wind = wind.view((1, 3) + (1,) * (V.dim() - 2))
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
