"""Procedural Cloth3D-style shirt meshes for the shirt eval protocol (a
numpy-only copy of flingbot_tpu/env/shirts.py).

The reference's shirt tasks load Cloth3D-derived quad-mesh garments
(reference: environment/tasks.py:131-142; README.md:136-141 'flingbot-
shirt-eval').  The Cloth3D assets themselves are not redistributable, so
this module constructs equivalent garments: a two-layer T-shirt quad mesh
(front + back panels sewn along shoulders, sides and sleeve seams; collar,
cuffs and hem left open) written as a `*_processed.obj` that the standard
quad-cloth loader (engine/topology.load_cloth, same contract as the reference
loader) consumes unchanged.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def _t_shape_cells(body_cols: int, body_rows: int, sleeve_cols: int,
                   sleeve_rows: int) -> np.ndarray:
    """Boolean (rows, cols) mask of active cells of a T laid flat:
    row 0 = shoulder line, sleeves span the full width for the top
    `sleeve_rows` rows; below that only the body columns are active."""
    rows = body_rows
    cols = body_cols + 2 * sleeve_cols
    mask = np.zeros((rows, cols), bool)
    mask[:sleeve_rows, :] = True
    mask[:, sleeve_cols:sleeve_cols + body_cols] = True
    return mask


def make_shirt_mesh(
    body_w: float = 0.36,
    body_h: float = 0.48,
    sleeve_l: float = 0.14,
    sleeve_h: float = 0.14,
    collar_w: float = 0.12,
    spacing: float = 0.0125,
    thickness: float = 0.006,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build the two-layer sewn shirt.  Returns (verts (V,3) float32,
    quads (Q,4) int64).  The garment lies in the x-z plane (y = layer)."""
    body_cols = max(2, round(body_w / spacing))
    body_rows = max(2, round(body_h / spacing))
    sleeve_cols = max(1, round(sleeve_l / spacing))
    sleeve_rows = max(1, round(sleeve_h / spacing))
    collar_cols = max(1, round(collar_w / spacing))
    cells = _t_shape_cells(body_cols, body_rows, sleeve_cols, sleeve_rows)
    R, C = cells.shape

    # grid points incident to >= 1 active cell
    pt_active = np.zeros((R + 1, C + 1), bool)
    rr, cc = np.nonzero(cells)
    for dr in (0, 1):
        for dc in (0, 1):
            pt_active[rr + dr, cc + dc] = True

    # boundary points: not surrounded by 4 active cells
    def cell_at(r, c):
        ok = (r >= 0) & (r < R) & (c >= 0) & (c < C)
        out = np.zeros(np.broadcast(r, c).shape, bool)
        out[ok] = cells[np.clip(r, 0, R - 1), np.clip(c, 0, C - 1)][ok]
        return out

    pr, pc = np.meshgrid(np.arange(R + 1), np.arange(C + 1), indexing="ij")
    surrounded = (cell_at(pr - 1, pc - 1) & cell_at(pr - 1, pc)
                  & cell_at(pr, pc - 1) & cell_at(pr, pc))
    boundary = pt_active & ~surrounded

    # open (unsewn) boundary segments: collar on the shoulder line, hem at
    # the bottom of the body, cuffs at the sleeve ends
    open_pts = np.zeros_like(boundary)
    c0 = sleeve_cols + (body_cols - collar_cols) // 2
    open_pts[0, c0:c0 + collar_cols + 1] = True          # collar
    open_pts[body_rows, :] = True                         # hem
    open_pts[: sleeve_rows + 1, 0] = True                 # left cuff
    open_pts[: sleeve_rows + 1, C] = True                 # right cuff
    sewn = boundary & ~open_pts

    # vertex ids: front layer for every active point; back layer shares the
    # id at sewn points, otherwise gets its own
    front_id = np.full((R + 1, C + 1), -1, np.int64)
    back_id = np.full((R + 1, C + 1), -1, np.int64)
    verts = []
    for r in range(R + 1):
        for c in range(C + 1):
            if not pt_active[r, c]:
                continue
            x, z = c * spacing, r * spacing
            if sewn[r, c]:
                front_id[r, c] = back_id[r, c] = len(verts)
                verts.append((x, 0.0, z))
            else:
                front_id[r, c] = len(verts)
                verts.append((x, thickness / 2, z))
                back_id[r, c] = len(verts)
                verts.append((x, -thickness / 2, z))

    quads = []
    for r, c in zip(rr, cc):
        a, b = front_id[r, c], front_id[r, c + 1]
        d, e = front_id[r + 1, c], front_id[r + 1, c + 1]
        quads.append((a, b, e, d))
        a, b = back_id[r, c], back_id[r, c + 1]
        d, e = back_id[r + 1, c], back_id[r + 1, c + 1]
        quads.append((a, d, e, b))  # reversed winding for the back panel

    verts = np.asarray(verts, np.float32)
    verts[:, 0] -= verts[:, 0].mean()
    verts[:, 2] -= verts[:, 2].mean()
    return verts, np.asarray(quads, np.int64)


def write_shirt_obj(path: str, **kwargs) -> str:
    """Write a shirt as a quad OBJ the loader accepts (*_processed.obj)."""
    verts, quads = make_shirt_mesh(**kwargs)
    with open(path, "w") as f:
        f.write("# procedural two-layer shirt (Cloth3D-style quad mesh)\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for q in quads:
            f.write(f"f {q[0] + 1} {q[1] + 1} {q[2] + 1} {q[3] + 1}\n")
    return path


def make_shirt_library(out_dir: str, n: int = 4, seed: int = 0) -> Dict:
    """Write `n` randomized shirt OBJs (size variation like Cloth3D's
    garment spread) into out_dir; returns {path: (V, Q) counts}."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        kw = dict(
            body_w=float(rng.uniform(0.30, 0.42)),
            body_h=float(rng.uniform(0.40, 0.55)),
            sleeve_l=float(rng.uniform(0.10, 0.18)),
            sleeve_h=float(rng.uniform(0.10, 0.16)),
            collar_w=float(rng.uniform(0.09, 0.14)),
        )
        path = os.path.join(out_dir, f"shirt_{i:02d}_processed.obj")
        write_shirt_obj(path, **kw)
        verts, quads = make_shirt_mesh(**kw)
        out[path] = (len(verts), len(quads))
    return out
