"""Vision-based stretch detection + closed-loop widening
(reference real_world/stretch.py).

The front camera sees the lifted cloth; the cloth is "stretched" when the
top edge between the grippers is straight and level.  The env widens the
grasp until the detector fires or the width limit is hit."""

from __future__ import annotations

import numpy as np

from flingbot_tpu_torch.real_world.setup import MAX_GRASP_WIDTH


def is_cloth_grasped(depth: np.ndarray, near: float = 0.3,
                     far: float = 1.2, min_pixels: int = 500) -> bool:
    """Anything hanging in the gripper depth band counts as held cloth."""
    band = (depth > near) & (depth < far)
    return int(band.sum()) >= min_pixels


def top_edge_profile(depth: np.ndarray, near: float = 0.3, far: float = 1.2):
    """Per-column row of the highest cloth pixel (NaN where no cloth)."""
    band = (depth > near) & (depth < far)
    H, W = band.shape
    rows = np.argmax(band, axis=0).astype(float)
    rows[~band.any(axis=0)] = np.nan
    return rows

def is_stretched(depth: np.ndarray, flat_tol_px: float = 8.0,
                 tilt_tol_px: float = 10.0) -> bool:
    """Top edge straightness + tilt test (reference stretch.py:54-140):
    the sagging middle of an unstretched cloth hangs below the line between
    the grasp points."""
    rows = top_edge_profile(depth)
    cols = np.where(~np.isnan(rows))[0]
    if len(cols) < 10:
        return False
    left, right = cols[0], cols[-1]
    edge = rows[left:right + 1]
    edge = edge[~np.isnan(edge)]
    line = np.linspace(rows[left], rows[right], len(edge))
    sag = np.nanmax(edge - line)  # positive = hangs below the chord
    tilt = abs(rows[left] - rows[right])
    return sag < flat_tol_px and tilt < tilt_tol_px


def stretch(ur5_pair, camera, width: float, fling_height: float,
            increment: float = 0.02, max_width: float = MAX_GRASP_WIDTH,
            tool_down=(2.22, -2.22, 0.0)) -> float:
    """Widen until the front camera sees a taut top edge
    (reference stretch.py:143-162).  Returns the final width."""
    while width < max_width:
        _, depth = camera.get_rgbd()
        if not is_cloth_grasped(depth):
            return width
        if is_stretched(depth):
            return width
        width += increment
        hw = width / 2
        ur5_pair.movel(
            [[hw, 0.0, fling_height, *tool_down],
             [-hw, 0.0, fling_height, *tool_down]],
            v=0.05,
        )
    return max_width
