"""Real-world image utilities: workspace crop, cloth mask, coverage, and
pixel -> 3D with calibrated extrinsics (reference real_world/utils.py)."""

from __future__ import annotations

import numpy as np

from flingbot_tpu_torch.real_world.setup import WS_PC


def crop_workspace(img: np.ndarray, ws=WS_PC) -> np.ndarray:
    r0, r1, c0, c1 = ws
    return img[r0:r1, c0:c1]


def cloth_mask_hsv(rgb: np.ndarray, lo=(0, 0, 0), hi=(100, 100, 100)):
    """Dark-background HSV segmentation, largest component kept
    (SimEnv.get_cloth_mask analog for real frames)."""
    import cv2

    hsv = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
    in_bg = cv2.inRange(hsv, lo, hi)
    mask = (in_bg == 0).astype(np.uint8)
    n, labels, stats, _ = cv2.connectedComponentsWithStats(mask)
    if n <= 1:
        return mask
    best = 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
    return (labels == best).astype(np.uint8)


def coverage_px(mask: np.ndarray) -> float:
    return float(mask.astype(bool).mean())


def iou(mask_a: np.ndarray, mask_b: np.ndarray) -> float:
    a = mask_a.astype(bool)
    b = mask_b.astype(bool)
    union = (a | b).sum()
    return float((a & b).sum() / union) if union else 0.0


def pixel_to_3d(depth: np.ndarray, row: int, col: int,
                intrinsics: np.ndarray, cam_to_world: np.ndarray,
                depth_scale: float = 1.0) -> np.ndarray:
    """Unproject one pixel with calibrated camera extrinsics
    (reference real_world/utils.py:53-69)."""
    z = float(depth[row, col]) * depth_scale
    x = (col - intrinsics[0, 2]) * z / intrinsics[0, 0]
    y = (row - intrinsics[1, 2]) * z / intrinsics[1, 1]
    p = cam_to_world @ np.array([x, y, z, 1.0])
    return p[:3]
