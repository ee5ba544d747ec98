"""The flingbot camera: top-down pinhole at (0, 2, 0), fov 39.5978 deg
(counterpart of flingbot_tpu/render/camera.py).

    world_x =  (col - c) * depth / f
    world_y =  camera_height - depth
    world_z = -(row - c) * depth / f

with c = S/2 and f = (S/2)/tan(fov/2); depth is linear eye-space distance,
so the empty floor reads exactly camera_height = 2.0.
"""

from __future__ import annotations

import numpy as np
import torch

CAMERA_FOV = 39.5978
CAMERA_HEIGHT = 2.0


def focal_length(image_size: int) -> float:
    return float((image_size / 2.0)
                 / np.tan(np.pi * CAMERA_FOV / 180.0 / 2.0))


def pixel_to_world(row, col, depth, image_size: int) -> torch.Tensor:
    """(row, col, depth) -> world (..., 3)."""
    f = focal_length(image_size)
    c = image_size / 2.0
    x = (col - c) * depth / f
    y = CAMERA_HEIGHT - depth
    z = -(row - c) * depth / f
    return torch.stack([x, y, z], -1)
