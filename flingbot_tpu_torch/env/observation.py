"""Observation pipeline: render -> masks -> adaptive scaling -> 96-view
transform stack (counterpart of flingbot_tpu/env/observation.py).

One render gives RGB-D; the cloth mask is `depth < floor`; adaptive scale
factors shrink the action crops to fit the cloth (simEnv.py:719-732); and
one batched warp produces the observation stack together with the dense
action-validity channels that select_action reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flingbot_tpu_torch.learning.transforms import prepare_image
from flingbot_tpu_torch.render.camera import CAMERA_HEIGHT, pixel_to_world
from flingbot_tpu_torch.render.rasterizer import render_rgbd

LEFT_ARM_BASE = (0.765, 0.0, 0.0)
RIGHT_ARM_BASE = (-0.765, 0.0, 0.0)


class Observation(NamedTuple):
    rgb: torch.Tensor  # (B, S, S, 3)
    depth: torch.Tensor  # (B, S, S)
    cloth_mask: torch.Tensor  # (B, S, S) bool
    obs_stack: torch.Tensor  # (B, T, 4, D, D)
    mask_stack: torch.Tensor  # (B, T, 5, D, D) depth, reach_l, reach_r,
    #                           grasp, inbounds
    grasp_ok: torch.Tensor  # (B, S, S) eroded cloth mask
    adaptive_scales: torch.Tensor  # (B, n_scales)
    adaptive_ratio: torch.Tensor  # (B,)


def erode_disk(mask, radius: int):
    """Binary erosion by a disk (with wraparound, as the JAX package)."""
    out = mask
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy * dy + dx * dx > radius * radius or (dy == 0 and dx == 0):
                continue
            out = out & torch.roll(torch.roll(mask, dy, 1), dx, 2)
    return out


def _norm_last(x):
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                      + x[..., 2] * x[..., 2])


def compute_observation(positions, active, rotations, scale_factors, faces,
                        tri_mask, *, image_size: int = 400, obs_dim: int = 64,
                        conservative_grasp_radius: int = 1,
                        use_adaptive_scaling: bool = True,
                        reach_distance_limit: float = 1.2,
                        palette=None) -> Observation:
    """positions (B, 3, N), active (B, N); rotations (R,) degrees;
    scale_factors (n_scales,); cloth triangles faces (B, T, 3), tri_mask
    (B, T) (compute_observation, observation.py:61).  The grasp circle's
    radius is in pixels; without adaptive scaling the crop ratio is 1;
    an arm reaches pixels within reach_distance_limit m of its base."""
    rgb, depth = render_rgbd(positions, active, faces, tri_mask,
                             image_size=image_size, palette=palette)
    cloth_mask = depth < CAMERA_HEIGHT - 1e-4
    B, S, dev = depth.shape[0], image_size, depth.device

    rows = cloth_mask.any(2)
    cols = cloth_mask.any(1)
    idx = torch.arange(S, device=dev)[None]
    rmin = torch.where(rows, idx, S).amin(1)
    rmax = torch.where(rows, idx, -1).amax(1)
    cmin = torch.where(cols, idx, S).amin(1)
    cmax = torch.where(cols, idx, -1).amax(1)
    croprow = torch.maximum(S - 2 * rmin, S - 2 * (S - rmax))
    cropcol = torch.maximum(S - 2 * cmin, S - 2 * (S - cmax))
    crop = torch.maximum(croprow, cropcol).to(torch.float32) * 1.5
    ratio = torch.where(rows.any(1) & (crop < S), crop / S, 1.0)
    if not use_adaptive_scaling:
        ratio = torch.ones_like(ratio)
    scales = scale_factors.to(torch.float32)[None] * ratio[:, None]

    rr = torch.arange(S, dtype=torch.float32, device=dev).view(1, S, 1)
    cc = torch.arange(S, dtype=torch.float32, device=dev).view(1, 1, S)
    world = pixel_to_world(rr.expand(B, S, S), cc.expand(B, S, S), depth, S)
    left = torch.tensor(LEFT_ARM_BASE, dtype=torch.float32, device=dev)
    right = torch.tensor(RIGHT_ARM_BASE, dtype=torch.float32, device=dev)
    reach_l = _norm_last(world - left) < reach_distance_limit
    reach_r = _norm_last(world - right) < reach_distance_limit
    grasp_ok = erode_disk(cloth_mask, conservative_grasp_radius)

    src = torch.cat([rgb, depth[..., None], reach_l[..., None].float(),
                     reach_r[..., None].float(), grasp_ok[..., None].float()],
                    -1)
    warped = prepare_image(src, rotations, scales, out_dim=obs_dim,
                           with_valid=True)
    return Observation(
        rgb=rgb, depth=depth, cloth_mask=cloth_mask,
        obs_stack=warped[:, :, :4], mask_stack=warped[:, :, 3:],
        grasp_ok=grasp_ok, adaptive_scales=scales, adaptive_ratio=ratio)
