"""Cloth randomization between real episodes: random pick-and-drop with an
IoU success check (reference real_world/reset_cloth.py:15-83)."""

from __future__ import annotations

import numpy as np

from flingbot_tpu_torch.real_world.utils import cloth_mask_hsv, iou


def pick_and_drop(env, max_attempts: int = 10,
                  min_iou_change: float = 0.15) -> bool:
    """Grab a random cloth point, lift high, drop; repeat until the cloth
    mask changed enough (the state is actually randomized)."""
    rng = np.random.default_rng()
    rgb, _ = env.top_camera.get_rgbd()
    before = cloth_mask_hsv(rgb)
    for _ in range(max_attempts):
        ys, xs = np.nonzero(before)
        if len(ys) == 0:
            return False
        i = rng.integers(len(ys))
        p = env.pixel_to_world(int(ys[i]), int(xs[i]))
        arm_idx = 0 if p[0] > 0 else 1
        arm = env.ur5_pair.arms[arm_idx]
        gripper = env.grippers[arm_idx]
        tool = [2.22, -2.22, 0.0]
        arm.movel([p[0], p[1], 0.25, *tool])
        arm.movel([p[0], p[1], 0.02, *tool], v=0.1)
        gripper.close()
        lift = rng.uniform(0.3, 0.6)
        arm.movel([p[0] * 0.5, p[1] * 0.5, lift, *tool])
        gripper.open()
        env.ur5_pair.out_of_the_way()
        rgb, _ = env.top_camera.get_rgbd()
        after = cloth_mask_hsv(rgb)
        if 1.0 - iou(before, after) >= min_iou_change:
            return True
        before = after
    return False
