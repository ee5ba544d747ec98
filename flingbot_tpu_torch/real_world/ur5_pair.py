"""Synchronized dual-arm wrapper (reference real_world/ur5_pair.py)."""

from __future__ import annotations

import threading
from typing import Sequence

from flingbot_tpu_torch.real_world.ur5 import UR5

OUT_OF_THE_WAY_JOINTS = [
    [-1.57, -2.0, 2.0, -1.57, -1.57, 0.0],
    [1.57, -1.14, -2.0, -1.57, 1.57, 0.0],
]


class UR5Pair:
    def __init__(self, left: UR5, right: UR5):
        self.left = left
        self.right = right
        self.arms = (left, right)

    def _both(self, fn_name: str, args_left, args_right, **kwargs):
        """Run the same motion on both arms concurrently, join both."""
        errs = []

        def run(arm, args):
            try:
                getattr(arm, fn_name)(args, **kwargs)
            except Exception as e:  # propagate after join
                errs.append(e)

        threads = [
            threading.Thread(target=run, args=(self.left, args_left)),
            threading.Thread(target=run, args=(self.right, args_right)),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]

    def movej(self, joints_pair: Sequence, **kwargs):
        self._both("movej", joints_pair[0], joints_pair[1], **kwargs)

    def movel(self, poses_pair: Sequence, **kwargs):
        self._both("movel", poses_pair[0], poses_pair[1], **kwargs)

    def movel_waypoints(self, waypoints_pair: Sequence, **kwargs):
        self._both("movel_waypoints", waypoints_pair[0], waypoints_pair[1],
                   **kwargs)

    def out_of_the_way(self):
        """Park both arms clear of the camera (reference ur5_pair.py:79-83)."""
        self.movej(OUT_OF_THE_WAY_JOINTS)

    def close(self):
        for arm in self.arms:
            arm.close()
