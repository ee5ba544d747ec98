"""A rig without hardware, for driving RealWorldEnv where there is none:
a camera that returns a fixed RGB-D frame, a UR5 that records the
URScript it is sent and arrives at once, and a synthetic top-down frame
with a calibration under which its cloth lies on the table within reach
of both arms.  Nothing here opens a socket."""

from __future__ import annotations

import numpy as np

from flingbot_tpu_torch.real_world.grippers import RG2
from flingbot_tpu_torch.real_world.ur5 import UR5
from flingbot_tpu_torch.real_world.ur5_pair import UR5Pair

FRAME_SHAPE = (1024, 1600)  # the Kinect's colour frame (rows, cols)


class FakeCamera:
    def __init__(self, rgb, depth, intrinsics=None):
        self._rgb, self._depth = rgb, depth
        self._intrinsics = intrinsics

    def get_rgbd(self, repeats=1):
        return self._rgb, self._depth

    def get_intrinsics(self):
        return self._intrinsics


class RecordingUR5(UR5):
    """A UR5 whose programs go to `sent` and whose moves arrive at once."""

    def __init__(self, ip: str = "0.0.0.0"):
        super().__init__(ip)
        self.sent = []

    def send_program(self, program: str):
        self.sent.append(program)

    def _wait_joints(self, target, timeout):
        pass

    def _wait_pose(self, target, timeout):
        pass


def recording_rig():
    """(UR5Pair of two RecordingUR5s, (RG2, RG2) driven through them)."""
    left, right = RecordingUR5(), RecordingUR5()
    grippers = (RG2(left, settle_s=0.0), RG2(right, settle_s=0.0))
    return UR5Pair(left, right), grippers


def synthetic_scene(rows=(300, 700), cols=(600, 1000), depth_m=1.5):
    """A red cloth on a black table seen from depth_m above it: (rgb,
    depth) frames of FRAME_SHAPE, a front-camera depth frame in which the
    lifted cloth's top edge is taut, intrinsics (of the render-size
    observation) and a camera-to-world transform that puts the table at
    z = 0 under the camera."""
    rgb = np.zeros(FRAME_SHAPE + (3,), np.uint8)
    rgb[rows[0]:rows[1], cols[0]:cols[1]] = (180, 60, 60)
    depth = np.full(FRAME_SHAPE, depth_m, np.float32)
    front = np.full(FRAME_SHAPE, 2.0, np.float32)
    front[400:600, 300:1300] = 0.8
    intr = np.array([[600.0, 0, 128], [0, 600.0, 128], [0, 0, 1]])
    cam_to_world = np.diag([1.0, -1.0, -1.0, 1.0])
    cam_to_world[2, 3] = depth_m
    return rgb, depth, front, intr, cam_to_world
