"""The port's real_world stack, held against flingbot_tpu's on the same
inputs: the nine checks of tests/test_real_world.py (imports without
hardware, URScript text, RTC parsing, the stretch detector, the cloth
mask and IoU, the calibration's rigid transform and depth scale,
RealWorldEnv's observation and action selection), plus one env step on a
recording rig that writes the replay record.

Tolerances: everything on the host is numpy on both sides and compared
exactly, but for the calibration's least squares (1e-8 against the
truth, as the JAX test, and 1e-12 against JAX) and the 96-view transform.
That one holds to prepare_image's port tolerance
(tests/test_torch_render.py::test_prepare_image_matches: 1e-5 on [0, 1]
channels of a 40-pixel source) per unit of each channel's magnitude and
of the source's size: the two libraries' float32 sampling coordinates
differ by rounding at the coordinates' scale, the source's side (256
pixels here), and a bilinear weight carries that difference into a
pixel's value."""

import struct
import threading

import numpy as np
import pytest
import torch

import calibrate_camera as jax_calib
import flingbot_tpu.real_world as jrw
from flingbot_tpu.real_world import real_world_env as jax_env_mod
from flingbot_tpu.real_world import stretch as jax_stretch
from flingbot_tpu.real_world import utils as jax_utils
from flingbot_tpu.real_world.ur5 import UR5 as JaxUR5
from flingbot_tpu.real_world.ur5 import UR5State as JaxUR5State
from flingbot_tpu_torch import calibrate_camera as calib
from flingbot_tpu_torch import real_world as rw
from flingbot_tpu_torch.real_world import fakes
from flingbot_tpu_torch.real_world import stretch, utils
from flingbot_tpu_torch.real_world.real_world_env import RealWorldEnv
from flingbot_tpu_torch.real_world.ur5 import (
    RTC_PACKET_SIZE, UR5, UR5State, _JOINT_OFFSET, _TCP_OFFSET)

torch.set_num_threads(2)
RENDER_DIM = 256
# test_prepare_image_matches' 1e-5 at a 40-pixel source, at this source
TRANSFORM_ATOL = 1e-5 * RENDER_DIM / 40


def test_package_imports_without_hardware():
    assert sorted(rw.__all__) == sorted(jrw.__all__)
    threads = threading.active_count()
    ur5 = UR5("0.0.0.0")
    st = UR5State("0.0.0.0")
    assert ur5._sock is None and st._thread is None
    assert threading.active_count() == threads  # no thread, no socket


def _record(cls):
    sent = []
    ur5 = cls("0.0.0.0")
    ur5.send_program = sent.append
    ur5.movej([0, -1.57, 1.57, 0, 0, 0], blocking=False)
    ur5.movel([0.1, 0.2, 0.3, 2.22, -2.22, 0], blocking=False)
    ur5.movel_waypoints(
        [[0, 0, 0.3, 2.2, -2.2, 0], [0, 0.2, 0.3, 2.2, -2.2, 0]],
        blocking=False)
    ur5.speed_stop()
    return sent


def test_urscript_synthesis():
    sent = _record(UR5)
    assert sent == _record(JaxUR5)
    assert sent[0].startswith("movej([0.000000, -1.570000")
    assert sent[1].startswith("movel(p[0.100000")
    assert "def wp():" in sent[2] and "r=0.01" in sent[2]
    assert sent[2].strip().splitlines()[-2].endswith("r=0.0)")


def test_rtc_packet_parse():
    packet = bytearray(RTC_PACKET_SIZE)
    joints = [0.1, -1.2, 1.3, -0.4, 1.5, -0.6]
    pose = [0.25, -0.1, 0.3, 2.2, -2.2, 0.0]
    packet[_JOINT_OFFSET:_JOINT_OFFSET + 48] = struct.pack(">6d", *joints)
    packet[_TCP_OFFSET:_TCP_OFFSET + 48] = struct.pack(">6d", *pose)
    st, jst = UR5State("0.0.0.0"), JaxUR5State("0.0.0.0")
    st._parse(bytes(packet))
    jst._parse(bytes(packet))
    np.testing.assert_array_equal(st.joints, jst.joints)
    np.testing.assert_array_equal(st.tcp_pose, jst.tcp_pose)
    np.testing.assert_allclose(st.joints, joints)
    np.testing.assert_allclose(st.tcp_pose, pose)


def test_stretch_detector():
    H, W = 120, 160
    taut = np.full((H, W), 2.0, np.float32)
    taut[40:80, 30:130] = 0.8
    saggy = np.full((H, W), 2.0, np.float32)
    cols = np.arange(30, 130)
    tops = (40 + 25 * np.sin((cols - 30) / 99 * np.pi)).astype(int)
    for c, t in zip(cols, tops):
        saggy[t:80, c] = 0.8
    for depth, want in ((taut, True), (saggy, False)):
        assert stretch.is_stretched(depth) == want
        assert jax_stretch.is_stretched(depth) == want
        assert stretch.is_cloth_grasped(depth) == \
            jax_stretch.is_cloth_grasped(depth)
        np.testing.assert_array_equal(stretch.top_edge_profile(depth),
                                      jax_stretch.top_edge_profile(depth))


def test_cloth_mask_and_iou():
    rgb = np.zeros((64, 64, 3), np.uint8)
    rgb[20:40, 20:40] = (200, 50, 50)
    rgb[5:9, 50:60] = (150, 150, 40)  # a smaller second blob
    mask = utils.cloth_mask_hsv(rgb)
    np.testing.assert_array_equal(mask, jax_utils.cloth_mask_hsv(rgb))
    assert mask[30, 30] == 1 and mask[5, 5] == 0 and mask[7, 55] == 0
    other = np.roll(mask, 3, axis=1)
    assert utils.iou(mask, other) == jax_utils.iou(mask, other)
    assert utils.iou(mask, mask) == 1.0
    assert utils.coverage_px(mask) == jax_utils.coverage_px(mask)


def test_rigid_transform_recovery():
    rng = np.random.default_rng(0)
    R_true = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    if np.linalg.det(R_true) < 0:
        R_true[:, 0] *= -1
    t_true = np.array([0.3, -0.2, 0.5])
    cam = rng.uniform(-1, 1, (20, 3))
    world = (R_true @ cam.T).T + t_true
    T = calib.rigid_transform(cam, world)
    np.testing.assert_allclose(T[:3, :3], R_true, atol=1e-8)
    np.testing.assert_allclose(T[:3, 3], t_true, atol=1e-8)
    np.testing.assert_allclose(T, jax_calib.rigid_transform(cam, world),
                               atol=1e-12)


def test_depth_scale_refinement():
    rng = np.random.default_rng(1)
    cam = rng.uniform(0.2, 1.0, (15, 3))
    wrong = cam * np.array([1.0, 1.0, 1.0 / 1.07])
    scale = calib.refine_depth_scale(wrong, cam)
    assert abs(scale - 1.07) < 1e-2
    assert abs(scale - jax_calib.refine_depth_scale(wrong, cam)) < 1e-12


def _envs(**kw):
    """The port's env (on the CPU) and the JAX env on one synthetic rig
    whose cloth lies on the table within reach (fakes.synthetic_scene)."""
    rgb, depth, front, intr, c2w = fakes.synthetic_scene()
    common = dict(obs_dim=64, num_rotations=4, scale_factors=[1.0, 1.5],
                  render_dim=RENDER_DIM,
                  top_camera=fakes.FakeCamera(rgb, depth),
                  front_camera=fakes.FakeCamera(rgb, front),
                  cam_intrinsics=intr, cam_extrinsics=c2w, **kw)
    return (RealWorldEnv(device="cpu", **common),
            jax_env_mod.RealWorldEnv(**common))


def test_obs_pipeline():
    env, jenv = _envs()
    obs, jobs = env.reset(), jenv.reset()
    for name in ("pretransform_rgb", "pretransform_depth", "cloth_mask",
                 "adaptive_scale_factors"):
        np.testing.assert_array_equal(getattr(env, name),
                                      getattr(jenv, name), err_msg=name)
    assert float(env.pretransform_depth[0, 0]) == 2.0
    assert tuple(obs.shape) == (8, 4, 64, 64) and obs.device.type == "cpu"
    jobs = np.asarray(jobs)
    scale = np.abs(jobs).max(axis=(0, 2, 3), keepdims=True)
    np.testing.assert_allclose(obs.numpy() / scale, jobs / scale,
                               atol=TRANSFORM_ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_action_selection_safety(seed):
    env, jenv = _envs()
    env.reset()
    jenv.reset()
    vm = np.random.default_rng(seed).uniform(size=(1, 8, 64, 64))
    action = env._select_action(torch.as_tensor(vm))
    want = jenv._select_action(vm)
    assert action is not None and want is not None
    assert action.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(action[k], v, err_msg=k)
    assert rw.setup.MIN_GRASP_WIDTH <= action["width"] \
        <= rw.setup.MAX_GRASP_WIDTH


def test_step_on_a_recording_rig(tmp_path):
    from flingbot_tpu_torch.learning.memory import read_step, step_keys

    pair, grippers = fakes.recording_rig()
    env, _ = _envs(ur5_pair=pair, grippers=grippers, episode_length=1,
                   replay_buffer_path=str(tmp_path))
    env.reset()
    vm = np.random.default_rng(0).uniform(size=(1, 8, 64, 64))
    action = env._select_action(vm)
    env.step(vm)
    sent = pair.left.sent + pair.right.sent
    assert any(s.startswith("def wp():") for s in sent)  # the fling
    assert any("set_digital_out" in s for s in sent)  # a gripper
    keys = step_keys(str(tmp_path))
    assert keys == ["000000000_step00_last"]
    attrs, arrays = read_step(str(tmp_path), keys[0])
    assert attrs["rotation"] == action["rotation"]
    assert arrays["observations"].shape == (4, 64, 64)
    assert arrays["actions"][action["row"], action["col"]] == 1
