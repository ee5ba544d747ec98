"""RealWorldEnv: the dual-UR5 rig behind the same env API as SimEnv
(counterpart of flingbot_tpu/real_world/real_world_env.py).

Parity with the reference (real_world/realWorldEnv.py:39-565): observations
come from a top-down Kinect (workspace-cropped, resized, background
replaced), coverage from HSV cloth segmentation, the pick-stretch-fling
primitive from blended URScript trajectories with a front RealSense doing
closed-loop stretch detection.  Episodes carry error flags
(failed_grasp / timed_out / cloth_stuck) instead of crashing, an IoU no-op
check terminates stuck episodes, and a frame-recorder thread with a runaway
watchdog captures videos.

The learning stack (value maps in, transformed obs out, replay schema) is
IDENTICAL to the sim path — this class only swaps the physics.  The
96-view transform of each observation runs on the env's device (the card
unless the caller asks for the CPU); episodes are dumped through the
port's Memory into a replay directory."""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.env.exceptions import (
    GraspFailException,
    UR5MoveTimeoutException,
)
from flingbot_tpu_torch.learning.memory import Memory
from flingbot_tpu_torch.learning.transforms import (
    prepare_image, transform_pixels_to_source)
from flingbot_tpu_torch.real_world import setup as rw_setup
from flingbot_tpu_torch.real_world import stretch as stretch_mod
from flingbot_tpu_torch.real_world.fling import fling as fling_traj
from flingbot_tpu_torch.real_world.utils import (
    cloth_mask_hsv,
    coverage_px,
    crop_workspace,
    iou,
    pixel_to_3d,
)

RECORDER_FRAME_LIMIT = 50000  # runaway watchdog (realWorldEnv.py:207-210)
TOOL_DOWN = [2.22, -2.22, 0.0]


def _host(x) -> np.ndarray:
    """A value map (numpy, or a tensor on any device) as a host array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class FrameRecorder:
    def __init__(self, camera, fps: float = 12.0):
        self.camera = camera
        self.fps = fps
        self.frames = []
        self._running = False

    def start(self):
        self._running = True
        threading.Thread(target=self._loop, daemon=True).start()

    def stop(self):
        self._running = False

    def _loop(self):
        while self._running:
            try:
                rgb, _ = self.camera.get_rgbd()
                self.frames.append(rgb)
            except Exception:
                pass
            if len(self.frames) > RECORDER_FRAME_LIMIT:
                raise SystemExit("frame recorder runaway — aborting")
            time.sleep(1.0 / self.fps)


class RealWorldEnv:
    def __init__(
        self,
        replay_buffer_path: Optional[str] = None,
        obs_dim: int = 64,
        num_rotations: int = 12,
        scale_factors: Sequence[float] = (1.0, 1.5, 2.0, 2.5),
        action_primitives: Sequence[str] = ("fling",),
        pix_grasp_dist: int = 8,
        episode_length: int = 10,
        render_dim: int = 256,
        cloth_name: str = "white_rect",
        fixed_fling_height: float = 0.45,
        top_camera=None,
        front_camera=None,
        ur5_pair=None,
        grippers=None,
        cam_intrinsics=None,
        cam_extrinsics=None,
        dump_visualizations: bool = False,
        use_adaptive_scaling: bool = True,
        device="cuda",
        **_unused,
    ):
        self.device = resolve_device(device)
        self.replay_buffer_path = replay_buffer_path
        self.obs_dim = obs_dim
        self.render_dim = render_dim
        self.episode_length = episode_length
        self.action_primitives = tuple(action_primitives)
        self.pix_grasp_dist = pix_grasp_dist
        self.fixed_fling_height = fixed_fling_height
        self.cloth = rw_setup.CLOTHS[cloth_name]
        self.use_adaptive_scaling = use_adaptive_scaling

        if "fling" in self.action_primitives:
            self.rotations = np.array(
                [(2 * i / (num_rotations - 1) - 1) * 90
                 for i in range(num_rotations)], np.float32)
        else:
            self.rotations = np.array(
                [(2 * i / num_rotations - 1) * 180
                 for i in range(num_rotations)], np.float32)
        self.scale_factors = np.asarray(scale_factors, np.float32)
        self.adaptive_scale_factors = self.scale_factors.copy()

        # hardware (injected so the class is constructible without a rig)
        self.top_camera = top_camera
        self.front_camera = front_camera
        self.ur5_pair = ur5_pair
        self.grippers = grippers or ()
        self.cam_intrinsics = cam_intrinsics
        self.cam_extrinsics = cam_extrinsics

        self.episode_memory = Memory()
        self.current_timestep = 0
        self.terminate = False
        self.prev_mask = None
        self.recorder = None
        if dump_visualizations and top_camera is not None:
            self.recorder = FrameRecorder(top_camera)
            self.recorder.start()

    # -- observation ----------------------------------------------------

    def get_obs(self):
        """Workspace crop -> square resize -> (4, S, S) rgb+depth obs with
        background replaced (realWorldEnv.py:373-425)."""
        import cv2

        rgb, depth = self.top_camera.get_rgbd()
        rgb = crop_workspace(rgb)
        depth = crop_workspace(depth)
        rgb = cv2.resize(rgb, (self.render_dim, self.render_dim))
        depth = cv2.resize(depth, (self.render_dim, self.render_dim))
        mask = cloth_mask_hsv(rgb).astype(bool)
        rgb = rgb.copy()
        rgb[~mask] = (230, 230, 230)
        depth = depth.copy()
        depth[~mask] = 2.0  # sim floor-depth convention
        self.pretransform_rgb = rgb
        self.pretransform_depth = depth
        self.cloth_mask = mask

        self.adaptive_scale_factors = self.scale_factors.copy()
        if self.use_adaptive_scaling and mask.any():
            S = self.render_dim
            rows = np.where(mask.any(axis=1))[0]
            cols = np.where(mask.any(axis=0))[0]
            crop = max(S - 2 * rows.min(), S - 2 * (S - rows.max()),
                       S - 2 * cols.min(), S - 2 * (S - cols.max()))
            crop = int(crop * 1.5)
            if crop < S:
                self.adaptive_scale_factors *= crop / S

        obs = np.concatenate(
            [np.transpose(rgb.astype(np.float32) / 255, (2, 0, 1)),
             depth[None].astype(np.float32)], axis=0)
        return obs

    def _transformed_obs(self, obs) -> torch.Tensor:
        """(4, S, S) obs -> (T, 4, D, D) views on the env's device."""
        hwc = torch.as_tensor(np.transpose(obs, (1, 2, 0)),
                              device=self.device)
        return prepare_image(
            hwc[None], torch.as_tensor(self.rotations, device=self.device),
            torch.as_tensor(self.adaptive_scale_factors, device=self.device),
            out_dim=self.obs_dim)[0]

    def pixel_to_world(self, row: int, col: int) -> np.ndarray:
        return pixel_to_3d(
            self.pretransform_depth, row, col,
            self.cam_intrinsics, self.cam_extrinsics)

    # -- coverage -------------------------------------------------------

    def compute_coverage(self) -> float:
        """Pixel coverage scaled to m^2 by the cloth's known flat area
        (realWorldEnv.py:367-371)."""
        frac = coverage_px(self.cloth_mask)
        if not hasattr(self, "_max_frac"):
            self._max_frac = max(frac, 1e-6)
        self._max_frac = max(self._max_frac, frac)
        return frac * self.cloth["flattened_area"] / self._max_frac

    # -- episode flow ---------------------------------------------------

    def reset(self):
        self.episode_memory = Memory()
        self.current_timestep = 0
        self.terminate = False
        self.prev_mask = None
        if self.ur5_pair is not None:
            self.ur5_pair.out_of_the_way()
        obs = self.get_obs()
        self.episode_memory.add_value("pretransform_observations", obs)
        self.transformed_obs = self._transformed_obs(obs)
        return self.transformed_obs

    def step(self, value_maps):
        flags = {"failed_grasp": False, "timed_out": False,
                 "cloth_stuck": False}
        pre_cov = self.compute_coverage()
        action = self._select_action(value_maps)
        try:
            if action is not None:
                self._execute(action)
        except GraspFailException:
            flags["failed_grasp"] = True
            self.terminate = True
        except UR5MoveTimeoutException:
            flags["timed_out"] = True
            self.terminate = True
        finally:
            if self.ur5_pair is not None:
                self.ur5_pair.out_of_the_way()

        obs = self.get_obs()
        post_cov = self.compute_coverage()

        # IoU no-op termination (realWorldEnv.py:104-115)
        if self.prev_mask is not None and \
                iou(self.prev_mask, self.cloth_mask) > 0.85:
            flags["cloth_stuck"] = True
            self.terminate = True
        self.prev_mask = self.cloth_mask

        self._log_step(action, value_maps, pre_cov, post_cov, flags)
        self.current_timestep += 1
        self.terminate = self.terminate or \
            self.current_timestep >= self.episode_length
        self.episode_memory.add_rewards_and_termination(
            post_cov - pre_cov, self.terminate)
        self.episode_memory.add_value("next_observations", obs)
        if self.terminate:
            self.on_episode_end()
            return self.reset()
        self.episode_memory.add_value("pretransform_observations", obs)
        self.transformed_obs = self._transformed_obs(obs)
        return self.transformed_obs

    # -- action selection / safety --------------------------------------

    def _select_action(self, value_maps):
        """Host-side descending-value scan with real-world safety checks
        (grasp width bounds, reach, realWorldEnv.py:470-565)."""
        if isinstance(value_maps, dict):
            stacked = np.stack(
                [_host(value_maps[p]) for p in self.action_primitives])
        else:
            stacked = _host(value_maps)
        P, T, D, _ = stacked.shape
        pg = self.pix_grasp_dist
        order = np.argsort(stacked.reshape(-1))[::-1]
        n_scales = len(self.adaptive_scale_factors)
        for flat in order[:2000]:
            p, rem = divmod(int(flat), T * D * D)
            t, rem = divmod(rem, D * D)
            y, x = divmod(rem, D)
            if not (pg <= y < D - pg and pg <= x < D - pg):
                continue
            rot = float(self.rotations[t // n_scales])
            scale = float(self.adaptive_scale_factors[t % n_scales])
            px = transform_pixels_to_source(
                torch.tensor([[y + pg, x], [y - pg, x]]),
                torch.tensor(rot), torch.tensor(scale), self.render_dim,
                D).numpy()
            if (px < 0).any() or (px >= self.render_dim).any():
                continue
            p1 = self.pixel_to_world(int(px[0, 0]), int(px[0, 1]))
            p2 = self.pixel_to_world(int(px[1, 0]), int(px[1, 1]))
            width = float(np.linalg.norm(p1 - p2))
            if not (rw_setup.MIN_GRASP_WIDTH <= width
                    <= rw_setup.MAX_GRASP_WIDTH):
                continue
            if np.linalg.norm(p1 - rw_setup.LEFT_ARM_BASE) \
                    > rw_setup.REACH_LIMIT or \
                    np.linalg.norm(p2 - rw_setup.RIGHT_ARM_BASE) \
                    > rw_setup.REACH_LIMIT:
                continue
            g1 = bool(self.cloth_mask[int(px[0, 0]), int(px[0, 1])])
            g2 = bool(self.cloth_mask[int(px[1, 0]), int(px[1, 1])])
            if not (g1 or g2):
                continue
            return {
                "primitive": self.action_primitives[p],
                "p1": p1, "p2": p2, "width": width,
                "g1": g1, "g2": g2,
                "transform_idx": t, "row": y, "col": x,
                "rotation": rot, "scale": scale,
                "value": float(stacked.reshape(-1)[flat]),
            }
        return None

    def _execute(self, action):
        """pick -> stretch -> fling on hardware (realWorldEnv.py:212-365)."""
        pair = self.ur5_pair
        p1, p2 = action["p1"], action["p2"]
        pair.movel([
            [p1[0], p1[1], 0.15, *TOOL_DOWN],
            [p2[0], p2[1], 0.15, *TOOL_DOWN]])
        pair.movel([
            [p1[0], p1[1], 0.01, *TOOL_DOWN],
            [p2[0], p2[1], 0.01, *TOOL_DOWN]], v=0.1)
        for g, hold in zip(self.grippers, (action["g1"], action["g2"])):
            if hold:
                g.close()
        pair.movel([
            [p1[0] * 0.5, p1[1] * 0.5, 0.35, *TOOL_DOWN],
            [p2[0] * 0.5, p2[1] * 0.5, 0.35, *TOOL_DOWN]], v=0.3)
        _, depth = self.front_camera.get_rgbd()
        if not stretch_mod.is_cloth_grasped(depth):
            for g in self.grippers:
                g.open()
            raise GraspFailException("cloth not lifted")
        width = stretch_mod.stretch(
            pair, self.front_camera, action["width"],
            self.fixed_fling_height)
        single = None
        if action["g1"] != action["g2"]:
            single = 0 if action["g1"] else 1
        fling_traj(pair, self.grippers, width,
                   fling_height=self.fixed_fling_height, single_arm=single)

    def _log_step(self, action, value_maps, pre_cov, post_cov, flags):
        mem = self.episode_memory
        if action is None:
            return
        t = action["transform_idx"]
        mask = np.zeros((self.obs_dim, self.obs_dim), np.float32)
        mask[action["row"], action["col"]] = 1.0
        mem.add_observation(self.transformed_obs[t].cpu().numpy())
        mem.add_action(mask)
        mem.add_value("preaction_coverage", float(pre_cov))
        mem.add_value("postaction_coverage", float(post_cov))
        mem.add_value("max_coverage", self.cloth["flattened_area"])
        mem.add_value("init_coverage", float(pre_cov))
        mem.add_value("task_difficulty", "hard")
        mem.add_value("rotation", action["rotation"])
        mem.add_value("scale", action["scale"])
        mem.add_value("action_primitive", action["primitive"])
        for k, v in flags.items():
            mem.add_value(k, float(v))

    def on_episode_end(self):
        if self.replay_buffer_path is not None and len(self.episode_memory):
            self.episode_memory.dump(self.replay_buffer_path)
        self.episode_memory = Memory()
