"""One env step in three parts, batched (counterpart of step_begin /
step_finish in flingbot_tpu/env/sim_env.py):

  step_begin   action selection + pre-coverage + each env's program
  (host loop)  primitives.program_chunk until every env is done; the
               program ends in STABILIZE, the postaction settle
  step_finish  no-move early exit + post-coverage

the episode video (render_frames, then write_webm), which SimEnv and
BatchSimEnv share, and SimEnv, the single-env surface of the JAX package
(one env with episodes and a replay record, held as a B = 1 BatchSimEnv).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from flingbot_tpu_torch.env.action import ActionSelection, select_action
from flingbot_tpu_torch.env.coverage import get_current_covered_area
from flingbot_tpu_torch.env.observation import Observation
from flingbot_tpu_torch.env.primitives import (
    PrimitiveConfig, build_selected_program, init_program_carry)
from flingbot_tpu_torch.learning.memory import Memory
from flingbot_tpu_torch.render.rasterizer import render_rgbd

NO_MOVE_EPS = 5e-2  # postaction early-exit threshold (simEnv.py:475-477)
VIDEO_SIZE = 256  # px of the episode videos (sim_env.py:487-514)
VIDEO_FPS = 24
VIDEO_CHUNK = 16  # frames rendered at once


def step_begin(state, value_maps: torch.Tensor, obs: Observation,
               rotations: torch.Tensor, prim_cfg: PrimitiveConfig,
               pix_grasp_dist: int = 8, primitives=("fling",),
               pix_drag_dist: int = 10, pix_place_dist: int = 10,
               record_frames: int = 0):
    """Returns (sel, pre_cov, pre_pos, carry, program): the program of
    each env's selected primitive and action, ending in STABILIZE
    (step_begin, sim_env.py:179); the carry has record_frames frame slots
    per env."""
    sel = select_action(value_maps, obs, rotations, primitives=primitives,
                        pix_grasp_dist=pix_grasp_dist,
                        pix_drag_dist=pix_drag_dist,
                        pix_place_dist=pix_place_dist)
    pre_cov = get_current_covered_area(state.positions, state.active)
    prog, init_fh = build_selected_program(
        primitives, sel.prim_idx, sel.p1_world, sel.p2_world, sel.p1_grasp,
        sel.p2_grasp, prim_cfg)
    d = sel.p1_world - sel.p2_world
    dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                      + d[:, 2] * d[:, 2])
    carry = init_program_carry(state, dist, init_fh, record_frames)
    return sel, pre_cov, state.positions, carry, prog


def step_finish(carry, pre_pos, record_frames: int = 0):
    """Returns (state, post_cov, terminate), and with record_frames > 0
    also the recorded frames (B, F, 3, N) and each env's count of them
    (B,) (step_finish, sim_env.py:213-227)."""
    state = carry.state
    d = state.positions - pre_pos
    disp = torch.where(state.active, torch.sqrt(
        d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]), 0.0)
    no_move = disp.amax(1) < NO_MOVE_EPS
    post_cov = get_current_covered_area(state.positions, state.active)
    terminate = carry.terminate | no_move
    if record_frames > 0:
        return state, post_cov, terminate, carry.frames, carry.frame_idx
    return state, post_cov, terminate


# --------------------------------------------------------------------------
# the episode video
# --------------------------------------------------------------------------

def video_dir(replay_buffer_path: Optional[str]) -> str:
    """Where the episode videos go: visualizations/ beside the replay
    record."""
    base = os.path.dirname(replay_buffer_path or "") or "."
    return os.path.join(base, "visualizations")


def render_frames(frames, active: torch.Tensor, palette=None,
                  size: int = VIDEO_SIZE) -> np.ndarray:
    """Recorded positions (F, 3, N) of one env with its active mask (N,)
    -> uint8 RGB (F, size, size, 3) on the host, rendered on active's
    device without faces (each particle a disk of pixels), VIDEO_CHUNK
    frames at a time.  palette = (cloth (3,), floor (S, S, 3)): the
    env's domain-randomized colours, the floor resampled to size."""
    dev = active.device
    frames = torch.as_tensor(frames).to(dev)
    if palette is not None:
        cloth, floor = palette
        floor = F.interpolate(floor.permute(2, 0, 1)[None], size=(size, size),
                              mode="bilinear", align_corners=False)[0]
        floor = floor.permute(1, 2, 0)
    out = [np.zeros((0, size, size, 3), np.uint8)]
    for s in range(0, frames.shape[0], VIDEO_CHUNK):
        chunk = frames[s:s + VIDEO_CHUNK]
        n = chunk.shape[0]
        pal = None if palette is None else (cloth.expand(n, 3),
                                            floor.expand(n, -1, -1, -1))
        rgb, _ = render_rgbd(chunk, active.expand(n, -1), image_size=size,
                             palette=pal)
        out.append((rgb * 255).to(torch.uint8).cpu().numpy())
    return np.concatenate(out)


def write_webm(frames: np.ndarray, path: str) -> str:
    """uint8 RGB frames (F, H, W, 3) -> a browser-playable VP9 webm at
    VIDEO_FPS (the JAX package's writer, sim_env.py:487-514)."""
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"VP90"),
                             VIDEO_FPS, (w, h))
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., ::-1]))  # RGB -> BGR
    writer.release()
    return path


def write_episode_video(chunks, active, palette, path: str) -> str:
    """One env's recorded chunks (a list of (F_i, 3, N), one per step) ->
    its episode video at path."""
    frames = np.concatenate([np.asarray(c) for c in chunks])
    return write_webm(render_frames(frames, active, palette), path)


# --------------------------------------------------------------------------
# the single env
# --------------------------------------------------------------------------

class SimEnv:
    """One cloth env with episodes (SimEnv, sim_env.py:230-524), held as a
    B = 1 BatchSimEnv (`self.env`): reset and step go through its scene,
    settle, render, observation and step_begin -> program_chunk ->
    step_finish loop, so its physics is the batched path's.

        env = SimEnv(loader.get_next_task, replay_buffer_path=replay)
        obs = env.reset()                     # (T, 4, D, D)
        obs = env.step(policy.value_maps(obs))

    The keywords and their defaults are the JAX constructor's (backend
    "xla", Gauss-Seidel springs, block contacts every substep, 30
    iterations, contacts 8 x window 16); `device` is CUDA unless the
    caller asks for the CPU.  Each episode draws the next task and a
    fresh render palette (domain_randomization); its settle step takes
    the env's contact knobs, where the JAX reset settles at
    solver.step's contact defaults (8 x window 16) whatever they are.  With
    dump_visualizations a step records the positions of every
    record_every-th sim step, up to record_frames (384) of them, and
    on_episode_end writes the episode's video under visualizations/
    beside the replay record."""

    def __init__(
        self,
        get_task_fn: Callable,
        replay_buffer_path: Optional[str] = None,
        obs_dim: int = 64,
        num_rotations: int = 12,
        scale_factors: Sequence[float] = (1.0, 1.5, 2.0, 2.5),
        action_primitives: Sequence[str] = ("fling",),
        pix_grasp_dist: int = 8,
        pix_drag_dist: int = 10,
        pix_place_dist: int = 10,
        stretchdrag_dist: float = 0.3,
        reach_distance_limit: float = 1.2,
        fixed_fling_height: float = -1.0,
        conservative_grasp_radius: int = 1,
        use_adaptive_scaling: bool = True,
        grasp_height: float = 0.02,
        fling_speed: float = 6e-3,
        episode_length: int = 10,
        render_dim: int = 400,
        particle_radius: float = 0.00625,
        dump_visualizations: bool = False,
        self_collision: bool = True,
        spring_mode: str = "gs",
        contact_mode: str = "block",
        contact_every: int = 1,
        contact_iterations: int = 8,
        contact_window: int = 16,
        backend: str = "xla",
        substeps: int = 4,
        iterations: int = 30,
        max_grid_dim: int = 104,
        mesh_caps=None,
        domain_randomization: bool = True,
        seed: int = 0,
        device="cuda",
        **_unused,
    ):
        # batch_env imports this module's step functions
        from flingbot_tpu_torch.env.batch_env import BatchSimEnv

        self.env = BatchSimEnv(
            episode_length=episode_length, max_grid_dim=max_grid_dim,
            mesh_caps=mesh_caps, obs_dim=obs_dim,
            num_rotations=num_rotations, scale_factors=scale_factors,
            action_primitives=action_primitives,
            pix_grasp_dist=pix_grasp_dist, pix_drag_dist=pix_drag_dist,
            pix_place_dist=pix_place_dist, stretchdrag_dist=stretchdrag_dist,
            conservative_grasp_radius=conservative_grasp_radius,
            use_adaptive_scaling=use_adaptive_scaling,
            reach_distance_limit=reach_distance_limit,
            render_dim=render_dim, substeps=substeps, iterations=iterations,
            contact_every=contact_every,
            contact_iterations=contact_iterations,
            contact_window=contact_window, spring_mode=spring_mode,
            self_collision=self_collision, backend=backend,
            contact_mode=contact_mode,
            domain_randomization=domain_randomization,
            fling_speed=fling_speed, fixed_fling_height=fixed_fling_height,
            seed=seed, device=device)
        self.env.prim_cfg = self.env.prim_cfg._replace(
            grasp_height=grasp_height)
        self.device = self.env.device
        self.get_task_fn = get_task_fn
        self.replay_buffer_path = replay_buffer_path
        self.obs_dim = obs_dim
        self.episode_length = episode_length
        self.particle_radius = particle_radius
        self.action_primitives = tuple(action_primitives)
        self.rotations = self.env.rotations.cpu().numpy()
        self.scale_factors = np.asarray(scale_factors, np.float32)
        self.adaptive_scale_factors = self.scale_factors.copy()
        self.dump_visualizations = dump_visualizations
        self.record_frames = 384 if dump_visualizations else 0
        self.record_every = 8
        self.current_task = None
        self.episode_memory = Memory()
        self.current_timestep = 0
        self.terminate = False
        self.episode_count = 0
        self.init_coverage = None

    @property
    def state(self):
        return self.env.state

    @property
    def topo(self):
        return self.env.topo

    @property
    def obs(self) -> Observation:
        """The current observation, batched (B = 1)."""
        return self.env.obs

    def _observed(self) -> torch.Tensor:
        self.adaptive_scale_factors = (
            self.env.obs.adaptive_scales[0].cpu().numpy())
        return self.env.obs.obs_stack[0]

    def _pretransform_obs(self) -> np.ndarray:
        return self.env._pretransform(self.env.obs)[0].cpu().numpy()

    def get_transformations(self):
        return [(float(r), float(s)) for r in self.rotations
                for s in self.adaptive_scale_factors]

    def reset(self) -> torch.Tensor:
        """Load the next task, park the arms, settle one solver step,
        record the init coverage and observe (reset, sim_env.py:368-393).
        Returns the obs stack (T, 4, D, D)."""
        self.episode_memory = Memory()
        self.current_timestep = 0
        self.terminate = False
        self.current_task = self.get_task_fn()
        topo, state = self.env.load_scenes([self.current_task])
        self.env.reset(state, topo)
        self.init_coverage = float(self.env.init_coverage[0])
        obs = self._observed()
        self.episode_memory.add_value("pretransform_observations",
                                      self._pretransform_obs())
        return obs

    def step(self, value_maps) -> torch.Tensor:
        """value_maps: {primitive: (T, D, D)} or a (P, T, D, D) array.
        Returns the next obs stack (T, 4, D, D); at the episode's end, the
        first of the next episode (step, sim_env.py:402-456)."""
        if isinstance(value_maps, dict):
            vm = torch.stack([torch.as_tensor(value_maps[p])
                              for p in self.action_primitives])
        else:
            vm = torch.as_tensor(value_maps)
        vm = vm.to(self.device)
        prev_stack = self.env.obs.obs_stack[0]
        self.env.record_frames = self.record_frames
        self.env.record_every = self.record_every
        self.env.step(vm[None])
        last = self.env.last
        pre_cov = float(last.pre_coverage[0])
        post_cov = float(last.post_coverage[0])
        self._log_step(last.selection, vm, prev_stack, pre_cov, post_cov)

        self.current_timestep += 1
        self.terminate = bool(last.terminate[0]) or (
            self.current_timestep >= self.episode_length)
        self.episode_memory.add_rewards_and_termination(
            post_cov - pre_cov, self.terminate)
        obs = self._observed()
        self.episode_memory.add_value("next_observations",
                                      self._pretransform_obs())
        if self.terminate:
            self.on_episode_end()
            return self.reset()
        self.episode_memory.add_value("pretransform_observations",
                                      self._pretransform_obs())
        return obs

    def _log_step(self, sel: ActionSelection, vm, obs_stack, pre_cov,
                  post_cov):
        """log_step_stats parity (simEnv.py:434-464): the selected
        transform's observation, the one-hot action, the value map and
        the task's statistics."""
        mem = self.episode_memory
        sel = ActionSelection(*(x[0].cpu().numpy() for x in sel))
        t, p = int(sel.transform_idx), int(sel.prim_idx)
        action = np.zeros((self.obs_dim, self.obs_dim), np.float32)
        action[int(sel.row), int(sel.col)] = 1.0
        mem.add_observation(obs_stack[t].cpu().numpy())
        mem.add_action(action)
        mem.add_value("preaction_coverage", pre_cov)
        mem.add_value("postaction_coverage", post_cov)
        mem.add_value("rotation", float(sel.rotation))
        mem.add_value("scale", float(sel.scale))
        mem.add_value("value_map", vm[p, t].cpu().numpy())
        mem.add_value("action_primitive", self.action_primitives[p])
        mem.add_value("max_indices", np.asarray(
            [t, int(sel.row), int(sel.col)]))
        mem.add_value("pretransform_pixels",
                      np.asarray(sel.pretransform_pixels))
        for key, value in self.current_task.get_stats().items():
            mem.add_value(key, value)

    def on_episode_end(self):
        """Count the episode, write its video (dump_visualizations) and
        dump its replay record."""
        self.episode_count += 1
        chunks = self.env.frames[0]
        if self.dump_visualizations and chunks:
            write_episode_video(
                chunks, self.state.active[0],
                None if self.env.palette is None else tuple(
                    p[0] for p in self.env.palette),
                os.path.join(video_dir(self.replay_buffer_path),
                             f"{self.episode_count - 1:09d}.webm"))
        self.env.frames[0] = []
        if self.replay_buffer_path is not None and len(self.episode_memory):
            self.episode_memory.dump(self.replay_buffer_path)
        self.episode_memory = Memory()

    # -- small parity helpers ------------------------------------------

    def compute_coverage(self) -> float:
        return float(get_current_covered_area(self.state.positions,
                                              self.state.active)[0])

    def is_cloth_grasped(self) -> bool:
        """Is the cloth's highest particle above 0.2 m?"""
        ys = self.state.positions[0, 1][self.state.active[0]]
        return bool(ys.max() > 0.2)
