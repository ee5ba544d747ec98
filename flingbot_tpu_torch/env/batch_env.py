"""BatchSimEnv: a batch of cloth envs (grid cloths, shirts on one layered
lattice, or other quad meshes through the generic mesh path) stepping in
lockstep on one card (counterpart of flingbot_tpu/env/batch_env.py).

    env = BatchSimEnv(get_task_fn=loader.get_next_task, num_envs=64,
                      replay_buffer_path=replay_dir, episode_length=3)
    obs = env.reset()                   # (B, T, 4, D, D)
    vm = policy.batch_value_maps(obs)   # (B, P, T, D, D)
    obs = env.step(vm)                  # env.last: per-env coverage etc.

Each step selects one action per env among the action primitives (fling,
stretchdrag, drag, place; one value map each), runs each env's program
(ending in the postaction STABILIZE) through the batched interpreter in
host-driven chunks, scores coverage before and after, and renders the
next observation.  With a task source, every env slot runs episodes: each step
is logged to the slot's replay Memory, an episode ends on termination or
after `episode_length` steps, is dumped to the replay record, and its
slot is reloaded with the next task (batch_env.py:587-719).

`reset(state, topo)` instead starts every slot from states the caller
made (no tasks, no episodes, no replay).
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.engine.solver import (
    BACKENDS, CONTACT_MODES, SPRING_MODES)
from flingbot_tpu_torch.engine.solver import step as solver_step
from flingbot_tpu_torch.engine.state import (
    MAX_GRID_DIM, ClothState, SolverParams)
from flingbot_tpu_torch.engine.topology import (
    GridTopology, grid_triangles_dynamic)
from flingbot_tpu_torch.env.action import ActionSelection
from flingbot_tpu_torch.env.coverage import get_current_covered_area
from flingbot_tpu_torch.env.observation import (
    Observation, compute_observation)
from flingbot_tpu_torch.env.primitives import (
    STABLE_MAX_STEPS, PrimitiveConfig, program_chunk)
from flingbot_tpu_torch.env.scene import PARK_PICKERS, make_batch, scene_task
from flingbot_tpu_torch.env.sim_env import step_begin, step_finish
from flingbot_tpu_torch.learning.memory import Memory
from flingbot_tpu_torch.learning.nets import rotation_list
from flingbot_tpu_torch.render.rasterizer import domain_randomized_palette

OBS_CHUNK = 16


class StepInfo(NamedTuple):
    selection: ActionSelection
    pre_coverage: torch.Tensor  # (B,) m^2
    post_coverage: torch.Tensor
    terminate: torch.Tensor  # (B,) bool
    sim_steps: torch.Tensor  # (B,) solver steps the program ran
    chunks: int  # host-driven program chunks


class StepStart(NamedTuple):
    """What BatchSimEnv.begin_step hands to run_program and end_step."""
    t0: float  # perf_counter at the step's start
    prev_stack: torch.Tensor  # the observation the actions were chosen on
    selection: ActionSelection
    pre_coverage: torch.Tensor
    pre_positions: torch.Tensor
    carry: object  # the interpreter's start carry
    prog: object  # the programs
    max_steps: int  # sim-step cap of the programs


class BatchSimEnv:
    """Cloth envs in lockstep.  Observation and primitive settings default
    to run_sim.py's (the fling; grasp radius 1, adaptive scaling, reach
    1.2 m, grasp height 0.02, surface-sampled render); the fling speed and
    height and the solver knobs default to the production operating
    point.  The rotations are -90..90 degrees with the fling among the
    primitives, a full turn without (nets.rotation_list).

    get_task_fn: returns the next env.tasks.Task (TaskLoader.get_next_task)
    for reset() and reloads; layered_spec: the shared lattice of a shirt
    task file, or mesh_caps: the (verts, edges, tris) bucket of a file of
    other meshes, which take the generic mesh path (both from
    tasks.detect_topology_buckets).  backend and contact_mode go to
    solver.step; the defaults are the production
    "pallas" / "sort" that run_sim and eval_quality pass (the JAX
    constructor's own are "xla" / "block").  A layered batch runs "sort"
    whatever contact_mode says, as the JAX env does."""

    def __init__(self, get_task_fn: Optional[Callable] = None,
                 num_envs: Optional[int] = None,
                 replay_buffer_path: Optional[str] = None,
                 episode_length: int = 10,
                 max_grid_dim: int = MAX_GRID_DIM, layered_spec=None,
                 mesh_caps=None, obs_dim: int = 64, num_rotations: int = 12,
                 scale_factors: Sequence[float] = (
                     1.0, 1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 2.75),
                 action_primitives: Sequence[str] = ("fling",),
                 pix_grasp_dist: int = 8, pix_drag_dist: int = 10,
                 pix_place_dist: int = 10, stretchdrag_dist: float = 0.3,
                 conservative_grasp_radius: int = 1,
                 use_adaptive_scaling: bool = True,
                 reach_distance_limit: float = 1.2, render_dim: int = 400,
                 substeps: int = 4, iterations: int = 16,
                 contact_every: int = 2, contact_iterations: int = 4,
                 contact_window: int = 12, spring_mode: str = "chebyshev",
                 self_collision: bool = True, backend: str = "pallas",
                 contact_mode: str = "sort",
                 domain_randomization: bool = True,
                 fling_speed: float = 6e-3, fixed_fling_height: float = -1.0,
                 chunk_steps: int = 64, max_program_steps: int = 4000,
                 solver_params: SolverParams | None = None, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        for name, value, choices in (
                ("spring_mode", spring_mode, SPRING_MODES),
                ("backend", backend, BACKENDS),
                ("contact_mode", contact_mode, CONTACT_MODES)):
            if value not in choices:
                raise ValueError(f"unknown {name} {value!r}")
        if mesh_caps is not None and layered_spec is not None:
            raise ValueError("pass either mesh_caps (the generic mesh path) "
                             "or layered_spec")
        if layered_spec is not None and contact_mode != "sort":
            # the layered step has the sorted contact group only
            # (batch_env.py:143-153)
            warnings.warn(f"layered topology: contact_mode {contact_mode!r}"
                          " -> 'sort' (the only contact group the layered "
                          "shirt path implements)")
            contact_mode = "sort"
        if get_task_fn is not None and not num_envs:
            raise ValueError("a task source needs num_envs")
        self.get_task_fn = get_task_fn
        self.num_envs = num_envs
        self.replay_buffer_path = replay_buffer_path
        self.episode_length = episode_length
        self.max_grid_dim = max_grid_dim
        self.layered_spec = layered_spec
        self.mesh_caps = mesh_caps
        self.action_primitives = tuple(action_primitives)
        self.rotations = torch.as_tensor(
            rotation_list(num_rotations, self.action_primitives),
            device=self.device)
        self.scale_factors = torch.tensor(scale_factors, dtype=torch.float32,
                                          device=self.device)
        self.obs_dim = obs_dim
        self.pix_grasp_dist = pix_grasp_dist
        self.pix_drag_dist = pix_drag_dist
        self.pix_place_dist = pix_place_dist
        self.obs_kw = dict(
            conservative_grasp_radius=conservative_grasp_radius,
            use_adaptive_scaling=use_adaptive_scaling,
            reach_distance_limit=reach_distance_limit)
        self.render_dim = render_dim
        self.sim_kw = dict(
            substeps=substeps, iterations=iterations,
            contact_every=contact_every,
            contact_iterations=contact_iterations,
            contact_window=contact_window, spring_mode=spring_mode,
            self_collision=self_collision, backend=backend,
            contact_mode=contact_mode)
        self.prim_cfg = PrimitiveConfig(
            fling_speed=fling_speed, fixed_fling_height=fixed_fling_height,
            stretchdrag_dist=stretchdrag_dist,
            max_program_steps=max_program_steps)
        # solver_params: SolverParams with overrides (the JAX env's
        # solver_overrides); drag or lift set turns the aero pass on
        self.params = solver_params or SolverParams()
        self.chunk_steps = int(chunk_steps)
        self.domain_randomization = domain_randomization
        self.generator = torch.Generator().manual_seed(seed)
        self.palette = None
        self.last: StepInfo | None = None
        self.tasks = None
        self.memories: list = []
        self.timesteps = np.zeros(0, np.int64)
        self.episodes_done = 0
        self.episodes_terminated = 0  # ended early: terminate before length

    # ------------------------------------------------------------------

    def load_scenes(self, tasks):
        """File tasks -> (topology, state) batch, pickers parked
        (_load_scene, batch_env.py:336-345, for all of them at once)."""
        return make_batch([scene_task(t) for t in tasks],
                          max_grid_dim=self.max_grid_dim, device=self.device,
                          layered_spec=self.layered_spec,
                          mesh_caps=self.mesh_caps)

    def reset(self, state: ClothState | None = None,
              topo=None) -> torch.Tensor:
        """Load a task into every env slot (or take the caller's start
        states and topology: a GridTopology, a LayeredGridTopology or a
        MeshTopology),
        park the arms, settle one solver step, record init coverage and
        observe (reset, batch_env.py:370-396)."""
        if state is None:
            if self.get_task_fn is None:
                raise ValueError("reset() without states needs get_task_fn")
            self.tasks = [self.get_task_fn() for _ in range(self.num_envs)]
            topo, state = self.load_scenes(self.tasks)
            self.memories = [Memory() for _ in range(self.num_envs)]
            self.timesteps = np.zeros(self.num_envs, np.int64)
        else:
            self.tasks = None
        park = torch.tensor(PARK_PICKERS, dtype=torch.float32,
                            device=self.device)
        self.topo = topo
        state = state.replace(picker_pos=park.expand(state.batch, -1,
                                                     -1).clone())
        self.state = solver_step(state, topo, self.params, **self.sim_kw)
        self.init_coverage = get_current_covered_area(
            self.state.positions, self.state.active)
        if self.domain_randomization:
            self.palette = domain_randomized_palette(
                self.generator, state.batch, self.render_dim, self.device)
        self._observe()
        if self.tasks is not None:
            for i, mem in enumerate(self.memories):
                mem.add_value("pretransform_observations",
                              self._pretransform_np[i])
        return self.obs.obs_stack

    def _render(self, idx: torch.Tensor | None = None) -> Observation:
        """Observations of all env slots, or of slots idx, rendered and
        warped in slices of OBS_CHUNK envs: one slice's 96-view
        temporaries are a few hundred MB at render 400."""
        pos, act = self.state.positions, self.state.active
        faces, fmask = self._cloth_faces()
        palette = self.palette
        if idx is not None:
            pos, act, faces, fmask = pos[idx], act[idx], faces[idx], fmask[idx]
            if palette is not None:
                palette = (palette[0][idx], palette[1][idx])
        outs = []
        for s in range(0, pos.shape[0], OBS_CHUNK):
            sl = slice(s, s + OBS_CHUNK)
            outs.append(compute_observation(
                pos[sl], act[sl], self.rotations, self.scale_factors,
                faces[sl], fmask[sl], image_size=self.render_dim,
                obs_dim=self.obs_dim, **self.obs_kw,
                palette=None if palette is None else (
                    palette[0][sl], palette[1][sl])))
        return Observation(*(torch.cat(x) for x in zip(*outs)))

    @staticmethod
    def _pretransform(obs: Observation) -> torch.Tensor:
        """(B, 4, S, S) RGB-D of the render (_pretransform_obs,
        batch_env.py:494-498)."""
        return torch.cat([obs.rgb.permute(0, 3, 1, 2), obs.depth[:, None]],
                         1).to(torch.float32)

    def _observe(self):
        self.obs = None
        self.obs = self._render()
        if self.tasks is not None:
            # one host copy per step for the replay record, not one per env
            self._pretransform_np = self._pretransform(self.obs).cpu().numpy()

    def _observe_subset(self, idx: torch.Tensor):
        """Re-render only slots idx and write them into the observation
        and its host copy (_observe_subset, batch_env.py:500-536)."""
        sub = self._render(idx)
        self.obs = Observation(*(b.index_copy(0, idx, x)
                                 for b, x in zip(self.obs, sub)))
        self._pretransform_np[idx.cpu().numpy()] = (
            self._pretransform(sub).cpu().numpy())

    def _cloth_faces(self):
        """(faces (B, T, 3), mask (B, T)) in lattice slots for the
        renderer's surface samples (_cloth_faces, batch_env.py:443-459)."""
        t = self.topo
        if isinstance(t, GridTopology):
            return grid_triangles_dynamic(t.dimx, t.dimy, t.max_dimx,
                                          t.max_dimy)
        return t.triangles, t.tri_mask

    def step(self, value_maps: torch.Tensor) -> torch.Tensor:
        """value_maps (B, P, T, D, D) -> next obs stack (B, T, 4, D, D).
        With tasks: replay logging, episode ends and reloads; prints the
        step's [env.perf] wall-time buckets."""
        start = self.begin_step(value_maps)
        # hard cap: every program ends within max_steps sim steps plus its
        # jump-only interpreter steps (< 2 per instruction)
        max_chunks = math.ceil(
            (start.max_steps + 2 * start.prog.num_instructions)
            / self.chunk_steps) + 1
        carry, chunks = start.carry, 0
        for _ in range(max_chunks):
            carry, done = self.run_program(start, carry, self.chunk_steps)
            chunks += 1
            if bool(done.all()):
                break
        return self.end_step(start, carry, chunks)

    def begin_step(self, value_maps: torch.Tensor) -> StepStart:
        """The first part of step(): each env's action and program from
        value_maps; the env is left as it was."""
        t0 = time.perf_counter()
        vm = torch.as_tensor(value_maps).to(self.device)
        sel, pre_cov, pre_pos, carry, prog = step_begin(
            self.state, vm, self.obs, self.rotations, self.prim_cfg,
            self.pix_grasp_dist, self.action_primitives, self.pix_drag_dist,
            self.pix_place_dist)
        return StepStart(t0, self.obs.obs_stack, sel, pre_cov, pre_pos,
                         carry, prog,
                         self.prim_cfg.max_program_steps + STABLE_MAX_STEPS)

    def run_program(self, start: StepStart, carry, steps: int):
        """Up to `steps` interpreter steps of start's programs from carry
        -> (carry, done (B,) bool)."""
        return program_chunk(carry, self.topo, self.params, start.prog,
                             chunk_steps=steps, max_steps=start.max_steps,
                             sim_kw=self.sim_kw)

    def end_step(self, start: StepStart, carry, chunks: int) -> torch.Tensor:
        """The last part of step() on the programs' carry: post coverage,
        termination, the next observation; with tasks, the replay record,
        episode ends and reloads."""
        t0, sel, pre_cov = start.t0, start.selection, start.pre_coverage
        state, post_cov, terminate = step_finish(carry, start.pre_positions)
        self.state = state
        self.last = StepInfo(sel, pre_cov, post_cov, terminate,
                             carry.total_steps, chunks)
        t_prog = time.perf_counter()
        self._observe()
        t_obs = time.perf_counter()
        if self.tasks is None:
            return self.obs.obs_stack

        reload_idx = self._log_step(start.prev_stack, sel, pre_cov,
                                    post_cov, terminate)
        t_replay = time.perf_counter()
        if reload_idx:
            self._reload(reload_idx)
        t_end = time.perf_counter()
        # wall-time buckets of the step (batch_env.py:697-717); each ends
        # at a host sync, so the attribution is good to one queue tail
        print(f"[env.perf] program {t_prog - t0:.3f}s "
              f"(chunks {chunks}x{self.chunk_steps}) "
              f"observe {t_obs - t_prog:.3f}s "
              f"replay {t_replay - t_obs:.3f}s "
              f"reload {t_end - t_replay:.3f}s (n={len(reload_idx)}) "
              f"total {t_end - t0:.3f}s", flush=True)
        return self.obs.obs_stack

    def _log_step(self, prev_stack, sel, pre_cov, post_cov, terminate):
        """Add the step to every slot's Memory with the values the JAX env
        adds (batch_env.py:618-644); dump the episodes that end.  Returns
        the slots to reload."""
        B = self.num_envs
        pre_cov = pre_cov.cpu().numpy()
        post_cov = post_cov.cpu().numpy()
        terminate = terminate.cpu().numpy()
        # replay keeps only the selected transform's observation
        sel_obs = prev_stack[torch.arange(B, device=self.device),
                             sel.transform_idx].cpu().numpy()
        sel = ActionSelection(*(x.cpu().numpy() for x in sel))
        reload_idx = []
        for i in range(B):
            mem = self.memories[i]
            t = int(sel.transform_idx[i])
            action = np.zeros((self.obs_dim, self.obs_dim), np.float32)
            action[int(sel.row[i]), int(sel.col[i])] = 1.0
            mem.add_observation(sel_obs[i])
            mem.add_action(action)
            mem.add_value("preaction_coverage", float(pre_cov[i]))
            mem.add_value("postaction_coverage", float(post_cov[i]))
            mem.add_value("rotation", float(sel.rotation[i]))
            mem.add_value("scale", float(sel.scale[i]))
            mem.add_value("action_primitive",
                          self.action_primitives[int(sel.prim_idx[i])])
            mem.add_value("max_indices", np.asarray(
                [t, int(sel.row[i]), int(sel.col[i])]))
            mem.add_value("pretransform_pixels",
                          np.asarray(sel.pretransform_pixels[i]))
            for key, value in self.tasks[i].get_stats().items():
                mem.add_value(key, value)
            self.timesteps[i] += 1
            done = bool(terminate[i]) or (
                self.timesteps[i] >= self.episode_length)
            mem.add_rewards_and_termination(
                float(post_cov[i] - pre_cov[i]), done)
            mem.add_value("next_observations", self._pretransform_np[i])
            if done:
                if self.replay_buffer_path is not None and len(mem):
                    mem.dump(self.replay_buffer_path)
                self.episodes_done += 1
                self.episodes_terminated += int(
                    self.timesteps[i] < self.episode_length)
                reload_idx.append(i)
            else:
                mem.add_value("pretransform_observations",
                              self._pretransform_np[i])
        return reload_idx

    def _reload(self, reload_idx):
        """Load the next tasks into the finished slots, all at once
        (batch_env.py:654-692): slot writeback, a settle step over the
        whole batch of which only those slots are kept, their init
        coverage, a fresh palette and a re-render of those slots only."""
        for i in reload_idx:
            self.tasks[i] = self.get_task_fn()
            self.memories[i] = Memory()
            self.timesteps[i] = 0
        topo, state = self.load_scenes([self.tasks[i] for i in reload_idx])
        idx = torch.tensor(reload_idx, dtype=torch.int64, device=self.device)
        self.topo = self.topo.set_slots(idx, topo)
        self.state = self.state.set_slots(idx, state)
        if self.domain_randomization:
            fresh = domain_randomized_palette(
                self.generator, len(reload_idx), self.render_dim, self.device)
            self.palette = tuple(p.index_copy(0, idx, f)
                                 for p, f in zip(self.palette, fresh))
        settled = solver_step(self.state, self.topo, self.params,
                              **self.sim_kw)
        self.state = self.state.set_slots(idx, settled.index(idx))
        cov = get_current_covered_area(self.state.positions,
                                       self.state.active)
        self.init_coverage = self.init_coverage.index_copy(0, idx, cov[idx])
        self._observe_subset(idx)
        for i in reload_idx:
            self.memories[i].add_value("pretransform_observations",
                                       self._pretransform_np[i])
