"""BatchSimEnv: a batch of cloth envs (grid cloths, or shirts on one
layered lattice) stepping in lockstep on one card (counterpart of
flingbot_tpu/env/batch_env.py, eval path).

    obs = env.reset(state, topo)        # (B, T, 4, D, D)
    vm = policy.batch_value_maps(obs)   # (B, P, T, D, D)
    obs = env.step(vm)                  # env.last: per-env coverage etc.

Each step selects one fling per env, runs the fling program (ending in the
postaction STABILIZE) through the batched interpreter in host-driven
chunks, scores coverage before and after, and renders the next
observation.  Task files, replay writing and episode resets are not part
of this port yet: start states come from the caller.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.engine.solver import step as solver_step
from flingbot_tpu_torch.engine.state import ClothState, SolverParams
from flingbot_tpu_torch.engine.topology import (
    GridTopology, grid_triangles_dynamic)
from flingbot_tpu_torch.env.action import ActionSelection
from flingbot_tpu_torch.env.coverage import get_current_covered_area
from flingbot_tpu_torch.env.observation import (
    Observation, compute_observation)
from flingbot_tpu_torch.env.primitives import (
    STABLE_MAX_STEPS, PrimitiveConfig, program_chunk)
from flingbot_tpu_torch.env.scene import PARK_PICKERS
from flingbot_tpu_torch.env.sim_env import step_begin, step_finish
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


class BatchSimEnv:
    """Fling envs in lockstep.  Observation and primitive settings are the
    production defaults of run_sim.py (grasp radius 1, adaptive scaling,
    reach 1.2 m, grasp height 0.02, fling speed 6e-3, surface-sampled
    render); the solver knobs default to the production operating point."""

    def __init__(self, obs_dim: int = 64, num_rotations: int = 12,
                 scale_factors: Sequence[float] = (
                     1.0, 1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 2.75),
                 pix_grasp_dist: int = 8, render_dim: int = 400,
                 substeps: int = 4, iterations: int = 16,
                 contact_every: int = 2, contact_iterations: int = 4,
                 contact_window: int = 12, domain_randomization: bool = True,
                 chunk_steps: int = 64, max_program_steps: int = 4000,
                 solver_params: SolverParams | None = None, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.rotations = torch.as_tensor(rotation_list(num_rotations),
                                         device=self.device)
        self.scale_factors = torch.tensor(scale_factors, dtype=torch.float32,
                                          device=self.device)
        self.obs_dim = obs_dim
        self.pix_grasp_dist = pix_grasp_dist
        self.render_dim = render_dim
        self.sim_kw = dict(
            substeps=substeps, iterations=iterations,
            contact_every=contact_every,
            contact_iterations=contact_iterations,
            contact_window=contact_window)
        self.prim_cfg = PrimitiveConfig(max_program_steps=max_program_steps)
        # solver_params: SolverParams with overrides (the JAX env's
        # solver_overrides); drag or lift set turns the aero pass on
        self.params = solver_params or SolverParams()
        self.chunk_steps = int(chunk_steps)
        self.domain_randomization = domain_randomization
        self.generator = torch.Generator().manual_seed(seed)
        self.palette = None
        self.last: StepInfo | None = None

    # ------------------------------------------------------------------

    def reset(self, state: ClothState, topo) -> torch.Tensor:
        """Load start states (arms parked), settle one step, observe.
        topo: a GridTopology or a LayeredGridTopology."""
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
        return self.obs.obs_stack

    def _observe(self):
        """Render and warp in slices of OBS_CHUNK envs: one slice's 96-view
        temporaries are a few hundred MB at render 400."""
        self.obs = None
        faces, fmask = self._cloth_faces()
        outs = []
        for s in range(0, self.state.batch, OBS_CHUNK):
            sl = slice(s, s + OBS_CHUNK)
            outs.append(compute_observation(
                self.state.positions[sl], self.state.active[sl],
                self.rotations, self.scale_factors, faces[sl], fmask[sl],
                image_size=self.render_dim, obs_dim=self.obs_dim,
                palette=None if self.palette is None else (
                    self.palette[0][sl], self.palette[1][sl])))
        self.obs = Observation(*(torch.cat(x) for x in zip(*outs)))

    def _cloth_faces(self):
        """(faces (B, T, 3), mask (B, T)) in lattice slots for the
        renderer's surface samples (_cloth_faces, batch_env.py:443-459)."""
        t = self.topo
        if isinstance(t, GridTopology):
            return grid_triangles_dynamic(t.dimx, t.dimy, t.max_dimx,
                                          t.max_dimy)
        return t.triangles, t.tri_mask

    def step(self, value_maps: torch.Tensor) -> torch.Tensor:
        """value_maps (B, P, T, D, D) -> next obs stack (B, T, 4, D, D)."""
        vm = value_maps.to(self.device)
        sel, pre_cov, pre_pos, carry, prog = step_begin(
            self.state, vm, self.obs, self.rotations, self.prim_cfg,
            self.pix_grasp_dist)
        max_steps = self.prim_cfg.max_program_steps + STABLE_MAX_STEPS
        # hard cap: every program ends within max_steps sim steps plus its
        # jump-only interpreter steps (< 2 per instruction)
        max_chunks = math.ceil(
            (max_steps + 2 * prog.num_instructions) / self.chunk_steps) + 1
        chunks = 0
        for _ in range(max_chunks):
            carry, done = program_chunk(
                carry, self.topo, self.params, prog,
                chunk_steps=self.chunk_steps, max_steps=max_steps,
                sim_kw=self.sim_kw)
            chunks += 1
            if bool(done.all()):
                break
        state, post_cov, terminate = step_finish(carry, pre_pos)
        self.state = state
        self.last = StepInfo(sel, pre_cov, post_cov, terminate,
                             carry.total_steps, chunks)
        self._observe()
        return self.obs.obs_stack
