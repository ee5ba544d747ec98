"""One env step in three parts, batched (counterpart of step_begin /
step_finish in flingbot_tpu/env/sim_env.py):

  step_begin   action selection + pre-coverage + each env's program
  (host loop)  primitives.program_chunk until every env is done; the
               program ends in STABILIZE, the postaction settle
  step_finish  no-move early exit + post-coverage
"""

from __future__ import annotations

import torch

from flingbot_tpu_torch.env.action import select_action
from flingbot_tpu_torch.env.coverage import get_current_covered_area
from flingbot_tpu_torch.env.observation import Observation
from flingbot_tpu_torch.env.primitives import (
    PrimitiveConfig, build_selected_program, init_program_carry)

NO_MOVE_EPS = 5e-2  # postaction early-exit threshold (simEnv.py:475-477)


def step_begin(state, value_maps: torch.Tensor, obs: Observation,
               rotations: torch.Tensor, prim_cfg: PrimitiveConfig,
               pix_grasp_dist: int = 8, primitives=("fling",),
               pix_drag_dist: int = 10, pix_place_dist: int = 10):
    """Returns (sel, pre_cov, pre_pos, carry, program): the program of
    each env's selected primitive and action, ending in STABILIZE
    (step_begin, sim_env.py:179)."""
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
    carry = init_program_carry(state, dist, init_fh)
    return sel, pre_cov, state.positions, carry, prog


def step_finish(carry, pre_pos):
    """Returns (state, post_cov, terminate)."""
    state = carry.state
    d = state.positions - pre_pos
    disp = torch.where(state.active, torch.sqrt(
        d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]), 0.0)
    no_move = disp.amax(1) < NO_MOVE_EPS
    post_cov = get_current_covered_area(state.positions, state.active)
    return state, post_cov, carry.terminate | no_move
