"""Replay-record statistics (counterpart of flingbot_tpu/utils/stats.py).

Reads the step files that learning.memory.Memory writes and produces the
same key families as the JAX collect_stats, with the same filters:
episodes flagged failed_grasp / cloth_stuck / timed_out and steps whose
postaction coverage is under 5% of the cloth's flat area are left out,
and every statistic is kept per task_difficulty (easy / hard / shirt).
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from flingbot_tpu_torch.learning.memory import read_step, step_keys
from flingbot_tpu_torch.utils.vis import draw_action

_ERROR_FLAGS = ("failed_grasp", "cloth_stuck", "timed_out")


def get_dataset_size(replay_dir: str) -> int:
    """Number of steps in a replay directory (0 when there is none)."""
    return len(step_keys(replay_dir))


def collect_stats(
    replay_dir: str,
    num_points: int = 128,
    action_primitives=("fling", "stretchdrag", "drag", "place"),
    filter_keys_fn=None,
) -> Optional[Dict]:
    """Coverage statistics of the last `num_points` steps of a replay
    directory (collect_stats, stats.py:38-179); None when there is no
    record.  The image panels are `img_before_after`, `img_action` (the
    action drawn on the observation before it) and `img_value_map`."""
    keys = step_keys(replay_dir)
    if not keys:
        return None
    if filter_keys_fn is not None:
        keys = [k for i, k in enumerate(keys) if filter_keys_fn(i, k)]
    elif len(keys) > num_points:
        keys = keys[-num_points:]
    num_points = max(len(keys), 1)

    delta_cov = defaultdict(list)
    final_cov = defaultdict(list)
    init_cov = defaultdict(list)
    best_cov = defaultdict(lambda: defaultdict(float))
    ep_delta = defaultdict(list)
    ep_len = defaultdict(list)
    step_delta = defaultdict(lambda: defaultdict(list))
    step_post = defaultdict(lambda: defaultdict(list))
    step_pre = defaultdict(lambda: defaultdict(list))
    prim_counts = {ap: 0 for ap in action_primitives}

    for k in keys:
        attrs, _ = read_step(replay_dir, k, arrays=False)
        if any(attrs.get(flag, False) for flag in _ERROR_FLAGS):
            continue
        if "max_coverage" not in attrs:
            continue
        mx = float(attrs["max_coverage"])
        post = float(attrs.get("postaction_coverage", 0.0)) / mx
        pre = float(attrs.get("preaction_coverage", 0.0)) / mx
        if post < 0.05:
            continue
        level = str(attrs.get("task_difficulty", "hard"))
        episode = k.split("_step")[0]
        step = k.split("step")[1].split("_")[0]
        delta_cov[level].append(post - pre)
        step_delta[level][step].append(post - pre)
        step_post[level][step].append(post)
        step_pre[level][step].append(pre)
        prim = str(attrs.get("action_primitive", ""))
        if prim in prim_counts:
            prim_counts[prim] += 1
        best_cov[level][episode] = max(best_cov[level][episode], post)
        if "last" in k:
            ep_len[level].append(int(step))
            final_cov[level].append(post)
            init_cov[level].append(
                float(attrs.get("init_coverage", 0.0)) / mx)
            ep_delta[level].append(final_cov[level][-1]
                                   - init_cov[level][-1])

    retval = {}

    def emit(name, data):
        for level, vals in data.items():
            if not len(vals):
                continue
            arr = np.asarray(vals, np.float64)
            retval[f"{name}/{level}/distribution"] = arr
            retval[f"{name}/{level}/mean"] = arr.mean()
            retval[f"{name}/{level}/max"] = arr.max()
            retval[f"{name}/{level}/min"] = arr.min()
            if name == "delta_coverage":
                n = len(arr)
                retval[f"{name}/{level}/percent_positive"] = (
                    np.count_nonzero(arr > 0) / n)
                retval[f"{name}/{level}/percent_negative"] = (
                    np.count_nonzero(arr < 0) / n)
                retval[f"{name}/{level}/percent_zero"] = (
                    np.count_nonzero(arr == 0) / n)

    emit("delta_coverage", delta_cov)
    emit("final_coverage", final_cov)
    emit("init_coverage", init_cov)
    emit("episode_delta_coverage", ep_delta)
    emit("episode_length", ep_len)
    emit("best_coverage", {
        lvl: list(d.values()) for lvl, d in best_cov.items()})
    retval["delta_coverage_steps"] = {
        lvl: dict(d) for lvl, d in step_delta.items()}
    retval["postaction_coverage_steps"] = {
        lvl: dict(d) for lvl, d in step_post.items()}
    retval["preaction_coverage_steps"] = {
        lvl: dict(d) for lvl, d in step_pre.items()}
    for ap in ("fling", "drag", "place"):
        if ap in prim_counts:
            retval[f"action_primitive/percent_{ap}"] = (
                prim_counts[ap] / num_points)

    # a sample before/after panel for dashboards (stats.py:145-179)
    for _ in range(3):
        k = random.choice(keys) if keys else None
        if k is None:
            break
        attrs, g = read_step(replay_dir, k)
        if "pretransform_observations" in g and "next_observations" in g:
            before = g["pretransform_observations"][:3]
            after = g["next_observations"][:3]
            retval["img_before_after"] = np.concatenate(
                [before, after], axis=2)  # (3, H, 2W)
            # action-annotated panel (utils.py:377-390 draws the grasp
            # line on the observation); a drawing failure leaves it out,
            # as the JAX package's collect_stats does
            if "pretransform_pixels" in g:
                try:
                    img = draw_action(
                        np.transpose(before, (1, 2, 0)).copy(),
                        str(attrs.get("action_primitive", "fling")),
                        np.asarray(g["pretransform_pixels"]), thickness=2)
                    retval["img_action"] = np.transpose(img, (2, 0, 1))
                except Exception:
                    pass
            if "value_map" in g:
                vm = np.asarray(g["value_map"], np.float32)
                vm = (vm - vm.min()) / max(vm.max() - vm.min(), 1e-9)
                retval["img_value_map"] = vm[None]  # (1, D, D)
            break
    return retval
