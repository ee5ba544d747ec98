"""Quality evaluation of the port: coverage after K flings on a task set
(counterpart of the root eval_quality.py).

    python -m flingbot_tpu_torch.eval_quality \
        --tasks data_r3/rect_eval_hard_100.npz --policy heuristic \
        --steps 3 --num_envs 64 --episodes 100

--tasks takes a task file exported by tools/export_tasks_npz.py.  Policies:
'heuristic' (value peaks at cloth pixels far from the cloth centroid: grasp
the far edge), 'random' value maps, and 'ckpt', the value net of --load (a
checkpoint of the port, or a JAX checkpoint exported to .npz by
tools/export_ckpt_npz.py; --tta averages its value maps over the 8
dihedral transforms of each view).  Runs on the card; --device cpu
runs the plain PyTorch path on the CPU.  The last line of the output is
the JSON line of the root eval_quality.py: episodes, seconds and the
coverage statistics of the replay record.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

# the keys of the JSON line (eval_quality.py:157-168)
_KEY_PREFIXES = ("final_coverage/", "init_coverage/",
                 "episode_delta_coverage/", "best_coverage/")
_KEY_SUFFIXES = ("/mean", "/max")


def heuristic_value_maps(obs_stack: torch.Tensor) -> torch.Tensor:
    """(B, T, 4, D, D) obs -> (B, 1, T, D, D) float32 values
    (eval_quality.py:35-51), computed in float64 as the numpy original.

    Cloth pixels score by distance from the cloth centroid (prefer grasping
    the far edge of the cloth); background pixels score -1."""
    depth = obs_stack[:, :, 3]  # (B, T, D, D)
    cloth = depth < 1.995
    D = depth.shape[-1]
    ar = torch.arange(D, dtype=torch.float64, device=depth.device)
    ys = ar.view(1, 1, D, 1)
    xs = ar.view(1, 1, 1, D)
    c = cloth.to(torch.float64)
    denom = torch.clamp(c.sum((2, 3), keepdim=True), min=1)
    cy = (c * ys).sum((2, 3), keepdim=True) / denom
    cx = (c * xs).sum((2, 3), keepdim=True) / denom
    dist = torch.sqrt((ys - cy) ** 2 + (xs - cx) ** 2) / D
    vm = torch.where(cloth, dist, -1.0)
    return vm[:, None].to(torch.float32)


def json_line(stats: dict, episodes: int, seconds: float) -> dict:
    """The last line of eval_quality: the picked statistics, rounded."""
    out = {"episodes": episodes, "seconds": round(seconds, 1)}
    for k, v in sorted(stats.items()):
        if any(k.startswith(p) and k.endswith(s)
               for p in _KEY_PREFIXES for s in _KEY_SUFFIXES) \
                or k.endswith("percent_positive"):
            out[k] = round(float(v), 4)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tasks", required=True)
    p.add_argument("--policy", default="heuristic",
                   choices=["heuristic", "random", "ckpt"])
    p.add_argument("--load", default=None)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--num_envs", type=int, default=8)
    p.add_argument("--num_rotations", type=int, default=12)
    p.add_argument("--scale_factors", nargs="+", type=float,
                   default=[1.0, 1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 2.75])
    p.add_argument("--render_dim", type=int, default=256)
    p.add_argument("--max_grid_dim", type=int, default=104)
    p.add_argument("--episodes", type=int, default=None,
                   help="total episodes (default: one pass over the tasks)")
    # the production solver config (flingbot_tpu/utils/config.py)
    p.add_argument("--backend", default="pallas", choices=["pallas", "xla"])
    p.add_argument("--spring_mode", default="chebyshev",
                   choices=["gs", "jacobi", "chebyshev"])
    p.add_argument("--contact_mode", default="sort",
                   choices=["sort", "sweep", "block", "table"])
    p.add_argument("--substeps", type=int, default=4)
    p.add_argument("--iterations", type=int, default=16)
    p.add_argument("--contact_every", type=int, default=2)
    p.add_argument("--contact_iterations", type=int, default=4)
    p.add_argument("--contact_window", type=int, default=12)
    p.add_argument("--exec_mode", choices=["chunked", "fused"],
                   default="chunked",
                   help="accepted and ignored: a TPU execution knob of the "
                        "JAX package that does not change results")
    p.add_argument("--chunk_steps", type=int, default=192)
    p.add_argument("--domain_randomization",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tta", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--solver_overrides", type=str, default=None,
                   help="JSON dict of SolverParams overrides")
    p.add_argument("--device", default="cuda")
    p.add_argument("--stats_out", default=None,
                   help="also write every statistic, per-episode "
                        "distributions included, to this JSON file")
    return p.parse_args(argv)


def main(argv=None, buckets=None):
    """Runs the evaluation of argv.  buckets: BatchSimEnv's topology
    buckets (layered_spec, mesh_caps); default: the task file's own
    (tasks.detect_topology_buckets)."""
    args = parse_args(argv)
    if args.policy == "ckpt" and args.load is None:
        raise ValueError("--policy ckpt needs --load: a checkpoint")
    if args.tta and args.policy != "ckpt":
        raise ValueError("--tta averages the value net's maps: it needs "
                         "--policy ckpt")

    from flingbot_tpu_torch.device import resolve_device
    from flingbot_tpu_torch.env.batch_env import BatchSimEnv
    from flingbot_tpu_torch.env.tasks import (
        TaskLoader, detect_topology_buckets)
    from flingbot_tpu_torch.learning.nets import MaximumValuePolicy
    from flingbot_tpu_torch.utils.checkpoint import load_checkpoint
    from flingbot_tpu_torch.utils.config import solver_params
    from flingbot_tpu_torch.utils.stats import collect_stats

    device = resolve_device(args.device)
    params = solver_params(args.solver_overrides)
    policy = None
    if args.policy == "ckpt":
        policy = MaximumValuePolicy(["fling"], 64, tta=args.tta,
                                    device=device)
        load_checkpoint(args.load, policy)
    loader = TaskLoader(args.tasks, repeat=True)
    if buckets is None:
        buckets = detect_topology_buckets(args.tasks)
    with tempfile.TemporaryDirectory(suffix="_replay") as replay:
        env = BatchSimEnv(
            get_task_fn=loader.get_next_task, num_envs=args.num_envs,
            replay_buffer_path=replay, episode_length=args.steps,
            max_grid_dim=args.max_grid_dim, **buckets,
            obs_dim=64, num_rotations=args.num_rotations,
            scale_factors=args.scale_factors, render_dim=args.render_dim,
            substeps=args.substeps, iterations=args.iterations,
            contact_every=args.contact_every,
            contact_iterations=args.contact_iterations,
            contact_window=args.contact_window,
            spring_mode=args.spring_mode, backend=args.backend,
            contact_mode=args.contact_mode,
            domain_randomization=args.domain_randomization,
            chunk_steps=args.chunk_steps, solver_params=params,
            seed=args.seed, device=device)
        target = args.episodes or len(loader)
        obs = env.reset()
        rng = np.random.default_rng(0)
        t0 = time.time()
        while env.episodes_done < target:
            if args.policy == "heuristic":
                vm = heuristic_value_maps(obs)
            elif args.policy == "random":  # the root eval_quality's draws
                vm = torch.from_numpy(rng.uniform(
                    size=(obs.shape[0], 1, obs.shape[1], 64, 64)
                ).astype(np.float32))
            else:
                vm = policy.batch_value_maps(obs)
            obs = env.step(vm)
            print(f"[eval] episodes {env.episodes_done}/{target} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        seconds = time.time() - t0
        stats = collect_stats(replay, num_points=10 ** 9) or {}
    print(f"[eval] episodes ended early (terminate before {args.steps} "
          f"steps): {env.episodes_terminated} of {env.episodes_done}",
          flush=True)
    if args.stats_out:
        with open(args.stats_out, "w") as f:
            json.dump({k: np.asarray(v).tolist() for k, v in stats.items()
                       if not k.startswith("img_")
                       and not k.endswith("_steps")}, f)
    print(json.dumps(json_line(stats, env.episodes_done, seconds)))


if __name__ == "__main__":
    main()
