"""Training and evaluation entry point of the port (counterpart of the root
run_sim.py).

Build the policy (resuming from `{log}/latest_ckpt.pth`), step a batch of
envs in lockstep, and every round: act, step the envs (episodes are
dumped to the replay directory), optimize each primitive's value net on
that primitive's transitions and checkpoint, and print statistics every
32 rounds.  `--action_primitives` takes any of fling, stretchdrag, drag
and place (one value net each).

    python -m flingbot_tpu_torch.run_sim --tasks tasks.npz --log runs/exp1
    python -m flingbot_tpu_torch.run_sim --tasks eval.npz --eval \
        --load runs/exp1/latest_ckpt.pth

--tasks takes a task file exported by tools/export_tasks_npz.py; --load a
checkpoint of the port or a JAX checkpoint exported by
tools/export_ckpt_npz.py.  The replay record is a directory,
`{log}/replay_buffer/` (`{ckpt}_eval_{i}/replay_buffer/` with --eval).
Runs on the card; --device cpu runs the plain PyTorch path on the CPU.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.env.batch_env import BatchSimEnv
from flingbot_tpu_torch.env.tasks import TaskLoader, detect_topology_buckets
from flingbot_tpu_torch.learning.dataset import GraspDataset
from flingbot_tpu_torch.learning.nets import MaximumValuePolicy
from flingbot_tpu_torch.learning.train import optimize
from flingbot_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint, setup_eval_dir)
from flingbot_tpu_torch.utils.config import (
    apply_presets, config_parser, seed_all, solver_params)
from flingbot_tpu_torch.utils.stats import collect_stats, get_dataset_size


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def add_histogram(self, *a, **k):
        pass

    def add_image(self, *a, **k):
        pass


def make_writer(logdir):
    """A tensorboardX SummaryWriter, or a writer that drops everything
    where tensorboardX is missing."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return _NullWriter()
    return SummaryWriter(logdir=logdir)


def setup(args, device):
    """Build the policy, auto-resume, and derive the replay directory (a
    fresh {ckpt}_eval_{i}/ in eval mode) (setup_network, utils.py:100-141
    of the reference)."""
    policy = MaximumValuePolicy(**{**vars(args), "device": device})
    checkpoint_path = args.load
    dataset_path = args.dataset_path
    if (args.log and os.path.exists(args.log) and checkpoint_path is None
            and os.path.exists(f"{args.log}/latest_ckpt.pth")):
        checkpoint_path = f"{args.log}/latest_ckpt.pth"
    if checkpoint_path is not None:
        print(f"Loading checkpoint {checkpoint_path}")
        load_checkpoint(checkpoint_path, policy)
        print(f"\tSteps: {policy.steps()}")
    if args.eval:
        if args.load is None:
            raise ValueError("--eval needs --load")
        policy.action_expl_prob = 0.0
        policy.value_expl_prob = 0.0
        args.log = setup_eval_dir(args.load)
        dataset_path = args.log + "replay_buffer"
        print(f"Evaluating {args.load}: saving to {dataset_path}")
    elif dataset_path is None and args.log is not None:
        dataset_path = f"{args.log}/replay_buffer"
        print(f"Replay Buffer path: {dataset_path}")
    return policy, dataset_path


def _print_stats(stats, writer, dataset_size):
    print("=" * 18 + f" {dataset_size} points " + "=" * 18)
    for key, value in stats.items():
        if "_steps" in key:
            continue
        if "distribution" in key:
            writer.add_histogram(key, value, global_step=dataset_size)
        elif "img" in key:
            writer.add_image(key, value, global_step=dataset_size)
        elif np.isscalar(value) or getattr(value, "ndim", 1) == 0:
            writer.add_scalar(key, float(value), global_step=dataset_size)
            print(f"\t[{key:<42}]:\t{float(value):.04f}")


def main(argv=None, max_rounds=None):
    """Run the loop; max_rounds (a Python argument, not a flag) stops it
    after that many rounds.  Returns (policy, history): one dict per round
    with its act / step / optimize seconds (optimize None when the round
    did not optimize), its losses and the replay size."""
    args = apply_presets(config_parser().parse_args(argv))
    device = resolve_device(args.device)
    seed_all(args.seed)
    os.makedirs(args.log, exist_ok=True)
    policy, dataset_path = setup(args, device)
    writer = make_writer(args.log)
    if not os.path.exists(args.log + "/args.pkl"):
        with open(args.log + "/args.pkl", "wb") as f:
            pickle.dump(vars(args), f)

    task_loader = TaskLoader(args.tasks, repeat=not args.eval)
    env = BatchSimEnv(
        get_task_fn=task_loader.get_next_task, num_envs=args.num_envs,
        replay_buffer_path=dataset_path, episode_length=args.episode_length,
        max_grid_dim=args.max_grid_dim,
        **detect_topology_buckets(args.tasks),
        obs_dim=args.obs_dim, num_rotations=args.num_rotations,
        scale_factors=args.scale_factors,
        action_primitives=args.action_primitives,
        pix_grasp_dist=args.pix_grasp_dist, pix_drag_dist=args.pix_drag_dist,
        pix_place_dist=args.pix_place_dist,
        stretchdrag_dist=args.stretchdrag_dist,
        conservative_grasp_radius=args.conservative_grasp_radius,
        use_adaptive_scaling=args.use_adaptive_scaling,
        reach_distance_limit=args.reach_distance_limit,
        render_dim=args.render_dim,
        substeps=args.substeps, iterations=args.iterations,
        contact_every=args.contact_every,
        contact_iterations=args.contact_iterations,
        contact_window=args.contact_window, spring_mode=args.spring_mode,
        self_collision=not args.no_self_collision, backend=args.backend,
        contact_mode=args.contact_mode,
        domain_randomization=args.domain_randomization,
        fling_speed=args.fling_speed,
        fixed_fling_height=args.fixed_fling_height,
        chunk_steps=args.chunk_steps,
        solver_params=solver_params(args.solver_overrides), seed=args.seed,
        dump_visualizations=args.dump_visualizations, device=device)

    # one dataset per primitive, refreshed incrementally: a fresh one per
    # round would re-read every step's attributes to re-apply the filter
    datasets = {}

    def dataset_factory(primitive):
        ds = datasets.get(primitive)
        if ds is None:
            ds = datasets[primitive] = GraspDataset(
                dataset_path,
                filter_fn=lambda a: a.get("action_primitive") == primitive,
                **vars(args))
        else:
            ds.refresh()
        return ds

    def lap(t):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t

    history = []
    try:
        obs = env.reset()
    except StopIteration:
        print("No tasks available")
        return policy, history

    i = get_dataset_size(dataset_path)
    eval_episode_target = len(task_loader) if args.eval else None
    while max_rounds is None or len(history) < max_rounds:
        t0 = time.perf_counter()
        vm = policy.batch_value_maps(obs)
        rec = {"round": i, "act": lap(t0), "optimize": None, "losses": {}}
        t0 = time.perf_counter()
        try:
            obs = env.step(vm)
        except StopIteration:
            print("[eval] task set exhausted")
            break
        rec["step"] = lap(t0)
        history.append(rec)
        dataset_size = rec["dataset_size"] = get_dataset_size(dataset_path)
        if i > args.warmup:
            policy.decay_exploration()
        if not args.eval and dataset_size > args.warmup \
                and i % args.update_frequency == 0:
            t0 = time.perf_counter()
            rec["losses"] = optimize(
                policy, dataset_factory, batch_size=args.batch_size,
                batches_per_update=args.batches_per_update, writer=writer)
            save_checkpoint(f"{args.log}/latest_ckpt.pth", policy)
            rec["optimize"] = lap(t0)
            print(f"[round {i}] act {rec['act']:.1f}s step {rec['step']:.1f}s"
                  f" optimize {rec['optimize']:.1f}s n={dataset_size}",
                  flush=True)
            if i % args.save_ckpt == 0:
                save_checkpoint(
                    f"{args.log}/ckpt_{policy.steps():06d}.pth", policy)
        if i % 32 == 0 and dataset_size > 0:
            _print_stats(collect_stats(dataset_path) or {}, writer,
                         dataset_size)
        if args.eval and env.episodes_done >= eval_episode_target:
            print("[eval] done:", env.episodes_done, "episodes")
            break
        i += 1

    if args.eval:
        stats = collect_stats(dataset_path, num_points=10 ** 9) or {}
        for key, value in stats.items():
            if "_steps" in key or "distribution" in key or "img" in key:
                continue
            print(f"\t[{key:<42}]:\t{float(value):.04f}")
    return policy, history


if __name__ == "__main__":
    main()
