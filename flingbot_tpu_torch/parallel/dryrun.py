"""The multi-device dry run: the training stack sharded over n ranks
(counterpart of dryrun_multichip, __graft_entry__.py:29-147).

One collect round of a sharded BatchSimEnv (task load -> settle -> action
selection -> the host-driven primitive programs -> replay record, each
rank simulating its own env slots), then the GraspDataset read of the
collected transitions in env order, then one data-parallel optimize step
(make_dp_train_step) on each rank's shard of that batch.

    python -m flingbot_tpu_torch.parallel.dryrun --ranks 2 --device cpu

spawns one process per rank (NCCL on cards, gloo on the CPU) over
tcp://localhost; `dryrun` runs one rank inside a process group that
already exists.  By default the task is the JAX dry run's synthetic
folded cloth (28 x 28 on a 32 lattice) and the env its tiny one;
`dryrun`'s `tasks`, `num_envs` and `env_kw` run it on a task file at
other knobs.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from flingbot_tpu_torch.parallel.mesh import (
    make_dp_train_step, make_env_sharding, make_mesh, replicate,
    shard_batch, spawn)

# the JAX dry run's env (dryrun_multichip): 2 rotations x 2 scales, render
# 128, no self-collision, 8 Chebyshev iterations, 1-step episodes, a 3x
# servo speed (the same program in ~3x fewer steps)
DRYRUN_ENV = dict(obs_dim=64, num_rotations=2, scale_factors=(1.0, 1.5),
                  render_dim=128, max_grid_dim=32, self_collision=False,
                  spring_mode="chebyshev", iterations=8, episode_length=1,
                  chunk_steps=48, seed=11, fling_speed=2e-2)


def write_folded_task(path: str, dim: int = 28):
    """The JAX dry run's task: a flat dim x dim cloth whose far half is
    folded back over the near half (no crumpling sim)."""
    from flingbot_tpu_torch.engine.topology import grid_positions
    from flingbot_tpu_torch.env.tasks import append_tasks

    pos = grid_positions(dim, dim, lower=(0.0, 0.006, 0.0))
    pos[:, [0, 2]] -= pos[:, [0, 2]].mean(axis=0)
    half = pos[:, 2] > 0
    pos[half, 2] = -pos[half, 2]
    pos[half, 1] += 0.008
    n_p = dim * dim
    spacing = 0.00625
    p4 = np.concatenate(
        [pos, np.full((n_p, 1), n_p / 0.5, np.float32)], axis=1)
    area = (dim - 1) * (dim - 1) * spacing * spacing
    append_tasks(path, [dict(
        flatten_area=area, initial_coverage=area / 2,
        task_difficulty="hard", cloth_size=np.asarray([dim, dim]),
        particle_pos=p4.reshape(-1), particle_vel=np.zeros(n_p * 3),
        phase=np.zeros(n_p), cloth_stiff=np.asarray([0.9, 1.0, 0.9]),
        cloth_mass=0.5)])


def replay_dir(workdir: str, rank: int) -> str:
    return os.path.join(workdir, f"replay_rank{rank}")


def dryrun(workdir: str, mesh=None, tasks: str | None = None,
           num_envs: int | None = None, env_kw: dict | None = None) -> dict:
    """One rank of the dry run in the current process group; every rank
    of `mesh` calls it with the same arguments and a workdir they share.
    Returns {"episodes": all ranks' episodes, "loss": the dp step's loss,
    "envs": this rank's env count}."""
    from flingbot_tpu_torch.env.batch_env import BatchSimEnv
    from flingbot_tpu_torch.env.tasks import TaskLoader
    from flingbot_tpu_torch.learning.dataset import GraspDataset
    from flingbot_tpu_torch.learning.nets import SpatialValueNet

    sharding = make_env_sharding(mesh)
    world, dev = sharding.world, sharding.device
    n_envs = num_envs or max(world, 4)
    kw = {**DRYRUN_ENV, **(env_kw or {})}
    if tasks is None:
        tasks = os.path.join(workdir, "tasks.npz")
        if sharding.rank == 0 and not os.path.exists(tasks):
            write_folded_task(tasks)
        dist.barrier(group=mesh)

    # collect: one round through the sharded env
    env = BatchSimEnv(
        get_task_fn=TaskLoader(tasks, repeat=True).get_next_task,
        num_envs=n_envs, replay_buffer_path=replay_dir(workdir,
                                                       sharding.rank),
        sharding=sharding, **kw)
    obs = env.reset()
    if env.num_envs * world != n_envs or env.state.device != dev:
        raise AssertionError("the env state is not split over the ranks")
    rng = np.random.default_rng(5)
    vm = rng.uniform(size=(n_envs, 1, obs.shape[1], kw["obs_dim"],
                           kw["obs_dim"])).astype(np.float32)
    env.step(torch.as_tensor(shard_batch(vm, mesh), device=dev))
    episodes = torch.tensor([env.episodes_done], device=dev)
    dist.all_reduce(episodes, group=mesh)
    if int(episodes) != n_envs:
        raise AssertionError(f"{int(episodes)} of {n_envs} episodes ended")
    dist.barrier(group=mesh)

    # replay -> the batch in env order (rank by rank) -> one dp step
    samples = []
    for r in range(world):
        ds = GraspDataset(replay_dir(workdir, r))
        samples += [ds[i] for i in range(len(ds))]
    if len(samples) < n_envs:
        raise AssertionError(f"{len(samples)} transitions in the replay")
    obs_l, mask_l, rew_l = zip(*samples[:n_envs])
    batch = (np.stack(obs_l), np.stack(mask_l).astype(np.float32),
             np.asarray(rew_l, np.float32))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = SpatialValueNet(rgb_only=True)
    net = replicate(net.to(dev).eval(), mesh)
    # optax.adamw(1e-3), the JAX dry run's optimizer (weight decay 1e-4)
    opt = torch.optim.AdamW(net.parameters(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    loss = make_dp_train_step(net, opt, mesh)(*shard_batch(batch, mesh))
    if not np.isfinite(loss):
        raise AssertionError(f"dp train loss {loss}")
    return {"episodes": int(episodes), "loss": loss, "envs": env.num_envs}


def _rank_main(rank: int, device: torch.device, workdir: str, num_envs,
               env_kw):
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 4))
    out = dryrun(workdir, make_mesh(), num_envs=num_envs, env_kw=env_kw)
    if rank == 0:
        with open(os.path.join(workdir, "result.json"), "w") as f:
            json.dump({**out, "device": str(device)}, f)


def dryrun_multichip(n_ranks: int, device="cuda", num_envs: int | None = None,
                     env_kw: dict | None = None) -> dict:
    """The dry run over n_ranks spawned processes, one per card (or gloo
    ranks with device="cpu"); returns rank 0's result and prints the JAX
    dry run's closing line."""
    with tempfile.TemporaryDirectory(prefix="dryrun_mc_") as workdir:
        spawn(_rank_main, n_ranks, device,
              args=(workdir, num_envs, env_kw))
        with open(os.path.join(workdir, "result.json")) as f:
            out = json.load(f)
    print(f"[dryrun_multichip] {n_ranks} ranks OK; collected "
          f"{out['episodes']} episodes through the sharded BatchSimEnv, dp "
          f"train loss={out['loss']:.4f}", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=1)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    return dryrun_multichip(a.ranks, a.device)


if __name__ == "__main__":
    main()
