"""Data parallelism over torch.distributed: env-axis sharding and the
data-parallel value-net update (counterpart of
flingbot_tpu/parallel/mesh.py).

The JAX package runs one program over a device mesh: the env batch is
sharded over the mesh's `dp` axis (NamedSharding) and the value-net update
averages gradients with `pmean` inside shard_map.  PyTorch's idiom is one
process per device:

    device = init_distributed("tcp://localhost:29500", 4, rank)
    mesh = make_mesh()                        # the dp process group
    env = BatchSimEnv(..., num_envs=64, sharding=make_env_sharding(mesh))
    step = make_dp_train_step(net, optimizer, mesh)
    loss = step(*shard_batch((obs, mask, reward), mesh))

A rank owns the contiguous rows [r B / n, (r + 1) B / n) of a batch of B,
the layout of P("dp").  NCCL carries the collectives on the card, gloo on
the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.learning.train import masked_mse_loss

# the BatchNorm buffers that the dp step averages across ranks
BN_STATS = ("running_mean", "running_var")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> torch.device:
    """Join the process group once per process (init_distributed,
    mesh.py:95-105): NCCL on the card, gloo on the CPU.  The address
    (`tcp://host:port`, or `host:port`), world size and rank come from the
    arguments, or from MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK.
    Returns this rank's device: cuda:<local rank> (LOCAL_RANK, else the
    rank modulo the cards of the host), or the CPU."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        kwargs = {}
        if coordinator_address is not None:
            addr = coordinator_address
            if "://" not in addr:
                addr = "tcp://" + addr
            kwargs = dict(init_method=addr, world_size=num_processes,
                          rank=process_id)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", **kwargs)
    if dev.type == "cuda":
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return dev


def make_mesh(n_devices: Optional[int] = None):
    """The dp process group over the first n_devices ranks (all of them by
    default): the counterpart of Mesh(devices[:n], ("dp",)).  Every rank
    calls it."""
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"need {n} ranks, have {world}")
    if n == world:
        return dist.group.WORLD
    return dist.new_group(list(range(n)))


def _rank_world(mesh):
    return dist.get_rank(mesh), dist.get_world_size(mesh)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_rows(n_rows: int, rank: int, world: int) -> range:
    """The rows of a leading axis of n_rows that rank owns under P("dp")."""
    if n_rows % world:
        raise ValueError(f"a leading axis of {n_rows} does not split over "
                         f"{world} ranks")
    k = n_rows // world
    return range(rank * k, (rank + 1) * k)


def shard_batch(tree, mesh=None):
    """This rank's rows of every array or tensor of a leading-batch tree
    (dicts, lists, tuples); leaves without a batch axis pass unchanged
    (shard_batch, mesh.py:35-45)."""
    rank, world = _rank_world(mesh)

    def take(x):
        if getattr(x, "ndim", 0) >= 1:
            rows = shard_rows(x.shape[0], rank, world)
            return x[rows.start:rows.stop]
        return x

    return _tree_map(take, tree)


def replicate(tree, mesh=None):
    """Broadcast every tensor of a tree, or every parameter and buffer of a
    module, from the group's first rank, in place (replicate,
    mesh.py:48-52); returns the tree."""
    src = dist.get_global_rank(mesh or dist.group.WORLD, 0)
    tensors = []
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    else:
        _tree_map(lambda x: tensors.append(x) if torch.is_tensor(x)
                  else None, tree)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=mesh)
    return tree


@dataclasses.dataclass(frozen=True)
class EnvSharding:
    """This rank's share of an env batch: BatchSimEnv(sharding=...)
    simulates env slots env_range(num_envs) on `device`."""
    rank: int
    world: int
    device: torch.device

    def env_range(self, num_envs: int) -> range:
        return shard_rows(num_envs, self.rank, self.world)


def make_env_sharding(mesh=None) -> EnvSharding:
    """The env sharding of this rank (make_env_sharding, mesh.py:108-110):
    its rank and world in the dp group, and its device (the current card
    under NCCL, else the CPU)."""
    rank, world = _rank_world(mesh)
    if dist.get_backend(mesh) == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return EnvSharding(rank, world, device)


def _pmean_(tensors, mesh, world: int):
    """Average tensors across the group in place, through one all-reduce
    of their concatenation (gloo has no AVG, so SUM then divide, as
    pmean = psum / n)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh)
    flat /= world
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()


def make_dp_train_step(net, optimizer, mesh=None):
    """The data-parallel masked-MSE update (make_dp_train_step,
    mesh.py:53-92).  Returns step(obs, action_mask, reward) -> loss, run
    on every rank with its shard of the batch: the loss in train mode on
    the local shard (BatchNorm normalizes within the shard, as under
    shard_map), then the gradients, the loss and the BatchNorms' updated
    running statistics averaged across ranks (DDP's broadcast_buffers
    would copy rank 0's statistics instead), then the optimizer's step on
    every rank.  The net and optimizer are updated in place and start
    equal on every rank (replicate)."""
    params = list(net.parameters())
    stats = [b for name, b in net.named_buffers()
             if name.rsplit(".", 1)[-1] in BN_STATS]
    _, world = _rank_world(mesh)

    def step(obs, action_mask, reward) -> float:
        p0 = params[0]
        obs, action_mask, reward = (
            torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
            .to(device=p0.device, dtype=p0.dtype)
            for x in (obs, action_mask, reward))
        net.train()
        try:
            loss = masked_mse_loss(net, obs, action_mask, reward)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            mean_loss = loss.detach().reshape(1).clone()
            with torch.no_grad():
                _pmean_([p.grad for p in params] + stats + [mean_loss],
                        mesh, world)
            optimizer.step()
        finally:
            net.eval()
        return float(mean_loss)

    return step


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(rank, fn, world, address, device, args):
    dev = init_distributed(address, world, rank, device=device)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks: int, device="cuda", args=()):
    """Run fn(rank, device, *args) in n_ranks fresh processes, each joined
    to one process group over tcp://localhost (init_distributed), and wait
    for all of them; a rank that raises fails the call.  fn must be
    importable by name (a module-level function)."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_ranks:
        raise RuntimeError(f"{n_ranks} ranks need {n_ranks} cards, have "
                           f"{torch.cuda.device_count()}")
    address = f"tcp://localhost:{free_port()}"
    mp.start_processes(_spawned, args=(fn, n_ranks, address, dev.type, args),
                       nprocs=n_ranks, start_method="spawn")
