"""The functions the ranks of tests/test_torch_parallel.py run, in a module
that imports neither JAX nor the JAX package, so that each spawned rank
starts in seconds.  Not a test module: pytest collects nothing here."""

import torch
import torch.distributed as dist

from flingbot_tpu_torch.learning.nets import OBS_MEAN, OBS_STD, SpatialValueNet
from flingbot_tpu_torch.parallel.mesh import (
    make_dp_train_step, make_env_sharding, make_mesh, replicate, shard_batch)


def dp_step(rank, device, state_path, dtype, num_blocks, batch, out_path):
    """One dp step of an rgb-only SpatialValueNet loaded from state_path,
    in dtype (the normalization constants set in dtype too), with
    optax.adamw(1e-3)'s settings; rank 0 saves the loss, the net's state,
    the averaged gradients the step applied, and each rank's rows of the
    batch and env range."""
    torch.set_num_threads(2)
    dt = getattr(torch, dtype)
    net = SpatialValueNet(rgb_only=True, num_blocks=num_blocks).to(dt)
    net.mean.copy_(torch.tensor(OBS_MEAN[:3], dtype=dt).view(1, -1, 1, 1))
    net.std.copy_(torch.tensor(OBS_STD[:3], dtype=dt).view(1, -1, 1, 1))
    if rank == 0:
        net.load_state_dict(torch.load(state_path, weights_only=True))
    mesh = make_mesh()
    replicate(net, mesh)  # the other ranks take rank 0's weights
    opt = torch.optim.AdamW(net.parameters(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    loss = make_dp_train_step(net, opt, mesh)(*shard_batch(batch, mesh))
    sharding = make_env_sharding(mesh)
    mine = {"rows": shard_batch(torch.arange(len(batch[0])), mesh),
            "envs": sharding.env_range(8), "device": str(sharding.device)}
    layout = [None] * dist.get_world_size()
    dist.all_gather_object(layout, mine)
    if rank == 0:
        torch.save({"loss": loss, "state": net.state_dict(),
                    "grads": {n: p.grad for n, p in net.named_parameters()},
                    "layout": layout}, out_path)
