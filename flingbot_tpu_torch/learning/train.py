"""Value-net optimization: the DQN-style masked-MSE update (counterpart of
flingbot_tpu/learning/train.py).

Predict a dense value map, select the executed pixel with the one-hot
action mask, and regress it to the normalized delta-coverage reward with
MSE and AdamW (run_sim.py:16-34 of the reference).  Gradients are
autograd over the convolutions, as the JAX package's are XLA autodiff.
"""

from __future__ import annotations

from typing import Dict

import torch

from flingbot_tpu_torch.learning.nets import MaximumValuePolicy, NetState


def masked_mse_loss(net, obs, action_mask, reward) -> torch.Tensor:
    """Mean squared error of the value at each sample's action pixel; the
    net's BatchNorms run in whatever mode the net is in."""
    pred = (net(obs) * action_mask).sum((1, 2))
    return ((pred - reward) ** 2).mean()


def train_on_batch(ns: NetState, obs, action_mask, reward) -> float:
    """One AdamW step of one net on one batch, BatchNorm in train mode
    (its running statistics updated); returns the loss.  The batch is
    moved to the net's device and dtype."""
    p = next(ns.net.parameters())
    obs, action_mask, reward = (
        torch.as_tensor(x).to(device=p.device, dtype=p.dtype)
        for x in (obs, action_mask, reward))
    ns.net.train()
    try:
        loss = masked_mse_loss(ns.net, obs, action_mask, reward)
        ns.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ns.optimizer.step()
    finally:
        ns.net.eval()
    ns.steps += 1
    return float(loss.detach())


def optimize(policy: MaximumValuePolicy, dataset_factory,
             batch_size: int = 128, batches_per_update: int = 1,
             writer=None) -> Dict[str, float]:
    """optimize() (train.py:57-87): batches_per_update steps of each
    primitive's net, each on a batch of that primitive's transitions; a
    primitive whose dataset holds fewer than batch_size transitions is
    skipped.  Returns each primitive's last loss."""
    losses = {}
    for key, ns in policy.nets.items():
        ds = dataset_factory(key)
        if ds is None or len(ds) < batch_size:
            continue
        for _ in range(batches_per_update):
            batch = ds.sample_batch(batch_size)
            if batch is None:
                break
            loss = train_on_batch(ns, *batch)
            losses[key] = loss
            if writer is not None:
                writer.add_scalar(f"loss/{key}", loss, global_step=ns.steps)
    return losses
