"""Offline value-net training on a finished replay record (counterpart of
scripts/offline_train_r3.py).

The optimize step (run_sim.py:16-34 of the reference) is plain supervised
regression on replay transitions; it runs interleaved with collection only
because collection is the bottleneck.  This runs EXTRA optimize rounds on
the final replay directory after collection stops (same loss, dataset
jitter and BatchNorm semantics), saving numbered checkpoints for the
learning curve.

    python -m flingbot_tpu_torch.offline_train --log runs/exp1 --steps 400 \
        --save_every 100

The policy is rebuilt from the run's `{log}/args.pkl` (run_sim writes it)
and resumed from `{log}/latest_ckpt.pth` when there is one; every
`--save_every` batches it writes `{log}/ckpt_{step:06d}.pth` and
`{log}/latest_ckpt.pth`.  As in the JAX script, each round of save_every
batches reads the replay through fresh datasets (default seed).  Runs on
the card; --device cpu runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import pickle

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.learning.dataset import GraspDataset
from flingbot_tpu_torch.learning.nets import MaximumValuePolicy
from flingbot_tpu_torch.learning.train import optimize
from flingbot_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint)
from flingbot_tpu_torch.utils.config import seed_all


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--log", default="runs/round3")
    p.add_argument("--steps", type=int, default=400,
                   help="optimizer steps (batches) to run")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--save_every", type=int, default=100)
    p.add_argument("--mirror_augment", action="store_true",
                   help="x-flip obs+action augmentation (GraspDataset)")
    p.add_argument("--dihedral_augment", action="store_true",
                   help="full D4 obs+action augmentation (GraspDataset)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> MaximumValuePolicy:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    seed_all(args.seed)

    replay = os.path.join(args.log, "replay_buffer")
    # rebuild the policy exactly as the training run did (args.pkl)
    with open(os.path.join(args.log, "args.pkl"), "rb") as f:
        run_args = pickle.load(f)
    policy = MaximumValuePolicy(**{**run_args, "device": device})
    ck = os.path.join(args.log, "latest_ckpt.pth")
    if os.path.exists(ck):
        load_checkpoint(ck, policy)
        print(f"resumed {ck} at step {policy.steps()}", flush=True)

    def dataset_factory(primitive):
        return GraspDataset(
            replay,
            filter_fn=lambda a: a.get("action_primitive") == primitive,
            mirror_augment=args.mirror_augment,
            dihedral_augment=args.dihedral_augment)

    done = 0
    while done < args.steps:
        n = min(args.save_every, args.steps - done)
        optimize(policy, dataset_factory, batch_size=args.batch_size,
                 batches_per_update=n)
        done += n
        step = policy.steps()
        save_checkpoint(os.path.join(args.log, f"ckpt_{step:06d}.pth"),
                        policy)
        save_checkpoint(ck, policy)
        print(f"[offline] {done}/{args.steps} batches (policy step {step})",
              flush=True)
    return policy


if __name__ == "__main__":
    main()
