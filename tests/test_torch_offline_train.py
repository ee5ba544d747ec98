"""The port's offline training (flingbot_tpu_torch.offline_train, the
counterpart of scripts/offline_train_r3.py) on a tiny replay directory:
the policy rebuilt from args.pkl, numbered checkpoints every save_every
batches, the weights those of calling optimize directly with the same
seed and fresh datasets per round (bit for bit), and a second run
resuming from latest_ckpt.pth."""

import os
import pickle

import numpy as np
import pytest
import torch

from flingbot_tpu_torch import offline_train
from flingbot_tpu_torch.learning.dataset import GraspDataset
from flingbot_tpu_torch.learning.memory import Memory
from flingbot_tpu_torch.learning.nets import MaximumValuePolicy
from flingbot_tpu_torch.learning.train import optimize
from flingbot_tpu_torch.utils.checkpoint import load_checkpoint
from flingbot_tpu_torch.utils.config import seed_all

torch.set_num_threads(2)
RUN_ARGS = dict(action_primitives=["fling"], obs_dim=16, num_blocks=2,
                lr=1e-3, seed=5, device="cuda")
FLAGS = ["--steps", "4", "--batch_size", "4", "--save_every", "2",
         "--seed", "3", "--device", "cpu"]


@pytest.fixture
def run_dir(tmp_path):
    """A run's log directory: args.pkl (as run_sim writes it, device
    included) and a replay directory of 3 episodes of 4 steps."""
    rng = np.random.default_rng(0)
    replay = tmp_path / "replay_buffer"
    for _ in range(3):
        mem = Memory()
        for t in range(4):
            obs = rng.uniform(0, 1, (4, 16, 16)).astype(np.float32)
            obs[3] = 1.99 + 0.01 * obs[3]
            action = np.zeros((16, 16), np.float32)
            action[rng.integers(16), rng.integers(16)] = 1
            mem.add_observation(obs)
            mem.add_action(action)
            mem.add_rewards_and_termination(0.0, t == 3)
            pre = float(rng.uniform(0.1, 0.2))
            mem.add_value("preaction_coverage", pre)
            mem.add_value("postaction_coverage",
                          pre + float(rng.uniform(-0.02, 0.05)))
            mem.add_value("max_coverage", 0.25)
            mem.add_value("action_primitive", "fling")
        mem.dump(str(replay))
    with open(tmp_path / "args.pkl", "wb") as f:
        pickle.dump(RUN_ARGS, f)
    return str(tmp_path)


def weights(policy):
    return {k: v.clone() for k, v in
            policy.nets["fling"].net.state_dict().items()}


def test_offline_train_matches_optimize(run_dir):
    policy = offline_train.main(["--log", run_dir] + FLAGS)
    assert sorted(f for f in os.listdir(run_dir) if f.endswith(".pth")) \
        == ["ckpt_000002.pth", "ckpt_000004.pth", "latest_ckpt.pth"]

    seed_all(3)
    ref = MaximumValuePolicy(**{**RUN_ARGS, "device": "cpu"})
    replay = os.path.join(run_dir, "replay_buffer")
    factory = lambda prim: GraspDataset(  # noqa: E731
        replay, filter_fn=lambda a: a.get("action_primitive") == prim)
    saved = []
    for _ in range(2):
        optimize(ref, factory, batch_size=4, batches_per_update=2)
        saved.append(weights(ref))
    assert ref.steps() == policy.steps() == 4
    for name, ckpt in ((0, "ckpt_000002.pth"), (1, "ckpt_000004.pth"),
                       (1, "latest_ckpt.pth")):
        back = MaximumValuePolicy(**{**RUN_ARGS, "device": "cpu"})
        load_checkpoint(os.path.join(run_dir, ckpt), back)
        for k, v in weights(back).items():
            assert torch.equal(v, saved[name][k]), (ckpt, k)
    for k, v in weights(policy).items():
        assert torch.equal(v, saved[1][k]), k
    assert not torch.equal(saved[0]["head.weight"], saved[1]["head.weight"])


def test_offline_train_resumes(run_dir):
    offline_train.main(["--log", run_dir] + FLAGS)
    policy = offline_train.main(["--log", run_dir, "--steps", "2"]
                                + FLAGS[2:])
    assert policy.steps() == 6
    assert os.path.exists(os.path.join(run_dir, "ckpt_000006.pth"))
