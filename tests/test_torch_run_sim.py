"""The port's training entry point, python -m flingbot_tpu_torch.run_sim,
on the CPU at a tiny size: rounds that collect, train and checkpoint; an
--eval round from that checkpoint; the policy's exploration; the flags it
refuses; eval_quality with a checkpoint and test-time averaging; the
bench.  One `cuda` test holds a train step on the card against the CPU.

The card test needs neither jax nor h5py: the task-file helpers are
imported inside the fixture."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from flingbot_tpu_torch import bench, eval_quality, run_sim
from flingbot_tpu_torch.learning.nets import MaximumValuePolicy
from flingbot_tpu_torch.learning.train import train_on_batch
from flingbot_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUND4 = os.path.join(ROOT, "runs", "round4", "latest_ckpt.npz")
# 2 envs of 10-12 particle edges, a short solver and small renders
SMALL = ["--device", "cpu", "--num_envs", "2", "--max_grid_dim", "12",
         "--render_dim", "64", "--num_rotations", "2", "--scale_factors",
         "1.0", "--substeps", "2", "--iterations", "2",
         "--contact_iterations", "1", "--contact_window", "4"]


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    """A 2-task file exported as eval_quality's CPU test makes one."""
    from tests.test_torch_common import write_grid_tasks
    from tools.export_tasks_npz import export

    d = tmp_path_factory.mktemp("tasks")
    h5 = write_grid_tasks(str(d / "tasks.hdf5"), ((12, 10), (11, 12)),
                          np.random.default_rng(0))
    export(h5, str(d / "tasks.npz"), limit=2)
    return str(d / "tasks.npz")


@pytest.fixture(scope="module")
def trained(tasks, tmp_path_factory):
    """2 rounds of episodes of 1 step, training from the first round."""
    log = str(tmp_path_factory.mktemp("run") / "log")
    policy, history = run_sim.main(
        SMALL + ["--tasks", tasks, "--log", log, "--episode_length", "1",
                 "--warmup", "0", "--batch_size", "2", "--dihedral_augment"],
        max_rounds=2)
    return log, policy, history


def test_run_sim_collects_trains_and_checkpoints(trained):
    log, policy, history = trained
    assert len(history) == 2
    sizes = [h["dataset_size"] for h in history]
    assert sizes == [2, 4]
    assert len(os.listdir(os.path.join(log, "replay_buffer"))) == 4
    assert all(h["optimize"] is not None for h in history)
    assert all(np.isfinite(h["losses"]["fling"]) for h in history)
    assert policy.steps() == 2
    with open(os.path.join(log, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    assert args["num_envs"] == 2 and args["dihedral_augment"]
    # round 0 is a multiple of --save_ckpt, as in the JAX loop
    assert os.path.exists(os.path.join(log, "ckpt_000001.pth"))
    fresh = MaximumValuePolicy(["fling"], 64, device="cpu")
    load_checkpoint(os.path.join(log, "latest_ckpt.pth"), fresh)
    assert fresh.steps() == 2


def test_run_sim_eval_round(tasks, trained):
    log, _, _ = trained
    ckpt = os.path.join(log, "latest_ckpt.pth")
    policy, history = run_sim.main(
        SMALL + ["--tasks", tasks, "--log", log, "--eval", "--load", ckpt,
                 "--episode_length", "1"], max_rounds=1)
    replay = os.path.join(log, "latest_ckpt_eval_0", "replay_buffer")
    assert sorted(os.listdir(replay)) == [
        "000000000_step00_last.npz", "000000001_step00_last.npz"]
    assert policy.steps() == 2 and policy.value_expl_prob == 0.0
    assert all(h["optimize"] is None for h in history)


def test_exploration():
    kw = dict(obs_dim=8, num_blocks=1, device="cpu")
    obs = torch.rand(3, 2, 4, 8, 8, generator=torch.Generator()
                     .manual_seed(0))
    greedy = MaximumValuePolicy(["fling"], **kw)
    maps = greedy.batch_value_maps(obs)
    net = greedy.nets["fling"].net.eval()
    with torch.no_grad():
        want = net(obs.reshape(6, 4, 8, 8)).reshape(3, 1, 2, 8, 8)
    assert torch.equal(maps, want)
    explore = MaximumValuePolicy(["fling", "drag"], value_expl_prob=1.0,
                                 value_expl_decay=0.5,
                                 action_expl_prob=1.0,
                                 action_expl_decay=0.25, **kw)
    u = explore.batch_value_maps(obs)
    assert u.shape == (3, 2, 2, 8, 8)
    # uniform maps in [0, 1), then every primitive but one at the minimum
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    flat = [bool((u[:, p] == u.min()).all()) for p in range(2)]
    assert sorted(flat) == [False, True]
    assert len(torch.unique(u[:, flat.index(False)])) > 100
    explore.decay_exploration()
    explore.decay_exploration()
    assert explore.value_expl_prob == 0.25
    assert explore.action_expl_prob == 0.0625


@pytest.mark.parametrize("flags", [
    ["--backend", "xla"], ["--contact_mode", "sweep"],
    ["--dump_visualizations"]])
def test_unported_flags_raise(flags):
    """--dump_visualizations is refused (ROADMAP Queue 1 item 7);
    --backend xla and --contact_mode sweep, refused until the xla backend
    was ported, now pass apply_presets and reach the env's solver
    keywords."""
    from flingbot_tpu_torch.utils.config import apply_presets, config_parser

    if flags == ["--dump_visualizations"]:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_sim.main(SMALL + ["--tasks", "unused.npz"] + flags)
        return
    args = apply_presets(config_parser().parse_args(
        SMALL + ["--tasks", "unused.npz"] + flags))
    assert getattr(args, flags[0][2:]) == flags[1]


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_sim.main(["--tasks", "unused.npz"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--num_envs", "1", "--dim", "8"])


def test_eval_quality_with_a_checkpoint_and_tta(tasks, capsys):
    """The committed round-4 checkpoint (exported from the JAX package)
    drives one eval step with test-time averaging."""
    eval_quality.main(SMALL + ["--tasks", tasks, "--policy", "ckpt",
                               "--load", ROUND4, "--tta", "--steps", "1"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["episodes"] == 2
    assert np.isfinite(last["best_coverage/hard/mean"])


def test_bench_prints_the_median_of_its_windows(capsys):
    rates = bench.main(["--device", "cpu", "--num_envs", "2", "--dim",
                        "12", "--steps", "1", "--windows", "5"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(rates) == 5 and len(lines) == 6
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["value"] == round(float(np.median(rates)), 1)
    assert "on CPU" in last["metric"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """One train step of the round-4 checkpoint at batch 16, obs 64, on
    the card and on the CPU.  cuDNN's convolutions and their backward sum
    in other orders than the CPU's (TF32 off), so the two agree only to
    float32 rounding that the backward pass amplifies: loss rtol 1e-4;
    per tensor |card - cpu| <= 1e-4 x max |cpu| for the weights and the
    running statistics, 1e-3 for the Adam moments (the round-4 Adam state
    is 662 steps old, so the step divides by a settled second moment, not
    by the new gradient's own size)."""
    rng = np.random.default_rng(0)
    obs = rng.uniform(0, 1, (16, 4, 64, 64)).astype(np.float32)
    obs[:, 3] = 1.99 + 0.01 * obs[:, 3]
    mask = np.zeros((16, 64, 64), np.float32)
    mask[np.arange(16), rng.integers(0, 64, 16), rng.integers(0, 64, 16)] = 1
    reward = rng.uniform(-0.2, 0.5, 16).astype(np.float32)
    pols = []
    for dev in (cuda_device, "cpu"):
        p = MaximumValuePolicy(["fling"], 64, lr=1e-3, device=dev)
        load_checkpoint(ROUND4, p)
        pols.append((p, train_on_batch(p.nets["fling"], obs, mask, reward)))
    (card, l_card), (cpu, l_cpu) = pols
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    a, b = card.nets["fling"], cpu.nets["fling"]
    for k, v in b.net.state_dict().items():
        if v.dtype.is_floating_point:
            err = float((a.net.state_dict()[k].cpu() - v).abs().max())
            assert err <= 1e-4 * float(v.abs().max()), (k, err)
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()[
        "state"]
    for i in sb:
        for k in ("exp_avg", "exp_avg_sq"):
            err = float((sa[i][k].cpu() - sb[i][k]).abs().max())
            assert err <= 1e-3 * float(sb[i][k].abs().max()), (i, k, err)
