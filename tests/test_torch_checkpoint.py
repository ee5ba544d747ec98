"""Checkpoints across the two packages: a JAX checkpoint exported by
tools/export_ckpt_npz.py and loaded by the port gives the JAX policy's
value maps (with and without test-time averaging) and continues training
where the JAX policy does; the port's own checkpoints round-trip bit for
bit; the committed runs/round4/latest_ckpt.npz is the export of
runs/round4/latest_ckpt.pth."""

import os
import pickle

import numpy as np
import pytest
import torch

from flingbot_tpu.learning.nets import MaximumValuePolicy as JaxPolicy
from flingbot_tpu.learning.train import train_on_batch as jax_train
from flingbot_tpu.utils.checkpoint import save_checkpoint as jax_save
from flingbot_tpu_torch.learning.nets import MaximumValuePolicy
from flingbot_tpu_torch.learning.train import train_on_batch
from flingbot_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint, setup_eval_dir)
from tests.test_torch_train import (
    TOL, batches, compare, jax_flat, port_flat)
from tools.export_ckpt_npz import export

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUND4 = os.path.join(ROOT, "runs", "round4", "latest_ckpt")
D = 32


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX policy (full net, obs 32) trained 2 steps, so that its
    BatchNorm statistics and Adam state are not the initial ones, saved
    by the JAX save_checkpoint and exported; returns (policy, npz path,
    pth path)."""
    d = tmp_path_factory.mktemp("ckpt")
    pol = JaxPolicy(["fling"], 12, [1.0], D, lr=1e-3, seed=2,
                    value_expl_prob=0.25)
    for b in batches(np.random.default_rng(1), 2, D, "float32"):
        jax_train(pol.nets["fling"], *b)
    pth, npz = str(d / "jax.pth"), str(d / "jax.npz")
    jax_save(pth, pol)
    export(pth, npz)
    return pol, npz, pth


def obs_batch(seed=0, B=2, T=3):
    obs = np.random.default_rng(seed).uniform(0, 1, (B, T, 4, D, D))
    obs[:, :, 3] = 1.99 + 0.01 * obs[:, :, 3]
    return obs.astype(np.float32)


@pytest.mark.parametrize("tta", [False, True])
def test_exported_jax_checkpoint_gives_its_value_maps(jax_ckpt, tta):
    jpol, npz, _ = jax_ckpt
    jpol.tta, jpol.value_expl_prob = tta, 0.0
    obs = obs_batch()
    want = np.asarray(jpol.batch_value_maps(obs))
    pol = MaximumValuePolicy(["fling"], D, tta=tta, device="cpu")
    load_checkpoint(npz, pol)
    assert pol.steps() == 2 and pol.value_expl_prob == 0.25
    pol.value_expl_prob = 0.0
    got = pol.batch_value_maps(torch.from_numpy(obs)).numpy()
    assert got.shape == want.shape == (2, 1, 3, D, D)
    # 17 float32 convolutions summed in other orders (tests/test_torch_nets)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_training_continues_from_an_exported_checkpoint(jax_ckpt):
    """One more step on both sides after loading: equal within the float32
    tolerances of tests/test_torch_train.py, and the Adam count came
    across (a count of 0 would change the bias correction, 1 - 0.9^3
    against 1 - 0.9, far outside them)."""
    jpol, npz, pth = jax_ckpt
    with open(pth, "rb") as f:  # the JAX side, reloaded from its file
        jpol.load_state_dict(pickle.load(f)["policy"])
    pol = MaximumValuePolicy(["fling"], D, lr=1e-3, device="cpu")
    load_checkpoint(npz, pol)
    b = batches(np.random.default_rng(9), 1, D, "float32")[0]
    lj = jax_train(jpol.nets["fling"], *b)
    lp = train_on_batch(pol.nets["fling"], *b)
    assert abs(lp - lj) <= TOL["float32"]["loss"] * abs(lj)
    got = port_flat(pol.nets["fling"])
    assert got[1] == 3
    compare(jax_flat(jpol), got, TOL["float32"], "after loading")


def test_port_checkpoint_round_trip(tmp_path):
    pol = MaximumValuePolicy(["fling"], 16, lr=1e-3, action_expl_prob=0.5,
                             device="cpu")
    for b in batches(np.random.default_rng(2), 2, 16, "float32"):
        train_on_batch(pol.nets["fling"], *b)
    path = str(tmp_path / "latest_ckpt.pth")
    save_checkpoint(path, pol)
    assert not os.path.exists(path + ".tmp")
    fresh = MaximumValuePolicy(["fling"], 16, seed=7, device="cpu")
    load_checkpoint(path, fresh)
    assert fresh.steps() == 2 and fresh.action_expl_prob == 0.5
    a, b = pol.nets["fling"], fresh.nets["fling"]
    for (ka, va), (kb, vb) in zip(a.net.state_dict().items(),
                                  b.net.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    obs = torch.from_numpy(obs_batch()[:, :, :, :16, :16].copy())
    assert torch.equal(pol.batch_value_maps(obs),
                       fresh.batch_value_maps(obs))
    log = setup_eval_dir(path)
    assert log.endswith("latest_ckpt_eval_0/") and os.path.isdir(log)
    assert setup_eval_dir(path).endswith("latest_ckpt_eval_1/")


def test_committed_round4_export_is_current(tmp_path):
    fresh = export(ROUND4 + ".pth", str(tmp_path / "r4.npz"))
    with np.load(ROUND4 + ".npz") as z:
        assert sorted(z.files) == sorted(fresh)
        for k in z.files:
            assert z[k].dtype == fresh[k].dtype, k
            np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)
    assert int(fresh["nets/fling/steps"]) == 662
    assert int(fresh["nets/fling/count"]) == 662
    pol = MaximumValuePolicy(["fling"], 64, device="cpu")
    load_checkpoint(ROUND4 + ".npz", pol)
    assert pol.steps() == 662


def test_loading_a_jax_pickle_names_the_exporter():
    pol = MaximumValuePolicy(["fling"], 64, device="cpu")
    with pytest.raises(ValueError, match="tools/export_ckpt_npz.py"):
        load_checkpoint(ROUND4 + ".pth", pol)
