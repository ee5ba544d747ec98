"""The port's training path held against flingbot_tpu's: train_on_batch
from a carried-across NetState (weights, BatchNorm statistics, Adam
state), GraspDataset batches over the same records, and optimize()
rounds over them.

Tolerances.  In float64 the two sides agree to ~1e-13 (the same
arithmetic in other summation orders): the port's BatchNorm updates its
running variance with the biased batch variance, as Flax does, and
torch's AdamW equals optax.adamw.  In float32 each side rounds its
convolutions and reductions in its own order, and Adam divides each
gradient by its own size, so a small gradient whose rounding differs
moves its weight by up to 2 x lr: float32 is held to JAX per tensor at
1e-2 of the tensor's largest element (the moments and weights; 3e-5 for
the loss and the running statistics), and to the port's own float64 run
at 1e-3."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flingbot_tpu.learning.dataset import GraspDataset as JaxDataset
from flingbot_tpu.learning.memory import Memory as JaxMemory
from flingbot_tpu.learning.nets import MaximumValuePolicy as JaxPolicy
from flingbot_tpu.learning.train import optimize as jax_optimize
from flingbot_tpu.learning.train import train_on_batch as jax_train
from flingbot_tpu_torch.learning.convert import (
    flatten, flax_from_state_dict, flax_moments, policy_state_from_flat)
from flingbot_tpu_torch.learning.dataset import GraspDataset
from flingbot_tpu_torch.learning.memory import Memory
from flingbot_tpu_torch.learning.nets import (
    OBS_MEAN, OBS_STD, MaximumValuePolicy)
from flingbot_tpu_torch.learning.train import optimize, train_on_batch
from tests.test_torch_common import t  # noqa: F401  (CPU, 2 threads)
from tools.export_ckpt_npz import flatten_policy

GROUPS = ("params", "batch_stats", "mu", "nu")
# |port - jax| <= TOL x max |jax| per tensor (loss: relative)
TOL = {
    "float64": {"loss": 1e-12, "params": 1e-10, "batch_stats": 1e-10,
                "mu": 1e-10, "nu": 1e-10},
    "float32": {"loss": 3e-5, "params": 1e-2, "batch_stats": 3e-5,
                "mu": 1e-2, "nu": 1e-2},
}
# the port in float32 against the port in float64, same measure
TOL_F32_VS_F64 = {"params": 1e-3, "batch_stats": 1e-5, "mu": 1e-3,
                  "nu": 1e-3}


def jax_policy(obs_dim, dtype, seed=0):
    """A JAX policy (full 8-block net) whose NetState holds `dtype`
    arrays; call under jax.enable_x64 for float64."""
    pol = JaxPolicy(["fling"], 12, [1.0], obs_dim, lr=1e-3,
                    weight_decay=1e-6, seed=seed)
    ns = pol.nets["fling"]
    cast = lambda tr: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, dtype), tr)
    ns.params, ns.batch_stats = cast(ns.params), cast(ns.batch_stats)
    ns.opt_state = ns.tx.init(ns.params)
    return pol


def jax_flat(pol):
    """The JAX policy's state as an exported checkpoint's flat arrays."""
    nets = {k: dict(jax.tree_util.tree_map(np.asarray, ns.state_dict()),
                    opt_state=ns.opt_state) for k, ns in pol.nets.items()}
    return flatten_policy({"nets": nets, "action_expl_prob": 0.0,
                           "value_expl_prob": 0.0})


def port_policy(flat, obs_dim, dtype):
    """The port's policy with the exported state loaded, in dtype (the
    normalization constants set in dtype too)."""
    pol = MaximumValuePolicy(["fling"], obs_dim, lr=1e-3, weight_decay=1e-6,
                             device="cpu")
    for ns in pol.nets.values():
        net = ns.net.to(dtype)
        net.mean.copy_(torch.tensor(OBS_MEAN[:3], dtype=dtype).view(1, -1,
                                                                     1, 1))
        net.std.copy_(torch.tensor(OBS_STD[:3], dtype=dtype).view(1, -1, 1,
                                                                  1))
    pol.load_state_dict(policy_state_from_flat(flat))
    return pol


def port_flat(ns):
    """A port NetState in the exported layout's groups."""
    params, stats = flax_from_state_dict(ns.net.state_dict())
    mu, nu, count = flax_moments(ns.optimizer.state_dict(), 8)
    return {"params": flatten(params), "batch_stats": flatten(stats),
            "mu": mu, "nu": nu}, count


def compare(jflat, port, tol, what):
    """Each group of the port's state (port_flat) against the JAX flat
    state: |port - jax| <= tol[group] x max |jax| per tensor; prints the
    worst element of each group."""
    got, count = port
    assert count == int(jflat["nets/fling/count"])
    for g in GROUPS:
        worst = (0.0, "")
        for k, v in got[g].items():
            ref = np.asarray(jflat[f"nets/fling/{g}/{k}"], np.float64)
            err = np.abs(v - ref).max() / max(np.abs(ref).max(), 1e-30)
            worst = max(worst, (float(err), k))
        print(f"{what} {g}: worst |port - jax| / max |jax| {worst[0]:.3e} "
              f"in {worst[1]} (tolerance {tol[g]:.0e})")
        assert worst[0] <= tol[g], (what, g, worst)


def batches(rng, n, obs_dim, dtype):
    out = []
    for _ in range(n):
        obs = rng.uniform(0, 1, (4, 4, obs_dim, obs_dim))
        obs[:, 3] = 1.99 + 0.01 * obs[:, 3]
        mask = np.zeros((4, obs_dim, obs_dim))
        mask[np.arange(4), rng.integers(0, obs_dim, 4),
             rng.integers(0, obs_dim, 4)] = 1
        out.append(tuple(a.astype(dtype) for a in (
            obs, mask, rng.uniform(-0.2, 0.5, 4))))
    return out


def train_both(dtype, obs_dim=32, port_dtype=None):
    """3 train steps from one carried-across state on both sides (the JAX
    side in dtype, the port in port_dtype, default dtype), on the same
    seeded batches; returns per step (jax loss, port loss, jax flat
    state, the port's state in the same groups)."""
    jpol = jax_policy(obs_dim, dtype)
    ppol = port_policy(jax_flat(jpol), obs_dim,
                       getattr(torch, port_dtype or dtype))
    jns, pns = jpol.nets["fling"], ppol.nets["fling"]
    out = []
    for b in batches(np.random.default_rng(0), 3, obs_dim, "float32"):
        b = tuple(a.astype(dtype) for a in b)
        lj = jax_train(jns, *b)
        lp = train_on_batch(pns, *b)
        out.append((lj, lp, jax_flat(jpol), port_flat(pns)))
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_train_steps_match_jax(dtype):
    """B=4, obs 32, the full 8-block net, 3 steps: the loss, BatchNorm
    running statistics, weights and Adam moments after every step."""
    tol = TOL[dtype]
    n = 4 * 32 * 32  # BatchNorm samples per channel
    with jax.enable_x64(dtype == "float64"):
        runs = train_both(dtype)
    for s, (lj, lp, jflat, got) in enumerate(runs):
        print(f"step {s}: loss jax {lj!r} port {lp!r}")
        assert abs(lp - lj) <= tol["loss"] * abs(lj)
        compare(jflat, got, tol, f"{dtype} step {s}")
    if dtype == "float64":
        # the running statistics element by element too
        for _, _, jflat, got in runs:
            for k, v in got[0]["batch_stats"].items():
                np.testing.assert_allclose(
                    v, jflat[f"nets/fling/batch_stats/{k}"], rtol=1e-9,
                    atol=0, err_msg=k)
        # torch's own BatchNorm2d updates the running variance with
        # n / (n - 1) times the batch variance: after the first step that
        # misses the batch_stats tolerance by orders of magnitude
        rv1 = runs[0][2]["nets/fling/batch_stats/BatchNorm_0/var"]
        batch_var = (rv1 - 0.99) / 0.01  # the running variance starts at 1
        unbiased = 0.99 + 0.01 * batch_var * n / (n - 1)
        assert np.abs(unbiased - rv1).max() > 1e3 * tol[
            "batch_stats"] * np.abs(rv1).max()
    else:
        # the port's float32 steps against its float64 steps on the same
        # (float32) batches
        with jax.enable_x64(True):
            truth = train_both("float64", port_dtype="float64")
        for s, ((_, _, _, got), (_, _, _, ref)) in enumerate(zip(runs,
                                                                truth)):
            for g in GROUPS:
                err = max(np.abs(got[0][g][k] - v).max() / np.abs(v).max()
                          for k, v in ref[0][g].items())
                print(f"float32 step {s} {g}: |port32 - port64| / max "
                      f"{err:.3e} (tolerance {TOL_F32_VS_F64[g]:.0e})")
                assert err <= TOL_F32_VS_F64[g]


# ---------------------------------------------------------------------------
# replay records written through both Memory classes


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """10 episodes of 3 steps (one of them 'drag'), obs 16, written from
    the same values into a JAX HDF5 record and a port replay directory."""
    d = tmp_path_factory.mktemp("records")
    h5, rdir = str(d / "replay.hdf5"), str(d / "replay")
    rng = np.random.default_rng(0)
    for ep in range(10):
        mems = (JaxMemory(), Memory())
        for step in range(3):
            obs = rng.uniform(0, 1, (4, 16, 16)).astype(np.float32)
            obs[3] = 1.99 + 0.005 * obs[3]
            mask = np.zeros((16, 16), np.float32)
            mask[rng.integers(16), rng.integers(16)] = 1
            vals = dict(preaction_coverage=float(rng.uniform(0.05, 0.2)),
                        postaction_coverage=float(rng.uniform(0.05, 0.3)),
                        max_coverage=float(rng.uniform(0.25, 0.4)),
                        action_primitive="drag" if ep == 3 else "fling",
                        task_difficulty="hard", init_coverage=0.08)
            for m in mems:
                m.add_observation(obs)
                m.add_action(mask)
                for k, v in vals.items():
                    m.add_value(k, v)
                m.add_rewards_and_termination(0.05, step == 2)
        mems[0].dump(h5)
        mems[1].dump(rdir)
    return h5, rdir


@pytest.mark.parametrize("kw", [
    dict(rgb_only=True, obs_color_jitter=True, dihedral_augment=True),
    dict(rgb_only=True, obs_color_jitter=True, mirror_augment=True,
         use_normalized_coverage=False)])
def test_dataset_batches_equal_jax(records, kw):
    """Same records, same seed: bit-equal batches, with color jitter and
    dihedral (or mirror) augmentation on, and the same primitive filter."""
    h5, rdir = records
    jds = JaxDataset(h5, seed=3, filter_fn=lambda g:
                     g.attrs.get("action_primitive") == "fling", **kw)
    pds = GraspDataset(rdir, seed=3, filter_fn=lambda a:
                       a.get("action_primitive") == "fling", **kw)
    assert pds.keys == jds.keys and len(pds) == 27
    for _ in range(3):
        for a, b in zip(jds.sample_batch(8), pds.sample_batch(8)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_dataset_refresh_and_validity(tmp_path):
    """refresh() appends only new steps; check_validity deletes a step
    file without observations or with a mask that is not one-hot."""
    rdir = str(tmp_path / "replay")
    rng = np.random.default_rng(1)

    def episode(valid=True):
        m = Memory()
        m.add_observation(rng.uniform(0, 1, (4, 8, 8)).astype(np.float32))
        mask = np.zeros((8, 8), np.float32)
        mask[1, 2] = 1.0 if valid else 0.5
        m.add_action(mask)
        m.add_value("preaction_coverage", 0.1)
        m.add_value("postaction_coverage", 0.2)
        m.add_value("max_coverage", 0.3)
        m.add_rewards_and_termination(0.1, True)
        return m.dump(rdir)

    episode()
    ds = GraspDataset(rdir)
    assert len(ds) == 1
    episode(valid=False)
    np.savez(os.path.join(rdir, "000000009_step00_last.npz"),
             actions=np.zeros((8, 8)))
    assert ds.refresh() == 2 and len(ds) == 3
    ds = GraspDataset(rdir, check_validity=True)
    assert ds.keys == ["000000000_step00_last"]
    assert sorted(os.listdir(rdir)) == ["000000000_step00_last.npz"]


def test_optimize_rounds_match_jax(records):
    """Two optimize() rounds (2 batches of 4 each) over the records, from
    one carried-across policy, in float64: the same losses, weights,
    statistics and Adam moments (the float64 tolerances above)."""
    h5, rdir = records
    kw = dict(rgb_only=True, obs_color_jitter=True, dihedral_augment=True,
              seed=5)
    jds = JaxDataset(h5, filter_fn=lambda g:
                     g.attrs.get("action_primitive") == "fling", **kw)
    pds = GraspDataset(rdir, filter_fn=lambda a:
                       a.get("action_primitive") == "fling", **kw)
    with jax.enable_x64(True):
        jpol = jax_policy(16, "float64", seed=1)
        ppol = port_policy(jax_flat(jpol), 16, torch.float64)
        for r in range(2):
            lj = jax_optimize(jpol, lambda _: jds, batch_size=4,
                              batches_per_update=2)
            lp = optimize(ppol, lambda _: pds, batch_size=4,
                          batches_per_update=2)
            assert lj.keys() == lp.keys() == {"fling"}
            np.testing.assert_allclose(lp["fling"], lj["fling"],
                                       rtol=TOL["float64"]["loss"])
            compare(jax_flat(jpol), port_flat(ppol.nets["fling"]),
                    TOL["float64"], f"optimize round {r}")
        assert ppol.steps() == jpol.steps() == 4
