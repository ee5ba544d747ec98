"""The port's data parallelism (flingbot_tpu_torch.parallel) held against
flingbot_tpu.parallel: a 2-rank gloo dp step against make_dp_train_step
on a 2-device mesh of conftest's virtual CPU devices, the P("dp") row
layout of shard_batch and make_env_sharding, the reset of a sharded
BatchSimEnv against the unsharded env's slots (the dry run at 2 ranks is
tests/test_torch_dryrun.py).

The dp step runs in float64 on both sides.  The loss holds within rtol
1e-5 (it agrees to ~1e-15), the BatchNorm statistics within 1e-10 of the
largest element of each tensor (tests/test_torch_train.py's float64
bound), and the averaged gradients the step applied within 1e-12 of it
(measured ~5e-15 against the mean of JAX's per-shard gradients).  The
updated parameters hold within 1e-12 of optax.adamw(1e-3) applied to
those gradients, and within atol 1e-6 (1e-3 of the learning rate) of
JAX's dp step: Adam's first step moves a weight by lr g / (|g| + eps),
whose slope in g is up to 1 / eps, so where the two shards' gradients
cancel to near eps the last places in which JAX's compiled step sums
them move a weight by up to ~4e-7 (measured).  The ranks run
tests/torch_parallel_ranks.py, which imports no JAX."""

import numpy as np
import pytest
import torch

from flingbot_tpu_torch.env.batch_env import BatchSimEnv, ShardTasks
from flingbot_tpu_torch.env.tasks import TaskLoader
from flingbot_tpu_torch.learning.convert import (
    flatten, flax_from_state_dict, state_dict_from_flax)
from flingbot_tpu_torch.parallel import mesh
from tests import torch_parallel_ranks
from tests.test_torch_common import write_grid_tasks

import jax  # noqa: E402  (after test_torch_common: the CPU platform)
import optax  # noqa: E402
from flingbot_tpu.learning.nets import SpatialValueNet as JaxNet  # noqa
from flingbot_tpu.learning.train import masked_mse_loss  # noqa: E402
from flingbot_tpu.parallel import mesh as jax_mesh  # noqa: E402
from tools.export_tasks_npz import export  # noqa: E402

RANKS, BATCH = 2, 8
BLOCKS = 2  # residual blocks of the net (8 in production)
# x max |value| per tensor
TOL = {"grads": 1e-12, "batch_stats": 1e-10}
PARAMS_ATOL = 1e-6  # against JAX's dp step


def batch():
    """obs, mask and reward shaped as tests/test_parallel.py's, seeded."""
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((BATCH, 4, 16, 16))
    mask = np.zeros((BATCH, 16, 16))
    mask[:, 5, 5] = 1.0
    return obs, mask, np.linspace(0, 1, BATCH)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    obs, mask, reward = batch()
    with jax.enable_x64(True):
        net = JaxNet(rgb_only=True, num_blocks=BLOCKS)
        variables = net.init(jax.random.PRNGKey(0), obs[:1], train=False)
        f64 = lambda tr: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jax.numpy.asarray(a, jax.numpy.float64), tr)
        params, stats = f64(variables["params"]), f64(
            variables["batch_stats"])
    state, out = d / "start.pt", d / "out.pt"
    torch.save(state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, params), jax.tree_util.tree_map(np.asarray, stats)),
        state)
    mesh.spawn(torch_parallel_ranks.dp_step, RANKS, "cpu",
               args=(str(state), "float64", BLOCKS, (obs, mask, reward),
                     str(out)))
    with jax.enable_x64(True):
        tx = optax.adamw(1e-3)
        m = jax_mesh.make_mesh(RANKS)
        step = jax_mesh.make_dp_train_step(net, tx, m)
        jp, js, _, jloss = step(
            jax_mesh.replicate(params, m), jax_mesh.replicate(stats, m),
            jax_mesh.replicate(tx.init(params), m),
            *(jax_mesh.shard_batch(x, m) for x in (obs, mask, reward)))
        layout = {
            "rows": [s.index[0] for s in sorted(
                jax_mesh.shard_batch(np.arange(BATCH),
                                     m).addressable_shards,
                key=lambda s: s.device.id)],
            "envs": [v[0] for k, v in sorted(
                jax_mesh.make_env_sharding(m).devices_indices_map(
                    (8,)).items(), key=lambda kv: kv[0].id)]}
        # the averaged gradient pmean hands the optimizer
        grad = jax.grad(lambda p, o, mk, r: masked_mse_loss(
            net, p, stats, o, mk, r)[0])
        shards = [grad(params, *(x[k * 4:k * 4 + 4]
                                 for x in (obs, mask, reward)))
                  for k in range(RANKS)]
        jgrads = jax.tree_util.tree_map(
            lambda *g: np.asarray(sum(g) / RANKS), *shards)
        ref = {"loss": float(jloss), "grads": flatten(jgrads),
               "adamw": lambda g: flatten(jax.tree_util.tree_map(
                   np.asarray, optax.apply_updates(
                       params, tx.update(g, tx.init(params),
                                         params)[0]))),
               "params": flatten(jax.tree_util.tree_map(np.asarray,
                                                        jp)),
               "batch_stats": flatten(jax.tree_util.tree_map(
                   np.asarray, js))}
    return ref, layout, torch.load(out, weights_only=False)


def test_dp_step_matches_jax(dp_run):
    ref, _, got = dp_run
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    params, stats = flax_from_state_dict(got["state"])
    grads, _ = flax_from_state_dict({**got["state"], **got["grads"]})
    for what, tree in (("grads", grads), ("batch_stats", stats)):
        worst = max(float(np.abs(v - ref[what][k]).max()
                          / np.abs(ref[what][k]).max())
                    for k, v in flatten(tree).items())
        print(f"{what}: worst |port - jax| / max |jax| {worst:.3e}")
        assert worst <= TOL[what], what
    params = flatten(params)
    worst = max(float(np.abs(v - ref["params"][k]).max())
                for k, v in params.items())
    print(f"params: worst |port - jax| {worst:.3e}")
    assert worst <= PARAMS_ATOL
    # the optimizer's step itself: optax.adamw on the port's gradients
    with jax.enable_x64(True):
        want = ref["adamw"](jax.tree_util.tree_map(
            jax.numpy.asarray, grads))
    for k, v in params.items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-12,
                                   err_msg=k)


def test_dp_layout_matches_p_dp(dp_run):
    _, layout, got = dp_run
    for r, mine in enumerate(got["layout"]):
        want_rows = layout["rows"][r]
        assert mine["rows"].tolist() == list(range(BATCH))[want_rows]
        assert mine["envs"] == range(8)[layout["envs"][r]]
        assert mine["device"] == "cpu"
    assert mesh.shard_rows(8, 1, RANKS) == range(4, 8)
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_rows(7, 0, RANKS)


@pytest.fixture(scope="module")
def grid_tasks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tasks")
    h5 = write_grid_tasks(str(d / "tasks.hdf5"),
                          ((16, 16), (14, 12), (12, 15), (15, 14), (13, 13)),
                          np.random.default_rng(0))
    npz = str(d / "tasks.npz")
    export(h5, npz)
    return npz


def test_sharded_reset_matches_unsharded_slots(grid_tasks):
    kw = dict(num_envs=4, obs_dim=32, num_rotations=4, scale_factors=(1.0,),
              render_dim=64, max_grid_dim=16, iterations=4,
              contact_iterations=2, contact_window=4, device="cpu")
    whole = BatchSimEnv(get_task_fn=TaskLoader(grid_tasks).get_next_task,
                        **kw)
    obs = whole.reset()
    for r in range(RANKS):
        part = BatchSimEnv(
            get_task_fn=TaskLoader(grid_tasks).get_next_task,
            sharding=mesh.EnvSharding(r, RANKS, torch.device("cpu")), **kw)
        got = part.reset()
        rows = slice(2 * r, 2 * r + 2)
        assert part.num_envs == 2
        assert [t.name for t in part.tasks] == [
            t.name for t in whole.tasks[rows]]
        np.testing.assert_array_equal(part.init_coverage.numpy(),
                                      whole.init_coverage[rows].numpy())
        np.testing.assert_array_equal(part.state.positions.numpy(),
                                      whole.state.positions[rows].numpy())
        for a, b in zip(part.palette, whole.palette):
            np.testing.assert_array_equal(a.numpy(), b[rows].numpy())
        np.testing.assert_array_equal(got.numpy(), obs[rows].numpy())


def test_shard_tasks_follow_the_unsharded_order():
    names = iter(range(100))
    take = ShardTasks(lambda: next(names), range(2, 4), 4)
    # reset: slots 2, 3 of positions 0-3; a reload of all slots: 6, 7
    assert [take(), take(), take(), take()] == [2, 3, 6, 7]
