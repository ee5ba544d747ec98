"""The value net of flingbot_tpu_torch held against flingbot_tpu's Flax
SpatialValueNet, with the weights carried across by
learning/convert.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flingbot_tpu.learning.nets import SpatialValueNet as FlaxNet
from flingbot_tpu.learning.nets import value_map_inference as jax_infer
from flingbot_tpu_torch.learning.convert import (
    flax_from_state_dict, state_dict_from_flax)
from flingbot_tpu_torch.learning.nets import (
    MaximumValuePolicy, SpatialValueNet, rotation_list)
import tests.test_torch_common  # noqa: F401  (CPU platform, 2 threads)


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flax_vars(seed, rgb_only):
    net = FlaxNet(rgb_only=rgb_only, num_blocks=3)
    v = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 16, 16)))
    # non-trivial running statistics, as after training
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.05, 0.3, a.shape).astype(
            np.float32), v["batch_stats"])
    return net, _to_numpy(v["params"]), stats


def test_value_maps_match_converted_flax_net():
    for rgb_only in (True, False):
        net, params, stats = _flax_vars(0, rgb_only)
        obs = np.random.default_rng(1).random((6, 4, 16, 16)).astype(
            np.float32)
        obs[:, 3] = 1.99 + 0.01 * obs[:, 3]  # depth near the floor
        ref = np.asarray(jax_infer(net, params, stats, jnp.asarray(obs)))
        tnet = SpatialValueNet(rgb_only=rgb_only, num_blocks=3)
        tnet.load_state_dict(state_dict_from_flax(params, stats))
        with torch.no_grad():
            out = tnet.eval()(torch.as_tensor(obs)).numpy()
        assert out.shape == ref.shape == (6, 16, 16)
        # 3 + 2 * 3 float32 convolutions summed in other orders
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_convert_round_trip():
    _, params, stats = _flax_vars(2, True)
    sd = state_dict_from_flax(params, stats)
    p2, s2 = flax_from_state_dict(sd)
    for a, b in zip(jax.tree_util.tree_leaves((params, stats)),
                    jax.tree_util.tree_leaves((p2, s2))):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jax.tree_util.tree_structure((params, stats)) == \
        jax.tree_util.tree_structure((p2, s2))


def test_policy_batch_value_maps_shapes_and_seed():
    kw = dict(action_primitives=["fling"], obs_dim=16, num_blocks=2,
              device="cpu")
    a = MaximumValuePolicy(seed=3, **kw)
    b = MaximumValuePolicy(seed=3, **kw)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    obs = torch.rand(2, 6, 4, 16, 16, generator=torch.Generator()
                     .manual_seed(0))
    va = a.batch_value_maps(obs, max_infer_batch=5)
    vb = b.batch_value_maps(obs)
    assert tuple(va.shape) == (2, 1, 6, 16, 16)
    np.testing.assert_allclose(va.numpy(), vb.numpy(), atol=1e-6)
    np.testing.assert_allclose(rotation_list(3), [-90.0, 0.0, 90.0])
