"""The fling program of flingbot_tpu_torch held against flingbot_tpu's
program builder, instruction by instruction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flingbot_tpu.env.primitives import PrimitiveConfig as JCfg
from flingbot_tpu.env.primitives import build_selected_program as jax_build
from flingbot_tpu_torch.env.primitives import (
    PrimitiveConfig, append_stabilize, build_fling_program)
import tests.test_torch_common  # noqa: F401  (CPU platform, 2 threads)


@pytest.mark.parametrize("fixed_height", [-1.0, 0.25])
def test_fling_program_matches(fixed_height):
    rng = np.random.default_rng(0)
    p1 = rng.normal(0, 0.2, (4, 3)).astype(np.float32)
    p2 = rng.normal(0, 0.2, (4, 3)).astype(np.float32)
    g1 = np.array([True, True, False, False])
    g2 = np.array([True, False, True, False])
    jcfg = JCfg(fixed_fling_height=fixed_height, fling_speed=5e-3)
    ref, ref_fh = jax.vmap(lambda a, b, c, d: jax_build(
        ("fling",), 0, a, b, c, d, jcfg))(jnp.asarray(p1), jnp.asarray(p2),
                                          jnp.asarray(g1), jnp.asarray(g2))
    cfg = PrimitiveConfig(fixed_fling_height=fixed_height, fling_speed=5e-3)
    prog, fh = build_fling_program(torch.tensor(p1), torch.tensor(p2),
                                   torch.tensor(g1), torch.tensor(g2), cfg)
    prog = append_stabilize(prog)
    assert prog.num_instructions == ref.kind.shape[1]
    for name in prog._fields:
        np.testing.assert_array_equal(getattr(prog, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(fh.numpy(), np.asarray(ref_fh))
