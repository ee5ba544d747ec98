"""The port's native host runtime (its own copy of fbnative.cpp, built into
the port's build directory) held against flingbot_tpu.native and the
pure-Python implementations: the quad-OBJ loader's arrays equal, the
covered area equal to the JAX native result and to its numpy copy
(chip_smoke.covered_area_plain, the plain version the card run holds it
against), and near the reference oracle and the device metric."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import covered_area_plain
from flingbot_tpu import native as jax_native
from flingbot_tpu.env.coverage import (
    get_current_covered_area as jax_coverage)
from flingbot_tpu_torch import native
from flingbot_tpu_torch.engine.build import build_dir
from flingbot_tpu_torch.engine.topology import load_cloth as py_load_cloth
from tests.test_native import write_quad_obj

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or not jax_native.available,
    reason="no g++ to build fbnative")


def test_builds_into_the_port_build_dir():
    assert native.available
    path = native.lib_path()
    assert os.path.dirname(path) == build_dir() and os.path.exists(path)
    assert not os.path.exists(os.path.join(
        os.path.dirname(native.__file__), "libfbnative.so"))


@pytest.mark.parametrize("dims", [(5, 4), (6, 5), (13, 9)])
def test_load_cloth_matches(tmp_path, dims):
    path = write_quad_obj(tmp_path / "cloth.obj", *dims)
    got = native.load_cloth(path)
    for a, b in zip(got, jax_native.load_cloth(path)):
        np.testing.assert_array_equal(a, b)
    # the Python loader: the same arrays (sorted edges, interleaved tris)
    for a, b in zip(got, py_load_cloth(path)):
        np.testing.assert_array_equal(a, b)


def test_load_cloth_refuses_a_triangle_mesh(tmp_path):
    path = tmp_path / "tri.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 0 0 1\nf 1 2 3\n")
    with pytest.raises(ValueError, match="quad mesh"):
        native.load_cloth(str(path))


@pytest.mark.parametrize("n,stride", [(800, 3), (5000, 4)])
def test_covered_area_matches(n, stride):
    from tests.test_env_basics import reference_covered_area

    rng = np.random.default_rng(5 + n)
    pos = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    if stride == 4:
        pos = np.concatenate([pos, np.ones((n, 1), np.float32)], axis=1)
    got = native.covered_area(pos)
    assert got == jax_native.covered_area(pos)
    assert got == covered_area_plain(pos)
    # the reference oracle rounds half to even: ~1% is its contract
    ref = reference_covered_area(
        np.concatenate([pos[:, :3], np.ones((n, 1), np.float32)],
                       axis=1).reshape(-1))
    assert abs(got - ref) / ref < 0.02
    # the device metric (env/coverage.py) measures the same cloud
    dev = float(jax_coverage(jnp.asarray(pos[:, :3])))
    assert abs(got - dev) / dev < 0.05
