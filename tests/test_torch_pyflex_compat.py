"""flingbot_tpu_torch.pyflex_compat held against flingbot_tpu.pyflex_compat
on the cases of tests/test_pyflex_compat.py: the 19-float set_scene, steps
and the particle setters, the shape states and render, the faces.

Both modules keep one global scene; each test sets both up afresh.
Tolerances: the scene as set up, the shape states, the faces and the
render's depth exactly; positions after 5 frames 1e-5 m (a flat cloth
falling onto the floor, the JAX solver's defaults on both sides: xla,
Gauss-Seidel, block contacts); the render's colours within one level
of 255 (shading 1e-6 apart)."""

import numpy as np
import pytest
import torch

from flingbot_tpu import pyflex_compat as jpyflex
from flingbot_tpu_torch import pyflex_compat as pyflex

torch.set_num_threads(2)

# 19-float param vector in flex_utils.py:332-342 order: cloth_pos(3),
# cloth_size(2), stiff(3), render_mode, cam_pos(3), cam_angle(3), cam_w,
# cam_h, mass, flip
PARAMS = np.array([0.0, 0.005, 0.0, 12, 12, 0.9, 1.0, 0.9, 2,
                   0, 2, 0, np.pi / 2, -np.pi / 2, 0, 128, 128, 0.3, 0],
                  np.float32)


@pytest.fixture(autouse=True)
def _scene():
    jpyflex.init(True, True, 128, 128)
    jpyflex.set_scene(0, PARAMS, np.array([]))
    pyflex.init(True, True, 128, 128, device="cpu")
    pyflex.set_scene(0, PARAMS, np.array([]))


def test_scene_step_positions_roundtrip():
    pos0 = pyflex.get_positions()
    np.testing.assert_array_equal(pos0, jpyflex.get_positions())
    assert pos0.reshape(-1, 4).shape[0] == 144
    for _ in range(5):
        pyflex.step()
        jpyflex.step()
    pos1 = pyflex.get_positions()
    np.testing.assert_allclose(pos1, jpyflex.get_positions(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(pyflex.get_velocities(),
                               jpyflex.get_velocities(), rtol=0, atol=1e-3)
    # gravity acted
    assert np.abs(pos1 - pos0).reshape(-1, 4)[:, :3].max() > 1e-5

    pyflex.set_positions(pos0)
    np.testing.assert_array_equal(pyflex.get_positions(), pos0)
    v = pyflex.get_velocities()
    pyflex.set_velocities(np.zeros_like(v))
    assert np.abs(pyflex.get_velocities()).max() == 0
    assert pyflex.get_phases().shape == jpyflex.get_phases().shape


def test_shape_states_and_render():
    np.testing.assert_array_equal(pyflex.get_shape_states(),
                                  jpyflex.get_shape_states())
    pyflex.add_sphere(0.02, [0.0, 0.3, 0.0], [0, 0, 0, 1])
    jpyflex.add_sphere(0.02, [0.0, 0.3, 0.0], [0, 0, 0, 1])
    np.testing.assert_array_equal(pyflex.get_shape_states(),
                                  jpyflex.get_shape_states())
    sp = pyflex.get_shape_states().reshape(-1, 14)
    sp[:, :3] = [[0.1, 0.2, 0.1], [-0.1, 0.2, 0.1]]
    pyflex.set_shape_states(sp.reshape(-1))
    jpyflex.set_shape_states(sp.reshape(-1))
    out = pyflex.get_shape_states()
    np.testing.assert_array_equal(out, jpyflex.get_shape_states())
    np.testing.assert_allclose(out.reshape(-1, 14)[0, :3], [0.1, 0.2, 0.1],
                               atol=1e-6)

    # lifted 5 cm: the scene spawns the cloth at y = -0.005, under the
    # floor the camera sees
    pos = pyflex.get_positions().reshape(-1, 4)
    pos[:, 1] += 0.05
    pyflex.set_positions(pos.reshape(-1))
    jpyflex.set_positions(pos.reshape(-1))
    rgba, depth = pyflex.render()
    jrgba, jdepth = jpyflex.render()
    assert rgba.shape == (128 * 128 * 4,) and rgba.dtype == np.uint8
    assert depth.shape == (128 * 128,)
    np.testing.assert_array_equal(depth, jdepth)
    assert np.isclose(depth.max(), 2.0, atol=1e-3)  # the floor
    assert (depth < 2.0).sum() > 100
    diff = np.abs(rgba.astype(np.int16) - jrgba.astype(np.int16))
    assert diff.max() <= 1


def test_faces():
    faces = pyflex.get_faces()
    np.testing.assert_array_equal(faces, jpyflex.get_faces())
    assert faces.reshape(-1, 3).shape[0] == 2 * 11 * 11


def test_set_scene_config_with_a_saved_state():
    """A task config with its saved state (Task.get_config / get_state):
    the particles and pickers as the JAX module sets them up."""
    rng = np.random.default_rng(0)
    n = 10 * 8
    pos = np.stack(np.meshgrid(np.arange(10) * 0.00625, [0.01],
                               np.arange(8) * 0.00625, indexing="ij"),
                   -1).transpose(2, 0, 1, 3).reshape(-1, 3)
    pp = np.concatenate([pos + rng.normal(0, 1e-3, pos.shape),
                         np.full((n, 1), n / 0.4)], 1).astype(np.float32)
    config = {"cloth_pos": [0.0, 0.0, 0.0], "cloth_size": [10, 8],
              "cloth_stiff": [0.8, 1.0, 0.9], "cloth_mass": 0.4}
    state = {"particle_pos": pp.reshape(-1),
             "particle_vel": rng.normal(0, 1e-3, n * 3).astype(np.float32),
             "shape_pos": np.tile(np.float32([0.2, 0.3, 0.1] + [0] * 11), 2)}
    pyflex.set_scene_config(config, state)
    jpyflex.set_scene_config(config, state)
    np.testing.assert_array_equal(pyflex.get_positions(),
                                  jpyflex.get_positions())
    np.testing.assert_array_equal(pyflex.get_velocities(),
                                  jpyflex.get_velocities())
    np.testing.assert_array_equal(pyflex.get_shape_states(),
                                  jpyflex.get_shape_states())
