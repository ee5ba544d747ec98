"""Renderer, observation, 96-view warp and action selection of
flingbot_tpu_torch held against flingbot_tpu on the same scenes."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flingbot_tpu.engine.topology import grid_triangles_dynamic as jax_tris
from flingbot_tpu.env.action import select_action as jax_select
from flingbot_tpu.env.observation import compute_observation as jax_obs
from flingbot_tpu.learning.transforms import prepare_image as jax_prepare
from flingbot_tpu.render import rasterizer as jr
from flingbot_tpu_torch.engine.topology import grid_triangles_dynamic
from flingbot_tpu_torch.env.action import select_action
from flingbot_tpu_torch.env.observation import compute_observation
from flingbot_tpu_torch.learning.transforms import prepare_image
from flingbot_tpu_torch.render import rasterizer as tr
from tests.test_torch_common import make_pair, port_state, stack, t

MAX_DIM = 16
S = 128
ROT = np.array([-90.0, -30.0, 30.0, 90.0], np.float32)
SCALES = np.array([1.0, 1.5], np.float32)


def _scene(seed=0):
    """Two folded, wavy cloths of different dims."""
    rng = np.random.default_rng(seed)
    jstates, jtopos, _, topo = make_pair(((16, 16), (14, 12)), MAX_DIM, rng,
                                         height=0.02, noise=0.02)
    jstate = stack(jstates)
    P = np.asarray(jstate.positions).copy()
    P[..., 1] += 0.03 * np.sin(P[..., 0] * 60)
    P[0, :, 0] = np.abs(P[0, :, 0]) * 1.5
    jstate = jstate.replace(positions=jnp.asarray(P, jnp.float32))
    return jstate, stack(jtopos), port_state(jstate, topo), topo


def _faces(jtopo, topo):
    jf = jax.vmap(lambda dx, dy: jax_tris(dx, dy, MAX_DIM, MAX_DIM))(
        jtopo.dimx, jtopo.dimy)
    return jf, grid_triangles_dynamic(topo.dimx, topo.dimy, MAX_DIM, MAX_DIM)


def test_render_rgbd_matches():
    jstate, jtopo, tstate, topo = _scene()
    (jf, jm), (tf, tm) = _faces(jtopo, topo)
    rgb_j, depth_j = jax.vmap(lambda p, a, f, m: jr.render_rgbd(
        p, a, image_size=S, faces=f, tri_mask=m))(
            jstate.positions, jstate.active, jf, jm)
    rgb_t, depth_t = tr.render_rgbd(tstate.positions, tstate.active,
                                    image_size=S, faces=tf, tri_mask=tm)
    # same f32 arithmetic per sample and an order-free scatter-min: the
    # depth buffer, and so the cloth mask, is identical
    np.testing.assert_array_equal(depth_t.numpy(), np.asarray(depth_j))
    assert (depth_t.numpy() < 2.0).sum() > 100
    # shading goes through sqrt/division in another op order: 1e-6
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-6)


def test_palette_from_the_same_uniforms():
    rng = np.random.default_rng(3)
    h, s, v = rng.random(3).astype(np.float32)
    c1, c2 = (rng.uniform(0.15, 1.0, 3).astype(np.float32) for _ in "ab")
    grids = [rng.random((g, g)).astype(np.float32) for g in tr.NOISE_OCTAVES]
    cloth_j = jr._hsv_to_rgb(h, s, v)
    total, amp, norm = jnp.zeros((S, S)), 1.0, 0.0
    for g in grids:
        total = total + amp * jax.image.resize(jnp.asarray(g), (S, S),
                                               "bilinear")
        norm += amp
        amp *= 0.55
    tt = total / norm
    floor_j = c1[None, None] + tt[..., None] * (c2 - c1)[None, None]
    cloth_t, floor_t = tr.palette_from_uniforms(
        t([h]), t([s]), t([v]), t(c1[None]), t(c2[None]),
        [t(g[None]) for g in grids], S)
    np.testing.assert_allclose(cloth_t[0].numpy(), np.asarray(cloth_j),
                               atol=1e-6)
    # bilinear upsampling weights computed in another op order
    np.testing.assert_allclose(floor_t[0].numpy(), np.asarray(floor_j),
                               atol=1e-5)


def test_prepare_image_matches():
    rng = np.random.default_rng(4)
    img = rng.random((2, 40, 40, 3)).astype(np.float32)
    scales = np.array([[1.0, 1.7], [0.6, 1.2]], np.float32)
    ref = jax.vmap(lambda im, sc: jax_prepare(
        jnp.asarray(im), jnp.asarray(ROT), sc, out_dim=16,
        with_valid=True))(jnp.asarray(img), jnp.asarray(scales))
    out = prepare_image(t(img), t(ROT), t(scales), out_dim=16,
                        with_valid=True)
    assert tuple(out.shape) == (2, 8, 4, 16, 16)
    # source coordinates go through f32 sin/cos of two libraries
    np.testing.assert_allclose(out[:, :, :3].numpy(),
                               np.asarray(ref[:, :, :3]), atol=1e-5)
    np.testing.assert_array_equal(out[:, :, 3].numpy(),
                                  np.asarray(ref[:, :, 3]))


def _observe(jstate, jtopo, tstate, topo):
    (jf, jm), (tf, tm) = _faces(jtopo, topo)
    jo = jax.vmap(lambda p, a, f, m: jax_obs(
        p, a, jnp.asarray(ROT), jnp.asarray(SCALES), image_size=S,
        obs_dim=32, faces=f, tri_mask=m))(jstate.positions, jstate.active,
                                          jf, jm)
    to = compute_observation(tstate.positions, tstate.active, t(ROT),
                             t(SCALES), image_size=S, obs_dim=32, faces=tf,
                             tri_mask=tm)
    return jo, to


def test_observation_matches():
    jo, to = _observe(*_scene(1))
    np.testing.assert_array_equal(to.cloth_mask.numpy(),
                                  np.asarray(jo.cloth_mask))
    np.testing.assert_array_equal(to.grasp_ok.numpy(),
                                  np.asarray(jo.grasp_ok))
    np.testing.assert_array_equal(to.adaptive_scales.numpy(),
                                  np.asarray(jo.adaptive_scales))
    # the 96-view stack: bilinear weights from f32 sin/cos of two libraries
    np.testing.assert_allclose(to.obs_stack.numpy(),
                               np.asarray(jo.obs_stack), atol=1e-5)
    # validity channels thresholded at 0.5, as select_action reads them
    np.testing.assert_array_equal(to.mask_stack.numpy()[:, :, 1:] > 0.5,
                                  np.asarray(jo.mask_stack)[:, :, 1:] > 0.5)


def test_select_action_identical():
    scene = _scene(2)
    jo, to = _observe(*scene)
    rng = np.random.default_rng(9)
    vm = rng.random((2, 1, 8, 32, 32)).astype(np.float32)
    # a tie at the maximum: both must take the first index
    vm[0, 0, 3, 10, 12] = vm[0, 0, 5, 10, 12] = 2.0
    for maps in (vm, np.zeros_like(vm)):  # zeros: the unmasked fallback
        js = jax.vmap(lambda v, o: jax_select(v, o, jnp.asarray(ROT),
                                              pix_grasp_dist=4))(
            jnp.asarray(maps), jo)
        ts = select_action(t(maps), to, t(ROT), pix_grasp_dist=4)
        for f in ("valid", "prim_idx", "transform_idx", "row", "col",
                  "p1_grasp", "p2_grasp", "rotation", "scale"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f)
        np.testing.assert_allclose(ts.p1_world.numpy(),
                                   np.asarray(js.p1_world), atol=1e-6)
        np.testing.assert_allclose(ts.pretransform_pixels.numpy(),
                                   np.asarray(js.pretransform_pixels),
                                   atol=1e-4)
