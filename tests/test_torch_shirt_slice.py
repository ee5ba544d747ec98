"""The shirt eval slice: one BatchSimEnv.step of flingbot_tpu_torch on two
small layered-lattice shirts, held against flingbot_tpu's chunked step
(step_begin / program_chunk / step_finish on a LayeredGridTopology, XLA
path of the production solver: chebyshev springs, sorted-window contacts
with the rest-pose filter) on the same start states and value maps.

As tests/test_torch_slice.py does for grid cloths, both sides run a cheap
solver config and a truncated program; the production knobs are covered
per module by test_torch_shirts.py and test_torch_kernels.py.  Coverage,
observation, action selection, the picker and the primitive programs are
the grid path's code: this test shows they serve shirts unchanged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flingbot_tpu.engine.solver import step as jax_step
from flingbot_tpu.engine.state import SolverParams as JParams
from flingbot_tpu.env.observation import compute_observation
from flingbot_tpu.env.primitives import (
    PrimitiveConfig as JCfg, STABLE_MAX_STEPS, program_chunk)
from flingbot_tpu.env.shirts import write_shirt_obj
from flingbot_tpu.env.sim_env import PARK_PICKERS, step_begin, step_finish
from flingbot_tpu_torch.engine.topology import compute_layered_spec
from flingbot_tpu_torch.env import primitives as tprim
from flingbot_tpu_torch.env.batch_env import BatchSimEnv
from flingbot_tpu_torch.env.scene import make_batch, shirt_task
from flingbot_tpu_torch.env.sim_env import step_begin as t_step_begin
from tests.test_torch_common import COVERAGE_RTOL, ieee_coverage, stack
from tests.test_torch_shirts import SMALL_SHIRT, jax_scene

SOLVER = dict(substeps=4, iterations=4, contact_every=2,
              contact_iterations=2, contact_window=4)
OBS = dict(image_size=128, obs_dim=32)
ROT = np.array([-90.0, -30.0, 30.0, 90.0], np.float32)
SCALES = np.array([1.0, 1.5], np.float32)
PIX = 4
MAX_PROGRAM_STEPS = 40


def lat(x):
    """Port (B, C, N) -> the JAX package's layered (B, N, C)."""
    return np.swapaxes(x.numpy(), 1, 2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shirt") / "small_processed.obj")
    write_shirt_obj(path, **SMALL_SHIRT)
    rng = np.random.default_rng(0)
    tasks = []
    for mass in (0.5, 0.8):
        t = shirt_task(path, cloth_mass=mass)
        pp = t.particle_pos.reshape(-1, 4).copy()
        pp[:, :3] += rng.normal(0, 2e-3, (len(pp), 3))
        t.particle_pos = pp.reshape(-1)
        tasks.append(t)
    spec = compute_layered_spec([t.mesh_arrays() for t in tasks])
    ttopo, tstate = make_batch(tasks, device="cpu", layered_spec=spec)
    scenes = [jax_scene(t, spec) for t in tasks]
    jp = JParams()
    park = jnp.asarray(PARK_PICKERS)
    jstate = stack([s.state.replace(picker_pos=park) for s in scenes])
    jtopo = stack([s.topo for s in scenes])
    jkw = dict(spring_mode="chebyshev", contact_mode="sort", **SOLVER)
    settle = jax.jit(jax.vmap(lambda s, tp: jax_step(s, tp, jp, **jkw)))
    jstate = settle(jstate, jtopo)

    env = BatchSimEnv(obs_dim=OBS["obs_dim"], num_rotations=len(ROT),
                      scale_factors=SCALES, render_dim=OBS["image_size"],
                      pix_grasp_dist=PIX, domain_randomization=False,
                      max_program_steps=MAX_PROGRAM_STEPS, chunk_steps=64,
                      device="cpu", **SOLVER)
    tobs = env.reset(tstate, ttopo)
    settled = env.state

    # the step starts from the port's settled state on both sides, so the
    # observation, the action and the pre-action coverage see the same
    # positions
    jsettled = jstate
    jstate = jstate.replace(positions=jnp.asarray(lat(settled.positions)),
                            velocities=jnp.asarray(lat(settled.velocities)))
    jobs = jax.vmap(lambda p, a, f, m: compute_observation(
        p, a, jnp.asarray(ROT), jnp.asarray(SCALES), faces=f, tri_mask=m,
        **OBS))(jstate.positions, jstate.active, jtopo.triangles,
                jtopo.tri_mask)

    T = len(ROT) * len(SCALES)
    vm = rng.uniform(size=(2, 1, T, 32, 32)).astype(np.float32)
    cfg = JCfg(max_program_steps=MAX_PROGRAM_STEPS)
    begin = jax.jit(jax.vmap(
        lambda s, tp, v, o: step_begin(s, tp, jp, v, o, jnp.asarray(ROT),
                                       ("fling",), cfg, pix_grasp_dist=PIX),
        in_axes=(0, 0, 0, 0)))
    sel, pre_cov, pre_pos, carry, prog = begin(jstate, jtopo,
                                               jnp.asarray(vm), jobs)
    max_steps = MAX_PROGRAM_STEPS + STABLE_MAX_STEPS
    chunk = jax.jit(jax.vmap(
        lambda c, tp, pg: program_chunk(c, tp, jp, pg, chunk_steps=1,
                                        max_steps=max_steps, **jkw)))

    # the port's interpreter, stepped alongside for the trace
    tsel, tpre, tpos, tcarry, tprog = t_step_begin(
        env.state, torch.as_tensor(vm), env.obs, env.rotations,
        env.prim_cfg, PIX)
    trace = []
    for _ in range(max_steps + 2 * prog.kind.shape[1]):
        carry, done = chunk(carry, jtopo, prog)
        if len(trace) < 200 and np.asarray(carry.pc).max() <= 4:
            tcarry, _ = tprim.program_chunk(
                tcarry, env.topo, env.params, tprog, chunk_steps=1,
                max_steps=max_steps, sim_kw=env.sim_kw)
            trace.append((np.asarray(carry.pc), tcarry.pc.numpy(),
                          np.asarray(carry.state.picker_pos),
                          tcarry.state.picker_pos.numpy(),
                          np.asarray(carry.total_steps),
                          np.asarray(carry.state.positions),
                          lat(tcarry.state.positions)))
        if bool(np.all(np.asarray(done))):
            break
    jfinal, post_cov, term = jax.vmap(step_finish)(carry, pre_pos)
    env.step(torch.as_tensor(vm))
    return dict(jstate=jsettled, settled=settled, jobs=jobs, tobs=tobs,
                sel=sel, pre_cov=pre_cov, post_cov=post_cov, term=term,
                tsel=tsel, tpre=tpre, trace=trace, env=env,
                jfinal=jfinal)


def test_settle_step_and_observation(run):
    # one solver step of identical start states (chaos has not set in)
    np.testing.assert_allclose(lat(run["settled"].positions),
                               np.asarray(run["jstate"].positions),
                               atol=1e-5)
    np.testing.assert_allclose(run["tobs"].numpy(),
                               np.asarray(run["jobs"].obs_stack), atol=1e-5)


def test_action_and_precoverage_identical(run):
    sel, tsel = run["sel"], run["tsel"]
    for f in ("prim_idx", "transform_idx", "row", "col", "p1_grasp",
              "p2_grasp", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(sel, f)),
                                      getattr(tsel, f).numpy(), err_msg=f)
    np.testing.assert_allclose(np.asarray(sel.p1_world),
                               tsel.p1_world.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(sel.p2_world),
                               tsel.p2_world.numpy(), atol=1e-6)
    assert bool(np.asarray(sel.p1_grasp | sel.p2_grasp).all())
    # same positions -> the same coverage formula: the port's is bit-equal
    # to it in IEEE float32, the JAX package's within its host's rounding
    ieee = ieee_coverage(run["settled"])
    np.testing.assert_array_equal(run["tpre"].numpy(), ieee)
    np.testing.assert_allclose(np.asarray(run["pre_cov"]), ieee,
                               rtol=COVERAGE_RTOL, atol=0)


def test_program_trace(run):
    trace = run["trace"]
    sim = 0
    for jpc, tpc, jpick, tpick, steps, jpos, tpos in trace:
        np.testing.assert_array_equal(jpc, tpc)
        # approach + lift phases are kinematic: the picker paths agree
        if jpc.max() <= 3:
            np.testing.assert_allclose(jpick, tpick, atol=1e-6)
        if steps.max() <= 2 and steps.max() > sim:
            # first two sim steps: cloth positions before chaos grows
            np.testing.assert_allclose(jpos, tpos, atol=1e-5)
            sim = steps.max()
    assert sim == 2
    assert trace[-1][0].max() >= 3  # reached the grasp check


def test_batch_step_coverage(run):
    env = run["env"]
    last = env.last
    ieee = ieee_coverage(run["settled"])
    np.testing.assert_array_equal(last.pre_coverage.numpy(), ieee)
    np.testing.assert_allclose(np.asarray(run["pre_cov"]), ieee,
                               rtol=COVERAGE_RTOL, atol=0)
    post = np.asarray(run["post_cov"])
    # 340 chaotic solver steps (the program is cut mid-fling by
    # MAX_PROGRAM_STEPS + STABLE_MAX_STEPS), so post-action coverage agrees
    # only statistically.  Six JAX-vs-JAX runs with 1e-7 position noise on
    # these shirts spread over 0.0138-0.0276 (env 0) and 0.0241-0.0296
    # (env 1) around 0.0221 / 0.0278: up to 37% relative.
    np.testing.assert_allclose(last.post_coverage.numpy(), post, rtol=0.6)
    assert np.isfinite(env.state.positions.numpy()).all()
    assert tuple(env.obs.obs_stack.shape) == (2, 8, 4, 32, 32)
    # the shirts were grasped and flung: the cloth moved
    assert float(np.abs(lat(env.state.positions)
                        - np.asarray(run["jstate"].positions)).max()) > 0.05
