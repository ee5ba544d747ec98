"""The action space of flingbot_tpu_torch held against flingbot_tpu: the
drag, place and stretch-drag programs, the per-env program selection,
action selection over several primitives (pairings, offsets, non-fling
rotations, ties across primitives), the observation knobs, one
BatchSimEnv step with a different primitive in each env, the flags that
run_sim accepts, and run_sim training one net per primitive.

Both sides run a cheap solver config and a truncated program, as
tests/test_torch_slice.py does.  The card test needs neither jax nor the
JAX package (a card's machine lacks flax and h5py): those imports sit in
a `try`."""

import os

import numpy as np
import pytest
import torch

from flingbot_tpu_torch import run_sim
from flingbot_tpu_torch.engine.solver import step as solver_step
from flingbot_tpu_torch.engine.topology import (
    grid_triangles_dynamic as port_faces)
from flingbot_tpu_torch.env import primitives as tprim
from flingbot_tpu_torch.env.action import select_action
from flingbot_tpu_torch.env.batch_env import BatchSimEnv
from flingbot_tpu_torch.env.coverage import GRID
from flingbot_tpu_torch.env.observation import (
    Observation, compute_observation)
from flingbot_tpu_torch.env.sim_env import step_begin
from flingbot_tpu_torch.env.sim_env import step_finish as tstep_finish
from flingbot_tpu_torch.env.tasks import TaskLoader
from flingbot_tpu_torch.learning.memory import read_step, step_keys
from flingbot_tpu_torch.learning.nets import rotation_list
from flingbot_tpu_torch.utils.config import apply_presets, config_parser

try:  # the JAX package, for the tests against it
    import jax
    import jax.numpy as jnp

    from flingbot_tpu.engine.topology import grid_triangles_dynamic
    from flingbot_tpu.env import primitives as jprim
    from flingbot_tpu.env.action import select_action as jax_select
    from flingbot_tpu.env.batch_env import BatchSimEnv as JEnv
    from flingbot_tpu.env.observation import (
        compute_observation as jax_observation)
    from flingbot_tpu.env.sim_env import step_finish as jax_finish
    from flingbot_tpu.env.tasks import TaskLoader as JLoader
    from flingbot_tpu.engine.solver import step as jax_solver_step
    from tests.test_torch_common import (
        canonical, make_pair, port_state, stack, write_grid_tasks)
    from tools.export_tasks_npz import export
except ImportError:
    jax = None

PRIMS = ("fling", "stretchdrag", "drag", "place")
PIX = dict(pix_grasp_dist=4, pix_drag_dist=6, pix_place_dist=5)
# no cloth fills the 16x16 lattice: the JAX package stacks per-env grid
# topologies, whose static full_grid flags must agree
DIMS = ((15, 14), (14, 12), (16, 12), (12, 15))
MAX_DIM = 16
OBS = dict(image_size=128, obs_dim=32)
SCALES = np.array([1.0, 1.5], np.float32)
NUM_ROT = 4
KNOBS = dict(conservative_grasp_radius=2, use_adaptive_scaling=False,
             reach_distance_limit=0.9)
CHEAP = dict(substeps=2, iterations=2, contact_every=2, contact_iterations=1,
             contact_window=4)
# long enough for drag and place to grasp and move the cloth: each arm
# servos ~0.73 m to its pre-grasp point and 0.28 m down at 5e-3 m a step
MAX_PROGRAM_STEPS = 240
NOISE_SEEDS = tuple(range(32))
INT_FIELDS = ("valid", "prim_idx", "transform_idx", "row", "col",
              "p1_grasp", "p2_grasp")
# picker paths depend on the cloth from these kinds on
DYNAMIC = (tprim.STRETCH, tprim.LIFT, tprim.CHECKGRASP, tprim.STABILIZE)

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")


def grasp_batch():
    """8 envs of seeded grasp points with every pair of grasp flags."""
    rng = np.random.default_rng(0)
    p1 = rng.normal(0, 0.2, (8, 3)).astype(np.float32)
    p2 = rng.normal(0, 0.2, (8, 3)).astype(np.float32)
    g1 = np.array([1, 1, 0, 0, 1, 0, 1, 0], bool)
    g2 = np.array([1, 0, 1, 0, 0, 1, 1, 0], bool)
    return p1, p2, g1, g2


def assert_programs_equal(prog, ref, prims):
    assert prog.num_instructions == ref.kind.shape[-1]
    for name in prog._fields:
        got, want = getattr(prog, name).numpy(), np.asarray(getattr(ref,
                                                                    name))
        if name == "base" and "stretchdrag" in prims:
            # the drag direction is a cross product scaled by its norm,
            # which XLA and PyTorch round in their own ways
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@needs_jax
@pytest.mark.parametrize("prim", ["drag", "place", "stretchdrag"])
def test_builder_matches(prim):
    p1, p2, g1, g2 = grasp_batch()
    cfg = jprim.PrimitiveConfig(stretchdrag_dist=0.25)
    ref, ref_fh = jax.vmap(lambda a, b, c, d: jprim.PROGRAM_BUILDERS[prim](
        a, b, c, d, cfg))(*(jnp.asarray(x) for x in (p1, p2, g1, g2)))
    prog, fh = tprim.PROGRAM_BUILDERS[prim](
        *(torch.tensor(x) for x in (p1, p2, g1, g2)),
        tprim.PrimitiveConfig(stretchdrag_dist=0.25))
    assert_programs_equal(prog, ref, (prim,))
    np.testing.assert_array_equal(fh.numpy(), np.asarray(ref_fh))
    # without a grasp on cloth the first instruction jumps to the end
    no_grasp = ~g1 if prim != "stretchdrag" else ~(g1 | g2)
    jumps = prog.cond[:, 0].numpy() > 0.5
    np.testing.assert_array_equal(jumps, no_grasp)
    assert (prog.jump[:, 0] == prog.num_instructions).all()


@needs_jax
def test_selected_program_matches():
    p1, p2, g1, g2 = grasp_batch()
    idx = np.array([0, 1, 2, 3, 2, 3, 1, 0], np.int32)
    cfg = jprim.PrimitiveConfig()
    ref, ref_fh = jax.vmap(lambda i, a, b, c, d: jprim.build_selected_program(
        PRIMS, i, a, b, c, d, cfg))(
        *(jnp.asarray(x) for x in (idx, p1, p2, g1, g2)))
    prog, fh = tprim.build_selected_program(
        PRIMS, torch.tensor(idx, dtype=torch.int64),
        *(torch.tensor(x) for x in (p1, p2, g1, g2)),
        tprim.PrimitiveConfig())
    assert_programs_equal(prog, ref, PRIMS)
    np.testing.assert_array_equal(fh.numpy(), np.asarray(ref_fh))
    # stabilize before padding: every abort jump lands on STABILIZE
    kind, jump = prog.kind.numpy(), prog.jump.numpy()
    for b in range(8):
        j = jump[b, 0]
        assert kind[b, j] == tprim.STABILIZE or j == prog.num_instructions


def port_observation(dims, rng, prims, **knobs):
    """(JAX states, port observation, rotations) of the same small cloths
    lying on the floor, rendered with the action space's rotations."""
    jstates, _, state, topo = make_pair(dims, MAX_DIM, rng, height=0.02,
                                        noise=2e-2)
    faces, fmask = port_faces(topo.dimx, topo.dimy, MAX_DIM, MAX_DIM)
    rot = torch.as_tensor(rotation_list(NUM_ROT, prims))
    obs = compute_observation(state.positions, state.active, rot,
                              torch.tensor(SCALES), faces, fmask, **OBS,
                              **knobs)
    return jstates, obs, rot


@needs_jax
@pytest.mark.parametrize("prims,pix", [
    (PRIMS, PIX), (("drag", "place"), dict(PIX, pix_place_dist=6))])
def test_select_action_matches(prims, pix):
    """Value maps: env 0 constant (every valid action ties); env 1 the same
    map for the first two primitives, whose grasp geometry agrees (fling
    and stretchdrag; drag and place at equal pixel distances), and lower
    values for the others, so its best action ties across primitives;
    envs 2 and 3 steered to the last two primitives."""
    rng = np.random.default_rng(1)
    _, obs, rot = port_observation(DIMS, rng, prims)
    jrot = JEnv(get_task_fn=None, num_envs=1, action_primitives=prims,
                num_rotations=NUM_ROT).rotations
    np.testing.assert_array_equal(rot.numpy(), jrot)
    P, T, D = len(prims), NUM_ROT * len(SCALES), OBS["obs_dim"]
    vm = rng.uniform(size=(4, P, T, D, D)).astype(np.float32)
    vm[0] = 0.5
    vm[1, 1] = vm[1, 0]
    vm[1, 2:] -= 1.0
    vm[2, P - 2] += 10.0
    vm[3, P - 1] += 10.0
    sel = select_action(torch.tensor(vm), obs, rot, primitives=prims, **pix)
    jsel = jax.vmap(lambda v, o: jax_select(
        v, o, jnp.asarray(rot.numpy()), primitives=prims, **pix),
        in_axes=(0, 0))(jnp.asarray(vm), Observation(
            *(jnp.asarray(x.numpy()) for x in obs)))
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(sel, f).numpy(),
                                      np.asarray(getattr(jsel, f)),
                                      err_msg=f)
    for f in ("rotation", "scale", "value"):
        np.testing.assert_array_equal(getattr(sel, f).numpy(),
                                      np.asarray(getattr(jsel, f)),
                                      err_msg=f)
    for f in ("p1_world", "p2_world"):
        np.testing.assert_allclose(getattr(sel, f).numpy(),
                                   np.asarray(getattr(jsel, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    assert bool(sel.valid.all())
    # ties across primitives pick the lower index on both sides
    np.testing.assert_array_equal(sel.prim_idx.numpy(), [0, 0, P - 2, P - 1])
    assert float(sel.value[1]) == float(vm[1, 1].reshape(-1)[
        sel.transform_idx[1] * D * D + sel.row[1] * D + sel.col[1]])


@needs_jax
def test_observation_knobs_match():
    rng = np.random.default_rng(2)
    jstates, obs, rot = port_observation(DIMS, rng, ("fling",), **KNOBS)
    js = stack(jstates)
    faces, fmask = jax.vmap(lambda dx, dy: grid_triangles_dynamic(
        dx, dy, MAX_DIM, MAX_DIM))(
        jnp.asarray([d[0] for d in DIMS]), jnp.asarray([d[1] for d in DIMS]))
    jobs = jax.vmap(lambda p, a, f, m: jax_observation(
        p, a, jnp.asarray(rot.numpy()), jnp.asarray(SCALES), faces=f,
        tri_mask=m, **OBS, **KNOBS))(js.positions, js.active, faces, fmask)
    for f in ("cloth_mask", "grasp_ok", "adaptive_ratio", "adaptive_scales"):
        np.testing.assert_array_equal(getattr(obs, f).numpy(),
                                      np.asarray(getattr(jobs, f)),
                                      err_msg=f)
    for f in ("obs_stack", "mask_stack"):
        np.testing.assert_allclose(getattr(obs, f).numpy(),
                                   np.asarray(getattr(jobs, f)), rtol=0,
                                   atol=1e-5, err_msg=f)
    # the knobs took effect: no crop shrink, a smaller grasp circle area
    # and reach than the defaults give
    _, dflt, _ = port_observation(DIMS, np.random.default_rng(2), ("fling",))
    assert (obs.adaptive_ratio == 1).all() and (dflt.adaptive_ratio < 1).all()
    assert obs.grasp_ok.sum() < dflt.grasp_ok.sum()
    assert obs.mask_stack[:, :, 1].sum() < dflt.mask_stack[:, :, 1].sum()


@pytest.fixture(scope="module")
def mixed_step(tmp_path_factory):
    """One step of 4 file tasks, env i steered to primitive i, on the port's
    BatchSimEnv (begin_step, run_program one interpreter step at a time,
    end_step) and on the JAX package's step_begin / program_chunk /
    step_finish from the port's settled states, with a trace of both
    interpreters."""
    d = tmp_path_factory.mktemp("action_space")
    h5 = write_grid_tasks(str(d / "tasks.hdf5"), DIMS,
                          np.random.default_rng(0))
    npz = str(d / "tasks.npz")
    export(h5, npz)
    common = dict(num_envs=4, obs_dim=OBS["obs_dim"], num_rotations=NUM_ROT,
                  scale_factors=tuple(SCALES), render_dim=OBS["image_size"],
                  max_grid_dim=MAX_DIM, domain_randomization=False,
                  action_primitives=PRIMS, stretchdrag_dist=0.25,
                  episode_length=1, **PIX, **KNOBS, **CHEAP)
    replay = str(d / "replay")
    env = BatchSimEnv(get_task_fn=TaskLoader(npz).get_next_task,
                      replay_buffer_path=replay,
                      max_program_steps=MAX_PROGRAM_STEPS, device="cpu",
                      **common)
    jenv = JEnv(get_task_fn=JLoader(h5).get_next_task, contact_mode="sort",
                spring_mode="chebyshev", **common)
    env.reset()
    jenv.reset()
    settled = env.state.index(torch.arange(4))
    jenv.state = jenv.state.replace(
        positions=jnp.asarray(canonical(settled.positions, env.topo,
                                        jenv.state.positions)),
        velocities=jnp.asarray(canonical(settled.velocities, env.topo,
                                         jenv.state.velocities)))
    jenv._observe()

    T, D = NUM_ROT * len(SCALES), OBS["obs_dim"]
    vm = np.random.default_rng(3).uniform(
        size=(4, len(PRIMS), T, D, D)).astype(np.float32)
    vm[np.arange(4), np.arange(4)] += 10.0
    max_steps = MAX_PROGRAM_STEPS + tprim.STABLE_MAX_STEPS
    # both steps again from the settled states under 1e-7 relative noise,
    # NOISE_SEEDS copies of the 4 envs in one batch: how far chaos alone
    # moves each side's post-action coverage
    S = len(NOISE_SEEDS)
    idx = np.arange(4 * S) % 4

    def noise(shape):
        return np.concatenate([
            1 + 1e-7 * np.random.default_rng(seed).standard_normal(
                (4,) + shape[1:]) for seed in NOISE_SEEDS]).astype(np.float32)

    def jax_side():
        """The JAX step one interpreter step at a time (its trace), then
        its noisy copies."""
        jsel, jpre, jpos, jcarry, jprog = jenv._vm_begin(
            jenv.state, jenv.topo, jenv.params, jnp.asarray(vm), jenv.obs,
            jnp.asarray(jenv.rotations))
        chunk = jax.jit(jax.vmap(
            lambda c, tp, pg: jprim.program_chunk(
                c, tp, jenv.params, pg, chunk_steps=1, max_steps=max_steps,
                **jenv.sim_kw), in_axes=(0, 0, 0)))
        trace = []
        for _ in range(max_steps + 2 * jprog.kind.shape[1]):
            jcarry, done = chunk(jcarry, jenv.topo, jprog)
            trace.append((np.asarray(jcarry.pc),
                          np.asarray(jcarry.state.picker_pos),
                          np.asarray(jcarry.total_steps),
                          np.asarray(jcarry.state.positions)
                          if len(trace) < 8 else None))
            if bool(np.all(np.asarray(done))):
                break
        _, post_cov, _ = jax.vmap(jax_finish)(jcarry, jpos)

        def tile(x):
            return jnp.asarray(np.asarray(x)[idx])

        jpos0 = np.asarray(jenv.state.positions)[idx]
        jstate = jax.tree_util.tree_map(tile, jenv.state).replace(
            positions=jnp.asarray(jpos0 * noise(jpos0.shape)))
        jtopo = jax.tree_util.tree_map(tile, jenv.topo)
        _, _, npos, ncarry, nprog = jenv._vm_begin(
            jstate, jtopo, jenv.params, jnp.asarray(vm[idx]),
            jax.tree_util.tree_map(tile, jenv.obs),
            jnp.asarray(jenv.rotations))
        done = False
        while not done:
            ncarry, d = chunk(ncarry, jtopo, nprog)
            done = bool(np.all(np.asarray(d)))
        jnoisy = np.asarray(jax.vmap(jax_finish)(ncarry, npos)[1])
        return jsel, jpre, jprog, trace, post_cov, jnoisy, jcarry.state

    jsel, jpre, jprog, jtrace, post_cov, jnoisy, jend = jax_side()
    # the port's side: the env's own step, one interpreter step at a time
    # to its end, then BatchSimEnv.end_step, then its noisy copies
    tsel, tpre, _, _, tprog = step_begin(
        env.state, torch.from_numpy(vm), env.obs, env.rotations,
        env.prim_cfg, env.pix_grasp_dist, env.action_primitives,
        env.pix_drag_dist, env.pix_place_dist)
    obs0 = Observation(*(x.clone() for x in env.obs))
    start = env.begin_step(torch.from_numpy(vm))
    tcarry, chunks, ttrace = start.carry, 0, []
    for _ in range(max_steps + 2 * tprog.kind.shape[1]):
        tcarry, tdone = env.run_program(start, tcarry, 1)
        chunks += 1
        ttrace.append((tcarry.pc.numpy(), tcarry.state.picker_pos.numpy(),
                       tcarry.state.positions.clone()
                       if len(ttrace) < 8 else None))
        if bool(tdone.all()):
            break
    env.end_step(start, tcarry, chunks)
    tidx = torch.from_numpy(idx)
    tstate = settled.index(tidx)
    tstate = tstate.replace(positions=tstate.positions * torch.from_numpy(
        noise(tuple(tstate.positions.shape))))
    ttopo = env.topo.index(tidx)
    _, _, tpos0, ncarry, nprog = step_begin(
        tstate, torch.from_numpy(vm[idx]),
        Observation(*(x[tidx] for x in obs0)), env.rotations,
        env.prim_cfg, env.pix_grasp_dist, env.action_primitives,
        env.pix_drag_dist, env.pix_place_dist)
    done = False
    while not done:
        ncarry, d = tprim.program_chunk(
            ncarry, ttopo, env.params, nprog, chunk_steps=64,
            max_steps=max_steps, sim_kw=env.sim_kw)
        done = bool(d.all())
    tnoisy = tstep_finish(ncarry, tpos0)[1].numpy()
    # the two traces step for step, as long as the JAX one; a port env
    # that ended first stays as it is (program_chunk), so its last entry
    # repeats
    trace = []
    for k, (jpc, jpick, steps, jpos) in enumerate(jtrace):
        tpc, tpick, tpos = ttrace[min(k, len(ttrace) - 1)]
        trace.append((jpc, tpc, jpick, tpick, steps, jpos,
                      None if jpos is None else canonical(
                          tpos, env.topo, jpos)))
    return dict(env=env, jenv=jenv, jsel=jsel, jpre=jpre, jprog=jprog,
                tsel=tsel, tpre=tpre, tprog=tprog, trace=trace,
                post_cov=post_cov, jax_noisy=jnoisy.reshape(S, 4),
                port_noisy=tnoisy.reshape(S, 4), jend=jend, replay=replay)


@needs_jax
def test_mixed_step_selection_and_programs(mixed_step):
    r = mixed_step
    sel, jsel = r["tsel"], r["jsel"]
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(sel, f).numpy(),
                                      np.asarray(getattr(jsel, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(sel.prim_idx.numpy(), [0, 1, 2, 3])
    # drag and place need p1's grasp circle on cloth, fling and
    # stretch-drag one of the two
    assert bool((sel.p1_grasp | sel.p2_grasp).all())
    assert bool(sel.p1_grasp[2:].all())
    for f in ("p1_world", "p2_world"):
        np.testing.assert_allclose(getattr(sel, f).numpy(),
                                   np.asarray(getattr(jsel, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(r["tpre"].numpy(), r["env"].last
                                  .pre_coverage.numpy())
    assert_programs_equal(r["tprog"], r["jprog"], PRIMS)


@needs_jax
def test_mixed_step_trace(mixed_step):
    """Program counters and picker paths agree while each env's path is
    kinematic; the first two sim frames agree before chaos grows."""
    r = mixed_step
    kinds = np.asarray(r["jprog"].kind)
    live = np.ones(4, bool)
    compared = np.zeros(4, int)
    seen = set()
    sim = 0
    for jpc, tpc, jpick, tpick, steps, jpos, tpos in r["trace"]:
        np.testing.assert_array_equal(tpc[live], jpc[live])
        np.testing.assert_allclose(tpick[live], jpick[live], rtol=0,
                                   atol=1e-6)
        compared += live
        at = kinds[np.arange(4), np.minimum(jpc, kinds.shape[1] - 1)]
        live &= ~np.isin(at, DYNAMIC) & (jpc < kinds.shape[1])
        seen.update((b, int(jpc[b])) for b in range(4))
        if jpos is not None and 0 < steps.max() <= 2 and steps.max() > sim:
            np.testing.assert_allclose(tpos, jpos, rtol=0, atol=1e-5)
            sim = steps.max()
    print("interpreter steps compared per env:", compared)
    assert sim == 2
    # every primitive ran past its grasp: the fling reached the stretch,
    # stretch-drag its drag (DRAGREL), drag and place the move with the
    # cloth in hand
    assert (0, 4) in seen and (1, 5) in seen
    assert (2, 3) in seen and (3, 4) in seen


@needs_jax
def test_mixed_step_coverage_and_replay(mixed_step):
    r = mixed_step
    env, jenv = r["env"], r["jenv"]
    post = np.asarray(r["post_cov"])
    port = env.last.post_coverage.numpy()
    jn, tn = r["jax_noisy"], r["port_noisy"]
    print("post-action coverage: port", port, "JAX", post)
    print(f"under 1e-7 noise, {len(NOISE_SEEDS)} seeds: JAX", jn.min(0),
          np.median(jn, 0), jn.max(0), "port", tn.min(0), np.median(tn, 0),
          tn.max(0))

    def inside(x, sample, widen=0.0):
        # a band widened by 4 float32 ulps: the JAX coverage's division
        # by GRID rounds differently from IEEE by 1 ulp on some hosts
        return ((x >= sample.min(0) * (1 - 5e-7) - widen)
                & (x <= sample.max(0) * (1 + 5e-7) + widen))

    # the coverage rounds each particle's stamp edge (off +- r) / span to
    # a grid index, so a draw takes values about one stamp edge apart: a
    # single draw lies inside the JAX spread widened on each side by the
    # most one rounded edge can move it, one row or column of the
    # GRID x GRID grid (coverage.py's arithmetic on each env's end state)
    row = grid_row_area(r["jend"])
    print("one coverage-grid row per env (m^2):", row)
    assert inside(port, jn, row).all()
    # the draw of one host that fell outside the plain spread (env 1,
    # stretch-drag: 0.00898542 against 0.00894799-0.00894802) lies inside
    # the band; a draw beyond it does not
    host_jn = np.array([0.00894799, 0.00894802], np.float32)
    assert inside(np.float32(0.00898542), host_jn, row[1])
    assert not inside(host_jn.max() * (1 + 5e-7) + 1.01 * row[1], host_jn,
                      row[1])
    # each side's median inside the other's spread
    assert inside(np.median(tn, 0), jn).all()
    assert inside(np.median(jn, 0), tn).all()
    # and within the slice tests' rtol 0.6, from their JAX-vs-JAX spread
    # under 1e-7 input noise
    np.testing.assert_allclose(env.last.post_coverage.numpy(), post,
                               rtol=0.6)
    assert np.isfinite(env.state.positions.numpy()).all()
    # where the end states differ, the solvers still agree: one frame from
    # the JAX end state (released cloths, a flung one still moving)
    jend = r["jend"]
    frame = jax.jit(jax.vmap(lambda s, t: jax_solver_step(
        s, t, jenv.params, **jenv.sim_kw)))(jend, jenv.topo)
    got = solver_step(port_state(jend, env.topo), env.topo, env.params,
                      **env.sim_kw)
    got_pos = canonical(got.positions, env.topo, frame.positions)
    print("one frame from the JAX end state: max |port - JAX|",
          np.abs(got_pos - np.asarray(frame.positions)).max(), "max |V|:",
          "JAX", np.abs(np.asarray(frame.velocities)).max((1, 2)),
          "port", got.velocities.abs().amax((1, 2)).numpy())
    np.testing.assert_allclose(got_pos, np.asarray(frame.positions),
                               rtol=0, atol=1e-5)
    keys = step_keys(r["replay"])
    assert len(keys) == 4
    prims = sorted(read_step(r["replay"], k)[0]["action_primitive"]
                   for k in keys)
    assert prims == sorted(PRIMS)


def grid_row_area(state) -> np.ndarray:
    """(B,) area in m^2 of one row (or column) of each env's coverage grid:
    GRID cells of span_x * span_z over the active particles' AABB, in
    float32 as env/coverage.py computes the spans.  state: a JAX batch
    (positions (B, N, 3), active (B, N))."""
    pos = np.asarray(state.positions, np.float32)
    act = np.asarray(state.active)
    x = np.where(act, pos[..., 0], np.nan)
    z = np.where(act, pos[..., 2], np.nan)
    grid = np.float32(GRID)
    span_x = np.maximum((np.nanmax(x, 1) - np.nanmin(x, 1)) / grid,
                        np.float32(1e-6))
    span_z = np.maximum((np.nanmax(z, 1) - np.nanmin(z, 1)) / grid,
                        np.float32(1e-6))
    return grid * span_x * span_z


@pytest.mark.parametrize("flags,attr,value", [
    (["--action_primitives", "place", "drag"], "action_primitives",
     ["place", "drag"]),
    (["--conservative_grasp_radius", "2"], "conservative_grasp_radius", 2),
    (["--no-use_adaptive_scaling"], "use_adaptive_scaling", False),
    (["--reach_distance_limit", "0.9"], "reach_distance_limit", 0.9)])
def test_apply_presets_accepts_the_action_space(flags, attr, value):
    args = apply_presets(config_parser().parse_args(flags))
    assert getattr(args, attr) == value


@needs_jax
def test_run_sim_trains_one_net_per_primitive(tmp_path):
    """2 rounds with --action_primitives place drag: uniform value maps
    (value exploration 1) pick each env's primitive at random, so both
    datasets fill and both nets train on their own transitions."""
    h5 = write_grid_tasks(str(tmp_path / "tasks.hdf5"),
                          ((12, 10), (11, 12), (10, 11), (12, 12)),
                          np.random.default_rng(0))
    npz = str(tmp_path / "tasks.npz")
    export(h5, npz)
    log = str(tmp_path / "log")
    policy, history = run_sim.main(
        ["--device", "cpu", "--num_envs", "4", "--max_grid_dim", "12",
         "--render_dim", "64", "--num_rotations", "2", "--scale_factors",
         "1.0", "--substeps", "2", "--iterations", "2",
         "--contact_iterations", "1", "--contact_window", "4",
         "--tasks", npz, "--log", log, "--episode_length", "1",
         "--warmup", "0", "--batch_size", "2", "--value_expl_prob", "1",
         "--value_expl_decay", "1", "--action_primitives", "place", "drag",
         "--reach_distance_limit", "1.0", "--conservative_grasp_radius",
         "0"], max_rounds=2)
    assert list(policy.nets) == ["place", "drag"]
    assert all(ns.steps >= 1 for ns in policy.nets.values())
    assert set(history[-1]["losses"]) == {"place", "drag"}
    assert all(np.isfinite(v) for v in history[-1]["losses"].values())
    replay = os.path.join(log, "replay_buffer")
    steps = [read_step(replay, k)[0] for k in step_keys(replay)]
    assert {s["action_primitive"] for s in steps} == {"place", "drag"}
    # without the fling the env's 2 rotations span a full turn
    assert {float(s["rotation"]) for s in steps} <= {-180.0, 0.0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_mixed_step_matches_cpu(cuda_device):
    """4 flat cloths, env i steered to primitive i: the selection from one
    observation, then 3 interpreter steps (a jump and 2 sim frames) on the
    card through the kernels and on the CPU plain path; positions agree
    to 1e-4 m, the card-vs-CPU frame gate of chip_smoke."""
    from flingbot_tpu_torch.env.scene import flat_tasks, make_batch

    rng = np.random.default_rng(0)
    T, D = NUM_ROT * len(SCALES), OBS["obs_dim"]
    vm = rng.uniform(size=(4, len(PRIMS), T, D, D)).astype(np.float32)
    vm[np.arange(4), np.arange(4)] += 10.0
    runs = []
    obs = None
    for dev in ("cpu", cuda_device):
        topo, state = make_batch(flat_tasks(DIMS), max_grid_dim=MAX_DIM,
                                 device=dev)
        env = BatchSimEnv(obs_dim=D, num_rotations=NUM_ROT,
                          scale_factors=tuple(SCALES),
                          render_dim=OBS["image_size"],
                          domain_randomization=False,
                          action_primitives=PRIMS, device=dev, **PIX)
        env.reset(state, topo)
        if obs is None:
            obs = env.obs
        sel, _, _, carry, prog = step_begin(
            env.state, torch.from_numpy(vm).to(dev),
            Observation(*(x.to(dev) for x in obs)), env.rotations,
            env.prim_cfg, env.pix_grasp_dist, PRIMS, env.pix_drag_dist,
            env.pix_place_dist)
        carry, _ = tprim.program_chunk(carry, env.topo, env.params, prog,
                                       chunk_steps=3, sim_kw=env.sim_kw)
        runs.append((sel, carry))
    (csel, ccarry), (gsel, gcarry) = runs
    for f in INT_FIELDS:
        assert torch.equal(getattr(gsel, f).cpu(), getattr(csel, f)), f
    assert csel.prim_idx.tolist() == [0, 1, 2, 3]
    assert torch.equal(gcarry.pc.cpu(), ccarry.pc)
    assert ccarry.total_steps.tolist() == [2, 2, 2, 2]
    err = float((gcarry.state.positions.cpu()
                 - ccarry.state.positions).abs().max())
    assert err <= 1e-4, err
