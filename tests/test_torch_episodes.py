"""Episodes of flingbot_tpu_torch's BatchSimEnv from a task file, held
against flingbot_tpu's BatchSimEnv on the same small tasks: the settled
start states and init coverage after reset() and after a reload, the
first step's action selection, the per-env timesteps, episodes_done and
the dumped replay keys; and the env's solver knobs (spring_mode,
self_collision) on the first frames of a step.

Both sides run a cheap solver config and, on the port, a truncated fling
program (max_program_steps, as tests/test_torch_slice.py): the production
knobs are covered per module by the other tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flingbot_tpu.env.batch_env import BatchSimEnv as JEnv
from flingbot_tpu.env.tasks import TaskLoader as JLoader
from flingbot_tpu_torch.env import primitives as tprim
from flingbot_tpu_torch.env.batch_env import BatchSimEnv
from flingbot_tpu_torch.env.sim_env import step_begin
from flingbot_tpu_torch.env.tasks import TaskLoader
from flingbot_tpu_torch.learning.memory import read_step, step_keys
from tests.test_torch_common import canonical, write_grid_tasks
from tools.export_tasks_npz import export

# no cloth fills the 16x16 lattice: the JAX package stacks per-env grid
# topologies, whose static full_grid flags must agree
DIMS = ((15, 14), (14, 12), (16, 12), (12, 15))
MAX_DIM = 16
CHEAP = dict(substeps=2, iterations=2, contact_every=2, contact_iterations=1,
             contact_window=4)
COMMON = dict(num_envs=2, obs_dim=32, num_rotations=4,
              scale_factors=(1.0, 1.5), render_dim=128, max_grid_dim=MAX_DIM,
              pix_grasp_dist=4, domain_randomization=False)
MAX_PROGRAM_STEPS = 40
SEL_FIELDS = ("transform_idx", "row", "col", "rotation", "scale",
              "p1_grasp", "p2_grasp", "valid")


@pytest.fixture(scope="module")
def task_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("episodes")
    h5 = write_grid_tasks(str(d / "tasks.hdf5"), DIMS,
                          np.random.default_rng(0))
    export(h5, str(d / "tasks.npz"))
    return h5, str(d / "tasks.npz"), d


def port_env(npz, replay=None, **kw):
    loader = TaskLoader(npz)
    return BatchSimEnv(get_task_fn=loader.get_next_task,
                       replay_buffer_path=replay, episode_length=2,
                       max_program_steps=MAX_PROGRAM_STEPS, device="cpu",
                       **COMMON, **kw)


def jax_env(h5, **kw):
    loader = JLoader(h5)
    return JEnv(get_task_fn=loader.get_next_task, action_primitives=["fling"],
                episode_length=2, contact_mode="sort", **COMMON, **kw)


def assert_states_close(env, jenv, slots, atol_p=1e-5, atol_v=1e-3):
    """The port's slots against the JAX env's slots (canonical order)."""
    js = jenv.state
    for name, atol in (("positions", atol_p), ("velocities", atol_v)):
        got = canonical(getattr(env.state, name), env.topo,
                        getattr(js, name))
        np.testing.assert_allclose(got[slots], np.asarray(
            getattr(js, name))[: len(slots)], rtol=0, atol=atol,
            err_msg=name)
    np.testing.assert_allclose(env.init_coverage.numpy()[slots],
                               jenv.init_coverage[: len(slots)],
                               rtol=0, atol=1e-5)


def test_episodes_and_reload_match(task_files):
    h5, npz, d = task_files
    replay = str(d / "replay")
    env = port_env(npz, replay, **CHEAP)
    jenv = jax_env(h5, spring_mode="chebyshev", **CHEAP)
    obs = env.reset()
    jenv.reset()
    assert [x.name for x in env.tasks] == [x.name for x in jenv.tasks]
    assert_states_close(env, jenv, [0, 1])
    assert obs.shape == (2, 8, 4, 32, 32)
    np.testing.assert_array_equal(env.timesteps, [0, 0])
    assert [len(m.data["pretransform_observations"])
            for m in env.memories] == [1, 1]

    # the first step's action selection, from the same value maps
    vm = np.random.default_rng(1).uniform(
        size=(2, 1, 8, 32, 32)).astype(np.float32)
    jsel = jenv._vm_begin(jenv.state, jenv.topo, jenv.params,
                          jnp.asarray(vm), jenv.obs,
                          jnp.asarray(jenv.rotations))[0]
    env.step(torch.from_numpy(vm))
    sel = env.last.selection
    for f in SEL_FIELDS:
        np.testing.assert_array_equal(getattr(sel, f).numpy(),
                                      np.asarray(getattr(jsel, f)), err_msg=f)
    early = env.last.terminate.numpy()
    np.testing.assert_array_equal(env.timesteps, np.where(early, 0, 1))
    assert env.episodes_done == int(early.sum())

    env.step(torch.from_numpy(vm))
    assert env.episodes_done == 2
    assert env.episodes_terminated == int(early.sum()) + int(
        env.last.terminate.numpy()[~early].sum())
    keys = step_keys(replay)
    assert keys == ["000000000_step00", "000000000_step01_last",
                    "000000001_step00", "000000001_step01_last"]
    assert sum(k.endswith("_last") for k in keys) == env.episodes_done
    attrs, arrays = read_step(replay, keys[0])
    assert attrs["task_difficulty"] == "hard"
    assert attrs["action_primitive"] == "fling"
    for k in ("observations", "actions", "pretransform_observations",
              "next_observations", "max_indices", "pretransform_pixels",
              "cloth_size", "cloth_stiff"):
        assert k in arrays, k
    assert arrays["pretransform_observations"].shape == (4, 128, 128)
    assert arrays["actions"].sum() == 1.0

    # the reloaded slots hold the next tasks of the file, settled as the
    # JAX env's reset() settles them (these tasks run both steps)
    assert not early.any()
    assert [x.name for x in env.tasks] == TaskLoader(npz).keys[2:4]
    np.testing.assert_array_equal(env.timesteps, [0, 0])
    assert [len(m) for m in env.memories] == [0, 0]
    jenv.reset()  # its loader serves tasks 3 and 4 now
    assert_states_close(env, jenv, [0, 1])


def test_env_knobs_reach_the_solver(task_files):
    """spring_mode="jacobi", self_collision=False through both envs: the
    settle frame of reset() and the first frames of a step's fling
    program, at the tolerances of tests/test_torch_jacobi.py."""
    h5, npz, _ = task_files
    knobs = dict(spring_mode="jacobi", self_collision=False, substeps=4,
                 iterations=4)
    env = port_env(npz, **knobs)
    jenv = jax_env(h5, backend="pallas", chunk_steps=1, **knobs)
    env.reset()
    jenv.reset()
    assert env.sim_kw["spring_mode"] == "jacobi"
    assert env.sim_kw["self_collision"] is False
    assert_states_close(env, jenv, [0, 1])

    # a step's first frames from the port's settled state on both sides
    jenv.state = jenv.state.replace(
        positions=jnp.asarray(canonical(env.state.positions, env.topo,
                                        jenv.state.positions)),
        velocities=jnp.asarray(canonical(env.state.velocities, env.topo,
                                         jenv.state.velocities)))
    jenv._observe()
    vm = np.random.default_rng(2).uniform(
        size=(2, 1, 8, 32, 32)).astype(np.float32)
    _, _, _, jcarry, jprog = jenv._vm_begin(
        jenv.state, jenv.topo, jenv.params, jnp.asarray(vm), jenv.obs,
        jnp.asarray(jenv.rotations))
    _, _, _, carry, prog = step_begin(
        env.state, torch.from_numpy(vm), env.obs, env.rotations,
        env.prim_cfg, env.pix_grasp_dist)
    moved = 0.0
    for _ in range(6):
        jcarry, _ = jenv._vm_chunk(jcarry, jenv.topo, jenv.params, jprog)
        carry, _ = tprim.program_chunk(
            carry, env.topo, env.params, prog, chunk_steps=1,
            max_steps=MAX_PROGRAM_STEPS + tprim.STABLE_MAX_STEPS,
            sim_kw=env.sim_kw)
        np.testing.assert_array_equal(carry.pc.numpy(),
                                      np.asarray(jcarry.pc))
        got = canonical(carry.state.positions, env.topo,
                        jcarry.state.positions)
        np.testing.assert_allclose(got, np.asarray(jcarry.state.positions),
                                   rtol=0, atol=1e-5)
        moved = max(moved, float(np.abs(
            got - canonical(env.state.positions, env.topo,
                            jcarry.state.positions)).max()))
    assert moved > 1e-4  # the frames did move the cloth


def test_unknown_spring_mode_raises():
    with pytest.raises(ValueError, match="spring_mode"):
        BatchSimEnv(spring_mode="sor", device="cpu")


def test_step_in_parts_equals_step(task_files, tmp_path):
    """BatchSimEnv.step is begin_step, run_program chunks and end_step:
    driven by hand from the same start, the parts give step()'s state,
    observation, step record and replay Memory (exactly: one CPU, one
    seed)."""
    _, npz, _ = task_files
    envs = [port_env(npz, replay=str(tmp_path / f"replay{i}"),
                     chunk_steps=16, **CHEAP) for i in range(2)]
    vm = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(2, 1, 8, 32, 32)).astype(np.float32))
    for env in envs:
        env.reset()
    whole = envs[0].step(vm)
    env = envs[1]
    start = env.begin_step(vm)
    assert torch.equal(env.state.positions, start.pre_positions)
    carry, chunks = start.carry, 0
    while True:
        carry, done = env.run_program(start, carry, 16)
        chunks += 1
        if bool(done.all()):
            break
    parts = env.end_step(start, carry, chunks)
    assert torch.equal(whole, parts)
    assert torch.equal(envs[0].state.positions, env.state.positions)
    a, b = envs[0].last, env.last
    assert a.chunks == b.chunks == chunks
    for x, y in zip(tuple(a.selection) + tuple(a[1:5]),
                    tuple(b.selection) + tuple(b[1:5])):
        assert torch.equal(x, y)
    assert list(envs[0].timesteps) == list(env.timesteps) == [1, 1]
    for m0, m1 in zip(envs[0].memories, env.memories):
        assert len(m0) == len(m1) == 1
