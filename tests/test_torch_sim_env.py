"""The single-env path of flingbot_tpu_torch held against flingbot_tpu:
SimEnv's reset and one step against the JAX SimEnv, frame recording in
the interpreter against the JAX run_program, BatchSimEnv's per-env frame
lists and episode videos across a reload, the webm writer, the B = 1
policy wrappers and the faces-free render.

Small cloths (14-16 particles a side on a 16 lattice), a cheap solver
(2 substeps x 2 iterations); the SimEnv and recording cases run without
self-collision (the JAX SimEnv's reset settles at solver.step's contact
defaults whatever its own, and contacts are held by the batch tests and
the batch env case here).  Tolerances: selection fields, frame counts
and the depth buffer exact; settled positions 1e-5 m and init coverage
1e-5 m^2 (as tests/test_torch_episodes.py); the observations (a warp of
renders of positions 1e-8 m apart: 2.4e-6 measured) and recorded frames
1e-5; pre-action coverage COVERAGE_RTOL; post-action coverage rtol 0.6
(the slice tests' JAX-vs-JAX spread under 1e-7 input noise); shading
1e-6."""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flingbot_tpu.engine.state import ClothState as JState
from flingbot_tpu.engine.state import SolverParams as JParams
from flingbot_tpu.engine.topology import build_grid_topology as jax_topology
from flingbot_tpu.engine.topology import grid_positions
from flingbot_tpu.env.action import select_action as jax_select
from flingbot_tpu.env.primitives import PROGRAM_BUILDERS as JBUILDERS
from flingbot_tpu.env.primitives import PrimitiveConfig as JConfig
from flingbot_tpu.env.primitives import run_program
from flingbot_tpu.env.sim_env import SimEnv as JSimEnv
from flingbot_tpu.env.tasks import TaskLoader as JLoader
from flingbot_tpu.render import rasterizer as jr
from flingbot_tpu_torch.engine.state import ClothState, SolverParams
from flingbot_tpu_torch.engine.topology import build_grid_topology
from flingbot_tpu_torch.env import primitives as tprim
from flingbot_tpu_torch.env.batch_env import BatchSimEnv
from flingbot_tpu_torch.env.sim_env import (
    SimEnv, render_frames, write_episode_video)
from flingbot_tpu_torch.env.tasks import SEQ_SIM_KW, TaskLoader
from flingbot_tpu_torch.learning.memory import read_step, step_keys
from flingbot_tpu_torch.learning.nets import MaximumValuePolicy
from flingbot_tpu_torch.render import rasterizer as tr
from tests.test_torch_common import (
    COVERAGE_RTOL, canonical, port_state, write_grid_tasks)
from tools.export_tasks_npz import export

torch.set_num_threads(2)

DIMS = ((15, 14), (14, 12), (16, 12), (12, 15))
MAX_DIM = 16
CHEAP = dict(substeps=2, iterations=2, self_collision=False)
COMMON = dict(obs_dim=32, num_rotations=4, scale_factors=(1.0, 1.5),
              render_dim=128, max_grid_dim=MAX_DIM, pix_grasp_dist=4,
              domain_randomization=False, episode_length=1, **CHEAP)
SEL_FIELDS = ("transform_idx", "row", "col", "rotation", "scale",
              "p1_grasp", "p2_grasp", "valid")


@pytest.fixture(scope="module")
def task_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim_env")
    h5 = write_grid_tasks(str(d / "tasks.hdf5"), DIMS,
                          np.random.default_rng(0))
    export(h5, str(d / "tasks.npz"))
    return h5, str(d / "tasks.npz"), d


@pytest.fixture(scope="module")
def one_step(task_files):
    """A port SimEnv and a JAX SimEnv reset on the same first task; the
    JAX env then takes the port's settled state, and both step once on
    the same value maps (episodes of 1 step: the step ends the episode,
    dumps it and resets onto the second task)."""
    h5, npz, d = task_files
    env = SimEnv(TaskLoader(npz).get_next_task,
                 replay_buffer_path=str(d / "replay"), device="cpu",
                 **COMMON)
    jenv = JSimEnv(JLoader(h5).get_next_task,
                   replay_buffer_path=str(d / "jax_replay.hdf5"), **COMMON)
    obs = env.reset()
    jobs = jenv.reset()
    reset = dict(obs=obs.numpy(), jobs=np.asarray(jobs),
                 init=env.init_coverage, jinit=jenv.init_coverage,
                 pos=canonical(env.state.positions, env.topo,
                               jenv.state.positions[None])[0],
                 jpos=np.asarray(jenv.state.positions))
    settled = env.state
    jenv.state = jenv.state.replace(positions=jnp.asarray(
        canonical(settled.positions, env.topo,
                  jenv.state.positions[None])[0]), velocities=jnp.asarray(
        canonical(settled.velocities, env.topo,
                  jenv.state.velocities[None])[0]))
    jenv.obs = jenv._observe()
    T, D = 8, COMMON["obs_dim"]
    vm = np.random.default_rng(3).uniform(size=(1, T, D, D)).astype(
        np.float32)
    jsel = jax_select(jnp.asarray(vm), jenv.obs, jnp.asarray(
        jenv.rotations), primitives=("fling",), pix_grasp_dist=4)
    env.step(torch.from_numpy(vm))
    last = env.env.last
    jenv.step(vm)
    return dict(env=env, jenv=jenv, reset=reset, sel=last.selection,
                jsel=jsel, replay=str(d / "replay"),
                jreplay=str(d / "jax_replay.hdf5"))


def test_reset_matches(one_step):
    """Init coverage, the settled cloth and the observation after
    reset()."""
    r = one_step["reset"]
    np.testing.assert_allclose(r["pos"], r["jpos"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(r["init"], r["jinit"], rtol=0, atol=1e-5)
    assert r["obs"].shape == r["jobs"].shape == (8, 4, 32, 32)
    np.testing.assert_allclose(r["obs"], r["jobs"], rtol=0, atol=1e-5)


def test_step_matches(one_step):
    """The selection (exact), pre-action coverage (COVERAGE_RTOL),
    post-action coverage (rtol 0.6) and the replay record's keys and
    values of one step."""
    r = one_step
    for f in SEL_FIELDS:
        np.testing.assert_array_equal(getattr(r["sel"], f).numpy()[0],
                                      np.asarray(getattr(r["jsel"], f)),
                                      err_msg=f)
    (key,) = step_keys(r["replay"])
    assert key == "000000000_step00_last"
    attrs, arrays = read_step(r["replay"], key)
    with h5py.File(r["jreplay"]) as f:
        (jkey,) = list(f.keys())
        g = f[jkey]
        jattrs = {k: g.attrs[k] for k in g.attrs}
        jarrays = {k: np.asarray(g[k]) for k in g.keys()}
    assert key == jkey
    assert set(attrs) == set(jattrs)
    assert set(arrays) == set(jarrays)
    for k in ("max_indices", "actions", "pretransform_pixels", "value_map",
              "cloth_size"):
        np.testing.assert_array_equal(arrays[k], jarrays[k], err_msg=k)
    for k in ("rotation", "scale", "task_name", "action_primitive"):
        assert attrs[k] == jattrs[k], k
    np.testing.assert_allclose(attrs["preaction_coverage"],
                               jattrs["preaction_coverage"],
                               rtol=COVERAGE_RTOL)
    np.testing.assert_allclose(attrs["postaction_coverage"],
                               jattrs["postaction_coverage"], rtol=0.6)
    for k in ("observations", "pretransform_observations"):
        np.testing.assert_allclose(arrays[k], jarrays[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    # the episode ended and the env reset onto the next task
    env = r["env"]
    assert env.episode_count == 1 and env.current_timestep == 0
    assert env.current_task.name == TaskLoader(
        os.path.join(os.path.dirname(r["replay"]), "tasks.npz")).keys[1]
    assert len(env.get_transformations()) == 8
    assert env.compute_coverage() == pytest.approx(env.init_coverage)
    assert not env.is_cloth_grasped()


# --------------------------------------------------------------------------
# frame recording
# --------------------------------------------------------------------------

D = 16
RECORD = dict(record_frames=64, record_every=4, max_steps=200)


def _flat_cloth():
    pos = grid_positions(D, D, lower=(0.0, 0.005, 0.0))
    pos[:, [0, 2]] -= pos[:, [0, 2]].mean(axis=0)
    return pos, D * D


def test_program_chunk_records_frames():
    """A fling program on a 16 x 16 cloth (tests/test_episode_video.py's
    case) through program_chunk and the JAX run_program, recording 64
    frames every 4 sim steps: the frame count exactly, the first frames
    to 1e-5 m, unrecorded slots zero; without recording nothing is
    allocated and the first chunk is bit-identical."""
    pos, n = _flat_cloth()
    inv = np.full(n, n / 0.2, np.float32)
    p1, p2 = pos[D // 2], pos[n - D // 2 - 1]
    jprog, jfh = JBUILDERS["fling"](jnp.asarray(p1), jnp.asarray(p2),
                                    jnp.float32(1), jnp.float32(1),
                                    JConfig(max_program_steps=200))
    _, _, jframes, jn = run_program(
        JState.create(pos, inv), jax_topology(D, D, max_dimx=D, max_dimy=D),
        JParams(), jprog, jnp.linalg.norm(jnp.asarray(p1 - p2)), jfh,
        **CHEAP, **RECORD)
    jn = int(jn)

    def port(record_frames, max_steps=RECORD["max_steps"]):
        state = ClothState.create(pos, inv, device="cpu")
        topo = build_grid_topology(D, D, max_dimx=D, max_dimy=D,
                                   device="cpu")
        t1 = torch.as_tensor(p1)[None]
        t2 = torch.as_tensor(p2)[None]
        g = torch.ones(1, dtype=torch.bool)
        prog, fh = tprim.build_fling_program(t1, t2, g, g,
                                             tprim.PrimitiveConfig())
        carry = tprim.init_program_carry(
            state, torch.linalg.norm(t1 - t2, dim=1), fh, record_frames)
        done = False
        while not done:
            carry, d = tprim.program_chunk(
                carry, topo, SolverParams(), prog, chunk_steps=64,
                max_steps=max_steps, sim_kw=dict(SEQ_SIM_KW, **CHEAP),
                record_every=RECORD["record_every"])
            done = bool(d.all())
        return carry

    carry = port(RECORD["record_frames"])
    got = int(carry.frame_idx[0])
    assert 5 < jn <= 64
    assert got == jn
    frames = carry.frames[0].transpose(1, 2).numpy()  # (F, N, 3)
    np.testing.assert_allclose(frames[:4], np.asarray(jframes[:4]), rtol=0,
                               atol=1e-5)
    assert np.abs(frames[:got] - frames[0]).max() > 0.01
    assert float(np.abs(frames[got:]).max()) == 0.0
    plain, recorded = port(0, 64), port(8, 64)
    assert plain.frames is None
    for name in ("positions", "velocities"):
        torch.testing.assert_close(getattr(plain.state, name),
                                   getattr(recorded.state, name), rtol=0,
                                   atol=0)


def test_batch_env_frames_across_a_reload(task_files, tmp_path):
    """BatchSimEnv with dump_visualizations: each step adds the frames its
    sim steps imply (one every 8th, from the first) to each env's list;
    an episode's end writes {episodes_done:09d}_env{i}.webm with all of
    them and the reload clears the slot's list."""
    import cv2

    _, npz, _ = task_files
    replay = str(tmp_path / "replay")
    env = BatchSimEnv(get_task_fn=TaskLoader(npz).get_next_task,
                      num_envs=2, replay_buffer_path=replay,
                      max_program_steps=40, dump_visualizations=True,
                      device="cpu", **dict(COMMON, episode_length=2,
                                           self_collision=True),
                      contact_every=2, contact_iterations=1,
                      contact_window=4)
    assert env.record_frames == 256 and env.record_every == 8
    env.reset()
    vm = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(2, 1, 8, 32, 32)).astype(np.float32))
    implied = lambda: [-(-int(s) // 8) for s in env.last.sim_steps]  # noqa
    env.step(vm)
    first = implied()
    early = env.last.terminate.numpy()
    assert not early.any()
    assert [[len(c) for c in f] for f in env.frames] == [[k] for k in first]
    assert not os.path.exists(os.path.join(str(tmp_path), "visualizations"))
    env.step(vm)
    assert env.episodes_done == 2
    assert env.frames == [[], []]
    for i, total in enumerate(np.add(first, implied())):
        path = tmp_path / "visualizations" / f"{i:09d}_env{i}.webm"
        cap = cv2.VideoCapture(str(path))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == total, path


def test_webm_written_from_frames(tmp_path):
    """Two chunks of 8 frames of a translating cloth -> a 16-frame webm
    (tests/test_episode_video.py's writer case)."""
    import cv2

    pos, n = _flat_cloth()
    chunks = [np.stack([pos.T + np.array([[0.002 * i + off], [0], [0]])
                        for i in range(8)]).astype(np.float32)
              for off in (0.0, 0.016)]
    path = write_episode_video(chunks, torch.ones(n, dtype=torch.bool),
                               None, str(tmp_path / "v" / "ep.webm"))
    cap = cv2.VideoCapture(path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 16
    rgb = render_frames(chunks[0], torch.ones(n, dtype=torch.bool))
    assert rgb.dtype == np.uint8 and rgb.shape == (8, 256, 256, 3)
    assert len({f.tobytes() for f in rgb}) > 1


def test_value_maps_and_act_are_batch_value_maps_at_one_env():
    policy = MaximumValuePolicy(["fling", "drag"], 16, num_blocks=1,
                                device="cpu")
    obs = torch.rand(4, 4, 16, 16, generator=torch.Generator().manual_seed(0))
    want = policy.batch_value_maps(obs[None])[0]
    got = policy.value_maps(obs)
    assert list(got) == ["fling", "drag"]
    for i, k in enumerate(got):
        torch.testing.assert_close(got[k], want[i], rtol=0, atol=0)
    acts = policy.act([obs, obs])
    assert len(acts) == 2
    torch.testing.assert_close(acts[1]["drag"], want[1], rtol=0, atol=0)


def test_faces_free_render_matches():
    """render_rgbd without faces (7 x 7 disk stamps of radius 2.5 px)
    against the JAX branch on two crumpled cloths: the depth buffer
    exactly, shading to 1e-6."""
    from tests.test_torch_common import make_pair, stack

    rng = np.random.default_rng(0)
    jstates, _, _, topo = make_pair(((16, 16), (14, 12)), MAX_DIM, rng,
                                    height=0.02, noise=0.02)
    jstate = stack(jstates)
    S = 96
    rgb_j, depth_j = jax.vmap(lambda p, a: jr.render_rgbd(
        p, a, image_size=S))(jstate.positions, jstate.active)
    tstate = port_state(jstate, topo)
    rgb_t, depth_t = tr.render_rgbd(tstate.positions, tstate.active,
                                    image_size=S)
    np.testing.assert_array_equal(depth_t.numpy(), np.asarray(depth_j))
    assert (depth_t.numpy() < 2.0).sum() > 100
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-6)
