"""The port's task generation (flingbot_tpu_torch.env.tasks
generate_tasks_batch and its pieces) held against the JAX package's
generator on the CPU.

The JAX side runs the XLA mirror of the production path (backend "xla",
spring_mode "chebyshev", contact_mode "sort", contacts every 2nd substep),
as tests/test_torch_step.py does, at the generator's step keywords: 30
spring iterations, contacts 8 x window 16.  Cloths of 16-24 particles on
a 24 lattice.  Tolerances:
  - drawn fields (keys, sizes, stiffness, mass, difficulty, picks,
    heights, displacements): bit-equal;
  - flatten area: COVERAGE_RTOL (XLA:CPU rounds the JAX coverage with the
    host, tools/host_rounding.py);
  - the anchor's path: 1e-6 m per frame (the sweep fraction is a float32
    division by a constant, which XLA:CPU may compute through the
    reciprocal);
  - positions 1e-5 m and velocities 1e-3 m/s after 2 frames
    (test_pallas.py:233,268-270, as tests/test_torch_step.py);
  - settled envs: bit-unchanged.
The card test reads data_r3/rect_eval_large_64.npz and needs neither jax
nor h5py."""

import functools
import os

import numpy as np
import pytest
import torch

from flingbot_tpu_torch.engine.state import SolverParams
from flingbot_tpu_torch.env import tasks as ttasks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LARGE = os.path.join(ROOT, "data_r3", "rect_eval_large_64.npz")
SIZES = dict(min_cloth_size=16, max_cloth_size=24,
             strict_min_edge_length=20)
LATTICE = 24
TINY = (1, 0, 1, 2)  # sweep, hold, settle, tosses
# chip_smoke's card-vs-CPU frame gate: FRAME_TOL m, or NOISE_FACTOR times
# the CPU frame's own move under NOISE relative input noise
FRAME_TOL, NOISE, NOISE_FACTOR = 1e-4, 1e-7, 2.0

torch.set_num_threads(2)


def jax_modules():
    """The JAX package's generator module and the test helpers (imported
    here: the card test must run where jax is missing)."""
    import jax.numpy as jnp

    from flingbot_tpu.env import tasks as jtasks
    from tests import test_torch_common as common
    return jnp, jtasks, common


def jax_sim_kw():
    return dict(substeps=4, iterations=30, self_collision=True,
                backend="xla", spring_mode="chebyshev", contact_mode="sort",
                contact_every=2)


def port_draws(seed, batch, difficulty, batches=1):
    """The port's draws of `batches` generator batches from one seed."""
    rng = np.random.default_rng(seed)
    return [ttasks.draw_batch(rng, batch, SIZES["min_cloth_size"],
                              SIZES["max_cloth_size"],
                              SIZES["strict_min_edge_length"], difficulty,
                              TINY[3])
            for _ in range(batches)]


def jax_batch(draw):
    """The JAX generator's start states of a draw (ClothState.create of
    the flat cloths, tasks.py:839-866), batched, with stacked topologies,
    and the port's flat_batch of the same draw."""
    jnp, _, common = jax_modules()
    from flingbot_tpu.engine.state import ClothState as JState
    from flingbot_tpu.engine.topology import build_grid_topology

    states, topos = [], []
    for (dx, dy), flat, stiff, mass in zip(draw.dims, draw.flats,
                                           draw.stiffs, draw.masses):
        n = dx * dy
        states.append(JState.create(flat, np.full(n, n / mass, np.float32),
                                    capacity=LATTICE * LATTICE))
        # traced-style dims: no full_grid fast path, so topologies stack
        topos.append(build_grid_topology(
            jnp.int32(dx), jnp.int32(dy),
            stiffness=tuple(float(s) for s in stiff),
            max_dimx=LATTICE, max_dimy=LATTICE))
    topo, state = ttasks.flat_batch(draw, LATTICE, "cpu")
    return common.stack(states), common.stack(topos), state, topo


def assert_close(state, topo, jstate, atol_p=1e-5, atol_v=1e-3):
    _, _, common = jax_modules()
    for name, atol in (("positions", atol_p), ("velocities", atol_v)):
        got = common.canonical(getattr(state, name), topo,
                               getattr(jstate, name))
        np.testing.assert_allclose(got, np.asarray(getattr(jstate, name)),
                                   rtol=0, atol=atol, err_msg=name)


def canonical_inv_mass(state, topo, jstate):
    _, _, common = jax_modules()
    return common.canonical(state.inv_mass[:, None], topo,
                            jstate.inv_mass[:, :, None])[..., 0]


def anchor(state, slot):
    return state.positions[torch.arange(state.batch), :, slot].numpy()


# --------------------------------------------------------------------------
# (a) the draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("difficulty", ["hard", "easy"])
def test_drawn_fields_equal_jax(difficulty, tmp_path, monkeypatch):
    """Two batches of 3 (5 tasks) from one seed on both sides.  The JAX
    generator runs with its step replaced by the identity and its chunk
    functions by recorders that write the drawn pick, lift height and
    start x (hard) or picks and displacements (easy) into the first
    velocity rows, which the task file keeps; the port runs its real
    generator on a 1-frame schedule."""
    import h5py

    jnp, jtasks, common = jax_modules()

    def no_step(st, tp, params, **kw):
        return st

    def record_anchor(st, tp, idx, p0, p1, s0, **kw):
        rec = jnp.stack([idx.astype(jnp.float32), p1[1], p0[0]])
        return st.replace(velocities=st.velocities.at[0].set(rec))

    def record_tosses(st, tp, idxs, disps, p0, p1, saved_w, s0, **kw):
        v = st.velocities.at[0, :idxs.shape[0]].set(
            idxs.astype(jnp.float32))
        v = v.at[1:1 + disps.shape[0]].set(disps)
        return st.replace(velocities=v), p0, p1, saved_w

    monkeypatch.setattr(jtasks, "solver_step", no_step)
    monkeypatch.setattr(jtasks, "_anchored_chunk", record_anchor)
    monkeypatch.setattr(jtasks, "_toss_chunk", record_tosses)
    kw = dict(batch=3, seed=4, task_difficulty=difficulty,
              max_grid_dim=LATTICE, schedule=TINY, log=False, **SIZES)
    h5 = str(tmp_path / "jax.hdf5")
    npz = str(tmp_path / "port.npz")
    assert jtasks.generate_tasks_batch(h5, 5, **kw) == 5
    assert ttasks.generate_tasks_batch(npz, 5, device="cpu", **kw) == 5

    # the dims rejection ran: a drawn pair had both edges under the strict
    # minimum (the JAX loop, tasks.py:826-837, replayed on seed 4)
    rng, rejected, kept = np.random.default_rng(4), 0, 0
    while kept < 3:
        dx, dy = (int(rng.integers(16, 24)) for _ in range(2))
        if dx < 20 and dy < 20:
            rejected += 1
            continue
        kept += 1
        rng.uniform(0.85, 0.95, 3), rng.uniform(0.2, 2.0)
    assert rejected > 0

    draws = port_draws(4, 3, difficulty, batches=2)
    order = [(d, j) for d in draws for j in range(3)][:5]
    port = ttasks.read_task_arrays(npz)
    with h5py.File(h5, "r") as f:
        assert sorted(f) == sorted(port) == sorted(
            ttasks.task_key(i) for i in range(5))
        for i, (draw, j) in enumerate(order):
            g, a = f[ttasks.task_key(i)], port[ttasks.task_key(i)]
            for name in ("cloth_size", "cloth_stiff", "shape_pos",
                         "phase") + ttasks.MESH_KEYS:
                want = np.asarray(g[name])
                assert a[name].dtype == want.dtype, name
                np.testing.assert_array_equal(a[name], want, err_msg=name)
            np.testing.assert_array_equal(a["cloth_size"], draw.dims[j])
            np.testing.assert_array_equal(a["cloth_stiff"], draw.stiffs[j])
            for name in ("cloth_mass", "task_difficulty", "flip_mesh"):
                want = np.asarray(g.attrs[name])
                assert a["@" + name][()] == want[()], name
                assert a["@" + name].dtype.kind == want.dtype.kind, name
            assert float(a["@cloth_mass"]) == draw.masses[j]
            np.testing.assert_allclose(
                float(a["@flatten_area"]), g.attrs["flatten_area"],
                rtol=common.COVERAGE_RTOL, atol=0)
            n = int(np.prod(draw.dims[j]))
            assert a["particle_pos"].shape == (4 * n,)
            assert a["particle_pos"].dtype == np.float32
            assert a["particle_vel"].shape == (3 * n,)
            rec = np.asarray(g["particle_vel"]).reshape(-1, 3)
            if difficulty == "hard":
                np.testing.assert_array_equal(
                    rec[0], [draw.picks[j], draw.targets[j][1],
                             draw.starts[j][0]])
                np.testing.assert_array_equal(
                    draw.starts[j], draw.flats[j][draw.picks[j]])
            else:
                np.testing.assert_array_equal(rec[0, :2], draw.picks[j])
                np.testing.assert_array_equal(rec[1:3], draw.targets[j])
                assert (draw.targets[j][:, 1] == np.float32(0.2)).all()


# --------------------------------------------------------------------------
# (b)-(d) the schedule's pieces, 1-2 frames against the JAX chunks
# --------------------------------------------------------------------------

def test_anchored_chunk_matches_jax():
    """The frames s = 3 (sweep, fraction 3/4) and s = 4 (hold) of a
    4-frame sweep: the anchor is set before each step, at rest, with its
    inverse mass pinned to 0.  The target is 1 cm above the start, so the
    anchor moves at most 7.5 mm in a frame, as fast as the production
    sweep's fastest (1.5 m in 200 frames).  Faster, the frame turns
    ill-conditioned: with a 2 cm target the JAX frame alone moves by up
    to 2.9e-5 m under 1e-7 relative input noise."""
    import jax

    jnp, jtasks, _ = jax_modules()
    from flingbot_tpu.engine.state import SolverParams as JParams

    draw = port_draws(3, 2, "hard")[0]
    jstate, jtopo, state, topo = jax_batch(draw)
    idx = np.asarray(draw.picks)
    slot = ttasks.lattice_slot(torch.tensor(idx), topo.dimx, LATTICE)
    p0 = np.stack(draw.starts)
    p1 = p0 + np.float32([0.0, 0.01, 0.0])
    jstate = jstate.replace(inv_mass=jax.vmap(
        lambda w, i: w.at[i].set(0.0))(jstate.inv_mass, jnp.asarray(idx)))
    state = ttasks.set_inv_mass(state, slot, torch.zeros(2))
    np.testing.assert_array_equal(
        canonical_inv_mass(state, topo, jstate), np.asarray(jstate.inv_mass))
    assert_close(state, topo, jstate, 0.0, 0.0)
    f = jax.jit(jax.vmap(functools.partial(
        jtasks._anchored_chunk, n_steps=1, sweep_steps=4, params=JParams(),
        sim_kw=jax_sim_kw()), in_axes=(0, 0, 0, 0, 0, None)))
    for s0 in (3, 4):
        jstate = f(jstate, jtopo, jnp.asarray(idx), jnp.asarray(p0),
                   jnp.asarray(p1), jnp.int32(s0))
        state = ttasks.anchored_chunk(
            state, topo, slot, torch.tensor(p0), torch.tensor(p1), s0,
            n_steps=1, sweep_steps=4, params=SolverParams(),
            sim_kw=ttasks.GEN_SIM_KW)
        want = np.asarray(jstate.positions)[np.arange(2), idx]
        np.testing.assert_allclose(anchor(state, slot), want, rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(anchor(state, slot), p1, rtol=0, atol=1e-6)
    assert_close(state, topo, jstate)
    assert float(state.positions[:, 1].max()) > 0.01


def test_toss_chunk_matches_jax():
    """Frames 0-2 of tosses of 2 frames: entry (record the inverse mass,
    start and target; pin), exit (restore after the step), and the next
    toss's entry.  Env 0 tosses the same particle twice, so its second
    entry must read the restored inverse mass.  Displacements of 1 cm."""
    import jax

    jnp, jtasks, _ = jax_modules()
    from flingbot_tpu.engine.state import SolverParams as JParams

    draw = port_draws(5, 2, "easy")[0]
    jstate, jtopo, state, topo = jax_batch(draw)
    idxs = np.stack(draw.picks).copy()
    idxs[0, 1] = idxs[0, 0]
    disps = np.random.default_rng(0).uniform(
        -0.01, 0.01, idxs.shape + (3,)).astype(np.float32)
    slots = ttasks.lattice_slot(torch.tensor(idxs.astype(np.int64)),
                                topo.dimx[:, None], LATTICE)
    f = jax.jit(jax.vmap(functools.partial(
        jtasks._toss_chunk, n_steps=1, sweep_steps=2, params=JParams(),
        sim_kw=jax_sim_kw()), in_axes=(0, 0, 0, 0, 0, 0, 0, None)))
    jcarry = (jstate, jnp.zeros((2, 3)), jnp.zeros((2, 3)), jnp.zeros(2))
    carry = (state, torch.zeros(2, 3), torch.zeros(2, 3), torch.zeros(2))
    w0 = canonical_inv_mass(state, topo, jstate)
    b = np.arange(2)
    for s0 in (0, 1, 2):
        jcarry = f(jcarry[0], jtopo, jnp.asarray(idxs), jnp.asarray(disps),
                   *jcarry[1:], jnp.int32(s0))
        carry = ttasks.toss_chunk(
            carry[0], topo, slots, torch.tensor(disps), *carry[1:], s0,
            n_steps=1, sweep_steps=2, params=SolverParams(),
            sim_kw=ttasks.GEN_SIM_KW)
        w = canonical_inv_mass(carry[0], topo, jcarry[0])
        np.testing.assert_array_equal(w, np.asarray(jcarry[0].inv_mass))
        np.testing.assert_array_equal(carry[3].numpy(),
                                      np.asarray(jcarry[3]))
        for k in (1, 2):
            np.testing.assert_allclose(carry[k].numpy(),
                                       np.asarray(jcarry[k]), rtol=0,
                                       atol=1e-6)
        t = s0 // 2
        np.testing.assert_allclose(
            anchor(carry[0], slots[:, t]),
            np.asarray(jcarry[0].positions)[b, idxs[:, t]], rtol=0,
            atol=1e-6)
        if s0 == 1:  # after the exit step: toss 0's particles restored
            np.testing.assert_array_equal(w, w0)
        else:  # a toss in progress: its particle pinned
            np.testing.assert_array_equal(w[b, idxs[:, t]], 0.0)
        np.testing.assert_array_equal(carry[3].numpy(),
                                      w0[b, idxs[:, t]])
        if s0 >= 1:
            assert_close(carry[0], topo, jcarry[0])


def test_settle_chunk_keeps_settled_envs():
    """Two settle frames: env 0 lies flat at rest (max speed 0, below the
    tolerance) and must come out bit-unchanged with k = 0; env 1 starts
    2 cm up with a seeded velocity field and steps twice."""
    import jax

    jnp, jtasks, common = jax_modules()
    from flingbot_tpu.engine.state import SolverParams as JParams

    draw = port_draws(9, 2, "hard")[0]
    jstate, jtopo, _, topo = jax_batch(draw)
    rng = np.random.default_rng(1)
    pos = np.asarray(jstate.positions).copy()
    vel = np.zeros_like(pos)
    act = np.asarray(jstate.active)
    pos[1, act[1], 1] += 0.02
    vel[1, act[1]] = rng.normal(0.0, 0.05, (act[1].sum(), 3))
    jstate = jstate.replace(positions=jnp.asarray(pos),
                            velocities=jnp.asarray(vel, jnp.float32))
    state = common.port_state(jstate, topo)
    f = jax.jit(jax.vmap(functools.partial(
        jtasks._settle_chunk, n_steps=2, max_settle=300,
        tol=ttasks.SETTLE_TOL, params=JParams(), sim_kw=jax_sim_kw()),
        in_axes=(0, 0, 0)))
    jout, jk, jv = f(jstate, jtopo, jnp.zeros(2, jnp.int32))
    out, k, v = ttasks.settle_chunk(
        state, topo, torch.zeros(2, dtype=torch.int64), n_steps=2,
        max_settle=300, tol=ttasks.SETTLE_TOL, params=SolverParams(),
        sim_kw=ttasks.GEN_SIM_KW)
    assert k.tolist() == np.asarray(jk).tolist() == [0, 2]
    for name, a in out.fields().items():
        assert torch.equal(a[0], getattr(state, name)[0]), name
    assert_close(out, topo, jout)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-3)
    assert float(v[1]) >= ttasks.SETTLE_TOL


# --------------------------------------------------------------------------
# (e)-(g) the archive, the env, the refusals
# --------------------------------------------------------------------------

def test_resume_stops_exactly_at_num_tasks(tmp_path):
    """As tests/test_task_generation.py: 3 tasks, then resumed to 5.  The
    first 3 stay as they were; the resumed draws restart from seed + 3."""
    path = str(tmp_path / "exact.npz")
    kw = dict(batch=2, seed=11, task_difficulty="easy",
              max_grid_dim=LATTICE, schedule=TINY, log=False, device="cpu",
              **SIZES)
    assert ttasks.generate_tasks_batch(path, 3, **kw) == 3
    first = ttasks.read_task_arrays(path)
    assert len(first) == 3
    assert ttasks.generate_tasks_batch(path, 5, **kw) == 5
    after = ttasks.read_task_arrays(path)
    assert sorted(after) == sorted(ttasks.task_key(i) for i in range(5))
    for key, arrays in first.items():
        for name, a in arrays.items():
            np.testing.assert_array_equal(after[key][name], a)
    resumed = port_draws(11 + 3, 2, "easy")[0]
    assert [tuple(after[ttasks.task_key(i)]["cloth_size"])
            for i in (3, 4)] == resumed.dims
    assert not os.path.exists(path + ".tmp")


def test_port_archive_loads_into_the_env(tmp_path):
    """A port-made archive read by TaskLoader and reset by BatchSimEnv on
    the CPU: the scene holds the archive's particles, and the set's
    statistics come out of generate_sets.set_stats."""
    from flingbot_tpu_torch.env.batch_env import BatchSimEnv
    from flingbot_tpu_torch.generate_sets import set_stats

    path = str(tmp_path / "tasks.npz")
    ttasks.generate_tasks_batch(path, 2, batch=2, seed=2,
                                max_grid_dim=LATTICE, schedule=TINY,
                                log=False, device="cpu", **SIZES)
    loader = ttasks.TaskLoader(path)
    env = BatchSimEnv(get_task_fn=loader.get_next_task, num_envs=2,
                      obs_dim=32, num_rotations=4, scale_factors=(1.0,),
                      render_dim=64, max_grid_dim=LATTICE,
                      domain_randomization=False, device="cpu",
                      substeps=2, iterations=2, contact_iterations=1,
                      contact_window=4)
    obs = env.reset()
    assert [t.name for t in env.tasks] == sorted(
        ttasks.task_key(i) for i in range(2))
    assert bool(torch.isfinite(obs).all())
    _, start = env.load_scenes(env.tasks)
    for i, task in enumerate(env.tasks):
        dx, dy = (int(v) for v in task.cloth_size)
        p = start.positions[i].view(3, LATTICE, LATTICE)[:, :dy, :dx]
        np.testing.assert_array_equal(
            p.reshape(3, -1).T.numpy(),
            task.particle_pos.reshape(-1, 4)[:, :3])
        assert task.task_difficulty == "hard"
    stats = set_stats(path)
    ratios = [t.initial_coverage / t.flatten_area for t in env.tasks]
    assert stats["n"] == 2
    assert stats["ratio_mean"] == round(float(np.mean(ratios)), 4)


# each option the port refused until the xla backend and the sequential
# generator were ported: (the call, what must reach the generator)
OPTIONS = {
    "backend": (dict(backend="xla"), dict(backend="xla")),
    "spring_mode": (dict(spring_mode="jacobi"), dict(spring_mode="jacobi")),
    "contact_mode": (dict(backend="xla", contact_mode="block"),
                     dict(contact_mode="block")),
    "sequential": (["--sequential"], dict(cloth_type="square")),
    "mesh": (["--cloth_type", "mesh", "--cloth_mesh_path", "data/shirts"],
             dict(cloth_type="mesh", cloth_mesh_path="data/shirts")),
    "shirt_set": (["--sets", "shirt"],
                  dict(cloth_type="mesh", cloth_mesh_path="data/shirts",
                       task_difficulty="hard", seed=500)),
}


@pytest.mark.parametrize("which", list(OPTIONS), ids=list(OPTIONS))
def test_unported_options_raise(which, tmp_path, monkeypatch):
    """The options that raised NotImplementedError before the xla backend
    and the sequential generator were ported now reach them: the batched
    generator runs a tiny batch with its step keywords; the CLI's
    --sequential / --cloth_type mesh and generate_sets' shirt set call
    generate_tasks with the JAX script's arguments (recorded here: a CPU
    run at their full sizes takes hours).  The name is that of the
    refusals this test held until then."""
    path = str(tmp_path / "tasks.npz")
    call, want = OPTIONS[which]
    seen = {}
    if isinstance(call, dict):
        step = ttasks.solver_step

        def recording_step(state, topo, params, **kw):
            seen.update(kw)
            return step(state, topo, params, **kw)

        monkeypatch.setattr(ttasks, "solver_step", recording_step)
        assert ttasks.generate_tasks_batch(
            path, 1, batch=1, max_grid_dim=LATTICE, schedule=TINY,
            device="cpu", **SIZES, **call) == 1
        assert ttasks.count_tasks(path) == 1
    else:
        from flingbot_tpu_torch import generate_sets

        def recording_generate(p, num, **kw):
            seen.update(kw, num=num)
            return ttasks.append_tasks(p, [{"initial_coverage": 0.5,
                                            "flatten_area": 1.0}])

        monkeypatch.setattr(ttasks, "generate_tasks", recording_generate)
        monkeypatch.setattr(generate_sets, "generate_tasks",
                            recording_generate)
        if which == "shirt_set":
            stats = generate_sets.main(call + ["--out", str(tmp_path),
                                               "--device", "cpu"])
            assert stats["shirt"]["n"] == 1 and seen["num"] == 16
        else:
            ttasks.main(["--path", path, "--num_tasks", "3",
                         "--device", "cpu"] + call)
            assert seen["num"] == 3
        assert seen["params"].dynamic_friction == np.float32(
            ttasks.GEN_FRICTION)
    for k, v in want.items():
        assert seen[k] == v, (k, seen.get(k))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_large_tasks_frame_as_on_cpu(cuda_device):
    """4 tasks of the large eval set (112-127 a side, the 128 lattice): one
    frame at the generator's step keywords on the card against the CPU
    plain path.  The frame of a crumpled file state is ill-conditioned for
    some envs (a last-place difference flips a contact), so each env is
    held to the larger of FRAME_TOL and NOISE_FACTOR times how far NOISE
    relative noise on its input positions moves the CPU frame."""
    from flingbot_tpu_torch.engine.solver import step
    from flingbot_tpu_torch.env.scene import make_batch, scene_task

    loader = ttasks.TaskLoader(LARGE)
    tasks = [scene_task(loader.get_next_task()) for _ in range(4)]
    topo, state = make_batch(tasks, max_grid_dim=128, device="cpu")
    params = SolverParams()
    cpu = step(state, topo, params, **ttasks.GEN_SIM_KW)
    card = step(state.to(cuda_device), topo.to(cuda_device), params,
                **ttasks.GEN_SIM_KW)
    spread = torch.zeros(4)
    for seed in (0, 1):
        P = state.positions
        noisy = P * (1 + NOISE * torch.randn(
            P.shape, generator=torch.Generator().manual_seed(seed)))
        moved = step(state.replace(positions=torch.where(
            state.active[:, None], noisy, P)), topo, params,
            **ttasks.GEN_SIM_KW)
        spread = torch.maximum(spread, (moved.positions - cpu.positions)
                               .abs().amax((1, 2)))
    err = (card.positions.cpu() - cpu.positions).abs().amax((1, 2))
    bound = torch.clamp(NOISE_FACTOR * spread, min=FRAME_TOL)
    assert bool((err <= bound).all()), (err, spread)
    assert bool(torch.isfinite(card.positions).all())
