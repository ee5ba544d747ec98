"""The port's sequential task generator (flingbot_tpu_torch.env.tasks
generate_randomization / generate_tasks, sim_n, wait_until_stable) held
against the JAX package's on the CPU.

  - the drawn fields: every numpy draw in order (dims, stiffness, mass,
    pickpoint, height, displacements) bit-equal, read through a recording
    Generator with the physics stubbed out on both sides, and the OBJ
    under a seeded `random`: the same mesh arrays; the anchor's slot is
    the JAX pickpoint's, its path within ANCHOR_TOL;
  - sim_n's anchored frames (solver.step's JAX defaults: the xla backend,
    Gauss-Seidel springs, block contacts every substep) within
    FRAME_TOL_P / FRAME_TOL_V after 2 frames;
  - one tiny task of each cloth type end to end (a short schedule, 4
    spring iterations) with the JAX writer's keys, read back by
    TaskLoader, and resumption from a partial archive.

Square cloths of 8-11 a side on a 16 lattice; meshes are the JAX tests'
small quad sheets (tests/test_native.py write_quad_obj) at their
MESH_CAPS."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flingbot_tpu.env.tasks as jtasks
from flingbot_tpu.engine.state import SolverParams as JParams
from flingbot_tpu_torch.engine.state import SolverParams
from flingbot_tpu_torch.env import tasks as ttasks
from tests.test_native import write_quad_obj
from tests.test_torch_common import COVERAGE_RTOL

SIZES = dict(min_cloth_size=8, max_cloth_size=12, strict_min_edge_length=8,
             max_grid_dim=16)
MESH_CAPS = (512, 8192, 1024)  # tests/test_mesh_cloth.py
# the anchor's path (m): the generator centres the cloth by its mean,
# summed in another order on each side
ANCHOR_TOL = 1e-6
# two frames (m, m/s): 4 substeps of 30 Gauss-Seidel passes and 8 block
# contact passes each
FRAME_TOL_P, FRAME_TOL_V = 1e-5, 2e-3
# a tiny schedule: (mesh drop, sweep, hold checks, toss sweep, tosses,
# settle) frames
# (a cloth lifted up to 1.5 m lands within the 100 settle frames)
TINY = (2, 3, 1, 2, 2, 100)
TINY_KW = dict(ttasks.SEQ_SIM_KW, iterations=4, contact_iterations=2)


@pytest.fixture(scope="module")
def obj_dir(tmp_path_factory):
    """Three small quad sheets of different sizes, 1.5 cm spacing."""
    d = tmp_path_factory.mktemp("objs")
    for i, (nx, ny) in enumerate(((6, 5), (7, 6), (8, 5))):
        path = d / f"sheet{i}_processed.obj"
        write_quad_obj(path, nx=nx, ny=ny)
        lines = [f"v {float(v.split()[1]) * 0.15} 0.0 "
                 f"{float(v.split()[3]) * 0.15}\n" if v.startswith("v ")
                 else v for v in open(path)]
        open(path, "w").writelines(lines)
    return str(d)


class RecordingRng:
    """A numpy Generator that logs each draw: (method, args, result)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.log = []

    def __getattr__(self, name):
        fn = getattr(self.rng, name)

        def call(*args, **kw):
            out = fn(*args, **kw)
            self.log.append((name, args, kw, np.array(out, copy=True)))
            return out
        return call


def stubbed_jax(monkeypatch, anchors):
    """The JAX generator without its physics: _sim_n records its anchor
    and returns the state; wait_until_stable settles at once."""
    def sim_n(state, topo, params, n, anchor_idx=None, anchor_pos=None,
              **kw):
        if anchor_idx is not None:
            anchors.append((int(anchor_idx), np.asarray(anchor_pos)))
        return state

    monkeypatch.setattr(jtasks, "_sim_n", sim_n)
    monkeypatch.setattr(jtasks, "wait_until_stable",
                        lambda state, *a, **k: (state, True))


def stubbed_port(monkeypatch, anchors):
    def sim_n(state, topo, params, n, anchor_slot=None, anchor_pos=None,
              **kw):
        if anchor_slot is not None:
            anchors.append((anchor_slot, anchor_pos.numpy()))
        return state

    monkeypatch.setattr(ttasks, "sim_n", sim_n)
    monkeypatch.setattr(ttasks, "wait_until_stable",
                        lambda state, *a, **k: (state, True))


CASES = {"square-hard": ("square", "hard"), "square-easy": ("square", "easy"),
         "mesh-hard": ("mesh", "hard")}


@pytest.mark.parametrize("case", list(CASES))
def test_drawn_fields_bit_equal(case, obj_dir, monkeypatch):
    cloth_type, difficulty = CASES[case]
    kw = dict(SIZES, task_difficulty=difficulty, cloth_type=cloth_type,
              cloth_mesh_path=obj_dir, mesh_caps=MESH_CAPS)
    jan, tan = [], []
    with monkeypatch.context() as m:
        stubbed_jax(m, jan)
        jrng = RecordingRng(11)
        random.seed(5)
        with jax.disable_jit():
            ref = None
            while ref is None:
                ref = jtasks.generate_randomization(jrng, **kw)
    with monkeypatch.context() as m:
        stubbed_port(m, tan)
        trng = RecordingRng(11)
        random.seed(5)
        out = None
        while out is None:
            out = ttasks.generate_randomization(trng, device="cpu", **kw)
    # every draw, in order, bit-equal
    assert len(jrng.log) == len(trng.log) > 0
    for (jn, ja, jk, jv), (tn, ta, tk, tv) in zip(jrng.log, trng.log):
        assert (jn, ja, jk) == (tn, ta, tk)
        assert np.array_equal(jv, tv) and jv.dtype == tv.dtype
    # the task's fields: the JAX writer's keys, the drawn ones bit-equal
    assert set(out) == set(ref)
    for k in ("cloth_size", "cloth_stiff", "cloth_mass", "task_difficulty",
              "mesh_verts", "mesh_stretch_edges", "mesh_bend_edges",
              "mesh_shear_edges", "mesh_faces", "flip_mesh"):
        assert np.array_equal(np.asarray(out[k]), np.asarray(ref[k])), k
        assert np.asarray(out[k]).dtype == np.asarray(ref[k]).dtype, k
    for k in ("particle_pos", "particle_vel", "shape_pos", "phase"):
        assert np.asarray(out[k]).shape == np.asarray(ref[k]).shape, k
        assert np.asarray(out[k]).dtype == np.asarray(ref[k]).dtype, k
    np.testing.assert_allclose(out["flatten_area"], ref["flatten_area"],
                               rtol=COVERAGE_RTOL)
    # the anchor: the JAX pickpoint's slot, on the same path
    assert len(jan) == len(tan) > 0
    dimx = int(out["cloth_size"][0])
    for (ji, jp), (ts, tp) in zip(jan, tan):
        want = ji if cloth_type == "mesh" else int(
            ttasks.lattice_slot(ji, dimx, SIZES["max_grid_dim"]))
        assert ts == want
        np.testing.assert_allclose(tp, jp, rtol=0, atol=ANCHOR_TOL)


def small_square(rng):
    """A 10 x 9 cloth on the 16 lattice, lying near flat, on both sides
    (the JAX canonical state and the port's lattice state)."""
    from flingbot_tpu.engine.state import ClothState as JState
    from flingbot_tpu.engine.topology import build_grid_topology as jgrid
    from tests.test_torch_common import port_state, cloth_positions
    from flingbot_tpu_torch.engine.topology import build_grid_topology

    dimx, dimy, n = 10, 9, 90
    pos = cloth_positions(dimx, dimy, rng, height=0.02, noise=3e-3)
    js = JState.create(pos, np.full(n, n / 0.5, np.float32), capacity=256)
    jt = jgrid(jnp.int32(dimx), jnp.int32(dimy), stiffness=(0.9, 0.9, 0.9),
               max_dimx=16, max_dimy=16)
    tt = build_grid_topology(dimx, dimy, stiffness=(0.9, 0.9, 0.9),
                             max_dimx=16, max_dimy=16, device="cpu")
    ts = port_state(jax.tree_util.tree_map(lambda a: a[None], js), tt)
    return js, jt, ts, tt, 3 * dimx + 4


def small_mesh(rng, obj_dir):
    """A 7 x 6 quad sheet 2 cm up with seeded noise, on both sides."""
    from tests.test_torch_mesh import pair
    from flingbot_tpu_torch.engine.topology import load_cloth

    v, tri, se, be, sh = load_cloth(f"{obj_dir}/sheet1_processed.obj")
    pos = (v + [0.0, 0.02, 0.0] + rng.normal(0, 2e-3, v.shape)).astype(
        np.float32)
    js, jt, ts, tt = pair((v, tri, se, be, sh), pos)
    return js, jt, ts, tt, 3


@pytest.mark.parametrize("cloth", ["square", "mesh"])
def test_sim_n_anchored_frames(cloth, obj_dir):
    """Two anchored frames of sim_n against the JAX _sim_n: the anchor held
    at a point 2 cm above its start, at solver.step's JAX defaults."""
    rng = np.random.default_rng(6)
    js, jt, ts, tt, idx = (small_square(rng) if cloth == "square"
                           else small_mesh(rng, obj_dir))
    slot = idx if cloth == "mesh" else int(ttasks.lattice_slot(idx, 10, 16))
    target = np.asarray(js.positions[idx]) + np.float32([0.01, 0.02, 0.0])
    js = js.replace(inv_mass=js.inv_mass.at[idx].set(0.0))
    w = ts.inv_mass.clone()
    w[0, slot] = 0.0
    ts = ts.replace(inv_mass=w)
    params = SolverParams(dynamic_friction=0.75)
    jparams = JParams().replace(dynamic_friction=jnp.float32(0.75))
    ref = jax.jit(lambda s: jtasks._sim_n(
        s, jt, jparams, 2, anchor_idx=jnp.int32(idx),
        anchor_pos=jnp.asarray(target)))(js)
    out = ttasks.sim_n(ts, tt, params, 2, anchor_slot=slot,
                       anchor_pos=torch.as_tensor(target))
    if cloth == "square":
        from tests.test_torch_common import canonical
        P = canonical(out.positions, tt, ref.positions[None])[0]
        V = canonical(out.velocities, tt, ref.velocities[None])[0]
    else:
        P, V = out.positions[0].numpy().T, out.velocities[0].numpy().T
    assert float(np.abs(np.asarray(ref.positions)
                        - np.asarray(js.positions)).max()) > 1e-3
    np.testing.assert_allclose(P, np.asarray(ref.positions), rtol=0,
                               atol=FRAME_TOL_P)
    np.testing.assert_allclose(V, np.asarray(ref.velocities), rtol=0,
                               atol=FRAME_TOL_V)
    np.testing.assert_array_equal(P[idx], target)
    assert out.step_count.tolist() == [2]


def jax_keys(obj_dir, monkeypatch, **kw):
    """The keys of a JAX generator task (its physics stubbed out)."""
    with monkeypatch.context() as m:
        stubbed_jax(m, [])
        with jax.disable_jit():
            ref = None
            rng = np.random.default_rng(0)
            while ref is None:
                ref = jtasks.generate_randomization(
                    rng, cloth_mesh_path=obj_dir, mesh_caps=MESH_CAPS, **kw)
    return set(ref)


@pytest.mark.parametrize("case", list(CASES))
def test_tiny_task_end_to_end(case, obj_dir, tmp_path, monkeypatch):
    """generate_tasks makes two tiny tasks into an archive with the JAX
    writer's keys; TaskLoader reads them back into the env's scenes."""
    from flingbot_tpu_torch.env.scene import make_batch, scene_task

    cloth_type, difficulty = CASES[case]
    kw = dict(SIZES, task_difficulty=difficulty, cloth_type=cloth_type)
    path = str(tmp_path / "tasks.npz")
    random.seed(1)
    assert ttasks.generate_tasks(
        path, 2, seed=2, cloth_mesh_path=obj_dir, mesh_caps=MESH_CAPS,
        schedule=TINY, sim_kw=TINY_KW, device="cpu", **kw) == 2
    keys = jax_keys(obj_dir, monkeypatch, **kw)
    arrays = ttasks.read_task_arrays(path)
    assert sorted(arrays) == sorted(ttasks.task_key(i) for i in range(2))
    for entries in arrays.values():
        assert {k.lstrip("@") for k in entries} == keys
    loader = ttasks.TaskLoader(path)
    tasks = [loader.get_next_task() for _ in range(2)]
    for task in tasks:
        assert task.task_difficulty == (
            "shirt" if cloth_type == "mesh" else difficulty)
        assert task.initial_coverage > 0 and task.flatten_area > 0
        assert np.isfinite(task.particle_pos).all()
    caps = MESH_CAPS if cloth_type == "mesh" else None
    _, state = make_batch([scene_task(task) for task in tasks],
                          max_grid_dim=16, mesh_caps=caps, device="cpu")
    assert bool(torch.isfinite(state.positions).all())
    # each task's coverage, recomputed from its stored particles, is the
    # coverage it was stored with
    from flingbot_tpu_torch.env.coverage import get_current_covered_area
    cov = get_current_covered_area(state.positions, state.active).numpy()
    np.testing.assert_array_equal(
        cov, np.array([task.initial_coverage for task in tasks],
                      np.float32))
    if cloth_type == "mesh":
        assert ttasks.detect_mesh_caps(path) == (256, 1024, 256)


def test_resume_from_a_partial_archive(obj_dir, tmp_path):
    """An archive topped up from 1 to 2 tasks holds, second, the task that
    seed + 1 draws first: the draws restart from seed + count."""
    kw = dict(SIZES, task_difficulty="hard", schedule=TINY, sim_kw=TINY_KW,
              device="cpu", log=False)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert ttasks.generate_tasks(a, 1, seed=3, **kw) == 1
    assert ttasks.generate_tasks(a, 2, seed=3, **kw) == 2
    assert ttasks.generate_tasks(a, 2, seed=3, **kw) == 2  # nothing to do
    assert ttasks.generate_tasks(b, 1, seed=4, **kw) == 1
    got, want = ttasks.read_task_arrays(a), ttasks.read_task_arrays(b)
    second, first = got[ttasks.task_key(1)], want[ttasks.task_key(0)]
    assert set(second) == set(first)
    for k in first:
        assert np.array_equal(second[k], first[k]), k
