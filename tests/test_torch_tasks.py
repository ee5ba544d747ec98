"""Task files in flingbot_tpu_torch: tools/export_tasks_npz.py turns the
HDF5 task sets into numpy archives, and the port's TaskLoader, bucket
detection and scene construction from file tasks are held against
flingbot_tpu's (TaskLoader, detect_topology_buckets, set_scene) on the
same tasks, exactly."""

import dataclasses
import os

import h5py
import numpy as np
import pytest
import torch

from flingbot_tpu.env import tasks as jtasks
from flingbot_tpu.env.scene import set_scene
from flingbot_tpu.engine.topology import LayeredSpec as JSpec
from flingbot_tpu_torch.engine.topology import gather_to_lattice
from flingbot_tpu_torch.env import tasks as ttasks
from flingbot_tpu_torch.env.batch_env import BatchSimEnv
from flingbot_tpu_torch.env.scene import make_batch, scene_task
from tests.test_torch_common import t
from tools.export_tasks_npz import export

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECT = os.path.join(ROOT, "data", "rect_eval_tasks.hdf5")
SHIRT = os.path.join(ROOT, "data_r3", "shirt_eval_16.hdf5")
COMMITTED = ("rect_eval_hard_100", "shirt_eval_16", "rect_eval_easy_64",
             "rect_eval_large_64")
TASK_ARRAYS = ("cloth_size", "particle_pos", "particle_vel", "shape_pos",
               "phase", "cloth_pos", "cloth_stiff", "mesh_verts",
               "mesh_stretch_edges", "mesh_bend_edges", "mesh_shear_edges",
               "mesh_faces", "camera_pos", "camera_angle")
TASK_SCALARS = ("name", "flatten_area", "initial_coverage", "task_difficulty",
                "cloth_mass", "flip_mesh", "camera_width", "camera_height")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(hdf5, npz) pairs: the rect set, and a 2-task slice of the shirt set
    (its HDF5 written with the JAX package's write_task)."""
    d = tmp_path_factory.mktemp("tasks")
    shirt_h5 = str(d / "shirt2.hdf5")
    with h5py.File(SHIRT, "r") as f:
        for key in sorted(f)[:2]:
            g = f[key]
            task = {k: np.array(g[k]) for k in g}
            task.update(dict(g.attrs))
            # write_task keys groups by count: keep the source order
            jtasks.write_task(shirt_h5, task)
    pairs = {}
    for name, h5 in (("rect", RECT), ("shirt", shirt_h5)):
        npz = str(d / f"{name}.npz")
        export(h5, npz)
        pairs[name] = (h5, npz)
    return pairs


def assert_same_value(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same_value(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def assert_same_task(a, b):
    for k in TASK_ARRAYS + TASK_SCALARS:
        assert_same_value(getattr(a, k), getattr(b, k))
    for view in ("get_config", "get_state", "get_stats"):
        assert_same_value(getattr(a, view)(), getattr(b, view)())
    assert str(a) == str(b)


@pytest.mark.parametrize("which", ["rect", "shirt"])
def test_task_loader_matches(exported, which):
    h5, npz = exported[which]
    jl, tl = jtasks.TaskLoader(h5), ttasks.TaskLoader(npz)
    assert len(jl) == len(tl) and jl.keys == tl.keys
    for _ in range(len(jl) + 2):  # past the end: repeat starts over
        assert_same_task(jl.get_next_task(), tl.get_next_task())
    jl, tl = (jtasks.TaskLoader(h5, repeat=False),
              ttasks.TaskLoader(npz, repeat=False))
    for _ in range(len(jl)):
        assert jl.get_next_task().name == tl.get_next_task().name
    for loader in (jl, tl):
        with pytest.raises(StopIteration):
            loader.get_next_task()


def test_topology_buckets_match(exported):
    for which in ("rect", "shirt"):
        h5, npz = exported[which]
        jb = jtasks.detect_topology_buckets(h5)
        tb = ttasks.detect_topology_buckets(npz)
        assert jb["mesh_caps"] == tb["mesh_caps"] is None
        if which == "rect":
            assert jb["layered_spec"] is tb["layered_spec"] is None
        else:
            assert tb["layered_spec"] is not None
            assert (dataclasses.asdict(jb["layered_spec"])
                    == dataclasses.asdict(tb["layered_spec"]))
        assert jtasks.detect_mesh_caps(h5) == ttasks.detect_mesh_caps(npz)
        assert (jtasks.detect_layered_spec(h5) is None) == (
            ttasks.detect_layered_spec(npz) is None)
    assert ttasks.detect_mesh_caps(exported["shirt"][1]) is not None


@pytest.mark.parametrize("name", COMMITTED)
def test_committed_npz_equal_their_sources(name):
    arrays = ttasks.read_task_arrays(
        os.path.join(ROOT, "data_r3", f"{name}.npz"))
    with h5py.File(os.path.join(ROOT, "data_r3", f"{name}.hdf5"), "r") as f:
        assert sorted(arrays) == sorted(f)
        for key in f:
            g, a = f[key], arrays[key]
            want = {n: np.array(g[n]) for n in g}
            want.update({"@" + n: np.asarray(v) for n, v in g.attrs.items()})
            assert sorted(a) == sorted(want)
            for n, v in want.items():
                if v.dtype.kind in "OSU":
                    assert str(a[n][()]) == str(v[()])
                    continue
                assert a[n].dtype == v.dtype and a[n].shape == v.shape, n
                np.testing.assert_array_equal(a[n], v)


def test_scene_from_rect_tasks_matches_set_scene(exported):
    loader = ttasks.TaskLoader(exported["rect"][1])
    tasks = [loader.get_next_task() for _ in range(3)]
    topo, state = make_batch([scene_task(x) for x in tasks], device="cpu")
    for b, task in enumerate(tasks):
        sc = set_scene(task.get_config(), task.get_state())
        js, jt = sc.state, sc.topo
        assert int(topo.dimx[b]) == int(jt.dimx)
        assert int(topo.dimy[b]) == int(jt.dimy)
        assert torch.equal(topo.stiffness[b], t(jt.stiffness))
        one = topo.index(slice(b, b + 1))
        lat = lambda x, fill=0.0: gather_to_lattice(  # noqa: E731
            t(x)[None], one, fill)[0]
        assert torch.equal(state.positions[b], lat(np.asarray(js.positions).T))
        assert torch.equal(state.velocities[b],
                           lat(np.asarray(js.velocities).T))
        assert torch.equal(state.inv_mass[b], lat(js.inv_mass))
        assert torch.equal(state.rest_inv_mass[b], lat(js.rest_inv_mass))
        assert torch.equal(state.active[b], lat(js.active, False))


def test_scene_from_shirt_tasks_matches_set_scene(exported):
    npz = exported["shirt"][1]
    spec = ttasks.detect_layered_spec(npz)
    jspec = JSpec(**dataclasses.asdict(spec))
    loader = ttasks.TaskLoader(npz)
    tasks = [loader.get_next_task() for _ in range(2)]
    topo, state = make_batch([scene_task(x) for x in tasks], device="cpu",
                             layered_spec=spec)
    for b, task in enumerate(tasks):
        sc = set_scene(task.get_config(), task.get_state(),
                       layered_spec=jspec)
        js, jt = sc.state, sc.topo
        for f in ("positions", "velocities"):
            assert torch.equal(getattr(state, f)[b],
                               t(np.asarray(getattr(js, f)).T))
        for f in ("inv_mass", "rest_inv_mass", "active"):
            assert torch.equal(getattr(state, f)[b], t(getattr(js, f)))
        for f in ("rest", "stiff", "count", "active", "triangles",
                  "tri_mask", "mesh_slot"):
            a, w = getattr(topo, f)[b], np.asarray(getattr(jt, f))
            assert torch.equal(a, t(w, a.dtype).reshape(a.shape)), f


def test_generic_mesh_buckets_raise():
    """A mesh_caps bucket was refused until the generic mesh path was
    ported: now the env takes it, and refuses only a bucket given with a
    layered spec (tests/test_torch_mesh.py steps such an env).  The name
    is that of the refusal this test held until then."""
    env = BatchSimEnv(get_task_fn=lambda: None, num_envs=1,
                      mesh_caps=(3328, 32768, 6400), device="cpu")
    assert env.mesh_caps == (3328, 32768, 6400)
    with pytest.raises(ValueError, match="either mesh_caps"):
        BatchSimEnv(get_task_fn=lambda: None, num_envs=1,
                    mesh_caps=(3328, 32768, 6400), layered_spec=object(),
                    device="cpu")


@pytest.mark.parametrize("which", ["rect", "shirt"])
def test_set_slots_equals_the_batch_built_whole(exported, which):
    """Reload writeback: slots set from a smaller batch equal the batch
    built from the combined task list."""
    npz = exported[which][1]
    spec = ttasks.detect_layered_spec(npz)
    loader = ttasks.TaskLoader(npz)
    tasks = [scene_task(loader.get_next_task()) for _ in range(3)]
    build = lambda ts: make_batch(ts, device="cpu",  # noqa: E731
                                  layered_spec=spec)
    topo, state = build(tasks)
    idx = torch.tensor([2, 0])
    new_topo, new_state = build([tasks[1], tasks[2]])
    topo = topo.set_slots(idx, new_topo)
    state = state.set_slots(idx, new_state)
    want_topo, want_state = build([tasks[2], tasks[1], tasks[1]])
    for k, v in want_state.fields().items():
        assert torch.equal(getattr(state, k), v), k
    for f in dataclasses.fields(want_topo):
        a, w = getattr(topo, f.name), getattr(want_topo, f.name)
        assert (torch.equal(a, w) if isinstance(w, torch.Tensor)
                else a == w), f.name
