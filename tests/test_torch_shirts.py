"""The shirt path of flingbot_tpu_torch held against flingbot_tpu on the
CPU: the layered-lattice topology, the layered spring solve, the layered
physics step, and the shirt loader.

Inputs: a small procedural shirt (tests/test_layered_topology.py's
SMALL_SHIRT) and tasks of the repo's shirt eval set,
data/shirt_eval_16.hdf5, read with h5py.  The JAX side runs the XLA path
of the production knobs (spring_mode="chebyshev", contact_mode="sort");
its contact group in mesh mode is held against the Pallas kernel in
tests/test_torch_kernels.py."""

import dataclasses
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flingbot_tpu.engine.solver import solve_springs_layered as jax_springs
from flingbot_tpu.engine.solver import step as jax_step
from flingbot_tpu.engine.state import SolverParams as JParams
from flingbot_tpu.engine.topology import LayeredSpec as JSpec
from flingbot_tpu.engine.topology import (
    build_layered_topology as jax_build, compute_layered_spec as jax_spec,
    load_cloth as jax_load_cloth)
from flingbot_tpu.env.scene import apply_state, make_scene
from flingbot_tpu.env.shirts import make_shirt_mesh as jax_shirt_mesh
from flingbot_tpu.env.shirts import write_shirt_obj
from flingbot_tpu_torch.engine.solver import (
    layered_spring_planes, solve_springs_layered, step)
from flingbot_tpu_torch.engine.state import SolverParams
from flingbot_tpu_torch.engine.topology import (
    MESH_KEYS, build_layered_topology, compute_layered_spec, load_cloth)
from flingbot_tpu_torch.env.scene import (
    ShirtTask, crumple, make_batch, shirt_task)
from flingbot_tpu_torch.env.shirts import make_shirt_mesh
import tests.test_torch_common  # noqa: F401  (CPU platform, 2 threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_FILE = os.path.join(ROOT, "data", "shirt_eval_16.hdf5")
SMALL_SHIRT = dict(body_w=0.15, body_h=0.20, sleeve_l=0.06, sleeve_h=0.06,
                   collar_w=0.06, spacing=0.0125)
KW = dict(substeps=4, iterations=16, contact_iterations=4, contact_every=2,
          contact_window=12)
TOPO_FIELDS = ("rest", "stiff", "count", "active", "triangles", "tri_mask",
               "mesh_slot")


def eval_tasks(n):
    """The first n tasks (None: all) of the shirt eval set as
    ShirtTasks."""
    tasks = []
    with h5py.File(EVAL_FILE, "r") as f:
        for key in list(f)[:n]:
            g = f[key]
            tasks.append(ShirtTask(
                **{k: np.asarray(g[k]) for k in MESH_KEYS},
                particle_pos=np.asarray(g["particle_pos"]),
                particle_vel=np.asarray(g["particle_vel"]),
                cloth_mass=float(g.attrs["cloth_mass"]),
                cloth_stiff=np.asarray(g["cloth_stiff"])))
    return tasks


@pytest.fixture(scope="module")
def small_obj(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shirt") / "small_processed.obj")
    write_shirt_obj(path, **SMALL_SHIRT)
    return path


def jax_scene(task: ShirtTask, spec):
    """make_scene + apply_state of the JAX package on the same task."""
    cfg = dict(task.mesh_arrays(), cloth_mass=task.cloth_mass,
               cloth_stiff=task.cloth_stiff, cloth_pos=task.cloth_pos)
    scene = make_scene(cfg, layered_spec=JSpec(**dataclasses.asdict(spec)))
    if task.particle_pos is None:
        return scene
    vel = task.particle_vel if task.particle_vel is not None else ()
    return apply_state(scene, dict(particle_pos=task.particle_pos,
                                   particle_vel=vel))


def test_shirt_mesh_and_loader_match(small_obj):
    for a, b in zip(make_shirt_mesh(**SMALL_SHIRT),
                    jax_shirt_mesh(**SMALL_SHIRT)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(load_cloth(small_obj), jax_load_cloth(small_obj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("source", ["small", "eval"])
def test_layered_topology_and_batch_equal_jax(source, small_obj):
    """(a) compute_layered_spec, the build_layered_topology arrays and the
    make_batch state equal exactly those of the JAX package's
    build_layered_topology and make_scene + apply_state."""
    if source == "small":
        tasks = [shirt_task(small_obj, cloth_mass=0.7,
                            cloth_stiff=(0.85, 0.9, 0.95))]
    else:
        tasks = eval_tasks(None)
    spec = compute_layered_spec([t.mesh_arrays() for t in tasks])
    jspec = jax_spec([t.mesh_arrays() for t in tasks])
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    if source == "eval":  # the eval set's lattice: 96 x 64, 19 classes
        assert len(tasks) == 23
        assert (spec.H, spec.W, len(spec.offsets)) == (96, 64, 19)
        assert (spec.vert_capacity, spec.tri_capacity) == (3328, 6400)
    t = tasks[0]
    verts = np.asarray(t.mesh_verts, np.float32).reshape(-1, 3)
    args = (verts, t.mesh_stretch_edges, t.mesh_bend_edges,
            t.mesh_shear_edges, t.mesh_faces, (0.8, 1.0, 0.9))
    topo = build_layered_topology(*args, spec=spec, device="cpu")
    jtopo = jax_build(*args, spec=jspec)
    for name in TOPO_FIELDS:
        np.testing.assert_array_equal(getattr(topo, name)[0].numpy(),
                                      np.asarray(getattr(jtopo, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(topo.rest_positions[0].numpy().T,
                                  np.asarray(jtopo.rest_positions))
    assert int(topo.num_verts[0]) == int(jtopo.num_verts)

    btopo, state = make_batch([t], device="cpu", layered_spec=spec)
    scene = jax_scene(t, spec)
    for name in TOPO_FIELDS:  # the task's own stiffness, in its order
        np.testing.assert_array_equal(getattr(btopo, name)[0].numpy(),
                                      np.asarray(getattr(scene.topo, name)),
                                      err_msg=name)
    for name in ("positions", "velocities"):
        np.testing.assert_array_equal(
            getattr(state, name)[0].numpy().T,
            np.asarray(getattr(scene.state, name)), err_msg=name)
    for name in ("inv_mass", "rest_inv_mass", "active"):
        np.testing.assert_array_equal(
            getattr(state, name)[0].numpy(),
            np.asarray(getattr(scene.state, name)), err_msg=name)


def test_layered_topology_refuses_a_mesh_that_does_not_fit(small_obj):
    t = shirt_task(small_obj)
    spec = compute_layered_spec([t.mesh_arrays()])
    args = (np.asarray(t.mesh_verts).reshape(-1, 3), t.mesh_stretch_edges,
            t.mesh_bend_edges, t.mesh_shear_edges, t.mesh_faces,
            (0.8, 1.0, 0.9))
    narrow = dataclasses.replace(spec, offsets=spec.offsets[:-1])
    with pytest.raises(ValueError, match="not in LayeredSpec.offsets"):
        build_layered_topology(*args, spec=narrow, device="cpu")
    small = dataclasses.replace(spec, vert_capacity=256)
    with pytest.raises(ValueError, match="vert_capacity"):
        build_layered_topology(*args, spec=small, device="cpu")
    with pytest.raises(ValueError, match="not layered-lattice"):
        build_layered_topology(np.random.default_rng(0).random((len(
            args[0]), 3)), *args[1:], spec=spec, device="cpu")


def test_layered_springs_match_jax():
    """(b) one Jacobi iteration over all 19 offset classes on a crumpled
    eval shirt, two slots grasped (w = 0): 1e-6.  The port sums the
    classes in another order than the JAX loop (measured 1.5e-8)."""
    tasks = eval_tasks(1)
    topo, state = make_batch(tasks, device="cpu")
    spec = topo.spec
    w = torch.where(state.active, state.inv_mass, 0.0)
    w[0, topo.mesh_slot[0, :2]] = 0.0
    P = state.positions
    out = solve_springs_layered(P, w, layered_spring_planes(w, topo), 0.9)
    scene = jax_scene(tasks[0], spec)
    ref = jax.jit(lambda p, w_: jax_springs(p, w_, scene.topo, 0.9))(
        jnp.asarray(P[0].numpy()).reshape(3, spec.H, spec.W),
        jnp.asarray(w[0].numpy()).reshape(spec.H, spec.W))
    ref = np.asarray(ref).reshape(3, -1)
    np.testing.assert_allclose(out[0].numpy(), ref, atol=1e-6)
    assert np.abs(ref - P[0].numpy()).max() > 1e-4


def _grasped(tasks, spec, picker_lift=0.02):
    """Port and JAX states with picker 0 grasping vertex 0 (inverse mass
    0) and its sphere pressing on the cloth."""
    topo, state = make_batch(tasks, device="cpu", layered_spec=spec)
    slot = topo.mesh_slot[:, 0]
    inv = state.inv_mass.clone()
    inv[torch.arange(len(tasks)), slot] = 0.0
    pick = state.positions[torch.arange(len(tasks)), :, slot] \
        + torch.tensor([0.0, picker_lift, 0.0])
    pp = state.picker_pos.clone()
    pp[:, 0] = pick
    picked = state.picked_idx.clone()
    picked[:, 0] = slot
    state = state.replace(inv_mass=inv, picker_pos=pp, picked_idx=picked)
    jstates = []
    for b, t in enumerate(tasks):
        s = jax_scene(t, spec).state
        jstates.append(s.replace(
            inv_mass=jnp.asarray(inv[b].numpy()),
            picker_pos=jnp.asarray(pp[b].numpy()),
            picked_idx=jnp.asarray(picked[b].numpy(), jnp.int32)))
    return topo, state, jstates


def _jax_step_fn(jtopo):
    jp = JParams()
    return jax.jit(lambda s: jax_step(s, jtopo, jp, spring_mode="chebyshev",
                                      contact_mode="sort", backend="xla",
                                      **KW))


def test_layered_step_matches_jax_with_active_picker(small_obj):
    """(d) one and two layered frames: picker 0 holds vertex 0 of each of
    two small shirts (different masses and start noise) 2 cm above the
    cloth, contacts every 2nd substep in mesh mode: positions 1e-5,
    velocities 1e-3 (tests/test_pallas.py:233,268-270's bounds)."""
    rng = np.random.default_rng(3)
    tasks = []
    for mass in (0.5, 0.9):
        t = shirt_task(small_obj, cloth_mass=mass)
        pp = t.particle_pos.reshape(-1, 4).copy()
        pp[:, :3] += rng.normal(0, 1e-3, (len(pp), 3))
        t.particle_pos = pp.reshape(-1)
        tasks.append(t)
    spec = compute_layered_spec([t.mesh_arrays() for t in tasks])
    topo, state, jstates = _grasped(tasks, spec)
    f = _jax_step_fn(jax_scene(tasks[0], spec).topo)
    start = state.positions.clone()
    for _ in range(2):
        jstates = [f(s) for s in jstates]
        state = step(state, topo, SolverParams(), **KW)
        for b, js in enumerate(jstates):
            np.testing.assert_allclose(state.positions[b].numpy().T,
                                       np.asarray(js.positions), atol=1e-5)
            np.testing.assert_allclose(state.velocities[b].numpy().T,
                                       np.asarray(js.velocities), atol=1e-3)
    # the grasped vertex stays put; the rest of the cloth falls
    slot = topo.mesh_slot[:, 0]
    b = torch.arange(2)
    assert torch.equal(state.positions[b, :, slot], start[b, :, slot])
    assert float((state.positions - start).abs().max()) > 1e-3


def test_layered_step_on_a_crumpled_eval_shirt():
    """(d) one frame of a crumpled eval shirt, where folds press the two
    panels together and the contact groups fire.  Here the JAX step itself
    moves by up to ~5e-5 m when its input moves by 1e-7 (contact counts
    and the speed-up-only clamp are discontinuous), so the port is held to
    the reference's own spread: within twice the largest JAX-vs-JAX
    difference over three seeded 1e-7 perturbations, and within 1e-4."""
    tasks = eval_tasks(1)
    spec = compute_layered_spec([t.mesh_arrays() for t in tasks])
    topo, state, jstates = _grasped(tasks, spec)
    f = _jax_step_fn(jax_scene(tasks[0], spec).topo)
    ref = f(jstates[0])
    out = step(state, topo, SolverParams(), **KW)
    err = np.abs(out.positions[0].numpy().T - np.asarray(ref.positions)).max()
    rng = np.random.default_rng(0)
    spread = 0.0
    for _ in range(3):
        s = jstates[0]
        noise = rng.normal(0, 1e-7, s.positions.shape) * np.asarray(
            s.active)[:, None]
        o = f(s.replace(positions=s.positions + jnp.asarray(noise,
                                                            jnp.float32)))
        spread = max(spread, float(jnp.abs(o.positions - ref.positions).max()))
    print(f"port vs JAX {err:.3e} m, JAX spread under 1e-7 noise "
          f"{spread:.3e} m")
    assert err <= max(2 * spread, 1e-5) and err < 1e-4, (err, spread)
    assert float(jnp.abs(ref.positions - jstates[0].positions).max()) > 1e-3


def test_crumple_picks_an_active_slot_and_settles(small_obj):
    """The seeded crumple grabs a random active slot of a layered batch,
    lifts, drops and settles: finite, above the floor, inactive slots
    untouched."""
    topo, state = make_batch([shirt_task(small_obj)] * 2, device="cpu")
    sim = dict(substeps=2, iterations=4, contact_every=2,
               contact_iterations=2, contact_window=4)
    out = crumple(state, topo, SolverParams(), torch.Generator().manual_seed(
        1), sim)
    assert torch.isfinite(out.positions).all()
    assert torch.equal(out.positions[:, :, ~state.active[0]],
                       state.positions[:, :, ~state.active[0]])
    assert float(out.positions[:, 1][out.active].min()) > -1e-3
    assert float((out.positions - state.positions).abs().max()) > 0.05
    assert (out.picked_idx == -1).all()


def test_shirt_entry_points_refuse_a_missing_card(small_obj):
    """The shirt constructors default to CUDA through resolve_device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    t = shirt_task(small_obj)
    spec = compute_layered_spec([t.mesh_arrays()])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_batch([t])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_layered_topology(
            np.asarray(t.mesh_verts).reshape(-1, 3), t.mesh_stretch_edges,
            t.mesh_bend_edges, t.mesh_shear_edges, t.mesh_faces,
            (0.8, 1.0, 0.9), spec=spec)
    topo, _ = make_batch([t], device="cpu")
    assert topo.rest.device.type == "cpu"
    with pytest.raises(ValueError, match="grid cloths or shirts"):
        from flingbot_tpu_torch.env.scene import flat_tasks
        make_batch([t] + flat_tasks([(8, 8)]), device="cpu")
