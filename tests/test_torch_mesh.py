"""The generic mesh path of flingbot_tpu_torch against the JAX package on
the CPU: build_mesh_topology's tables, mesh_normals, solve_springs_mesh,
one frame of _step_mesh (sort and block contacts, with and without drag
and lift, with and without picker friction), layered aero and picker
friction against the JAX _step_layered, and a BatchSimEnv on a mesh_caps
bucket (reset and one step) against the JAX env's pre-action coverage
and action.  A `cuda` test holds the contacts kernel's launch at the
generic mesh path's shape against its plain version.

The meshes are the JAX tests' small quad sheet (tests/test_native.py
write_quad_obj, 14 x 12 vertices scaled to a 1.5 cm spacing, as
tests/test_mesh_cloth.py scales it) padded to its MESH_CAPS, folded over
itself so that contacts fire."""

import numpy as np
import pytest
import torch

from flingbot_tpu_torch.engine import aero, kernels
from flingbot_tpu_torch.engine.solver import solve_springs_mesh, step
from flingbot_tpu_torch.engine.state import ClothState, SolverParams
from flingbot_tpu_torch.engine.topology import (
    MeshTopology, build_mesh_topology, load_cloth)

try:  # the JAX package, for the tests against it
    import jax
    import jax.numpy as jnp

    from flingbot_tpu.engine import aero as jaero
    from flingbot_tpu.engine import solver as jsolver
    from flingbot_tpu.engine import topology as jtopology
    from flingbot_tpu.engine.state import ClothState as JState
    from flingbot_tpu.engine.state import SolverParams as JParams
    from tests.test_torch_common import stack, t
except ImportError:  # a CUDA machine without flax: the cuda test only
    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype)


def write_quad_obj(path, nx, ny):
    """A flat quad-grid OBJ of nx x ny vertices, 0.1 apart (the JAX tests'
    tests/test_native.py write_quad_obj, which imports the JAX package)."""
    with open(path, "w") as f:
        for y in range(ny):
            for x in range(nx):
                f.write(f"v {x * 0.1} 0.0 {y * 0.1}\n")
        for y in range(ny - 1):
            for x in range(nx - 1):
                a = y * nx + x + 1
                f.write(f"f {a} {a + 1} {a + nx + 1} {a + nx}\n")

MESH_CAPS = (512, 8192, 1024)  # tests/test_mesh_cloth.py
CAPS = dict(capacity=MESH_CAPS[0], edge_capacity=MESH_CAPS[1],
            tri_capacity=MESH_CAPS[2], degree_capacity=24)
STIFF = (0.8, 1.0, 0.9)
NX, NY, SPACING = 14, 12, 0.015
KW = dict(substeps=4, iterations=16, contact_every=2, contact_iterations=4,
          contact_window=12)
AERO = dict(drag=1.0, lift=0.5, wind=(0.5, 0.0, -0.25))
# one spring pass / the normals: the same float32 formula, sums in
# another order
PASS_TOL = 2e-7
# one frame (m, m/s): 16 Chebyshev passes a substep and contacts; V =
# dP / dt_sub multiplies a position difference by 400
FRAME_TOL_P, FRAME_TOL_V = 2e-6, 2e-3


@pytest.fixture(scope="module")
def sheet(tmp_path_factory):
    """(vertices, triangles, stretch, bend, shear) of the quad sheet."""
    path = tmp_path_factory.mktemp("mesh") / "sheet_processed.obj"
    write_quad_obj(path, nx=NX, ny=NY)
    v, tri, se, be, sh = load_cloth(str(path))
    return v * (SPACING / 0.1), tri, se, be, sh


def crease_x(v):
    """x of the sheet's middle vertex column, where it folds."""
    return np.unique(v[:, 0])[NX // 2]


def folded(v, gap=0.006, rng=None):
    """The sheet folded over itself at its middle vertex column: the right
    half lies `gap` above the left, so their vertices collide, while the
    rest pose keeps them far apart."""
    p = v.astype(np.float32).copy()
    mid = np.float32(crease_x(v))
    right = p[:, 0] > mid
    p[right, 0] = 2 * mid - p[right, 0]
    p[:, 1] = 0.02 + np.where(right, gap, 0.0)
    if rng is not None:
        p += rng.normal(0, 5e-4, p.shape).astype(np.float32)
    return p


def port_pair(sheet, positions):
    """The port's mesh state and topology (on the CPU)."""
    v, tri, se, be, sh = sheet
    n = len(v)
    w = np.full(n, n / 0.5, np.float32)
    tt = build_mesh_topology(v, se, be, sh, tri, stiffness=STIFF,
                             device="cpu", **CAPS)
    ts = ClothState.create(positions, w, capacity=CAPS["capacity"],
                           device="cpu")
    return ts, tt


def pair(sheet, positions, picker=None):
    """The same mesh state on both sides: (JAX state, JAX topology, port
    state, port topology)."""
    v, tri, se, be, sh = sheet
    n = len(v)
    jt = jtopology.build_mesh_topology(v, se, be, sh, tri, stiffness=STIFF,
                                       **CAPS)
    js = JState.create(positions, np.full(n, n / 0.5, np.float32),
                       capacity=CAPS["capacity"])
    ts, tt = port_pair(sheet, positions)
    if picker is not None:
        js = js.replace(picker_pos=jnp.asarray(picker))
        ts = ts.replace(picker_pos=t(picker)[None])
    return js, jt, ts, tt


def test_build_mesh_topology_tables_equal_jax(sheet):
    v, tri, se, be, sh = sheet
    jt = jtopology.build_mesh_topology(v, se, be, sh, tri, stiffness=STIFF,
                                       **CAPS)
    tt = build_mesh_topology(v, se, be, sh, tri, stiffness=STIFF,
                             device="cpu", **CAPS)
    for f in ("edges", "rest", "stiffness", "edge_mask", "degree",
              "triangles", "tri_mask", "nbr_idx", "nbr_rest", "nbr_stiff",
              "nbr_mask"):
        a, want = getattr(tt, f)[0], np.asarray(getattr(jt, f))
        assert tuple(a.shape) == want.shape, f
        assert np.array_equal(a.numpy(), want.astype(a.numpy().dtype)), f
    assert np.array_equal(tt.rest_positions[0].numpy(),
                          np.asarray(jt.rest_positions).T)
    # the normals' incidence table lists every corner of every triangle
    vt, vm = tt.vert_tri[0].numpy(), tt.vert_tri_mask[0].numpy()
    assert vm.sum() == 3 * len(tri)
    n = len(v)
    for vert in (0, n // 2, n - 1):
        assert sorted(vt[vm[:, vert], vert]) == sorted(
            np.nonzero((tri == vert).any(1))[0].tolist())
    # a grid cloth through the mesh path: the same tables
    jg = jtopology.grid_mesh_topology(6, 5, stiffness=STIFF)
    from flingbot_tpu_torch.engine.topology import grid_mesh_topology
    tg = grid_mesh_topology(6, 5, stiffness=STIFF, device="cpu")
    for f in ("edges", "rest", "nbr_idx", "nbr_rest", "degree", "triangles"):
        assert np.array_equal(getattr(tg, f)[0].numpy(),
                              np.asarray(getattr(jg, f)).astype(
                                  getattr(tg, f).numpy().dtype)), f


@pytest.mark.parametrize("shape", ["flat", "fold"])
def test_mesh_normals(sheet, shape):
    """Flat sheet: unit normals, all up or all down.  Folded flat onto
    itself: at the crease the faces of both halves cancel (|n| -> 0)."""
    v = sheet[0]
    pos = folded(v, gap=0.0) if shape == "fold" else \
        v.astype(np.float32) + np.float32([0, 0.02, 0])
    js, jt, ts, tt = pair(sheet, pos)
    n = aero.mesh_normals(ts.positions, tt.triangles, tt.tri_mask,
                          ts.active, tt.vert_tri, tt.vert_tri_mask)[0]
    ref = np.asarray(jaero.mesh_normals(js.positions.T, jt.triangles,
                                        jt.tri_mask, js.active))
    np.testing.assert_allclose(n.numpy(), ref, rtol=0, atol=PASS_TOL)
    nv = len(v)
    mag = n[:, :nv].norm(dim=0)
    if shape == "flat":
        np.testing.assert_allclose(mag.numpy(), 1.0, atol=1e-6)
        assert float(n[1, :nv].abs().min()) > 0.999
    else:
        crease = v[:, 0] == crease_x(v)
        assert crease.sum() == NY
        assert float(mag[torch.as_tensor(crease)].max()) < 0.5
        assert float(mag.max()) > 0.999
    assert float(n[:, nv:].abs().max()) == 0.0  # padding slots


def test_solve_springs_mesh(sheet):
    rng = np.random.default_rng(0)
    pos = sheet[0].astype(np.float32) * 1.05 + rng.normal(
        0, 1e-3, sheet[0].shape).astype(np.float32)
    js, jt, ts, tt = pair(sheet, pos)
    w = torch.where(ts.active, ts.inv_mass, 0.0)
    out = solve_springs_mesh(ts.positions, w, tt, 0.9)[0]
    ref = jsolver.solve_springs_mesh(
        js.positions.T, jnp.where(js.active, js.inv_mass, 0.0), jt,
        jnp.float32(0.9))
    assert float(np.abs(np.asarray(ref) - np.asarray(js.positions.T)).max()
                 ) > 1e-4
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=PASS_TOL)


@pytest.mark.parametrize("knob", ["none", "aero", "picker_friction"])
@pytest.mark.parametrize("contact_mode", ["sort", "block"])
def test_step_mesh(sheet, contact_mode, knob):
    """One frame of _step_mesh on the folded sheet with a picker pressing
    on it: contacts fire; drag and lift through the mesh normals; picker
    friction against the substep's entry positions."""
    rng = np.random.default_rng(1)
    pos = folded(sheet[0], rng=rng)
    picker = np.array([pos[20] + [0.0, 0.015, 0.0], [-10.0, -10.0, -10.0]],
                      np.float32)
    js, jt, ts, tt = pair(sheet, pos, picker)
    over = {"none": {}, "aero": AERO,
            "picker_friction": {"picker_friction": 0.75}}[knob]
    params = SolverParams(**over)
    jparams = JParams().replace(**{
        k: jnp.asarray(v, jnp.float32) for k, v in over.items()})
    kw = dict(KW, spring_mode="gs", contact_mode=contact_mode)
    out = step(ts, tt, params, backend="xla", **kw)
    ref = jax.jit(lambda s: jsolver.step(
        s, jt, jparams, backend="xla", aero=knob == "aero", **kw))(js)
    np.testing.assert_allclose(out.positions[0].numpy().T,
                               np.asarray(ref.positions), rtol=0,
                               atol=FRAME_TOL_P)
    np.testing.assert_allclose(out.velocities[0].numpy().T,
                               np.asarray(ref.velocities), rtol=0,
                               atol=FRAME_TOL_V)
    if contact_mode == "block":
        assert np.array_equal(out.sweep_perm[0].numpy(),
                              np.asarray(ref.sweep_perm))
    # the knob and the contacts act: the frame differs without them
    plain = step(ts, tt, SolverParams(), backend="xla",
                 **dict(kw, contact_mode=contact_mode))
    bare = step(ts, tt, params, backend="xla", self_collision=False, **{
        k: v for k, v in kw.items() if k != "contact_mode"})
    assert float((bare.positions - out.positions).abs().max()) > 1e-4
    if knob != "none":
        assert float((plain.positions - out.positions).abs().max()) > 1e-6


@pytest.mark.parametrize("knob", ["aero", "picker_friction"])
def test_layered_aero_and_picker_friction(knob):
    """Drag and lift on a layered shirt (through the mesh normals of its
    layered triangles), and picker friction, against the JAX
    _step_layered: one frame."""
    from flingbot_tpu.env.shirts import write_shirt_obj
    from flingbot_tpu_torch.engine.topology import compute_layered_spec
    from flingbot_tpu_torch.env.scene import make_batch, shirt_task
    from tests.test_torch_shirts import SMALL_SHIRT, jax_scene
    import tempfile, os

    rng = np.random.default_rng(2)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "small_processed.obj")
        write_shirt_obj(path, **SMALL_SHIRT)
        task = shirt_task(path)
    pp = task.particle_pos.reshape(-1, 4).copy()
    pp[:, :3] += rng.normal(0, 2e-3, (len(pp), 3))
    task.particle_pos = pp.reshape(-1)
    spec = compute_layered_spec([task.mesh_arrays()])
    topo, state = make_batch([task], device="cpu", layered_spec=spec)
    scene = jax_scene(task, spec)
    grab = pp[10, :3] + np.float32([0.0, 0.015, 0.0])
    picker = np.stack([grab, np.full(3, -10.0, np.float32)])
    state = state.replace(picker_pos=t(picker)[None])
    js = scene.state.replace(picker_pos=jnp.asarray(picker))
    over = AERO if knob == "aero" else {"picker_friction": 0.75}
    jparams = JParams().replace(**{
        k: jnp.asarray(v, jnp.float32) for k, v in over.items()})
    kw = dict(KW, spring_mode="chebyshev", contact_mode="sort")
    out = step(state, topo, SolverParams(**over), **kw)
    ref = jax.jit(lambda s: jsolver.step(
        s, scene.topo, jparams, backend="xla", aero=knob == "aero",
        **kw))(js)
    np.testing.assert_allclose(np.swapaxes(out.positions.numpy(), 1, 2)[0],
                               np.asarray(ref.positions), rtol=0,
                               atol=FRAME_TOL_P)
    np.testing.assert_allclose(np.swapaxes(out.velocities.numpy(), 1, 2)[0],
                               np.asarray(ref.velocities), rtol=0,
                               atol=FRAME_TOL_V)
    plain = step(state, topo, SolverParams(), **kw)
    assert float((plain.velocities - out.velocities).abs().max()) > 1e-3


def test_batch_env_on_mesh_caps(sheet):
    """BatchSimEnv on a mesh_caps bucket at production knobs: two sheets
    loaded through scene_task and the generic mesh path, reset (settle,
    observe), then one step; the settle frame, the selected action and the
    pre-action coverage against the JAX env's functions on the same tasks
    (the xla backend's sorted contact group).  The step runs in chunks of
    8 interpreter steps: an env that is done stays as it is, so the chunk
    size changes only how many no-op steps follow the programs' end."""
    from flingbot_tpu.env.observation import compute_observation
    from flingbot_tpu.env.scene import set_scene
    from flingbot_tpu.env.sim_env import PARK_PICKERS, step_begin
    from flingbot_tpu.env.primitives import PrimitiveConfig as JCfg
    from flingbot_tpu_torch.env.batch_env import BatchSimEnv
    from flingbot_tpu_torch.env.tasks import Task

    v, tri, se, be, sh = sheet
    rng = np.random.default_rng(3)
    tasks = []
    for i, mass in enumerate((0.5, 0.8)):
        pos = folded(v, rng=rng) if i else (
            v.astype(np.float32) + np.float32([0, 0.01, 0]))
        n = len(v)
        pp = np.concatenate([pos, np.full((n, 1), n / mass, np.float32)], 1)
        tasks.append(Task(
            name=f"t{i}", flatten_area=0.03, initial_coverage=0.02,
            task_difficulty="shirt", particle_pos=pp.reshape(-1),
            particle_vel=np.zeros(3 * n, np.float32),
            mesh_verts=v.reshape(-1), mesh_stretch_edges=se.reshape(-1),
            mesh_bend_edges=be.reshape(-1), mesh_shear_edges=sh.reshape(-1),
            mesh_faces=tri.reshape(-1), cloth_stiff=np.array(STIFF),
            cloth_mass=mass, cloth_pos=np.array([0.0, 0.0, 0.0])))
    queue = list(tasks)
    rot = np.array([-90.0, 0.0, 90.0], np.float32)
    scales = np.array([1.0, 2.0], np.float32)
    env = BatchSimEnv(get_task_fn=lambda: queue.pop(0), num_envs=2,
                      mesh_caps=MESH_CAPS, obs_dim=32, num_rotations=3,
                      scale_factors=scales, render_dim=128,
                      domain_randomization=False, max_program_steps=40,
                      chunk_steps=8, device="cpu", **KW)
    obs = env.reset()
    assert isinstance(env.topo, MeshTopology)
    settled = env.state
    # the JAX env's scenes and settle step on the same tasks
    jp = JParams()
    scenes = [set_scene(tk.get_config(), tk.get_state(),
                        mesh_caps=MESH_CAPS) for tk in tasks]
    park = jnp.asarray(PARK_PICKERS)
    jstate = stack([s.state.replace(picker_pos=park) for s in scenes])
    jtopo = stack([s.topo for s in scenes])
    jkw = dict(KW, spring_mode="chebyshev", contact_mode="sort",
               backend="xla")
    jset = jax.jit(jax.vmap(lambda s, tp: jsolver.step(s, tp, jp, **jkw)))(
        jstate, jtopo)
    np.testing.assert_allclose(np.swapaxes(settled.positions.numpy(), 1, 2),
                               np.asarray(jset.positions), rtol=0,
                               atol=FRAME_TOL_P)
    # from the port's settled state: observation, action, pre-coverage
    jstate = jset.replace(
        positions=jnp.asarray(np.swapaxes(settled.positions.numpy(), 1, 2)),
        velocities=jnp.asarray(np.swapaxes(settled.velocities.numpy(), 1,
                                           2)))
    jobs = jax.vmap(lambda p, a, f, m: compute_observation(
        p, a, jnp.asarray(rot), jnp.asarray(scales), faces=f, tri_mask=m,
        image_size=128, obs_dim=32))(jstate.positions, jstate.active,
                                      jtopo.triangles, jtopo.tri_mask)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs.obs_stack),
                               atol=1e-5)
    vm = rng.uniform(size=(2, 1, 6, 32, 32)).astype(np.float32)
    sel, pre_cov, _, _, _ = jax.vmap(
        lambda s, tp, vv, o: step_begin(
            s, tp, jp, vv, o, jnp.asarray(rot), ("fling",),
            JCfg(max_program_steps=40), pix_grasp_dist=8))(
        jstate, jtopo, jnp.asarray(vm), jobs)
    env.step(torch.as_tensor(vm))
    last = env.last
    for f in ("transform_idx", "row", "col", "p1_grasp", "p2_grasp"):
        np.testing.assert_array_equal(np.asarray(getattr(sel, f)),
                                      getattr(last.selection, f).numpy(),
                                      err_msg=f)
    np.testing.assert_allclose(last.pre_coverage.numpy(),
                               np.asarray(pre_cov), rtol=1e-6)
    assert np.isfinite(env.state.positions.numpy()).all()
    assert env.state.step_count.min() > 1


@pytest.mark.parametrize("which", ["shirt", "rect"])
def test_eval_generic_mesh_tool_passes_the_mesh_bucket(which, monkeypatch):
    """tools/eval_generic_mesh.py runs eval_quality's evaluation with the
    shirt file's mesh bucket in place of its layered spec, and refuses a
    file that holds no meshes."""
    from flingbot_tpu_torch import eval_quality
    from flingbot_tpu_torch.env.tasks import detect_mesh_caps
    from tools import eval_generic_mesh

    path = {"shirt": "data_r3/shirt_eval_16.npz",
            "rect": "data_r3/rect_eval_hard_100.npz"}[which]
    seen = {}
    monkeypatch.setattr(eval_quality, "main",
                        lambda argv, buckets: seen.update(
                            argv=argv, buckets=buckets))
    argv = ["--tasks", path, "--device", "cpu", "--episodes", "2"]
    if which == "rect":
        with pytest.raises(SystemExit, match="no mesh tasks"):
            eval_generic_mesh.main(argv)
        return
    eval_generic_mesh.main(argv)
    assert seen["argv"] == argv
    assert seen["buckets"] == {"mesh_caps": detect_mesh_caps(path),
                               "layered_spec": None}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_contacts_mesh_generic_kernel_matches_plain(cuda_device, sheet):
    """The contacts kernel's mesh mode at the generic mesh path's shape (a
    MeshTopology padded to its vertex capacity) against its plain version
    on the same sorted inputs."""
    from flingbot_tpu_torch.engine import collisions

    rng = np.random.default_rng(4)
    pos = folded(sheet[0], rng=rng)
    ts, tt = port_pair(sheet, pos)
    ts, tt = ts.to(cuda_device), tt.to(cuda_device)
    moved = step(ts, tt, SolverParams(), self_collision=False, **KW)
    params = SolverParams()
    w = torch.where(ts.active, ts.inv_mass, 0.0)
    _, srt = collisions.sort_particles(
        moved.positions, ts.positions, w, ts.active,
        rest_dist=params.radius, rest_positions=tt.rest_positions)
    cp = kernels.contact_params(params, params.radius, 1, cuda_device)
    kw = dict(rests=srt[7:], window=12, iterations=4)
    before = kernels.LAUNCHES["contacts_mesh"]
    out_k = kernels.contacts(cp, *srt[:7], **kw)
    out_p = kernels.contacts_plain(cp, *srt[:7], **kw)
    assert kernels.LAUNCHES["contacts_mesh"] == before + 1
    for a, b in zip(out_k, out_p):
        assert float((a - b).abs().max()) <= 2e-6
