"""The port's tracer (flingbot_tpu_torch/utils/trace.py) in solver.step:
the span tree of one grid frame on the pallas backend, the host_syncs
and const_hits counters, tracing leaving the frame's numbers alone, and
the solver's constants kept on the device (engine.state.device_constant):
a warm frame uploads nothing, on every solver path, and computes the
same bits as a cold one.  The CPU runs the kernels' plain versions; the
`cuda` test holds the counter against PyTorch's own sync detection on a
card:

    python -m pytest tests/test_torch_trace.py -m cuda

This file imports no JAX, so it runs on a machine without it."""

import warnings

import numpy as np
import pytest
import torch

from flingbot_tpu_torch.engine import state as engine_state
from flingbot_tpu_torch.engine.solver import step
from flingbot_tpu_torch.engine.state import (
    ClothState, SolverParams, clear_device_constants, device_constant)
from flingbot_tpu_torch.engine.topology import build_grid_topology
from flingbot_tpu_torch.env.scene import make_batch, shirt_task
from flingbot_tpu_torch.env.shirts import write_shirt_obj
from flingbot_tpu_torch.utils import trace

DIM = 16
DIMS = ((16, 16), (12, 14))  # (dimx, dimy) of each env
# the constants of a grid frame on a card: 2 in the frame's set-up, the
# contact parameters in each contact group (its sort kernels take
# rest_dist as an argument).  The two groups' parameters are one value,
# so a cold frame uploads 3 and a warm one none.
CONSTANTS_PER_FRAME, COLD_SYNCS = 4, 3
# on the CPU each contact group's plain sort also takes its two scalars,
# the same two values in both groups
CPU_CONSTANTS_PER_FRAME = CONSTANTS_PER_FRAME + 2 * 2
CPU_COLD_SYNCS = COLD_SYNCS + 2
STAGES = ("solver.prep", "solver.substeps", "solver.contacts.sort",
          "solver.contacts.project", "solver.contacts.apply",
          "solver.substeps", "solver.contacts.sort",
          "solver.contacts.project", "solver.contacts.apply")


def _batch(device, seed=0):
    """Two crumpled-flat cloths of DIMS on a DIM x DIM lattice, at rest a
    few centimetres up, pickers parked."""
    rng = np.random.default_rng(seed)
    B, N = len(DIMS), DIM * DIM
    P = np.zeros((B, 3, DIM, DIM), np.float32)
    w = np.zeros((B, DIM, DIM), np.float32)
    for b, (dx, dy) in enumerate(DIMS):
        zz, xx = np.meshgrid(np.arange(dy) * 0.00625,
                             np.arange(dx) * 0.00625, indexing="ij")
        P[b, 0, :dy, :dx] = xx - xx.mean()
        P[b, 1, :dy, :dx] = 0.02 + rng.random((dy, dx)) * 4e-3
        P[b, 2, :dy, :dx] = zz - zz.mean()
        w[b, :dy, :dx] = dx * dy / 0.5
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    P = P.reshape(B, 3, N)
    w = w.reshape(B, N)
    state = ClothState(
        positions=t(P), velocities=t(np.zeros_like(P)), inv_mass=t(w),
        rest_inv_mass=t(w.copy()), active=t(w > 0),
        picker_pos=t(np.full((B, 2, 3), -10.0, np.float32)),
        picked_idx=t(np.full((B, 2), -1, np.int64)))
    topo = build_grid_topology([d[0] for d in DIMS], [d[1] for d in DIMS],
                               stiffness=(0.8, 1.0, 0.9), max_dimx=DIM,
                               max_dimy=DIM, device=device)
    return state, topo


@pytest.fixture(autouse=True)
def cold_constants():
    """Every test starts with no solver constant on the device, whichever
    tests ran before it in the process."""
    clear_device_constants()
    yield
    clear_device_constants()


@pytest.fixture
def tracing():
    """Tracing on for the test, the record emptied before and after."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def test_tracing_off_records_nothing_and_leaves_the_frame_bit_equal():
    state, topo = _batch("cpu")
    trace.drain()
    assert trace.span("solver.step") is trace.span("solver.prep")
    off = step(state, topo, SolverParams())
    assert trace.drain()[0] == []
    trace.enable()
    try:
        on = step(state, topo, SolverParams())
    finally:
        trace.disable()
        assert len(trace.drain()[0]) > 0
    for name, a in off.fields().items():
        assert torch.equal(a, getattr(on, name)), name


def test_a_grid_frame_records_its_stages_under_one_root(tracing):
    state, topo = _batch("cpu")
    for _ in range(2):
        state = step(state, topo, SolverParams())
    spans, _ = trace.drain()
    by_id = {s[1]: s for s in spans}
    roots = [s for s in spans if s[2] is None]
    assert [r[0] for r in roots] == ["solver.step"] * 2
    assert roots[0][5] <= roots[1][4]
    for root in roots:
        rid, frame = root[1], root[3]
        assert frame == rid
        mine = [s for s in spans if s[3] == rid]
        for s in mine:
            if s is not root:  # nested inside its parent, in one frame
                p = by_id[s[2]]
                assert p[3] == rid and p[4] <= s[4] <= s[5] <= p[5]
        children = sorted((s for s in mine if s[2] == rid),
                          key=lambda s: s[4])
        assert tuple(s[0] for s in children) == STAGES
        for a, b in zip(children, children[1:]):
            assert a[5] <= b[4]
        syncs = {}
        for s in mine:
            if s[0] == "solver.sync":
                parent_name = by_id[s[2]][0]
                syncs[parent_name] = syncs.get(parent_name, 0) + 1
        # the first frame uploads each constant the first time it is
        # met (the second contact group's are the first's); the second
        # frame finds them all on the device
        assert syncs == ({"solver.prep": 2, "solver.contacts.sort": 2,
                          "solver.contacts.project": 1}
                         if root is roots[0] else {})
    assert len(spans) == 2 * (1 + len(STAGES)) + CPU_COLD_SYNCS


def test_host_syncs_count_a_cold_frame_and_nothing_on_a_warm_one():
    state, topo = _batch("cpu")
    trace.drain()
    for frame in range(3):
        state = step(state, topo, SolverParams())
        _, counts = trace.drain()
        assert counts["host_syncs"] == (CPU_COLD_SYNCS if frame == 0
                                        else 0)
        assert counts["host_syncs"] + counts["const_hits"] \
            == CPU_CONSTANTS_PER_FRAME
        assert set(counts["launches"]) == {
            "substeps", "contacts", "contacts_mesh", "contact_apply",
            "contact_keys", "contact_gather", "contact_gather_mesh"}


def test_device_constant_keys_on_the_value_bits():
    dev = torch.device("cpu")
    trace.drain()
    a = device_constant([0.1, 0.0], dtype=torch.float32, device=dev)
    # the same float32 bits from a float64 that rounds to them: one value
    assert device_constant([float(np.float32(0.1)), 0.0],
                           dtype=torch.float32, device=dev) is a
    others = [device_constant([0.1, -0.0], dtype=torch.float32, device=dev),
              device_constant([0.1, 0.0], dtype=torch.float64, device=dev),
              device_constant([[0.1, 0.0]], dtype=torch.float32, device=dev),
              device_constant([0.1, np.nan], dtype=torch.float32,
                              device=dev)]
    assert device_constant([0.1, np.nan], dtype=torch.float32,
                           device=dev) is others[-1]
    assert all(o is not a for o in others)
    assert torch.signbit(others[0][1]) and others[1].dtype == torch.float64
    _, counts = trace.drain()
    assert (counts["host_syncs"], counts["const_hits"]) == (5, 2)
    clear_device_constants()
    assert device_constant([0.1, 0.0], dtype=torch.float32,
                           device=dev) is not a


SMALL_SHIRT = dict(body_w=0.15, body_h=0.20, sleeve_l=0.06, sleeve_h=0.06,
                   collar_w=0.06, spacing=0.0125)  # tests/test_torch_shirts.py
SHIRT_MESH_CAPS = (768, 3072, 1024)  # its 517 vertices, 2,977 edges, 968 tris
AERO = dict(drag=1.0, lift=0.5, wind=(0.5, 0.0, -0.25))
# path -> (batch, SolverParams overrides, step knobs, constants a frame).
# The substep loop (xla grid, layered, mesh) takes gravity and the
# substep length once a frame; every contact group on the CPU its
# parameters and the plain sort's two scalars; the aero grid step also
# gravity once a frame and the wind once a substep.
PATHS = {
    "grid-pallas": ("grid", {}, {}, CPU_CONSTANTS_PER_FRAME),
    "grid-xla-sort": ("grid", {}, dict(backend="xla", contact_mode="sort"),
                      2 + 2 * 3),
    "layered": ("layered", {}, {}, 2 + 2 * 3),
    "mesh": ("mesh", {}, {}, 2 + 2 * 3),
    "grid-aero": ("grid", AERO, {}, CPU_CONSTANTS_PER_FRAME + 1 + 4),
}


@pytest.fixture(scope="module")
def small_shirt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shirt") / "small_processed.obj")
    write_shirt_obj(path, **SMALL_SHIRT)
    return shirt_task(path)


@pytest.mark.parametrize("path", list(PATHS))
def test_a_warm_frame_uploads_nothing(path, small_shirt):
    batch, over, kw, per_frame = PATHS[path]
    if batch == "grid":
        state, topo = _batch("cpu")
    else:
        topo, state = make_batch(
            [small_shirt], device="cpu",
            mesh_caps=SHIRT_MESH_CAPS if batch == "mesh" else None)
    params = SolverParams(**over)
    state = step(state, topo, params, **kw)
    trace.drain()
    warm = step(state, topo, params, **kw)
    _, counts = trace.drain()
    assert (counts["host_syncs"], counts["const_hits"]) == (0, per_frame)
    clear_device_constants()
    cold = step(state, topo, params, **kw)
    _, counts = trace.drain()
    assert counts["host_syncs"] > 0
    for name, a in warm.fields().items():
        assert torch.equal(a, getattr(cold, name)), name
    kept = {k: (v, v.clone()) for k, v in engine_state._CONSTANTS.items()}
    for _ in range(3):  # no caller writes into a kept constant
        cold = step(cold, topo, params, **kw)
    assert engine_state._CONSTANTS.keys() == kept.keys()
    for k, (v, copy) in kept.items():
        assert engine_state._CONSTANTS[k] is v and torch.equal(v, copy)


def test_a_span_whose_block_raises_still_closes(tracing):
    with pytest.raises(ValueError):
        with trace.span("outer"):
            with trace.span("inner"):
                raise ValueError("stop")
    with trace.span("next"):
        pass
    (inner, outer, nxt), _ = trace.drain()
    assert (inner[0], outer[0], nxt[0]) == ("inner", "outer", "next")
    assert inner[2] == outer[1] and inner[3] == outer[1]
    assert outer[2] is None and nxt[2] is None and nxt[3] == nxt[1]


def _synchronizing(state, topo):
    """(counts, PyTorch's synchronizing warnings) of one frame."""
    torch.cuda.synchronize()
    trace.drain()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            step(state, topo, SolverParams())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _, counts = trace.drain()
    return counts, [str(w.message) for w in seen
                    if "synchronizing" in str(w.message)]


@pytest.mark.cuda
def test_every_host_sync_of_a_frame_is_counted():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    state, topo = _batch(torch.device("cuda"))
    state = step(state, topo, SolverParams())  # builds and loads kernels
    counts, syncs = _synchronizing(state, topo)  # a warm frame
    assert counts["host_syncs"] == 0 and syncs == []
    assert counts["const_hits"] == CONSTANTS_PER_FRAME
    clear_device_constants()
    counts, syncs = _synchronizing(state, topo)  # a cold one
    assert counts["host_syncs"] == COLD_SYNCS
    assert len(syncs) == counts["host_syncs"], syncs
