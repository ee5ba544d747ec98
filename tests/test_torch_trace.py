"""The port's tracer (flingbot_tpu_torch/utils/trace.py) in solver.step:
the span tree of one grid frame on the pallas backend, the host_syncs
counter, and tracing leaving the frame's numbers alone.  The CPU runs the
kernels' plain versions; the `cuda` test holds the counter against
PyTorch's own sync detection on a card:

    python -m pytest tests/test_torch_trace.py -m cuda

This file imports no JAX, so it runs on a machine without it."""

import warnings

import numpy as np
import pytest
import torch

from flingbot_tpu_torch.engine.solver import step
from flingbot_tpu_torch.engine.state import ClothState, SolverParams
from flingbot_tpu_torch.engine.topology import build_grid_topology
from flingbot_tpu_torch.utils import trace

DIM = 16
DIMS = ((16, 16), (12, 14))  # (dimx, dimy) of each env
# a grid frame on a card: 2 uploads in the frame's set-up, the contact
# parameters in each contact group (its sort kernels take rest_dist as an
# argument)
SYNCS_PER_FRAME = 4
# on the CPU each contact group's plain sort also uploads its two scalars
CPU_SYNCS_PER_FRAME = SYNCS_PER_FRAME + 2 * 2
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
        assert syncs == {"solver.prep": 2, "solver.contacts.sort": 4,
                         "solver.contacts.project": 2}
    assert len(spans) == 2 * (1 + len(STAGES) + CPU_SYNCS_PER_FRAME)


def test_host_syncs_rise_by_nine_a_frame_at_the_production_knobs():
    # the name is older than the count: a grid frame's dt upload went
    # with the contact epilogue kernel, and on the CPU a frame now makes
    # CPU_SYNCS_PER_FRAME (8; SYNCS_PER_FRAME on a card)
    state, topo = _batch("cpu")
    trace.drain()
    for frames in (1, 2):
        for _ in range(frames):
            state = step(state, topo, SolverParams())
        _, counts = trace.drain()
        assert counts["host_syncs"] == CPU_SYNCS_PER_FRAME * frames
        assert set(counts["launches"]) == {
            "substeps", "contacts", "contacts_mesh", "contact_apply",
            "contact_keys", "contact_gather", "contact_gather_mesh"}


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


@pytest.mark.cuda
def test_every_host_sync_of_a_frame_is_counted():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    state, topo = _batch(torch.device("cuda"))
    state = step(state, topo, SolverParams())  # builds and loads kernels
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
    syncs = [w for w in seen if "synchronizing" in str(w.message)]
    assert counts["host_syncs"] == SYNCS_PER_FRAME
    assert len(syncs) == counts["host_syncs"], [str(w.message)
                                                for w in seen]
