"""portbench.stages on made-up profiler events: each device operation
counts for the program span that launched it, whenever it ran; idle gaps
are named by the program span the host was in; the harness's own
reduction of the same events is unchanged; the readers of the program's
record return None on a run without one."""

import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, stages

MARKER_US = 5000.0  # the marker kernel's start on the device clock
MARKER_LAUNCH_NS = 4.99e6  # its runtime call's start, host 100.000 s


class _Event:
    def __init__(self, start_us, dur_us, name, corr, device=DeviceType.CUDA):
        self._s, self._d, self._n, self._c, self._t = (start_us, dur_us,
                                                       name, corr, device)

    def device_type(self):
        return self._t

    def start_ns(self):
        return int(round(self._s * 1000))

    def duration_ns(self):
        return int(round(self._d * 1000))

    def name(self):
        return self._n

    def correlation_id(self):
        return self._c


def _kernel(corr, launched_s, runs_s, dur_us, name, skew_us=0.0):
    """A runtime call at host time launched_s (skew_us later on the
    profiler's clock than the marker's launch says) and the device
    operation it launched, running from host time runs_s."""
    return [_Event((MARKER_LAUNCH_NS + (launched_s - 100.0) * 1e9) / 1e3
                   + skew_us, 2, "cudaLaunchKernel", corr, DeviceType.CPU),
            _Event(MARKER_US + (runs_s - 100.0) * 1e6, dur_us, name, corr)]


def _trace(events):
    tr = object.__new__(harness.DeviceTrace)
    tr.torch = torch
    raw = types.SimpleNamespace(events=lambda: events)
    tr.prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=raw))
    tr.t_marker, tr.t0, tr.t1 = 100.0, 100.001, 100.1
    return tr


# one frame: (name, id, parent, frame, t0, t1) on the host clock
SPANS = [("solver.sync", 3, 2, 1, 100.011, 100.012),
         ("solver.contacts.sort", 2, 1, 1, 100.010, 100.020),
         ("solver.contacts.apply", 4, 1, 1, 100.020, 100.030),
         ("solver.step", 1, None, 1, 100.002, 100.050)]


def _events(skew_us=0.0):
    launched = [
        (1, 100.0, 100.0, 1, "void at::cuda::sleep(long)"),
        # launched in the root, ends before the upload's copy starts
        (12, 100.003, 100.0100, 800, "prep_kernel"),
        # launched in sort, runs while the host is in apply
        (7, 100.015, 100.0345, 10, "radix_sort_kernel"),
        # the upload's copy, launched as its sync span opens: counts for
        # sort, the stage around it
        (8, 100.011, 100.0116, 1, "Memcpy HtoD (Pageable)"),
        # launched 3 us into apply
        (9, 100.020003, 100.0445, 4, "scatter_kernel"),
        (10, 100.040, 100.0485, 3, "root_kernel"),
        (11, 100.060, 100.0620, 2, "after_frame")]
    return sum((_kernel(*k, skew_us=0.0 if k[0] == 1 else skew_us)
                for k in launched), [])


def _harness_spans():
    sp = harness.Spans()
    sp.add("solver_step", 100.001, 100.1)
    return sp


def test_an_operation_counts_for_the_span_that_launched_it():
    p = stages.attribute(_trace(_events()), _harness_spans(), SPANS,
                         {"host_syncs": 1})
    assert p.device_s["solver.contacts.sort"] == pytest.approx([11e-6, 1])
    assert p.device_s["solver.contacts.apply"] == pytest.approx([4e-6, 1])
    assert p.device_s["solver.step"] == pytest.approx([803e-6, 2])
    assert p.device_s["outside"] == pytest.approx([2e-6, 1])
    assert "solver.sync" not in p.device_s
    assert p.uploads_placed == (1, 1)
    run = harness.Run(window_s=1.0, setup_s=1.0, env_frames=2, frames=1)
    assert harness.metric_reader("sort_device_ms.physics")(run) is None
    run.program = p
    assert harness.metric_reader("sort_device_ms.physics")(run) == \
        pytest.approx(11e-3)
    assert harness.metric_reader("glue_device_ms.physics")(run) == \
        pytest.approx(0.807)
    assert harness.metric_reader("host_syncs_per_frame.physics")(run) == 1.0
    assert harness.metric_reader("host_frame_ms.physics")(run) == \
        pytest.approx(1e3 * (0.048 - 0.001))


@pytest.mark.parametrize("skew_us", [-20.0, 15.0])
def test_the_uploads_tie_the_launch_clock_to_the_host(skew_us):
    """A marker launch read skew_us off: each upload's copy still lands in
    its own sync span, and the kernel launched 3 us into apply counts for
    apply."""
    exact = stages.attribute(_trace(_events()), _harness_spans(), SPANS, {})
    p = stages.attribute(_trace(_events(skew_us)), _harness_spans(), SPANS,
                         {})
    assert exact.clock_shift_s == 0.0
    assert p.clock_shift_s == pytest.approx(-skew_us * 1e-6, abs=1e-9)
    assert p.uploads_placed == (1, 1)
    assert p.device_s == pytest.approx(exact.device_s)


def test_an_idle_gap_is_named_by_the_span_the_host_was_in():
    p = stages.attribute(_trace(_events()), _harness_spans(), SPANS, {})
    idle = p.idle_s
    # gaps on the host clock; a gap's midpoint names it
    # 100.011601-100.0345 (after the upload's copy): the host in apply
    assert idle["solver_step/solver.contacts.apply"] == \
        pytest.approx(0.022899, abs=1e-9)
    # 100.001-100.0100, 100.03451-100.0445, 100.044504-100.0485: the root
    assert idle["solver_step/solver.step"] == pytest.approx(
        0.009 + 0.00999 + 0.003996, abs=1e-9)
    # 100.0108-100.0116: the host waiting inside the upload
    assert idle["solver_step/solver.sync"] == pytest.approx(0.0008,
                                                            abs=1e-9)
    # after the frame: no program span held the host
    assert idle["solver_step"] == pytest.approx(
        (100.062 - 100.048503) + (100.1 - 100.062002), abs=1e-9)
    assert sum(idle.values()) == pytest.approx(0.099 - 820e-6, abs=1e-9)
    assert p.idle_stage_s == pytest.approx(
        {"solver.contacts.sort": idle["solver_step/solver.sync"],
         "solver.contacts.apply": idle["solver_step/solver.contacts.apply"],
         "solver.step": idle["solver_step/solver.step"],
         "outside": idle["solver_step"]}, abs=1e-12)


def test_the_harness_reads_the_same_events_as_before():
    """The runtime calls the attribution needs leave the harness's own
    reduction, by_span and idle_by_phase and every reader, unchanged."""
    events = _events()
    device_only = [e for e in events if e.device_type() == DeviceType.CUDA]
    a = _trace(events).summary(_harness_spans())
    b = _trace(device_only).summary(_harness_spans())
    assert a == b
    assert a.by_span["solver_step"] == pytest.approx([820e-6, 5])
    assert a.idle_by_phase["solver_step"] == pytest.approx(0.099 - 820e-6)
    run = harness.Run(window_s=1.0, setup_s=1.0, env_frames=2, frames=1,
                      frame_spans=("solver_step",), trace=a)
    assert harness.metric_reader("frame_device_ms.physics")(run) == \
        pytest.approx(0.82)
    assert harness.metric_reader("launches_per_frame.physics")(run) == 5


def test_a_trace_without_the_markers_launch_fails():
    events = [e for e in _events() if e.correlation_id() != 1
              or e.device_type() == DeviceType.CUDA]
    with pytest.raises(harness.BenchError, match="launched the marker"):
        stages.attribute(_trace(events), _harness_spans(), SPANS, {})


def test_innermost_follows_nesting_and_adjacent_spans():
    times, labels = stages.innermost(SPANS)
    at = lambda t: (stages._at(times, labels, t) or ("none",))[0]  # noqa
    assert [at(t) for t in (100.001, 100.005, 100.0112, 100.015, 100.020,
                            100.035, 100.050)] == [
        "none", "solver.step", "solver.sync", "solver.contacts.sort",
        "solver.contacts.apply", "solver.step", "none"]


def test_the_program_readers_find_nothing_on_a_run_without_a_record():
    run = harness.Run(window_s=1.0, setup_s=1.0, env_frames=2, frames=1)
    for name in stages.READERS:
        assert harness.metric_reader(name)(run) is None
    run.program = stages.ProgramTrace(spans=[], counts={})
    for name in stages.READERS:
        assert harness.metric_reader(name)(run) is None


def test_a_physics_window_with_the_program_tracer_on():
    """portbench.stages at --trace 0 on the CPU, two envs: the record is
    zeroed at the window's start, so the counter reads 9 uploads a frame
    and every frame has its own root span."""
    import io
    import json

    from portbench.tests.tiny import OVERRIDES
    out = io.StringIO()
    torch.set_num_threads(2)
    # a seed whose correctness frame is the window's second, so that the
    # window ends after its second
    assert stages.main(["--workload", "rect-hard.physics", "--seed",
                        str(2 ** 31 + 75), "--seconds", "1", "--trace", "0"],
                       device="cpu", overrides=OVERRIDES, out=out) == 0
    r = json.loads(out.getvalue().strip().splitlines()[-1])
    assert r["frames"] > 0 and r["failed"] == 0
    assert r["metrics"]["host_syncs_per_frame"] == 9.0
    assert r["metrics"]["host_frame_ms"] > 0
