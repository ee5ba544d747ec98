"""The device trace's reduction on made-up profiler events: the marker
ties the clocks, each operation counts for the harness span it ran in,
and a trace with no raw results or no marker fails loudly."""

import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness


class _Event:
    def __init__(self, start_us, dur_us, name, device=DeviceType.CUDA):
        self._s, self._d, self._n, self._t = start_us, dur_us, name, device

    def device_type(self):
        return self._t

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._d * 1000)

    def name(self):
        return self._n


def _trace(events, t_marker=100.0, t0=100.001, t1=100.1):
    """A DeviceTrace whose profiler kept `events` (device clock in us)."""
    tr = object.__new__(harness.DeviceTrace)
    tr.torch = torch
    raw = types.SimpleNamespace(events=lambda: events)
    tr.prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=raw))
    tr.t_marker, tr.t0, tr.t1 = t_marker, t0, t1
    return tr


def _spans():
    sp = harness.Spans()
    sp.add("run_program", 100.002, 100.050)  # host seconds
    sp.add("end_step", 100.051, 100.090)
    return sp


def test_operations_count_for_the_span_they_ran_in():
    # device clock: the marker starts at 5000 us, i.e. host 100.000 s
    def at(host_s):
        return 5000 + (host_s - 100.0) * 1e6

    events = [_Event(5000, 1, "void at::cuda::sleep(long)"),
              _Event(at(100.010), 20, "substeps_kernel"),
              _Event(at(100.040), 5, "contacts_kernel"),
              _Event(at(100.060), 10, "render_kernel"),  # end_step
              _Event(at(100.070), 2, "Memcpy DtoH"),  # end_step
              _Event(at(100.095), 1, "late_kernel"),  # in no span
              _Event(at(100.500), 1, "after_window"),  # past t1
              _Event(at(100.020), 3, "host_op", DeviceType.CPU)]
    s = _trace(events).summary(_spans())
    assert s.in_spans(("run_program",)) == pytest.approx((25e-6, 2))
    secs, count = s.in_spans(("end_step",))
    assert secs == pytest.approx(12e-6) and count == 1
    assert s.by_span["harness"][1] == 1
    assert "after_window" not in s.kernels
    assert set(s.kernels) == {"substeps_kernel", "contacts_kernel",
                              "render_kernel", "late_kernel"}
    assert s.stage_s == pytest.approx({"springs": 20e-6,
                                       "contacts": 5e-6})
    assert s.busy_s == pytest.approx(38e-6)
    run = harness.Run(window_s=1.0, setup_s=1.0, env_frames=4, frames=2,
                      frame_spans=("run_program",), trace=s)
    assert harness.metric_reader("frame_device_ms.fling")(run) == \
        pytest.approx(1e3 * 25e-6 / 2)
    assert harness.metric_reader("launches_per_frame.fling")(run) == 1.0


def test_a_trace_with_no_marker_fails():
    with pytest.raises(harness.BenchError, match="marker"):
        _trace([_Event(15000, 20, "substeps_kernel")]).summary(_spans())


def test_a_trace_with_no_raw_results_fails():
    tr = _trace([])
    tr.prof.profiler.kineto_results = None
    with pytest.raises(harness.BenchError, match="raw kineto"):
        tr.summary(_spans())
