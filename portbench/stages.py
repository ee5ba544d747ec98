"""The solver's stages on the device trace's clock: the program's own spans
(flingbot_tpu_torch.utils.trace) laid over a traced window, so that each
device operation counts for the stage that launched it and each idle gap
for the span the host was in.

    python3 -m portbench.stages --workload rect-hard.physics --seed <n> \
        --seconds 51 --trace <0|1>

runs a cell's driver as portbench/run.py does, with the program's tracer
on over the window (its spans and counters zeroed at the window's start),
and prints one JSON line last: the rate with tracing on, and with
--trace 1 the cell's per-layer metrics, the readers of the program's
spans and counters (host_syncs_per_frame, sort_device_ms,
glue_device_ms, host_frame_ms), device ms a frame by stage and idle
seconds by span.  The window is not judged against the reference: this
is a measurement of where the time goes, not a benchmark run.

The device runs behind the host, so an operation's own time says nothing
of the stage that issued it.  Each device operation is tied to its
launching runtime call through the profiler's correlation id; the call's
host time is put on time.perf_counter by the marker kernel's own launch
(DeviceTrace reads the clock just before it), and the innermost program
span holding that time is the operation's stage.  An upload's copy counts
for the stage around its solver.sync span.  Idle gaps are named
"<harness span>/<innermost program span>" by the host time of their
midpoint, the harness span's name alone where no program span held it.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import sys
import time

from portbench import harness

ROOT_SPAN = "solver.step"
SYNC_SPAN = "solver.sync"
OUTSIDE = "outside"  # launched inside no program span
# the solver's stages that the glue is made of: the frame's set-up, the
# contact group's epilogue and the root's own operations
GLUE = ("solver.prep", "solver.contacts.apply", ROOT_SPAN)
READERS = ("host_syncs_per_frame", "sort_device_ms", "glue_device_ms",
           "host_frame_ms")


@dataclasses.dataclass
class ProgramTrace:
    """The program's spans and counters over a window; with a device
    trace also device time by launching stage and idle time by span."""

    spans: list  # (name, id, parent id, frame id, t0, t1), perf_counter
    counts: dict  # host_syncs, ..., and the kernel launch counters
    device_s: dict = dataclasses.field(default_factory=dict)
    # stage -> [device seconds, kernels] of the operations it launched
    idle_s: dict = dataclasses.field(default_factory=dict)
    # "<harness span>/<program span>" -> idle seconds
    idle_stage_s: dict = dataclasses.field(default_factory=dict)
    # the same by stage, an upload's idle counted for the stage around it
    clock_shift_s: float = 0.0  # the uploads' correction of the launches'
    # host times (_upload_shift)
    uploads_placed: tuple = (0, 0)  # host-to-device copies launched
    # inside a solver.sync span, of all in the window: the clock's check


def innermost(spans):
    """(times, labels): from times[k] until times[k + 1] the host was
    inside labels[k], the innermost span then open (None where none
    was).  Spans nest, as the program's stack of spans makes them."""
    marks = []
    for s in spans:
        marks.append((s[4], 1, s[1], s))  # opens: parents first
        marks.append((s[5], 0, -s[1], s))  # closes first, children first
    marks.sort(key=lambda m: m[:3])
    times, labels, stack = [], [], []
    for t, opens, _, s in marks:
        if opens:
            stack.append(s)
        else:
            stack.remove(s)
        times.append(t)
        labels.append(stack[-1] if stack else None)
    return times, labels


def _at(times, labels, t):
    k = bisect.bisect_right(times, t) - 1
    return labels[k] if k >= 0 else None


def _kineto(device_trace):
    """The window's device operations (start_us, end_us, name,
    correlation id) and, by correlation id, the start (ns) of each
    runtime call that launched one."""
    from torch.autograd import DeviceType
    raw = getattr(device_trace.prof.profiler, "kineto_results", None)
    if raw is None:
        raise harness.BenchError("the profiler kept no raw kineto results")
    ops, launches = [], {}
    for e in raw.events():
        start, corr = e.start_ns(), e.correlation_id()
        if e.device_type() == DeviceType.CUDA:
            dur = e.duration_ns()
            if dur > 0:
                ops.append((start * 1e-3, (start + dur) * 1e-3, e.name(),
                            corr))
        elif corr > 0:
            launches[corr] = min(start, launches.get(corr, start))
    return sorted(ops), launches


def attribute(device_trace, harness_spans: harness.Spans, program_spans,
              counts) -> ProgramTrace:
    """Device time by launching stage and idle time by span over the
    traced window [device_trace.t0, device_trace.t1]."""
    ops, launches = _kineto(device_trace)
    anchor = next((op for op in ops if "sleep" in op[2].lower()
                   or "spin" in op[2].lower()), None)
    if anchor is None:
        raise harness.BenchError("the trace holds no marker kernel to tie "
                                 "the device clock to the host's")
    if anchor[3] not in launches:
        raise harness.BenchError("the trace holds no runtime call that "
                                 "launched the marker: nothing ties a "
                                 "launch to the host clock")
    dev_offset = device_trace.t_marker - anchor[0] * 1e-6  # device us -> s
    launch_offset = device_trace.t_marker - launches[anchor[3]] * 1e-9
    lo, hi = device_trace.t0, device_trace.t1
    window = []  # (host start, host end, name, launch on the host clock)
    for op in ops:
        s, e, name, corr = op
        hs, he = s * 1e-6 + dev_offset, e * 1e-6 + dev_offset
        if he <= lo or hs >= hi or op == anchor:
            continue
        launch = launches.get(corr)
        window.append((max(hs, lo), min(he, hi), name,
                       None if launch is None
                       else launch * 1e-9 + launch_offset))
    shift = _upload_shift(window, program_spans)
    times, labels = innermost(program_spans)
    by_id = {s[1]: s for s in program_spans}

    def stage(span):
        if span is None:
            return OUTSIDE
        if span[0] == SYNC_SPAN and span[2] in by_id:
            return by_id[span[2]][0]
        return span[0]

    device_s = {}
    placed = total = 0
    for hs, he, name, launch in window:
        if launch is None:
            key = "unmatched"
        else:
            span = _at(times, labels, launch + shift)
            key = stage(span)
            if "HtoD" in name:
                total += 1
                placed += span is not None and span[0] == SYNC_SPAN
        acc = device_s.setdefault(key, [0.0, 0])
        acc[0] += he - hs
        acc[1] += 0 if name.startswith(("Memcpy", "Memset", "memcpy",
                                        "memset")) else 1
    h_items = sorted(harness_spans.items, key=lambda x: x[1])
    h_starts = [x[1] for x in h_items]

    def harness_at(t):
        k = bisect.bisect_right(h_starts, t) - 1
        return h_items[k][0] if k >= 0 and t < h_items[k][2] else "harness"

    idle, idle_stage = {}, {}
    for gs, ge in _gaps([w[:2] for w in window], lo, hi):
        mid = 0.5 * (gs + ge)
        span = _at(times, labels, mid)
        name = harness_at(mid) + ("/" + span[0] if span else "")
        idle[name] = idle.get(name, 0.0) + (ge - gs)
        key = stage(span)
        idle_stage[key] = idle_stage.get(key, 0.0) + (ge - gs)
    return ProgramTrace(spans=program_spans, counts=counts,
                        device_s=device_s, idle_s=idle,
                        idle_stage_s=idle_stage, clock_shift_s=shift,
                        uploads_placed=(placed, total))


def _upload_shift(window, program_spans) -> float:
    """Seconds to add to the launches' host times so that each upload's
    copy is launched inside its own solver.sync span.  The marker ties
    the clocks to within the few microseconds between DeviceTrace's read
    of the clock and the marker's launch, which differ from run to run;
    the uploads tie them again, thousands of times over a window: the
    k-th host-to-device copy is the k-th upload, and the quickest upload
    is put at its span's start.  0 where the copies and the spans do not
    pair up."""
    syncs = sorted(s[4] for s in program_spans if s[0] == SYNC_SPAN)
    copies = sorted(w[3] for w in window
                    if "HtoD" in w[2] and w[3] is not None)
    if not syncs or len(syncs) != len(copies):
        return 0.0
    return -min(c - s for c, s in zip(copies, syncs))


def _gaps(intervals, lo, hi):
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def device_ms(run, stages) -> float | None:
    """Device ms a batched frame launched in these stages, or None where
    the run has no attribution."""
    p = getattr(run, "program", None)
    if p is None or not p.device_s or not run.frames:
        return None
    return 1e3 * sum(p.device_s.get(s, [0.0])[0] for s in stages) \
        / run.frames


def main(argv=None, device=None, overrides=None, out=None) -> int:
    """One run.  device: None for the card (checked); the tests pass "cpu"
    with small traffic overrides and --trace 0."""
    from portbench import run as bench
    args = bench.parse_args(argv)
    if args.control:
        raise harness.BenchError("the control is portbench/run.py's")
    bench._cache_env()
    cell = harness.load_cell(args.workload)
    import torch
    from flingbot_tpu_torch.utils import trace
    if device is None:
        if not torch.cuda.is_available():
            raise bench.NoCard("torch.cuda.is_available() is false")
        device = "cuda"
    ctx = bench.Context(cell, args, device, torch, overrides)

    class SpanWindow(bench.Window):
        """The window with the program's record zeroed at its start and
        taken at its end."""

        def __enter__(self):
            trace.drain()
            return super().__enter__()

        def __exit__(self, *exc):
            done = super().__exit__(*exc)
            self.program = trace.drain()
            return done

    windows = []
    ctx.window = lambda: windows.append(SpanWindow(ctx)) or windows[-1]
    trace.enable()
    try:
        r, _, attempted, failed = harness.driver(
            cell.cell["driver"]).run(ctx)
    finally:
        trace.disable()
    win = windows[-1]
    spans, counts = win.program
    result = {"workload": cell.name, "seed": args.seed,
              "device": torch.cuda.get_device_name(ctx.device)
              if ctx.cuda else "cpu",
              "sim_steps_per_s": r.env_frames / r.window_s,
              "setup_s": r.setup_s, "frames": r.frames,
              "attempted": int(attempted), "failed": int(failed)}
    if args.trace:
        t = time.perf_counter()
        r.program = attribute(win.trace, r.spans, spans, counts)
        print(f"portbench: stages read in {time.perf_counter() - t:.1f} s",
              file=sys.stderr)
        metrics = {}
        for m in cell.per_layer:
            metrics[m["name"]] = harness.metric_reader(m["name"])(r)
        for name in READERS:
            metrics[name] = harness.metric_reader(name)(r)
        p = r.program
        result.update(
            metrics=metrics, busy_s=r.trace.busy_s,
            window_s=r.trace.window_s,
            device_ms_by_stage={k: 1e3 * v[0] / r.frames
                                for k, v in sorted(p.device_s.items())},
            kernels_by_stage={k: v[1] / r.frames
                              for k, v in sorted(p.device_s.items())},
            idle_s_by_span=dict(sorted(p.idle_s.items(),
                                       key=lambda x: -x[1])),
            idle_s_by_stage=dict(sorted(p.idle_stage_s.items(),
                                        key=lambda x: -x[1])),
            clock_shift_us=1e6 * p.clock_shift_s,
            uploads_in_sync_spans=list(p.uploads_placed),
            breakdown=harness.breakdown(r.trace))
    else:
        r.program = ProgramTrace(spans=spans, counts=counts)
        result["metrics"] = {n: harness.metric_reader(n)(r)
                             for n in ("host_syncs_per_frame",
                                       "host_frame_ms")}
    print(json.dumps(result), file=out or sys.stdout, flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # say why, print no result
        import traceback
        traceback.print_exc()
        raise SystemExit(3)
