"""What every cell shares: the cell's files found by name, the task order
drawn from the seed, the harness's own spans, the device trace and its
reduction, and the work of the solver's stages.

Nothing here imports the program; the drivers do.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import importlib
import json
import os
import time
from typing import Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "flingbot_tpu")


class BenchError(RuntimeError):
    """A cell that cannot run as its files say."""


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


@dataclasses.dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads with its files: the cell
    (workloads/<name>.json: driver, the limits of its comparisons), its
    configuration (the configs entry's file) and its traffic mix
    (traffic/<traffic>.json)."""

    name: str
    chips: int
    cell: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    def data_path(self, key: str) -> str:
        """A file the configuration names (task set, checkpoint), checked
        against the digest the configuration records."""
        entry = self.config[key]
        path = os.path.join(ROOT, entry["path"])
        if sha256(path) != entry["sha256"]:
            raise BenchError(f"{entry['path']} differs from the file the "
                             f"configuration {self.config['name']} names")
        return path


def load_cell(name: str, bench_path: Optional[str] = None) -> Cell:
    bench = _load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(BENCH_DIR, "traffic",
                                      w["traffic"] + ".json"))
    cell = _load_json(os.path.join(BENCH_DIR, "workloads", name + ".json"))

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name=name, chips=int(w["chips"]), cell=cell, config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def driver(name: str):
    """drivers/<name>.py, found by name."""
    return importlib.import_module(f"portbench.drivers.{name}")


def base_name(name: str) -> str:
    """A metric's quantity: the name up to its first dot.  The rest names
    the family of cells it is reported in (frame_device_ms.physics), each
    family moving its own end-to-end metric under its own bound."""
    return name.split(".", 1)[0]


def metric_reader(name: str):
    """metrics/<quantity>.py, found by the metric's name: read(run) ->
    number or None."""
    return importlib.import_module(
        f"portbench.metrics.{base_name(name)}").read


def kernel_maps() -> list:
    """Every kernel_maps/*.json: {"match": substring of a device kernel's
    name, "stage": the solver stage its time counts for}."""
    d = os.path.join(BENCH_DIR, "kernel_maps")
    return [_load_json(os.path.join(d, f)) for f in sorted(os.listdir(d))
            if f.endswith(".json")]


# --------------------------------------------------------------------------
# traffic: which task each env slot holds, from the seed
# --------------------------------------------------------------------------

def task_order(n_tasks: int, num_envs: int, seed: int, block: int = 0):
    """The task indices of num_envs slots: the tasks tiled to num_envs (so
    every seed runs the same multiset of cloths) in an order drawn from
    the seed; block k > 0 is the k-th further draw, for reloads."""
    rng = np.random.default_rng([int(seed), int(block)])
    return rng.permutation(np.arange(num_envs) % n_tasks)


# --------------------------------------------------------------------------
# spans on the host clock
# --------------------------------------------------------------------------

class Spans:
    """(name, start, end) on time.perf_counter, kept in memory."""

    def __init__(self):
        self.items = []

    def add(self, name: str, start: float, end: float):
        self.items.append((name, start, end))

    def total(self, name: str) -> float:
        return sum(e - s for n, s, e in self.items if n == name)

    def durations(self, name: str) -> list:
        return [e - s for n, s, e in self.items if n == name]


# --------------------------------------------------------------------------
# the device trace
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TraceSummary:
    window_s: float  # host-clock length of the traced window
    busy_s: float  # union of device operations' intervals
    kernels: dict  # name -> [seconds, count], device kernels only
    other_ops: dict  # memcpy / memset: name -> [seconds, count]
    idle_by_phase: dict  # harness span name -> idle seconds in it
    stage_s: dict  # solver stage -> seconds of its mapped kernels
    by_span: dict  # harness span name -> [device seconds, kernel count]

    def in_spans(self, names) -> tuple:
        """(device seconds, kernel count) of the operations that ran
        inside the harness spans of these names."""
        got = [self.by_span.get(n, [0.0, 0]) for n in names]
        return sum(g[0] for g in got), sum(g[1] for g in got)


class DeviceTrace:
    """torch.profiler over the device only (host-side op records would
    slow the host they measure), with a marker kernel that ties the
    device's clock to the host's, so that idle gaps can be named by the
    harness span the host was in."""

    MARKER_CYCLES = 1000

    def __init__(self, torch):
        self.torch = torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        torch = self.torch
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_marker = time.perf_counter()
        torch.cuda._sleep(self.MARKER_CYCLES)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        return False

    def _device_events(self):
        """(start_us, end_us, name) of every device operation, read from
        the profiler's raw results (building its Python event tree takes
        minutes at a million kernels)."""
        from torch.autograd import DeviceType
        raw = getattr(self.prof.profiler, "kineto_results", None)
        if raw is None:
            raise BenchError("the profiler kept no raw kineto results")
        events = []
        for e in raw.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start, dur = e.start_ns(), e.duration_ns()
            if dur > 0:
                events.append((start * 1e-3, (start + dur) * 1e-3, e.name()))
        return events

    def summary(self, spans: Spans) -> TraceSummary:
        events = self._device_events()
        if not events:
            raise BenchError("the profiler saw no device operation")
        events.sort()
        anchor = next((ev for ev in events if "sleep" in ev[2].lower()
                       or "spin" in ev[2].lower()), None)
        if anchor is None:
            raise BenchError("the trace holds no marker kernel to tie the "
                             "device clock to the host's")
        # device microseconds -> host perf_counter seconds
        offset = self.t_marker - anchor[0] * 1e-6
        lo, hi = self.t0, self.t1
        # the drivers' spans end in a synchronize or follow each other
        # without a gap, so what the host launched in a span ran on the
        # device inside the spans of its name: an operation belongs to
        # the span that holds its midpoint
        items = sorted(spans.items, key=lambda x: x[1])
        starts = [s for _, s, _ in items]

        def span_at(t):
            k = bisect.bisect_right(starts, t) - 1
            return items[k][0] if k >= 0 and t < items[k][2] else "harness"

        kernels, other, by_span = {}, {}, {}
        intervals = []
        for ev in events:
            s, e, name = ev
            hs, he = s * 1e-6 + offset, e * 1e-6 + offset
            if he <= lo or hs >= hi or ev == anchor:
                continue
            hs, he = max(hs, lo), min(he, hi)
            intervals.append((hs, he))
            is_copy = name.startswith(("Memcpy", "Memset", "memcpy",
                                       "memset"))
            acc = (other if is_copy else kernels).setdefault(name, [0.0, 0])
            acc[0] += he - hs
            acc[1] += 1
            acc = by_span.setdefault(span_at(0.5 * (hs + he)), [0.0, 0])
            acc[0] += he - hs
            acc[1] += 0 if is_copy else 1
        busy, gaps = 0.0, []
        cur_s, cur_e = None, lo
        for s, e in intervals:
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        gaps.append((cur_e, hi))
        idle = {}
        for gs, ge in gaps:
            if ge <= gs:
                continue
            label = span_at(0.5 * (gs + ge))
            idle[label] = idle.get(label, 0.0) + (ge - gs)
        stage_s = {}
        maps = kernel_maps()
        for name, (secs, _) in kernels.items():
            for m in maps:
                if m["match"] in name:
                    stage_s[m["stage"]] = stage_s.get(m["stage"], 0.0) + secs
                    break
        return TraceSummary(window_s=hi - lo, busy_s=busy, kernels=kernels,
                            other_ops=other, idle_by_phase=idle,
                            stage_s=stage_s, by_span=by_span)


def breakdown(trace: TraceSummary) -> dict:
    ops = sorted(((n, s) for n, (s, _) in {**trace.kernels,
                                            **trace.other_ops}.items()),
                 key=lambda x: -x[1])[:10]
    gaps = sorted(trace.idle_by_phase.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


# --------------------------------------------------------------------------
# the record a run leaves for the metric readers
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What one run measured.  Host-clock seconds; work in env-frames
    (one env advanced one solver frame); stage work as (bytes, f32 ops)
    summed over the window; None where the run has no such reading."""

    window_s: float
    setup_s: float
    env_frames: int  # useful env-frames completed in the window
    frames: int  # batched solver frames the window ran
    frame_spans: tuple = ()  # the spans in which the frames ran
    interp_steps: int = 0
    chunk_s: float = 0.0  # wall of whole run_program chunks
    spans: Spans = dataclasses.field(default_factory=Spans)
    stage_work: dict = dataclasses.field(default_factory=dict)
    trace: Optional[TraceSummary] = None
    window_peak_bytes: Optional[int] = None


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is one of
    FORBIDDEN_MODULES, compared whole (flingbot_tpu_torch is not
    flingbot_tpu)."""
    return sorted({m for m in modules
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})
