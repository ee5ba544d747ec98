"""Benchmark of flingbot_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of BENCHMARK.json's workloads; its files are
portbench/workloads/<name>.json (driver, limits of the comparisons), its
configuration's file and portbench/traffic/<traffic>.json.  The run makes
its inputs from the seed, sets up (counted in setup_s), measures for
`seconds` on the host clock (every end-to-end metric is all the work over
all the time of the window), then judges what the window produced against
the plain reference (portbench/reference) and prints one JSON line last
on standard output.  --trace 1 runs the window under the device profiler
and reports the per-layer metrics instead, each read by
portbench/metrics/<name>.py.

It needs a CUDA card and exits with another code than 0, printing no
result, without one.  --control bf16 puts the reference computed in
bfloat16 in the program's place, the control that has to come out not
correct (a test of the comparison, never a benchmark run).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class NoCard(RuntimeError):
    pass


def _cache_env():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = os.path.join(ROOT, "portbench", "build")
    os.environ["FLINGBOT_TORCH_BUILD_DIR"] = os.path.join(build, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "extensions")


class Window:
    """The measured window: its host-clock bounds, set-up before it, the
    device trace over it (--trace 1) and the peak memory inside it."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.trace = None
        self.peak_bytes = None

    def __enter__(self):
        ctx = self.ctx
        ctx.sync()
        if ctx.cuda:
            ctx.torch.cuda.reset_peak_memory_stats(ctx.device)
        if ctx.trace:
            from portbench.harness import DeviceTrace
            self.trace = DeviceTrace(ctx.torch).__enter__()
        ctx.sync()
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - ctx.t_start
        return self

    def __exit__(self, *exc):
        self.ctx.sync()
        self.t1 = time.perf_counter()
        if self.trace is not None:
            self.trace.__exit__(*exc)
        if self.ctx.cuda:
            self.peak_bytes = self.ctx.torch.cuda.max_memory_allocated(
                self.ctx.device)
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def trace_summary(self, spans):
        if self.trace is None:
            return None
        self.trace.t0, self.trace.t1 = self.t0, self.t1
        t = time.perf_counter()
        out = self.trace.summary(spans)
        print(f"portbench: trace read in {time.perf_counter() - t:.1f} s",
              file=sys.stderr)
        return out


class Context:
    """What a driver and the checks are given."""

    def __init__(self, cell, args, device, torch, overrides=None):
        from portbench.reference import physics
        self.cell = cell
        self.config = dict(cell.config)
        self.traffic = dict(cell.traffic, **(overrides or {}))
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.torch = torch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t_start = T_START
        k = self.config["solver"]
        self.knobs = dict(k)
        self.params = physics.Params()
        self.layered = self.config["topology"] == "layered"
        n = self.config["num_rotations"]
        import numpy as np
        self.rotations = torch.tensor(np.asarray(
            [(2 * i / (n - 1) - 1) * 90 for i in range(n)], np.float32),
            device=self.device)
        self.scale_factors = torch.tensor(self.config["scale_factors"],
                                          dtype=torch.float32,
                                          device=self.device)
        self._tasks = self._weights = None

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def window(self) -> Window:
        return Window(self)

    def clone(self, obj):
        """A copy of a state or carry whose tensors are the program's own
        at this point of the window."""
        return copy.deepcopy(obj)

    def ref_tasks(self):
        if self._tasks is None:
            from portbench.reference import topology
            self._tasks = topology.read_tasks(self.cell.data_path("tasks"))
        return self._tasks

    def weights(self):
        if self._weights is None:
            from portbench.reference import policy
            self._weights = policy.load(self.cell.data_path("policy"),
                                        self.device)
        return self._weights

    def stage_work(self, topo, active):
        """Per env, the (bytes, ops) of one frame's springs stage and
        contacts stage, as numpy arrays (B,), from the cloth problem."""
        import numpy as np
        from portbench import workmodel
        k = self.knobs
        n_act = active.reshape(active.shape[0], -1).sum(1).cpu().numpy()
        N = active.reshape(active.shape[0], -1).shape[1]
        groups = k["substeps"] // k["contact_every"]
        cw = [workmodel.contacts_work([int(n)], N, k["contact_window"],
                                      k["contact_iterations"],
                                      mesh=self.layered) for n in n_act]
        cw = (groups * np.array([c[0] for c in cw], np.float64),
              groups * np.array([c[1] for c in cw], np.float64))
        if self.layered:
            z = np.zeros(len(n_act))
            return (z, z), cw
        dims = list(zip(topo.dimx.cpu().numpy().tolist(),
                        topo.dimy.cpu().numpy().tolist()))
        sw = [workmodel.substeps_work([d], topo.max_dimy, topo.max_dimx,
                                      k["substeps"], k["iterations"])
              for d in dims]
        sw = (np.array([s[0] for s in sw], np.float64),
              np.array([s[1] for s in sw], np.float64))
        return sw, cw


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bf16",), default=None)
    return p.parse_args(argv)


def _metric(value, unit):
    return {"value": value, "unit": unit}


def main(argv=None, device=None, overrides=None, out=None) -> int:
    """One run.  device: None for the card (checked); the tests pass
    "cpu" with small traffic overrides."""
    args = parse_args(argv)
    sys.path.insert(0, ROOT)
    _cache_env()
    from portbench import checks, harness
    out = out or sys.stdout
    cell = harness.load_cell(args.workload)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{torch.cuda.device_count()} cards, the cell "
                         f"needs {cell.chips}")
        device = "cuda"
    ctx = Context(cell, args, device, torch, overrides)
    run, evidence, attempted, failed = harness.driver(
        cell.cell["driver"]).run(ctx)
    t_window = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.cuda else 0
    if ctx.cuda:
        torch.cuda.empty_cache()
    numbers = checks.judge(ctx, evidence, control=args.control is not None)
    print(f"portbench: setup {run.setup_s:.1f} s, window {run.window_s:.1f}"
          f" s, after the window {time.perf_counter() - t_window:.1f} s "
          f"(trace read, reference)", file=sys.stderr)
    limits = cell.cell["limits"]
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise harness.BenchError(
            f"the window left nothing to compare for {missing}")
    compared = {k: {"value": numbers[k], "limit": limits[k]}
                for k in sorted(limits)}
    correct = all(c["value"] <= c["limit"] for c in compared.values())

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if not args.trace:
        values = {"sim_steps_per_s": run.env_frames / run.window_s,
                  "setup_s": run.setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = _metric(
                values[harness.base_name(m["name"])], m["unit"])
    else:
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"])(run)
            if v is None:
                raise harness.BenchError(
                    f"metric {m['name']} found nothing to read in "
                    f"{cell.name}, which lists it")
            metrics[m["name"]] = _metric(v, units[m["name"]])
    dev = {"platform": "gpu" if ctx.cuda else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if ctx.cuda
           else "cpu", "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = harness.breakdown(run.trace)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        raise harness.BenchError(f"modules loaded that the port must not "
                                 f"load: {', '.join(bad)}")
    result["checks"] = compared
    for k, c in compared.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # the run is invalid: say why, print no result
        print(f"portbench: {type(e).__name__}: {e}", file=sys.stderr)
        raise SystemExit(3)
