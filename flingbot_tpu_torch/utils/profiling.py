"""Per-stage solver profiling, the NvFlexTimers analog (counterpart of
flingbot_tpu/utils/profiling.py).

The reference solver exposes per-stage GPU timers (predict, grid build,
collide, solveSprings, solveContacts, applyDeltas, finalize;
NvFlexGetTimers, reference PyFlex/include/NvFlex.h:197-223).  Here the
stages are the port's own functions, each timed on the card with CUDA
events after a warm-up call (on the CPU with the wall clock), and
`trace` records a torch.profiler trace for an op-level breakdown.

    report = profile_solver_stages(num_envs=64, dim=100)
    print(format_report(report))

    with trace("/tmp/torch-trace"):   # trace.json, for chrome://tracing
        step_fn(state)

    python -m flingbot_tpu_torch.utils.profiling --num_envs 64 --dim 100

A stage that fails raises: a kernel that does not build or launch must
not turn into a row of NaN.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import numpy as np
import torch

from flingbot_tpu_torch.device import resolve_device


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block (the card's kernels too, when there
    is one); writes logdir/trace.json and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _time_fn(fn, args, iters: int, device: torch.device) -> float:
    """Seconds per call of fn(*args): one warm-up call, then `iters` calls
    between two CUDA events (the wall clock on the CPU)."""
    fn(*args)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


@torch.no_grad()
def profile_solver_stages(num_envs: int = 64, dim: int = 100,
                          iters: int = 5, device="cuda") -> Dict[str, float]:
    """Times the solver's pipeline stages (seconds per batched step) on
    num_envs flat dim x dim cloths, at solver.step's defaults in the JAX
    package (tasks.SEQ_SIM_KW: 4 substeps x 30 Gauss-Seidel iterations,
    block contacts 8 x 16 every substep).  The state is kept in lattice
    order, so the JAX profiler's gather_to_lattice has no counterpart;
    `full step [pallas]` launches both CUDA kernels."""
    from flingbot_tpu_torch.engine import collisions, solver
    from flingbot_tpu_torch.engine.state import ClothState, SolverParams
    from flingbot_tpu_torch.engine.topology import (
        build_grid_topology, grid_positions, lattice_valid)
    from flingbot_tpu_torch.env.tasks import SEQ_SIM_KW

    dev = resolve_device(device)
    pos = grid_positions(dim, dim, lower=(0.0, 0.005, 0.0))
    n = dim * dim
    one = ClothState.create(pos, np.full(n, n / 0.5, np.float32),
                            device=dev)
    batch = ClothState(**{k: v.expand((num_envs,) + v.shape[1:]).clone()
                          for k, v in one.fields().items()})
    topo = build_grid_topology([dim] * num_envs, [dim] * num_envs,
                               max_dimx=dim, max_dimy=dim, device=dev)
    params = SolverParams()
    relax = float(params.relaxation_factor)
    B, N = num_envs, n
    valid = lattice_valid(topo.dimx, topo.dimy, dim, dim)
    flat_valid = valid.reshape(B, N)
    w = torch.where(valid, batch.inv_mass.view(B, dim, dim), 0.0)
    flat_w = w.reshape(B, N)

    report = {}

    def springs(s):
        P = s.positions.view(B, 3, dim, dim)
        for _ in range(120):
            P = solver.solve_springs_grid(P, w, valid, topo, relax, "gs")
        return P

    report["solveSprings (4x30 iters)"] = _time_fn(
        springs, (batch,), iters, dev)

    def sort_stage(s):
        return collisions.sweep_order(s.positions, flat_valid, params.radius)

    report["grid build (morton sort)"] = _time_fn(
        sort_stage, (batch,), iters, dev)

    def contacts(s):
        P = s.positions
        perm, inv = collisions.sweep_order(P, flat_valid, params.radius)
        return collisions.solve_contacts_sweep(
            P, flat_w, flat_valid, perm, inv, params,
            rest_dist=params.radius, lattice_w=dim, prev=P)

    report["solveContacts (8 iters)"] = _time_fn(
        contacts, (batch,), iters, dev)

    for backend in ("xla", "pallas"):
        kw = {**SEQ_SIM_KW, "backend": backend}
        report[f"full step [{backend}]"] = _time_fn(
            lambda s: solver.step(s, topo, params, **kw), (batch,), iters,
            dev)
    return report


def format_report(report: Dict[str, float], num_envs: int = 64) -> str:
    lines = ["stage                          ms/call   env-steps/s"]
    for k, v in report.items():
        rate = num_envs / v if v == v and v > 0 else float("nan")
        lines.append(f"{k:<30} {v * 1e3:8.2f}   {rate:10.0f}")
    return "\n".join(lines)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--num_envs", type=int, default=64)
    p.add_argument("--dim", type=int, default=100)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    rep = profile_solver_stages(a.num_envs, a.dim, a.iters, a.device)
    print(format_report(rep, a.num_envs))
    return rep


if __name__ == "__main__":
    main()
