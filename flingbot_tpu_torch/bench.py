"""Physics benchmark of the port: XPBD env-steps/s on a 100x100-particle
cloth with 512 envs (counterpart of the root bench.py, at its operating
point).

One env-step is one solver frame at the production knobs: dt 1/100, 4
substeps x 16 Chebyshev iterations, springs, ground friction and the
sorted-window self-collision (4 iterations, window 12, every 2nd
substep), on a flat cloth 5 mm above the floor.  After one warm-up frame
(which also builds the kernels), `--windows` windows of `--steps` frames
are timed on the host clock, each ending in a device synchronize; each
window's rate is printed on its own line, and the JSON line's value is
their median.

    python -m flingbot_tpu_torch.bench [--num_envs 512] [--dim 100]

The last line is one JSON object {"metric", "value", "unit",
"vs_baseline"}, as the root bench.py prints; the metric names the card.
`vs_baseline` divides by the root bench.py's estimate of the reference
(16 FleX envs at 125 sim-steps/s each on one GPU: 2,000 env-steps/s).
Runs on the card; --device cpu runs the plain PyTorch path on the CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.engine.solver import step
from flingbot_tpu_torch.engine.state import SolverParams
from flingbot_tpu_torch.engine.topology import (
    build_grid_topology, grid_positions)
from flingbot_tpu_torch.env.scene import Task, make_batch

BASELINE_ENV_STEPS_PER_SEC = 2000.0
SOLVER = dict(substeps=4, iterations=16, contact_every=2,
              contact_iterations=4, contact_window=12)


def flat_batch(num_envs: int, dim: int, device):
    """num_envs flat dim x dim cloths 5 mm above the floor, centred, each
    of mass 0.5: (state, topology)."""
    pos = grid_positions(dim, dim, lower=(0.0, 0.005, 0.0))
    pos[:, [0, 2]] -= pos[:, [0, 2]].mean(0)
    n = dim * dim
    pp = np.concatenate([pos, np.full((n, 1), n / 0.5, np.float32)], 1)
    task = Task(cloth_size=(dim, dim), particle_pos=pp.reshape(-1))
    _, state = make_batch([task] * num_envs, max_grid_dim=dim, device=device)
    topo = build_grid_topology([dim] * num_envs, [dim] * num_envs,
                               max_dimx=dim, max_dimy=dim, device=device)
    return state, topo


def measure(num_envs: int = 512, dim: int = 100, steps: int = 20,
            windows: int = 5, self_collision: bool = True,
            iterations: int = 16, substeps: int = 4, device="cuda"):
    """Returns (env-steps/s of each window, the last state, the
    topology)."""
    device = resolve_device(device)
    state, topo = flat_batch(num_envs, dim, device)
    params = SolverParams()
    kw = dict(SOLVER, substeps=substeps, iterations=iterations,
              self_collision=self_collision)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    state = step(state, topo, params, **kw)
    sync()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            state = step(state, topo, params, **kw)
        sync()
        rates.append(num_envs * steps / (time.perf_counter() - t0))
    return rates, state, topo


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--num_envs", type=int, default=512)
    p.add_argument("--dim", type=int, default=100)
    p.add_argument("--steps", type=int, default=20,
                   help="frames per timed window")
    p.add_argument("--windows", type=int, default=5,
                   help="timed windows; the value is their median")
    p.add_argument("--no_self_collision", action="store_true")
    p.add_argument("--iterations", type=int, default=16,
                   help="chebyshev iterations (default: production 16; "
                        "pass 30 for the FleX-parity row)")
    p.add_argument("--substeps", type=int, default=4)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    rates, state, _ = measure(a.num_envs, a.dim, a.steps, a.windows,
                           not a.no_self_collision, a.iterations,
                           a.substeps, device)
    if not bool(torch.isfinite(state.positions).all()):
        raise RuntimeError("non-finite positions after the timed frames")
    for i, r in enumerate(rates):
        print(f"[bench] window {i}: {a.steps} frames, {r:.1f} env-steps/s")
    value = statistics.median(rates)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(json.dumps({
        "metric": f"xpbd_env_steps_per_sec on {where} ({a.dim}x{a.dim} "
                  f"cloth, {a.num_envs} envs, {a.substeps} substeps x "
                  f"{a.iterations} chebyshev iters, self_collision="
                  f"{not a.no_self_collision}, median of {a.windows} "
                  f"windows of {a.steps} frames)",
        "value": round(value, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(value / BASELINE_ENV_STEPS_PER_SEC, 3),
    }))
    return rates


if __name__ == "__main__":
    main()
