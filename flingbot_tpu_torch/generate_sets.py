"""Generate the task sets on the card (counterpart of
scripts/generate_sets_r3.py).

    python -m flingbot_tpu_torch.generate_sets --sets hard,easy,large,train512
    python -m flingbot_tpu_torch.generate_sets --sets shirt

Each set goes to `<out>/<name>.npz` (default out: data_torch/), a task
archive that TaskLoader reads; an archive that exists is topped up to its
count, not overwritten.  The sets are those of the JAX script (sizes,
seeds, lattice), made by flingbot_tpu_torch.env.tasks.generate_tasks_batch
as the JAX script runs it: --backend pallas and --contact_mode sort by
default (the fused substeps kernel, sorted-window contacts, "gs" springs
run as Chebyshev), at the generator's friction (tasks.GEN_FRICTION, the FleX
scene's 0.75), with which PARITY.md says every committed JAX set was
made: at the production friction (0.1) the crumples come out near flat.
The shirt set (16 hard shirt tasks, seed 500, from data/shirts) goes
through the sequential generator, env.tasks.generate_tasks, as the JAX
script makes it (generate_sets_r3.py:87-96), at the same --gen_fric; the
JAX script passes that generator no friction, which is the production 0.1
(--gen_fric 0.1).  After each set one JSON line gives its statistics and
wall seconds.  Runs on the card; --device cpu runs the plain PyTorch
path.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from flingbot_tpu_torch.engine.state import SolverParams, f32
from flingbot_tpu_torch.env.tasks import (
    GEN_FRICTION, generate_tasks, generate_tasks_batch, read_task_arrays)

SETS = {
    # name: (file, num, difficulty, min_size, max_size, strict_min,
    #        max_grid, seed)
    "hard": ("rect_eval_hard_100.npz", 100, "hard", 64, 104, 64, 104, 100),
    "easy": ("rect_eval_easy_64.npz", 64, "easy", 64, 104, 64, 104, 200),
    "large": ("rect_eval_large_64.npz", 64, "hard", 112, 128, 112, 128,
              300),
    "train": ("rect_train_2048.npz", 2048, "hard", 64, 104, 64, 104, 400),
    # the committed training set of the JAX package: the protocol and
    # seed of `train`, 512 tasks
    "train512": ("rect_train_512.npz", 512, "hard", 64, 104, 64, 104, 400),
}
# the shirt set: (file, num, difficulty, seed), sequential, mesh cloths
SHIRT_SET = ("shirt_eval_16.npz", 16, "hard", 500)


def coverages(path: str):
    """Initial coverage and flatten area (m^2) of each task of a task
    archive, in key order (TaskLoader's)."""
    tasks = read_task_arrays(path)
    return tuple(np.array([float(tasks[k][f"@{name}"])
                           for k in sorted(tasks)])
                 for name in ("initial_coverage", "flatten_area"))


def ratio_stats(init, flat) -> dict:
    """Size, mean initial coverage (m^2) and the ratio initial coverage /
    flatten area (mean, sd, max) of a set's tasks (set_stats of the JAX
    script, with the ratio's sd); "ratio" holds each task's ratio."""
    init = np.asarray(init, np.float64)
    ratio = init / np.maximum(np.asarray(flat, np.float64), 1e-9)
    return {"n": len(init), "init_mean": float(init.mean()),
            "ratio_mean": float(ratio.mean()),
            "ratio_sd": float(ratio.std()),
            "ratio_max": float(ratio.max()), "ratio": ratio}


def set_stats(path: str) -> dict:
    """ratio_stats of a task archive to 4 digits, without the ratios."""
    return {k: round(v, 4) if isinstance(v, float) else v
            for k, v in ratio_stats(*coverages(path)).items()
            if k != "ratio"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sets", default="hard,easy,large,train")
    ap.add_argument("--out", default="data_torch")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--chunk_steps", type=int, default=96)
    ap.add_argument("--gen_fric", type=float, default=GEN_FRICTION,
                    help="dynamic_friction during task generation (default "
                         "%(default)s, that of the JAX package's committed "
                         "sets; the JAX script's default is the production "
                         "0.1)")
    ap.add_argument("--backend", default="pallas",
                    choices=["pallas", "xla"])
    ap.add_argument("--contact_mode", default="sort",
                    choices=["sort", "sweep", "block", "table"])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    params = SolverParams(dynamic_friction=f32(a.gen_fric))
    os.makedirs(a.out, exist_ok=True)
    stats = {}
    for name in a.sets.split(","):
        if name == "shirt":
            file, num, diff, seed = SHIRT_SET
            path = os.path.join(a.out, file)
            print(f"=== shirt: {num} mesh tasks -> {path}", flush=True)
            t0 = time.perf_counter()
            generate_tasks(path, num, seed=seed, task_difficulty=diff,
                           cloth_type="mesh", cloth_mesh_path="data/shirts",
                           params=params, device=a.device)
            stats[name] = dict(set_stats(path),
                               seconds=round(time.perf_counter() - t0, 2))
            print(f"[{name}] {json.dumps(stats[name])}", flush=True)
            continue
        file, num, diff, mins, maxs, strict, grid, seed = SETS[name]
        path = os.path.join(a.out, file)
        batch = min(a.batch, max(32, num))
        print(f"=== {name}: {num} {diff} tasks -> {path} (batch {batch}, "
              f"chunk {a.chunk_steps})", flush=True)
        t0 = time.perf_counter()
        generate_tasks_batch(
            path, num, batch=batch, seed=seed, min_cloth_size=mins,
            max_cloth_size=maxs, strict_min_edge_length=strict,
            task_difficulty=diff, max_grid_dim=grid, backend=a.backend,
            spring_mode="gs", contact_mode=a.contact_mode, contact_every=2,
            chunk_steps=a.chunk_steps, solver_params=params,
            device=a.device)
        stats[name] = dict(set_stats(path),
                           seconds=round(time.perf_counter() - t0, 2))
        print(f"[{name}] {json.dumps(stats[name])}", flush=True)
    print("ALL_SETS_DONE", flush=True)
    return stats


if __name__ == "__main__":
    main()
