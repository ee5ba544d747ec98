"""Runs of a cell on the CPU at a tiny size: two envs, chunks of two
interpreter steps, programs cut to a few sim steps (max_program_steps is
the cap past which STABILIZE's 300 steps count).

Besides the cells of BENCHMARK.json the tests run two fling cells that
it does not hold, so that the fling driver and the reference's
interpreter, render, views, coverage, value net and selection stay
tested: `rect-hard.fling` (its files are the benchmark's own; the cell
waits for a host steady enough to bound it) and `shirt.fling` (the
repo's procedural shirts, tests/fixtures/: the layered-lattice path,
which no benchmark configuration runs while no public source states
shirt sizes)."""

import contextlib
import io
import json
import os

import torch

from portbench import harness, run

OVERRIDES = {"num_envs": 2, "chunk_steps": 2, "max_program_steps": -294}
SECONDS = {"rect-hard.fling": 4, "shirt.fling": 2, "rect-hard.physics": 1}
# cells outside BENCHMARK.json: name -> (cell file, configuration file),
# relative to portbench/
EXTRA_CELLS = {
    "rect-hard.fling": ("workloads/rect-hard.fling.json",
                        "configs/rect-hard.json"),
    "shirt.fling": ("tests/fixtures/shirt.fling.json",
                    "tests/fixtures/shirt.json"),
}
FLING_END_TO_END = [{"name": "sim_steps_per_s.fling", "unit": "env-steps/s"},
                    {"name": "setup_s", "unit": "s"}]


def _json(path):
    with open(os.path.join(harness.BENCH_DIR, path)) as f:
        return json.load(f)


def load_cell(name: str) -> harness.Cell:
    """A cell of BENCHMARK.json or one of EXTRA_CELLS."""
    if name not in EXTRA_CELLS:
        return harness.load_cell(name)
    cell, config = EXTRA_CELLS[name]
    traffic = name.split(".", 1)[1]
    return harness.Cell(
        name=name, chips=1, cell=_json(cell), config=_json(config),
        traffic=_json(f"traffic/{traffic}.json"),
        end_to_end=FLING_END_TO_END, per_layer=[])


@contextlib.contextmanager
def _extra_cells():
    load = harness.load_cell
    harness.load_cell = lambda name, *a, **k: load_cell(name) \
        if name in EXTRA_CELLS else load(name, *a, **k)
    try:
        yield
    finally:
        harness.load_cell = load


def tiny_run(cell: str, seed: int = 2 ** 31 + 7, control: bool = False,
             seconds=None):
    """The result line of one CPU run of `cell`, as a dict."""
    torch.set_num_threads(2)
    out = io.StringIO()
    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds or SECONDS[cell]), "--trace", "0"]
    if control:
        argv += ["--control", "bf16"]
    with _extra_cells():
        assert run.main(argv, device="cpu", overrides=OVERRIDES,
                        out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
