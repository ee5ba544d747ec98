"""The port's per-stage solver profiler against flingbot_tpu's: every stage
timed and finite on the CPU at 2 envs of 8 x 8, the report's text equal to
the JAX format_report's character for character on the same report, a
failing stage raising, and trace() writing a torch.profiler trace."""

import json
import os

import pytest
import torch

from flingbot_tpu.utils.profiling import format_report as jax_format
from flingbot_tpu_torch.utils import profiling

torch.set_num_threads(2)
STAGES = ["solveSprings (4x30 iters)", "grid build (morton sort)",
          "solveContacts (8 iters)", "full step [xla]",
          "full step [pallas]"]


def test_every_stage_is_timed_and_finite():
    report = profiling.profile_solver_stages(2, 8, iters=1, device="cpu")
    assert list(report) == STAGES
    assert all(v > 0 and v < float("inf") for v in report.values()), report
    text = profiling.format_report(report, 2)
    assert text == jax_format(report, 2)
    assert len(text.splitlines()) == 1 + len(STAGES)


@pytest.mark.parametrize("report,n", [
    ({"solveSprings (4x30 iters)": 0.01234, "full step [pallas]": 2.5e-4},
     64),
    ({"a stage": float("nan"), "zero": 0.0, "slow": 12.0}, 3),
])
def test_format_report_matches(report, n):
    assert profiling.format_report(report, n) == jax_format(report, n)


@pytest.mark.parametrize("stage", ["solve_springs_grid", "step"])
def test_a_failing_stage_raises(stage, monkeypatch):
    """A failing stage raises, the first one or a full step (where the JAX
    profiler writes a NaN row and goes on)."""
    from flingbot_tpu_torch.engine import solver

    def broken(*a, **k):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(solver, stage, broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        profiling.profile_solver_stages(1, 4, iters=1, device="cpu")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()
