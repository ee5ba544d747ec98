"""The comparison has to fail what is wrong: the reference computed in
bfloat16 in the program's place (the control), and the timed path broken
underneath, once for each fault a cell can have: a step that returns its
state unchanged, half of the batch left out, an answer altered where it
is produced.  (A cell on one chip has no exchange between chips to leave
out.)  Tiny runs on the CPU; the harness's look for a card is skipped."""

import pytest
import torch

from portbench.tests.tiny import tiny_run

CELLS = ["rect-hard.fling", "shirt.fling", "rect-hard.physics"]


def _patch_step(monkeypatch, cell, make):
    """Replace the solver step that the cell's timed path calls."""
    from flingbot_tpu_torch.engine import solver
    from flingbot_tpu_torch.env import primitives
    if cell.endswith(".physics"):
        monkeypatch.setattr(solver, "step", make(solver.step))
    else:
        monkeypatch.setattr(primitives, "solver_step",
                            make(primitives.solver_step))


def _unchanged(step):
    return lambda state, *a, **k: state


def _half_batch(step):
    def broken(state, *a, **k):
        out = step(state, *a, **k)
        keep = torch.arange(state.batch) < (state.batch + 1) // 2
        pick = lambda new, old: torch.where(  # noqa: E731
            keep.view((-1,) + (1,) * (new.dim() - 1)), new, old)
        return out.replace(
            positions=pick(out.positions, state.positions),
            velocities=pick(out.velocities, state.velocities))
    return broken


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = tiny_run(cell, control=True)
    assert res["correct"] is False
    failing = [k for k, c in res["checks"].items()
               if c["value"] > c["limit"]]
    assert failing


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(cell, fault, monkeypatch):
    _patch_step(monkeypatch, cell,
                {"unchanged": _unchanged, "half_batch": _half_batch}[fault])
    res = tiny_run(cell)
    assert res["correct"] is False
    assert res["checks"]["frame_pos_gap_m"]["value"] > \
        res["checks"]["frame_pos_gap_m"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(cell, monkeypatch):
    """One contact result altered where the contacts kernel's CPU version
    produces it; on rect-hard.fling also one env's value map."""
    from flingbot_tpu_torch.engine import kernels
    plain = kernels.contacts_plain

    def altered(*a, **k):
        x, y, z = plain(*a, **k)
        x = x.clone()
        x[-1, 0] += 1e-3
        return x, y, z

    monkeypatch.setattr(kernels, "contacts_plain", altered)
    res = tiny_run(cell)
    assert res["correct"] is False
    if cell == "rect-hard.fling":
        monkeypatch.setattr(kernels, "contacts_plain", plain)
        from flingbot_tpu_torch.learning.nets import MaximumValuePolicy
        maps = MaximumValuePolicy.batch_value_maps

        def wrong_maps(self, obs, *a, **k):
            vm = maps(self, obs, *a, **k).clone()
            vm[-1, 0, 5] += 0.5
            return vm

        monkeypatch.setattr(MaximumValuePolicy, "batch_value_maps",
                            wrong_maps)
        res = tiny_run(cell)
        assert res["checks"]["value_rel_gap"]["value"] > \
            res["checks"]["value_rel_gap"]["limit"]
