"""Each cell runs end to end on the CPU at a tiny size and comes out
correct; the harness refuses to run without a card; nothing it loads is
JAX or the JAX package; the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny
from portbench.tests.tiny import tiny_run

CELLS = ["rect-hard.fling", "shirt.fling", "rect-hard.physics"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct_on_the_cpu(cell):
    res = tiny_run(cell)
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    rate = "sim_steps_per_s." + ("physics" if cell.endswith(".physics")
                                 else "fling")
    assert set(res["metrics"]) == {rate, "setup_s"}
    assert res["metrics"][rate]["value"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0
    limits = tiny.load_cell(cell).cell["limits"]
    assert set(res["checks"]) == set(limits)


def test_fling_window_waits_for_every_stage_its_limits_name():
    """A window shorter than the first program still runs to that
    program's end of step, value maps and next chunk, so every stage the
    limits name is compared."""
    import numpy as np
    seed = 3000000001  # its check chunk is the first program's second
    assert np.random.default_rng([seed, 1]).integers(1, 21) == 1
    res = tiny_run("rect-hard.fling", seed=seed, seconds=0.01)
    assert res["correct"] is True, res["checks"]
    limits = tiny.load_cell("rect-hard.fling").cell["limits"]
    assert set(res["checks"]) == set(limits)
    assert tiny.SECONDS["rect-hard.fling"] > 0.01


def test_harness_refuses_to_run_without_a_card():
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "rect-hard.physics",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in p.stderr


def test_no_jax_and_no_jax_package_in_a_run():
    code = (
        "import sys\n"
        "from portbench.tests.tiny import tiny_run\n"
        "tiny_run('rect-hard.physics')\n"
        "import portbench.drivers.fling, portbench.drivers.physics\n"
        "import portbench.checks, portbench.metrics._roofline\n"
        "from portbench import harness\n"
        "assert not harness.forbidden_modules(sys.modules), "
        "harness.forbidden_modules(sys.modules)\n"
        "assert 'flingbot_tpu_torch' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                   check=True, env=dict(os.environ, PYTHONPATH=harness.ROOT))


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["flingbot_tpu_torch", "flingbot_tpu_torch.env", "jaxtyping",
         "numpy"]) == []
    assert harness.forbidden_modules(
        ["flingbot_tpu.engine", "jax._src", "flax"]) == [
            "flax", "flingbot_tpu.engine", "jax._src"]


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.BENCH_DIR, "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("flingbot_tpu_torch", "flingbot_tpu",
                                   "jax", "flax"), (name, m)
    code = ("import sys\n"
            "import portbench.reference.physics, portbench.reference.interp\n"
            "import portbench.reference.vision, portbench.reference.policy\n"
            "import portbench.reference.topology\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('flingbot_tpu_torch', 'flingbot_tpu', 'jax')]\n")
    subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                   check=True, env=dict(os.environ, PYTHONPATH=harness.ROOT))


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    """On a card: one short run of the physics cell through the CLI."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "rect-hard.physics", "--seed", "11", "--seconds", "2", "--trace",
         "1"], cwd=harness.ROOT, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-2000:]
    import json
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0
