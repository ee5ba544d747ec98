"""The benchmark's files: BENCHMARK.json keeps to its contract, every
configuration, traffic mix, cell, metric and kernel map parses and is
found by name, and a file dropped into a copy is found with no edit."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert {m["name"] for m in bench["end_to_end"]} == {
        "sim_steps_per_s.physics", "setup_s"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    # every cell reports setup_s and one rate, each under its own bound
    for w in bench["workloads"]:
        mine = [m["name"] for m in bench["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) == 2, (w["name"], mine)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_per_layer_metrics_move_the_rate_in_listed_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    rates = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        rate = rates[m["moves"]]
        assert m["moves"] != "setup_s"
        assert set(m["workloads"]) <= set(rate["workloads"]) & cells
        harness.metric_reader(m["name"])  # found by name
    for w in bench["workloads"]:
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])


@pytest.mark.parametrize("name", ["rect-hard.fling", "shirt.fling",
                                  "rect-hard.physics"])
def test_cell_files_parse_and_name_their_parts(name):
    from portbench.tests import tiny
    cell = tiny.load_cell(name)
    harness.driver(cell.cell["driver"])
    assert cell.config["reduced"] == []
    for key in ("tasks", "policy"):
        assert os.path.exists(cell.data_path(key))
    assert all(isinstance(v, (int, float)) for v in cell.cell["limits"]
               .values())


def test_kernel_maps_name_a_stage():
    maps = harness.kernel_maps()
    assert {m["stage"] for m in maps} == {"springs", "contacts"}
    assert all(m["match"] for m in maps)


def test_files_dropped_into_a_copy_are_found(tmp_path):
    """A later change adds a cell, a traffic mix, a metric and a kernel map
    as new files; the harness finds them with no edit."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "rect-hard.dummy",
                               "config": "rect-hard", "traffic": "dummy",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({
        "name": "sim_steps_per_s.dummy", "unit": "env-steps/s",
        "better": "higher", "bound": 0.1, "source": "host_clock",
        "workloads": ["rect-hard.dummy"]})
    bench["per_layer"].append({
        "name": "dummy_metric", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "env step",
        "moves": "sim_steps_per_s.dummy", "workloads": ["rect-hard.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "portbench"
    (pb / "traffic" / "dummy.json").write_text('{"num_envs": 3}')
    (pb / "workloads" / "rect-hard.dummy.json").write_text(
        '{"driver": "dummy", "limits": {}}')
    (pb / "drivers" / "dummy.py").write_text("def run(ctx):\n    return 7\n")
    (pb / "metrics" / "dummy_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    (pb / "kernel_maps" / "dummy_kernel.json").write_text(
        '{"match": "dummy_kernel", "stage": "dummy"}')
    code = (
        "from portbench import harness\n"
        "c = harness.load_cell('rect-hard.dummy')\n"
        "assert c.traffic['num_envs'] == 3\n"
        "assert harness.driver(c.cell['driver']).run(None) == 7\n"
        "assert [m['name'] for m in c.per_layer] == ['dummy_metric']\n"
        "assert {m['name'] for m in c.end_to_end} == "
        "{'sim_steps_per_s.dummy', 'setup_s'}\n"
        "assert harness.metric_reader('dummy_metric')(None) == 42.0\n"
        "assert 'dummy' in {m['stage'] for m in harness.kernel_maps()}\n")
    subprocess.run([sys.executable, "-c", code], cwd=tmp_path, check=True,
                   env=dict(os.environ, PYTHONPATH=str(tmp_path)))


def test_benchmark_holds_none_of_the_tests_own_cells(bench):
    """The fling cells the tests run are not benchmark cells, and the
    shirts are not a benchmark configuration."""
    from portbench.tests import tiny
    assert not set(tiny.EXTRA_CELLS) & {w["name"]
                                        for w in bench["workloads"]}
    assert "shirt" not in {c["name"] for c in bench["configs"]}
    assert not os.path.exists(os.path.join(harness.BENCH_DIR, "configs",
                                           "shirt.json"))


def test_metric_names_share_a_reader_by_quantity():
    assert harness.base_name("frame_device_ms.physics") == "frame_device_ms"
    assert harness.metric_reader("frame_device_ms.fling") is \
        harness.metric_reader("frame_device_ms.physics")


def test_task_order_is_the_same_multiset_for_every_seed():
    a = harness.task_order(100, 256, 3141592653)
    b = harness.task_order(100, 256, 2 ** 31 + 12345)
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert list(a) == list(harness.task_order(100, 256, 3141592653))
