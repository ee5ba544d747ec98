"""The replay record of flingbot_tpu_torch (learning/memory.py, a
directory of numpy step files) and its statistics (utils/stats.py), held
against flingbot_tpu's HDF5 Memory and collect_stats: the same episodes
written by both Memory classes give the same step keys, the same values
in each step, and the same statistics to 1e-12."""

import h5py
import numpy as np
import pytest

from flingbot_tpu.learning.memory import Memory as JMemory
from flingbot_tpu.utils import stats as jstats
from flingbot_tpu_torch.learning.memory import Memory, read_step, step_keys
from flingbot_tpu_torch.utils import stats as tstats

# (difficulty, steps, flag) of each episode; flagged episodes and
# near-empty states are filtered by collect_stats
EPISODES = (("hard", 3, None), ("easy", 2, None), ("hard", 1, "cloth_stuck"),
            ("shirt", 3, None), ("hard", 2, None), ("easy", 3, "timed_out"),
            ("hard", 3, None))
PANELS = ("img_before_after", "img_action", "img_value_map")


def episode_values(rng, level, steps, flag):
    """The add_* calls of one episode, as BatchSimEnv makes them."""
    area = float(rng.uniform(0.2, 0.4))
    calls = [("value", "pretransform_observations",
              rng.random((4, 16, 16), np.float32))]
    pre = float(rng.uniform(0.0, 0.6)) * area
    for s in range(steps):
        # a near-empty state now and then (post < 5% of the flat area)
        post = float(rng.uniform(0.0, 1.1)) * area
        if rng.random() < 0.15:
            post = 0.01 * area
        calls += [("observation", rng.random((4, 8, 8), np.float32)),
                  ("action", np.eye(8, dtype=np.float32)[s]),
                  ("value", "preaction_coverage", pre),
                  ("value", "postaction_coverage", post),
                  ("value", "rotation", float(rng.choice([-90.0, 0.0]))),
                  ("value", "scale", 1.5),
                  ("value", "action_primitive", "fling"),
                  ("value", "max_indices", np.asarray([s, 3, 4])),
                  ("value", "pretransform_pixels",
                   rng.random((2, 2), np.float32)),
                  ("value", "task_name", f"task{level}{s}"),
                  ("value", "cloth_mass", 0.5),
                  ("value", "cloth_size", np.array([16, 12])),
                  ("value", "cloth_stiff", np.array([0.8, 1.0, 0.9])),
                  ("value", "max_coverage", area),
                  ("value", "task_difficulty", level),
                  ("value", "init_coverage", 0.3 * area),
                  ("value", "states", [rng.random(3), rng.random(2)]),
                  ("reward", post - pre, s == steps - 1),
                  ("value", "next_observations",
                   rng.random((4, 16, 16), np.float32))]
        if flag is not None:
            calls.append(("value", flag, s == steps - 1))
        if s < steps - 1:
            calls.append(("value", "pretransform_observations",
                          rng.random((4, 16, 16), np.float32)))
        pre = post
    return calls


def replay(mem_cls, calls):
    mem = mem_cls()
    for c in calls:
        if c[0] == "observation":
            mem.add_observation(c[1])
        elif c[0] == "action":
            mem.add_action(c[1])
        elif c[0] == "reward":
            mem.add_rewards_and_termination(c[1], c[2])
        else:
            mem.add_value(c[1], c[2])
    return mem


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("replay")
    h5, port = str(d / "replay.hdf5"), str(d / "replay")
    rng = np.random.default_rng(0)
    for ep in EPISODES:
        calls = episode_values(rng, *ep)
        assert (replay(JMemory, calls).dump(h5)
                == replay(Memory, calls).dump(port))
    return h5, port


def test_step_records_match(records):
    h5, port = records
    keys = step_keys(port)
    with h5py.File(h5, "r") as f:
        assert keys == list(f.keys())
        assert tstats.get_dataset_size(port) == jstats.get_dataset_size(h5)
        for key in keys:
            attrs, arrays = read_step(port, key)
            g = f[key]
            assert sorted(attrs) == sorted(g.attrs)
            for k, v in g.attrs.items():
                assert type(attrs[k]) is type(v) and attrs[k] == v, k
            datasets = {}
            g.visititems(lambda n, o: datasets.__setitem__(n, np.array(o))
                         if isinstance(o, h5py.Dataset) else None)
            assert sorted(arrays) == sorted(datasets)
            for k, v in datasets.items():
                assert arrays[k].dtype == v.dtype, k
                np.testing.assert_array_equal(arrays[k], v)
    assert keys[-1].endswith("_last")
    assert tstats.get_dataset_size(str(records[1]) + "_none") == 0


def assert_close(a, b, key):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), key
        for k in a:
            assert_close(a[k], b[k], f"{key}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=key)


@pytest.mark.parametrize("num_points", [10 ** 9, 7])
def test_collect_stats_matches(records, num_points):
    h5, port = records
    want = jstats.collect_stats(h5, num_points=num_points)
    got = tstats.collect_stats(port, num_points=num_points)
    skip = lambda k: k in PANELS  # noqa: E731  (a random step's images)
    assert sorted(k for k in got if not skip(k)) == sorted(
        k for k in want if not skip(k))
    for k in want:
        if not skip(k):
            assert_close(got[k], want[k], k)
    assert "best_coverage/hard/mean" in got
    assert "img_before_after" in got
    assert tstats.collect_stats(port + "_none") is None


def test_collect_stats_filter_matches(records):
    h5, port = records
    keep = lambda i, k: i % 2 == 0  # noqa: E731
    want = jstats.collect_stats(h5, filter_keys_fn=keep)
    got = tstats.collect_stats(port, filter_keys_fn=keep)
    for k in want:
        if k not in PANELS:
            assert_close(got[k], want[k], k)
