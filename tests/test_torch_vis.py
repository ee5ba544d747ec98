"""The port's report tools held against the JAX package's: draw_action for
every primitive, collect_stats' image panels (img_action among them) on
one replay record written by each package's Memory, and the ported
visualize building its gallery with an episode video."""

import os

import numpy as np
import pytest

from flingbot_tpu.learning.memory import Memory as JMemory
from flingbot_tpu.utils.stats import collect_stats as jax_collect_stats
from flingbot_tpu.utils.vis import draw_action as jax_draw_action
from flingbot_tpu_torch import visualize
from flingbot_tpu_torch.env.sim_env import video_dir, write_webm
from flingbot_tpu_torch.learning.memory import Memory
from flingbot_tpu_torch.utils.stats import collect_stats
from flingbot_tpu_torch.utils.vis import draw_action

PIXELS = np.array([[20.4, 12.0], [40.0, 51.7]], np.float32)


@pytest.mark.parametrize("primitive", ["fling", "stretchdrag", "drag",
                                       "place"])
def test_draw_action_matches(primitive):
    img = np.random.default_rng(0).random((64, 64, 3)).astype(np.float32)
    got = draw_action(img.copy(), primitive, PIXELS, thickness=2)
    want = jax_draw_action(img.copy(), primitive, PIXELS, thickness=2)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - img).max() > 0.5  # something was drawn


def _record(memory):
    """One step with the values collect_stats and visualize read."""
    rng = np.random.default_rng(1)
    memory.add_observation(rng.random((4, 32, 32)).astype(np.float32))
    memory.add_action(np.eye(32, dtype=np.float32))
    memory.add_rewards_and_termination(0.01, True)
    for key, value in (
            ("pretransform_observations",
             rng.random((4, 64, 64)).astype(np.float32)),
            ("next_observations", rng.random((4, 64, 64)).astype(np.float32)),
            ("pretransform_pixels", PIXELS),
            ("value_map", rng.random((32, 32)).astype(np.float32)),
            ("action_primitive", "fling"), ("task_difficulty", "hard"),
            ("max_coverage", 0.1), ("preaction_coverage", 0.05),
            ("postaction_coverage", 0.06), ("init_coverage", 0.05)):
        memory.add_value(key, value)
    return memory


def test_collect_stats_panels_match(tmp_path):
    h5 = str(tmp_path / "jax_replay.hdf5")
    _record(JMemory()).dump(h5)
    replay = str(tmp_path / "replay")
    _record(Memory()).dump(replay)
    got, want = collect_stats(replay), jax_collect_stats(h5)
    for key in ("img_action", "img_before_after", "img_value_map"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["img_action"].shape == (3, 64, 64)
    assert not np.array_equal(got["img_action"],
                              got["img_before_after"][:, :, :64])


def test_visualize_builds_a_gallery_with_the_video(tmp_path, capsys):
    replay = str(tmp_path / "replay")
    _record(Memory()).dump(replay)
    frames = np.zeros((4, 32, 32, 3), np.uint8)
    frames[:, 8:24, 8:24] = 200
    write_webm(frames, os.path.join(video_dir(replay), "000000000.webm"))
    out = str(tmp_path / "vis")
    visualize.main([replay, "--output_dir", out])
    html = open(os.path.join(out, "index.html")).read()
    assert '<video src="000000000.webm"' in html
    assert os.path.getsize(os.path.join(out, "000000000.webm")) > 0
    for tag in ("before", "after", "value"):
        assert os.path.exists(
            os.path.join(out, f"000000000_step00_last_{tag}.png")), tag
    printed = capsys.readouterr().out
    assert "delta_coverage/hard" in printed
    assert "0.500 &rarr; 0.600" in html
