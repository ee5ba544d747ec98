"""Offline metrics and an episode gallery over a replay directory
(counterpart of the root visualize.py).

`summarize` prints summary statistics and quantiles of a replay record,
`simple_visualize` writes per-step image panels (the observation before,
with the action drawn, and after; the value map) and a static HTML page
with the episode videos that --dump_visualizations wrote, browsable with
`python -m http.server`.  It reads the port's replay directory
(learning/memory.py: one .npz per step), not the JAX package's HDF5.

    python -m flingbot_tpu_torch.visualize runs/exp1/replay_buffer \
        [--output_dir vis/]
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from flingbot_tpu_torch.env.sim_env import video_dir
from flingbot_tpu_torch.learning.memory import read_step, step_keys
from flingbot_tpu_torch.utils.stats import collect_stats
from flingbot_tpu_torch.utils.vis import draw_action


def summarize(path: str, num_points: int = 10 ** 9):
    stats = collect_stats(path, num_points=num_points) or {}
    print(f"== Summary of {path} ==")
    for key, value in sorted(stats.items()):
        if "_steps" in key or "img" in key:
            continue
        if "distribution" in key:
            arr = np.asarray(value)
            qs = np.quantile(arr, [0.0, 0.25, 0.5, 0.75, 1.0])
            name = key.replace("/distribution", "")
            print(f"  {name:<40} n={len(arr):<5} "
                  f"q=[{qs[0]:+.3f} {qs[1]:+.3f} {qs[2]:+.3f} "
                  f"{qs[3]:+.3f} {qs[4]:+.3f}]")
        else:
            print(f"  {key:<40} {float(value):+.4f}")
    return stats


def _save_png(path, img):
    try:
        from PIL import Image
    except ImportError:
        return False
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)
    return True


_SPEED_SLIDER = """
<div>playback speed <input id="speed" type="range" min="0.25" max="4"
value="1" step="0.25" oninput="setSpeed(this.value)">
<span id="speedval">1x</span></div>
<script>
function setSpeed(v) {
  document.getElementById('speedval').innerText = v + 'x';
  document.querySelectorAll('video').forEach(el => el.playbackRate = v);
}
</script>
"""


def _episode_videos(replay_path: str, output_dir: str):
    """Copy the episode videos beside the gallery and return
    {episode_number: filename} (the video page of the reference,
    visualize.py:193-299)."""
    src_dir = video_dir(replay_path)
    out = {}
    if not os.path.isdir(src_dir):
        return out
    for fn in sorted(os.listdir(src_dir)):
        if not fn.endswith((".webm", ".mp4")):
            continue
        shutil.copy(os.path.join(src_dir, fn), os.path.join(output_dir, fn))
        try:
            out[int(os.path.splitext(fn)[0].split("_")[0])] = fn
        except ValueError:
            pass
    return out


def simple_visualize(path: str, output_dir: str = "vis", max_episodes=16):
    os.makedirs(output_dir, exist_ok=True)
    videos = _episode_videos(path, output_dir)
    rows = []
    for k in step_keys(path)[: max_episodes * 12]:
        attrs, g = read_step(path, k)
        cells = [f"<td>{k}</td>"]
        try:
            ep = int(k.split("_")[0])
        except ValueError:
            ep = -1
        if k.endswith("_last") and ep in videos:
            cells.append(
                f'<td><video src="{videos[ep]}" height="160px" controls '
                f'autoplay muted loop></video></td>')
        else:
            cells.append("<td></td>")
        for field, tag in (("pretransform_observations", "before"),
                           ("next_observations", "after")):
            if field in g:
                img = np.transpose(g[field][:3], (1, 2, 0)).copy()
                if tag == "before" and "pretransform_pixels" in g:
                    try:
                        img = draw_action(
                            img, str(attrs.get("action_primitive", "fling")),
                            g["pretransform_pixels"], thickness=2)
                    except Exception:
                        pass
                fn = f"{k}_{tag}.png"
                if _save_png(os.path.join(output_dir, fn), img):
                    cells.append(f'<td><img src="{fn}" height="160px"></td>')
        if "value_map" in g:
            vm = np.asarray(g["value_map"])
            vm = (vm - vm.min()) / max(vm.max() - vm.min(), 1e-9)
            fn = f"{k}_value.png"
            if _save_png(os.path.join(output_dir, fn), vm):
                cells.append(f'<td><img src="{fn}" height="160px"></td>')
        pre = attrs.get("preaction_coverage", float("nan"))
        post = attrs.get("postaction_coverage", float("nan"))
        mx = attrs.get("max_coverage", 1.0)
        cells.append(f"<td>{pre / mx:.3f} &rarr; {post / mx:.3f}</td>")
        rows.append("<tr>" + "".join(cells) + "</tr>")
    html = (
        "<html><body><h2>flingbot_tpu_torch replay</h2>"
        + (_SPEED_SLIDER if videos else "")
        + "<table border=1><tr><th>step</th><th>episode video</th>"
        "<th>before</th><th>after</th>"
        "<th>value map</th><th>coverage</th></tr>"
        + "\n".join(rows) + "</table></body></html>"
    )
    with open(os.path.join(output_dir, "index.html"), "w") as fh:
        fh.write(html)
    print(f"wrote {output_dir}/index.html "
          f"(serve with: python -m http.server -d {output_dir})")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", help="a replay directory")
    p.add_argument("--output_dir", default=None,
                   help="also write an HTML gallery here")
    p.add_argument("--num_points", type=int, default=10 ** 9)
    a = p.parse_args(argv)
    summarize(a.path, a.num_points)
    if a.output_dir:
        simple_visualize(a.path, a.output_dir)


if __name__ == "__main__":
    main()
