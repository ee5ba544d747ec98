"""Compare a port eval (python -m flingbot_tpu_torch.eval_quality
--stats_out X.json) with a JAX package eval row of an eval_session.jsonl:
each per-episode statistic's mean on both sides and the unpaired
bootstrap 95% CI of the difference (port - JAX), from
tools/eval_table.py's boot_diff_ci (10,000 resamples, seed 0).  Numpy
only.

Usage:
    python tools/eval_compare.py hard_stats.json hard/heuristic \
        [runs/round5b/eval_session.jsonl]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tools.eval_table import boot_diff_ci  # noqa: E402

STATS = ("best_coverage", "init_coverage", "episode_delta_coverage")


def compare(port: dict, row: dict) -> list:
    """[(key, n port, mean port, n JAX, mean JAX, CI of the difference,
    episodes equal to the row's 4 digits in episode order)] for every
    statistic whose distribution both sides hold."""
    rng = np.random.default_rng(0)
    out = []
    for k in sorted(port):
        if not (k.endswith("/distribution")
                and k.split("/")[0] in STATS and k in row):
            continue
        a = np.asarray(port[k], np.float64)
        b = np.asarray(row[k], np.float64)
        same = (int(np.sum(np.round(a, 4) == b)) if a.size == b.size
                else None)
        out.append((k[:-len("/distribution")], a.size, a.mean(), b.size,
                    b.mean(), boot_diff_ci(a, b, rng), same))
    return out


def main():
    stats_path, job = sys.argv[1], sys.argv[2]
    rows_path = (sys.argv[3] if len(sys.argv) > 3
                 else "runs/round5b/eval_session.jsonl")
    port = json.load(open(stats_path))
    rows = [json.loads(x) for x in open(rows_path) if x.strip()]
    row = next(r for r in rows if r.get("job") == job)
    for key, na, ma, nb, mb, ci, same in compare(port, row):
        excl = ci is not None and (ci[0] > 0 or ci[1] < 0)
        print(f"{key}: port {ma:.4f} (n={na}) JAX {mb:.4f} (n={nb}) "
              f"diff {ma - mb:+.4f} 95% CI [{ci[0]:+.4f}, {ci[1]:+.4f}]"
              f"{' excludes 0' if excl else ''}; episodes equal to 4 "
              f"digits in order: {same}")


if __name__ == "__main__":
    main()
