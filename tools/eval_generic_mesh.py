"""Evaluate a shirt task set through the port's generic mesh path.

    python tools/eval_generic_mesh.py --tasks data_r3/shirt_eval_16.npz \
        --policy heuristic --steps 3 --render_dim 256 --num_envs 64 \
        --seed 0 --episodes 64 --stats_out generic.json

Takes the flags of `python -m flingbot_tpu_torch.eval_quality` and runs
that evaluation with every shirt loaded as a MeshTopology at the file's
mesh bucket (tasks.detect_mesh_caps), where eval_quality itself puts a
file of layered shirts on the layered lattice.  The two paths solve the
same constraint system, so the two jobs' statistics should agree within
their bootstrap CI (tools/eval_table.py boot_diff_ci).  Runs on the card;
--device cpu runs it on the CPU.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from flingbot_tpu_torch import eval_quality  # noqa: E402
from flingbot_tpu_torch.env.tasks import detect_mesh_caps  # noqa: E402


def main(argv=None):
    args = eval_quality.parse_args(argv)
    caps = detect_mesh_caps(args.tasks)
    if caps is None:
        raise SystemExit(f"{args.tasks} holds no mesh tasks")
    eval_quality.main(argv, buckets={"mesh_caps": caps,
                                     "layered_spec": None})


if __name__ == "__main__":
    main()
