"""Statistics of task sets made by the port against the JAX package's sets
of the same name: size, mean initial coverage, and the ratio initial
coverage / flatten area (mean, sd, max; generate_sets.ratio_stats), with
the bootstrap 95% CI of each set's ratio mean and the unpaired bootstrap
95% CI of the difference of the means (port - JAX), from
tools/eval_table.py (10,000 resamples, seed 0).

    python tools/task_set_stats.py compare PORT_DIR [REF_DIR]

compares each <set>.npz of PORT_DIR (generate_sets' output) with
REF_DIR/<set>.npz (default data_r3), or, where the JAX set has no .npz
(rect_train_512), with REF_DIR/<set>.hdf5, read with h5py.  An archive
too large to carry off the machine that made it (rect_train_512, ~100 MB)
is first cut there to the two attributes the statistics read:

    python tools/task_set_stats.py strip data_torch/rect_train_512.npz OUT_DIR

which writes OUT_DIR/rect_train_512.npz, a task archive that compare
reads as it reads the whole one.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from flingbot_tpu_torch.generate_sets import (  # noqa: E402
    coverages, ratio_stats)
from tools.eval_table import boot_ci, boot_diff_ci  # noqa: E402

ATTRS = ("initial_coverage", "flatten_area")


def strip(src: str, out_dir: str):
    """The task archive src cut to each task's ATTRS, as
    out_dir/<its name>."""
    with np.load(src, allow_pickle=False) as z:
        kept = {e: z[e] for e in z.files if e.split("/@")[-1] in ATTRS}
    dst = os.path.join(out_dir, os.path.basename(src))
    np.savez_compressed(dst, **kept)
    print(f"[task_set_stats] {len(kept) // 2} tasks -> {dst}")


def reference(stem: str):
    """Initial coverage and flatten area of the JAX set `stem`: its .npz
    export, else its HDF5 file."""
    if os.path.exists(stem + ".npz"):
        return coverages(stem + ".npz")
    import h5py

    with h5py.File(stem + ".hdf5", "r") as f:
        return tuple(np.array([float(f[k].attrs[n]) for k in sorted(f)])
                     for n in ATTRS)


def compare(port_dir: str, ref_dir: str):
    rng = np.random.default_rng(0)
    for file in sorted(os.listdir(port_dir)):
        if not file.endswith(".npz"):
            continue
        name = file[:-len(".npz")]
        a = ratio_stats(*coverages(os.path.join(port_dir, file)))
        a["ci"] = boot_ci(a["ratio"], rng)
        b = ratio_stats(*reference(os.path.join(ref_dir, name)))
        b["ci"] = boot_ci(b["ratio"], rng)
        ci = boot_diff_ci(a["ratio"], b["ratio"], rng)
        for side, s in (("port", a), ("JAX ", b)):
            print(f"{name} {side}: n {s['n']} init mean {s['init_mean']:.4f}"
                  f" ratio mean {s['ratio_mean']:.4f} [{s['ci'][0]:.4f}, "
                  f"{s['ci'][1]:.4f}] sd {s['ratio_sd']:.4f} max "
                  f"{s['ratio_max']:.4f}")
        excl = ci[0] > 0 or ci[1] < 0
        print(f"{name} diff (port - JAX) {a['ratio_mean'] - b['ratio_mean']:+.4f}"
              f" 95% CI [{ci[0]:+.4f}, {ci[1]:+.4f}]"
              f"{' excludes 0' if excl else ''}")


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "strip":
        strip(sys.argv[2], sys.argv[3])
    elif len(sys.argv) in (3, 4) and sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else "data_r3")
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
