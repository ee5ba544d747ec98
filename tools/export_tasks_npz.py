"""Export a flingbot-format HDF5 task file to one numpy `.npz` archive.

The task files are gzip-chunked HDF5 (one group per task under a sha1
key; arrays as datasets, scalars as group attributes).  Reading them needs
h5py, which a machine that only runs `flingbot_tpu_torch` may lack; the
port's `flingbot_tpu_torch.env.tasks.TaskLoader` reads the `.npz` this
script writes with numpy alone.

Layout of the archive (every entry keeps its HDF5 dtype and shape, empty
`mesh_*` arrays of rectangle sets included):

    "<task key>/<dataset>"   a dataset of the group
    "<task key>/@<attr>"     a group attribute, as a 0-d array
                             (strings as numpy unicode)

Usage (needs h5py):
    python tools/export_tasks_npz.py data_r3/rect_eval_hard_100.hdf5 \
        data_r3/rect_eval_hard_100.npz [--limit N]

--limit keeps the first N tasks in sorted key order, the order in which
TaskLoader serves them.
"""

from __future__ import annotations

import argparse

import h5py
import numpy as np

ATTR_PREFIX = "@"


def read_tasks(hdf5_path: str, limit: int | None = None) -> dict:
    """{"<key>/<name>": array} for every task group of the file."""
    out = {}
    with h5py.File(hdf5_path, "r") as f:
        keys = sorted(f.keys())
        for key in keys[:limit]:
            g = f[key]
            for name in g:
                out[f"{key}/{name}"] = np.array(g[name])
            for name, value in g.attrs.items():
                if isinstance(value, (str, bytes)):
                    value = np.str_(value.decode() if isinstance(value, bytes)
                                    else value)
                out[f"{key}/{ATTR_PREFIX}{name}"] = np.asarray(value)
    return out


def export(hdf5_path: str, npz_path: str, limit: int | None = None) -> int:
    """Write the archive; returns the number of tasks exported."""
    arrays = read_tasks(hdf5_path, limit)
    np.savez_compressed(npz_path, **arrays)
    return len({k.split("/", 1)[0] for k in arrays})


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("hdf5")
    p.add_argument("npz")
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args()
    n = export(args.hdf5, args.npz, args.limit)
    print(f"[export] {n} tasks: {args.hdf5} -> {args.npz}")


if __name__ == "__main__":
    main()
