"""Export a checkpoint of the JAX package (flingbot_tpu) to one numpy
`.npz` archive that `flingbot_tpu_torch` loads.

A JAX checkpoint (`latest_ckpt.pth`, `ckpt_NNNNNN.pth`) is a pickle of
numpy trees whose optimizer state holds optax classes, so reading it
needs optax.  The archive holds the same numbers under flat "/"-joined
Flax paths, readable with numpy alone (layout:
flingbot_tpu_torch/learning/convert.py):

    nets/<primitive>/{params,batch_stats,mu,nu}/<flax path>
    nets/<primitive>/{count,steps}
    action_expl_prob, value_expl_prob

Usage (needs optax):
    python tools/export_ckpt_npz.py runs/round4/latest_ckpt.pth \
        runs/round4/latest_ckpt.npz
"""

from __future__ import annotations

import argparse
import pickle
from collections.abc import Mapping

import numpy as np


def _adam_state(opt_state):
    """The ScaleByAdamState (count, mu, nu) of an optax.adamw state."""
    for s in opt_state:
        if all(hasattr(s, a) for a in ("count", "mu", "nu")):
            return s
    raise ValueError("no Adam state (count, mu, nu) in the optimizer state")


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def flatten_policy(policy_state: dict) -> dict:
    """MaximumValuePolicy.state_dict() of the JAX package (numpy leaves)
    -> {flat key: array}."""
    out = {"action_expl_prob": np.float64(policy_state["action_expl_prob"]),
           "value_expl_prob": np.float64(policy_state["value_expl_prob"])}
    for key, ns in policy_state["nets"].items():
        pre = f"nets/{key}/"
        adam = _adam_state(ns["opt_state"])
        out.update(_flat(ns["params"], pre + "params/"))
        out.update(_flat(ns["batch_stats"], pre + "batch_stats/"))
        out.update(_flat(adam.mu, pre + "mu/"))
        out.update(_flat(adam.nu, pre + "nu/"))
        out[pre + "count"] = np.asarray(adam.count, np.int64)
        out[pre + "steps"] = np.asarray(int(ns["steps"]), np.int64)
    return out


def export(pth_path: str, npz_path: str) -> dict:
    """Write the archive; returns its arrays."""
    with open(pth_path, "rb") as f:
        payload = pickle.load(f)
    arrays = flatten_policy(payload["policy"])
    np.savez(npz_path, **arrays)
    return arrays


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("pth")
    p.add_argument("npz")
    a = p.parse_args()
    arrays = export(a.pth, a.npz)
    nets = sorted({k.split("/")[1] for k in arrays if k.startswith("nets/")})
    print(f"{a.npz}: {len(arrays)} arrays, nets {nets}")


if __name__ == "__main__":
    main()
