"""Checkpoints and auto-resume (counterpart of
flingbot_tpu/utils/checkpoint.py).

run_sim writes `latest_ckpt.pth` after every optimize round and
`ckpt_{steps:06d}.pth` every --save_ckpt rounds, resumes from
`{log}/latest_ckpt.pth`, and evaluates into a fresh `{ckpt}_eval_{i}/`.
A checkpoint of the port is `torch.save` of {"policy":
MaximumValuePolicy.state_dict()} with every tensor on the CPU: tensors,
dicts, lists, numbers, strings and None only, so that
`torch.load(weights_only=True)` reads it.  A checkpoint of the JAX package
(a pickle that needs optax) loads once exported to `.npz` by
tools/export_ckpt_npz.py.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np
import torch

from flingbot_tpu_torch.learning.convert import policy_state_from_flat


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, policy, extra: dict = None):
    """Write atomically: a temporary file, then os.replace."""
    payload = {"policy": _to_cpu(policy.state_dict())}
    if extra:
        payload.update(extra)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, policy) -> dict:
    """Load a port checkpoint (.pth) or an exported JAX checkpoint (.npz)
    into the policy; returns the payload."""
    if str(path).endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            payload = {"policy": policy_state_from_flat(
                {k: z[k] for k in z.files})}
    elif not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path} is not a checkpoint of flingbot_tpu_torch (a pickle of "
            "the JAX package?); export it where optax imports with "
            f"`python tools/export_ckpt_npz.py {path} <out>.npz` and load "
            "the .npz")
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    policy.load_state_dict(payload["policy"])
    return payload


def setup_eval_dir(load_path: str) -> str:
    """Derive the `{ckpt}_eval_{i}/` log dir (utils.py:125-137); {ckpt}
    is the checkpoint's path without its extension (.pth or .npz)."""
    prefix = os.path.splitext(str(load_path))[0]
    i = 0
    while os.path.exists(prefix + f"_eval_{i}/"):
        i += 1
    log = prefix + f"_eval_{i}/"
    os.makedirs(log, exist_ok=True)
    return log
