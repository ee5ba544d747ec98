"""Flax SpatialValueNet variables and optax AdamW state -> the port's
SpatialValueNet state_dict and torch AdamW state.

Inputs are numpy arrays, nested as Flax's `variables["params"]` and
`variables["batch_stats"]` (state_dict_from_flax), or flat under
"/"-joined Flax paths as tools/export_ckpt_npz.py writes a checkpoint
(policy_state_from_flat), so this module needs neither JAX, Flax nor
optax.  Flax names submodules by class and order: Conv_0 / BatchNorm_0
(stem), ResidualBlock_<k> {Conv_0, BatchNorm_0, Conv_1, BatchNorm_1},
Conv_1 (head).  Conv kernels, and their Adam moments, are HWIO in Flax
and OIHW in torch.

Layout of an exported checkpoint (flat keys):

    nets/<primitive>/params/<flax path>        weights
    nets/<primitive>/batch_stats/<flax path>   BatchNorm running mean, var
    nets/<primitive>/mu/<flax path>            Adam first moment
    nets/<primitive>/nu/<flax path>            Adam second moment
    nets/<primitive>/count                     Adam step count
    nets/<primitive>/steps                     the policy's step counter
    action_expl_prob, value_expl_prob
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch


def param_table(num_blocks: int) -> List[Tuple[str, str]]:
    """(torch parameter name, Flax params path) in the order of
    SpatialValueNet.parameters(), which is the order of the optimizer's
    state."""
    def bn(t, f):
        return [(f"{t}.weight", f"{f}/scale"), (f"{t}.bias", f"{f}/bias")]

    rows = [("stem.weight", "Conv_0/kernel")] + bn("stem_bn", "BatchNorm_0")
    for k in range(num_blocks):
        r = f"ResidualBlock_{k}"
        rows += [(f"blocks.{k}.conv1.weight", f"{r}/Conv_0/kernel")]
        rows += bn(f"blocks.{k}.bn1", f"{r}/BatchNorm_0")
        rows += [(f"blocks.{k}.conv2.weight", f"{r}/Conv_1/kernel")]
        rows += bn(f"blocks.{k}.bn2", f"{r}/BatchNorm_1")
    return rows + [("head.weight", "Conv_1/kernel")]


def _bn_prefixes(num_blocks: int) -> List[Tuple[str, str]]:
    rows = [("stem_bn", "BatchNorm_0")]
    for k in range(num_blocks):
        rows += [(f"blocks.{k}.bn1", f"ResidualBlock_{k}/BatchNorm_0"),
                 (f"blocks.{k}.bn2", f"ResidualBlock_{k}/BatchNorm_1")]
    return rows


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    """{"a/b/c": leaf} -> nested dicts."""
    out: dict = {}
    for path, v in flat.items():
        *head, leaf = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _num_blocks(flat_params: Mapping) -> int:
    k = 0
    while f"ResidualBlock_{k}/Conv_0/kernel" in flat_params:
        k += 1
    return k


def _to_torch(a, kernel: bool) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    return torch.from_numpy(np.array(
        a.transpose(3, 2, 0, 1) if kernel else a))


def _to_flax(t: torch.Tensor, kernel: bool) -> np.ndarray:
    """A copy: .numpy() of a CPU tensor shares its memory."""
    a = t.detach().cpu().numpy()
    return np.array(a.transpose(2, 3, 1, 0) if kernel else a)


def state_dict_from_flax(params: Mapping, batch_stats: Mapping) -> dict:
    """Flax (params, batch_stats) -> SpatialValueNet.state_dict()."""
    fp, fs = flatten(params), flatten(batch_stats)
    n = _num_blocks(fp)
    sd = {t: _to_torch(fp[f], f.endswith("kernel"))
          for t, f in param_table(n)}
    for t, f in _bn_prefixes(n):
        sd[f"{t}.running_mean"] = _to_torch(fs[f"{f}/mean"], False)
        sd[f"{t}.running_var"] = _to_torch(fs[f"{f}/var"], False)
        sd[f"{t}.num_batches_tracked"] = torch.tensor(0)
    return sd


def flax_from_state_dict(sd: Mapping) -> Tuple[dict, dict]:
    """The inverse of state_dict_from_flax: (params, batch_stats) as
    nested dicts of numpy arrays."""
    n = 0
    while f"blocks.{n}.conv1.weight" in sd:
        n += 1
    params = {f: _to_flax(sd[t], f.endswith("kernel"))
              for t, f in param_table(n)}
    stats = {}
    for t, f in _bn_prefixes(n):
        stats[f"{f}/mean"] = _to_flax(sd[f"{t}.running_mean"], False)
        stats[f"{f}/var"] = _to_flax(sd[f"{t}.running_var"], False)
    return unflatten(params), unflatten(stats)


def adam_state_from_flax(mu: Mapping, nu: Mapping, count: int) -> dict:
    """optax ScaleByAdamState (flat mu, nu trees and count) -> the "state"
    of torch.optim.AdamW.state_dict() over SpatialValueNet.parameters():
    exp_avg, exp_avg_sq, and step as a float32 tensor.  A count of 0 (no
    step taken) is the empty state."""
    if int(count) == 0:
        return {}
    return {i: {"step": torch.tensor(float(count)),
                "exp_avg": _to_torch(mu[f], f.endswith("kernel")),
                "exp_avg_sq": _to_torch(nu[f], f.endswith("kernel"))}
            for i, (_, f) in enumerate(param_table(_num_blocks(mu)))}


def flax_moments(opt_state: Mapping, num_blocks: int):
    """The inverse of adam_state_from_flax, after at least one step:
    (mu, nu, count) with flat Flax paths."""
    state = opt_state["state"]
    mu, nu, count = {}, {}, 0
    for i, (_, f) in enumerate(param_table(num_blocks)):
        s = state[i]
        mu[f] = _to_flax(s["exp_avg"], f.endswith("kernel"))
        nu[f] = _to_flax(s["exp_avg_sq"], f.endswith("kernel"))
        count = int(s["step"])
    return mu, nu, count


def policy_state_from_flat(flat: Mapping[str, np.ndarray]) -> dict:
    """An exported checkpoint (see the module docstring) ->
    MaximumValuePolicy.load_state_dict's argument."""
    tree = unflatten(flat)
    nets = {}
    for key, d in tree["nets"].items():
        mu, nu = flatten(d["mu"]), flatten(d["nu"])
        nets[key] = {
            "model": state_dict_from_flax(d["params"], d["batch_stats"]),
            "optimizer": {"state": adam_state_from_flax(mu, nu,
                                                        d["count"])},
            "steps": int(d["steps"])}
    return {"nets": nets,
            "action_expl_prob": float(tree["action_expl_prob"]),
            "value_expl_prob": float(tree["value_expl_prob"])}
