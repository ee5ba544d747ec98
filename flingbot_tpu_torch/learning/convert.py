"""Flax SpatialValueNet variables -> a torch SpatialValueNet state_dict.

Inputs are the nested dicts of numpy arrays that Flax's
`variables["params"]` and `variables["batch_stats"]` hold, so this module
needs neither JAX nor Flax.  Flax names submodules by class and order:
Conv_0 / BatchNorm_0 (stem), ResidualBlock_<k> {Conv_0, BatchNorm_0,
Conv_1, BatchNorm_1}, Conv_1 (head).  Conv kernels are HWIO in Flax and
OIHW in torch.
"""

from __future__ import annotations

import numpy as np
import torch


def _conv(kernel) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(kernel, np.float32).transpose(
            3, 2, 0, 1)))


def _bn(prefix: str, params: dict, stats: dict) -> dict:
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32).copy())  # noqa
    return {
        f"{prefix}.weight": t(params["scale"]),
        f"{prefix}.bias": t(params["bias"]),
        f"{prefix}.running_mean": t(stats["mean"]),
        f"{prefix}.running_var": t(stats["var"]),
        f"{prefix}.num_batches_tracked": torch.tensor(0),
    }


def state_dict_from_flax(params: dict, batch_stats: dict) -> dict:
    """Flax (params, batch_stats) -> SpatialValueNet.state_dict()."""
    sd = {"stem.weight": _conv(params["Conv_0"]["kernel"])}
    sd.update(_bn("stem_bn", params["BatchNorm_0"],
                  batch_stats["BatchNorm_0"]))
    k = 0
    while f"ResidualBlock_{k}" in params:
        p = params[f"ResidualBlock_{k}"]
        s = batch_stats[f"ResidualBlock_{k}"]
        sd[f"blocks.{k}.conv1.weight"] = _conv(p["Conv_0"]["kernel"])
        sd.update(_bn(f"blocks.{k}.bn1", p["BatchNorm_0"], s["BatchNorm_0"]))
        sd[f"blocks.{k}.conv2.weight"] = _conv(p["Conv_1"]["kernel"])
        sd.update(_bn(f"blocks.{k}.bn2", p["BatchNorm_1"], s["BatchNorm_1"]))
        k += 1
    sd["head.weight"] = _conv(params["Conv_1"]["kernel"])
    return sd


def flax_from_state_dict(sd: dict):
    """The inverse of state_dict_from_flax: (params, batch_stats) as
    nested dicts of numpy arrays."""
    conv = lambda w: w.detach().cpu().numpy().transpose(2, 3, 1, 0)  # noqa

    def bn(prefix):
        g = lambda n: sd[f"{prefix}.{n}"].detach().cpu().numpy()  # noqa
        return ({"scale": g("weight"), "bias": g("bias")},
                {"mean": g("running_mean"), "var": g("running_var")})

    params, stats = {"Conv_0": {"kernel": conv(sd["stem.weight"])}}, {}
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn("stem_bn")
    k = 0
    while f"blocks.{k}.conv1.weight" in sd:
        p, s = {}, {}
        p["Conv_0"] = {"kernel": conv(sd[f"blocks.{k}.conv1.weight"])}
        p["BatchNorm_0"], s["BatchNorm_0"] = bn(f"blocks.{k}.bn1")
        p["Conv_1"] = {"kernel": conv(sd[f"blocks.{k}.conv2.weight"])}
        p["BatchNorm_1"], s["BatchNorm_1"] = bn(f"blocks.{k}.bn2")
        params[f"ResidualBlock_{k}"], stats[f"ResidualBlock_{k}"] = p, s
        k += 1
    params["Conv_1"] = {"kernel": conv(sd["head.weight"])}
    return params, stats
