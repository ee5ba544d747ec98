"""Plain reference of the fling's value net: FlingBot's fully
convolutional, resolution-preserving net (3x3 conv to 16 channels +
BatchNorm + LeakyReLU 0.01, 8 residual blocks of two 3x3 convs with
BatchNorm, a 3x3 conv to one value channel), read from a checkpoint
archive of Flax variables (HWIO kernels) and run in eval mode on the RGB
channels.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

OBS_MEAN = (0.18, 0.18, 0.18)
OBS_STD = (0.1, 0.1, 0.1)
INFER_BATCH = 4096


def load(path: str, device, primitive: str = "fling") -> dict:
    """{flax path: tensor} of one primitive's weights and BatchNorm
    statistics, kernels as OIHW."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for group in ("params", "batch_stats"):
            prefix = f"nets/{primitive}/{group}/"
            for k in z.files:
                if k.startswith(prefix):
                    a = np.asarray(z[k], np.float32)
                    if k.endswith("kernel"):
                        a = a.transpose(3, 2, 0, 1)
                    out[group + "/" + k[len(prefix):]] = torch.from_numpy(
                        np.ascontiguousarray(a)).to(device)
    return out


def _bn(x, w, name):
    return F.batch_norm(x, w[f"batch_stats/{name}/mean"].to(x.dtype),
                        w[f"batch_stats/{name}/var"].to(x.dtype),
                        w[f"params/{name}/scale"].to(x.dtype),
                        w[f"params/{name}/bias"].to(x.dtype),
                        training=False, momentum=0.0, eps=1e-5)


def _conv(x, w, name):
    return F.conv2d(x, w[f"params/{name}/kernel"].to(x.dtype), padding=1)


@torch.no_grad()
def value_maps(weights: dict, obs: torch.Tensor) -> torch.Tensor:
    """obs (M, 4, D, D) -> value maps (M, D, D), in slices of INFER_BATCH
    images, in obs's dtype."""
    dev, dt = obs.device, obs.dtype
    mean = torch.tensor(OBS_MEAN, device=dev).view(1, -1, 1, 1).to(dt)
    std = torch.tensor(OBS_STD, device=dev).view(1, -1, 1, 1).to(dt)
    n_blocks = 0
    while f"params/ResidualBlock_{n_blocks}/Conv_0/kernel" in weights:
        n_blocks += 1
    out = []
    for s in range(0, obs.shape[0], INFER_BATCH):
        x = (obs[s:s + INFER_BATCH, 0:3] - mean) / std
        x = F.leaky_relu(_bn(_conv(x, weights, "Conv_0"), weights,
                             "BatchNorm_0"), 0.01)
        for k in range(n_blocks):
            r = f"ResidualBlock_{k}"
            y = torch.relu(_bn(_conv(x, weights, f"{r}/Conv_0"), weights,
                               f"{r}/BatchNorm_0"))
            y = _bn(_conv(y, weights, f"{r}/Conv_1"), weights,
                    f"{r}/BatchNorm_1")
            x = torch.relu(y + x)
        out.append(_conv(x, weights, "Conv_1")[:, 0])
    return torch.cat(out)
