"""Spatial action-value network and the maximum-value policy (counterpart
of flingbot_tpu/learning/nets.py, inference only, no test-time averaging).

A fully convolutional, resolution-preserving stack: 3x3 conv to 16
channels + BatchNorm + LeakyReLU, 8 residual blocks of two 3x3 convs with
BatchNorm, and a final 3x3 conv to one value channel.  Flax's BatchNorm
momentum 0.99 is torch's momentum 0.01; Flax SAME padding of a 3x3 conv is
padding=1.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from flingbot_tpu_torch.device import resolve_device

OBS_MEAN = (0.18, 0.18, 0.18, 1.99)
OBS_STD = (0.1, 0.1, 0.1, 0.006)


def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.01)


class ResidualBlock(nn.Module):
    def __init__(self, channels: int = 16):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = _bn(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = _bn(channels)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + x)


class SpatialValueNet(nn.Module):
    """(B, C, H, W) channel-first obs (rgb ++ depth) -> (B, H, W); with
    rgb_only (the production setting) the depth channel is ignored."""

    def __init__(self, rgb_only: bool = False, num_blocks: int = 8,
                 channels: int = 16):
        super().__init__()
        self.nin = 3 if rgb_only else 4
        self.register_buffer(
            "mean", torch.tensor(OBS_MEAN[:self.nin]).view(1, -1, 1, 1),
            persistent=False)
        self.register_buffer(
            "std", torch.tensor(OBS_STD[:self.nin]).view(1, -1, 1, 1),
            persistent=False)
        self.stem = nn.Conv2d(self.nin, channels, 3, padding=1, bias=False)
        self.stem_bn = _bn(channels)
        self.blocks = nn.ModuleList(
            [ResidualBlock(channels) for _ in range(num_blocks)])
        self.head = nn.Conv2d(channels, 1, 3, padding=1, bias=False)

    def forward(self, obs):
        x = (obs[:, :self.nin] - self.mean) / self.std
        x = nn.functional.leaky_relu(self.stem_bn(self.stem(x)), 0.01)
        for blk in self.blocks:
            x = blk(x)
        return self.head(x)[:, 0]


@torch.no_grad()
def value_map_inference(net: SpatialValueNet, obs) -> torch.Tensor:
    """obs (T, C, D, D) -> (T, D, D) value maps, eval mode."""
    net.eval()
    return net(obs)


class MaximumValuePolicy:
    """One value net per primitive (MaximumValuePolicy, nets.py:144),
    inference only, without exploration or test-time averaging.  Nets are
    initialized from `seed`; weights from a Flax checkpoint load through
    learning/convert.py into `policy.nets[primitive]`.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits; the policy turns TF32 off for convolutions and
    matmuls so that value maps match the float32 reference."""

    def __init__(self, action_primitives: Sequence[str] = ("fling",),
                 obs_dim: int = 64, rgb_only: bool = True,
                 num_blocks: int = 8, seed: int = 0, device="cuda"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.device = resolve_device(device)
        self.action_primitives = list(action_primitives)
        self.obs_dim = obs_dim
        self.nets = {}
        for i, key in enumerate(self.action_primitives):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed + i)
                net = SpatialValueNet(rgb_only=rgb_only,
                                      num_blocks=num_blocks)
            self.nets[key] = net.to(self.device).eval()

    @torch.no_grad()
    def batch_value_maps(self, obs: torch.Tensor,
                         max_infer_batch: int = 4096) -> torch.Tensor:
        """(B, T, C, D, D) -> (B, P, T, D, D): the whole env batch runs
        through each net, in slices of <= max_infer_batch images."""
        B, T = obs.shape[:2]
        flat = obs.reshape((B * T,) + obs.shape[2:]).to(self.device)
        n = max_infer_batch
        maps = []
        for key in self.action_primitives:
            vm = torch.cat([value_map_inference(self.nets[key], flat[s:s + n])
                            for s in range(0, flat.shape[0], n)])
            maps.append(vm.reshape(B, T, self.obs_dim, self.obs_dim))
        return torch.stack(maps, 1)


def rotation_list(num_rotations: int) -> np.ndarray:
    """The rotations of the fling action space in degrees, -90..90
    (simEnv.py:70-76)."""
    return np.asarray([(2 * i / (num_rotations - 1) - 1) * 90
                       for i in range(num_rotations)], np.float32)
