"""Spatial action-value network and the maximum-value policy (counterpart
of flingbot_tpu/learning/nets.py).

A fully convolutional, resolution-preserving stack: 3x3 conv to 16
channels + BatchNorm + LeakyReLU, 8 residual blocks of two 3x3 convs with
BatchNorm, and a final 3x3 conv to one value channel.  Flax's BatchNorm
momentum 0.99 is torch's momentum 0.01; Flax SAME padding of a 3x3 conv is
padding=1.  Each net trains with AdamW over all its parameters, as
optax.adamw does (NetState).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch import nn

from flingbot_tpu_torch.device import resolve_device

OBS_MEAN = (0.18, 0.18, 0.18, 1.99)
OBS_STD = (0.1, 0.1, 0.1, 0.006)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d whose train mode computes Flax's statistics
    (flax.linen.normalization._compute_stats): the biased batch variance
    as max(0, E[x^2] - E[x]^2), which both normalizes the batch and
    updates the running variance.  torch's own train mode updates the
    running variance with the unbiased variance, n / (n - 1) times larger.
    Eval mode is torch's."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.01)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None])


class ResidualBlock(nn.Module):
    def __init__(self, channels: int = 16):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(channels)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + x)


class SpatialValueNet(nn.Module):
    """(B, C, H, W) channel-first obs (rgb ++ depth) -> (B, H, W); with
    rgb_only (the production setting) the net reads the RGB channels, with
    depth_only the depth channel, else all four."""

    def __init__(self, rgb_only: bool = False, depth_only: bool = False,
                 num_blocks: int = 8, channels: int = 16):
        super().__init__()
        chans = slice(0, 3) if rgb_only else (
            slice(3, 4) if depth_only else slice(0, 4))
        self.chans = chans
        nin = chans.stop - chans.start
        self.register_buffer(
            "mean", torch.tensor(OBS_MEAN[chans]).view(1, -1, 1, 1),
            persistent=False)
        self.register_buffer(
            "std", torch.tensor(OBS_STD[chans]).view(1, -1, 1, 1),
            persistent=False)
        self.stem = nn.Conv2d(nin, channels, 3, padding=1, bias=False)
        self.stem_bn = BatchNorm(channels)
        self.blocks = nn.ModuleList(
            [ResidualBlock(channels) for _ in range(num_blocks)])
        self.head = nn.Conv2d(channels, 1, 3, padding=1, bias=False)

    def forward(self, obs):
        x = (obs[:, self.chans] - self.mean) / self.std
        x = nn.functional.leaky_relu(self.stem_bn(self.stem(x)), 0.01)
        for blk in self.blocks:
            x = blk(x)
        return self.head(x)[:, 0]


@torch.no_grad()
def value_map_inference(net: SpatialValueNet, obs) -> torch.Tensor:
    """obs (T, C, D, D) -> (T, D, D) value maps, eval mode."""
    net.eval()
    return net(obs)


@torch.no_grad()
def value_map_inference_tta(net: SpatialValueNet, obs) -> torch.Tensor:
    """Dihedral test-time averaging (nets.py:122-141): the net on all 8 D4
    transforms of each view, each map transformed back, averaged."""
    net.eval()
    acc = torch.zeros(obs.shape[:1] + obs.shape[-2:], dtype=obs.dtype,
                      device=obs.device)
    for k in range(4):
        for flip in (False, True):
            o = torch.rot90(obs, k, dims=(-2, -1))
            if flip:
                o = torch.flip(o, dims=(-1,))
            vm = net(o)
            if flip:
                vm = torch.flip(vm, dims=(-1,))
            acc = acc + torch.rot90(vm, -k, dims=(-2, -1))
    return acc / 8.0


class NetState:
    """One value net with its optimizer and the persistent step counter
    (NetState, nets.py:83-119).  torch's AdamW decays the weights before
    the Adam step, p (1 - lr wd) - lr m/(sqrt(v) + eps), where optax.adamw
    subtracts lr (m/(sqrt(v) + eps) + wd p): equal but for rounding."""

    def __init__(self, net: SpatialValueNet, lr: float = 1e-4,
                 weight_decay: float = 1e-6):
        self.net = net
        self.optimizer = torch.optim.AdamW(
            net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay)
        self.steps = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.net.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "steps": self.steps}

    def load_state_dict(self, d: Dict[str, Any]):
        """Weights, running statistics, the Adam moments and step count,
        and the step counter.  The learning rate and weight decay stay
        this NetState's, as a JAX NetState keeps its optimizer."""
        self.net.load_state_dict(d["model"])
        groups = self.optimizer.state_dict()["param_groups"]
        self.optimizer.load_state_dict({"state": d["optimizer"]["state"],
                                        "param_groups": groups})
        self.steps = int(d["steps"])


class MaximumValuePolicy:
    """One value net per primitive with epsilon-greedy value and action
    exploration (MaximumValuePolicy, nets.py:144-295).  Nets are
    initialized from `seed`; checkpoints load through
    utils/checkpoint.py.  The exploration draws come from generators the
    policy holds: a numpy Generator for the coin flips and a torch
    Generator on the policy's device for the uniform maps.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits; the policy turns TF32 off for convolutions and
    matmuls so that value maps and training match the float32
    reference."""

    def __init__(self, action_primitives: Sequence[str] = ("fling",),
                 obs_dim: int = 64, rgb_only: bool = True,
                 depth_only: bool = False, num_blocks: int = 8,
                 action_expl_prob: float = 0.0,
                 action_expl_decay: float = 0.9995,
                 value_expl_prob: float = 0.0,
                 value_expl_decay: float = 0.995, lr: float = 1e-4,
                 weight_decay: float = 1e-6, tta: bool = False,
                 seed: int = 0, device="cuda", **_unused):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.device = resolve_device(device)
        self.action_primitives = list(action_primitives)
        self.obs_dim = obs_dim
        self.action_expl_prob = float(action_expl_prob)
        self.action_expl_decay = float(action_expl_decay)
        self.value_expl_prob = float(value_expl_prob)
        self.value_expl_decay = float(value_expl_decay)
        self.tta = bool(tta)
        self.nets: Dict[str, NetState] = {}
        for i, key in enumerate(self.action_primitives):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed + i)
                net = SpatialValueNet(rgb_only=rgb_only,
                                      depth_only=depth_only,
                                      num_blocks=num_blocks)
            self.nets[key] = NetState(net.to(self.device).eval(), lr=lr,
                                      weight_decay=weight_decay)
        self.np_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def decay_exploration(self):
        self.action_expl_prob *= self.action_expl_decay
        self.value_expl_prob *= self.value_expl_decay

    def steps(self) -> int:
        return sum(n.steps for n in self.nets.values())

    @torch.no_grad()
    def batch_value_maps(self, obs: torch.Tensor,
                         max_infer_batch: int = 4096) -> torch.Tensor:
        """(B, T, C, D, D) -> (B, P, T, D, D): the whole env batch runs
        through each net, in slices of <= max_infer_batch images; then
        value exploration (uniform maps in [0, 1)) and, with several
        primitives, action exploration (every primitive but one set to
        the batch minimum), once per batch step (nets.py:245-282)."""
        B, T = obs.shape[:2]
        flat = obs.reshape((B * T,) + obs.shape[2:]).to(self.device)
        infer = value_map_inference_tta if self.tta else value_map_inference
        n = max_infer_batch
        maps = []
        for key in self.action_primitives:
            net = self.nets[key].net
            vm = torch.cat([infer(net, flat[s:s + n])
                            for s in range(0, flat.shape[0], n)])
            maps.append(vm.reshape(B, T, self.obs_dim, self.obs_dim))
        out = torch.stack(maps, 1)
        if self.np_rng.random() < self.value_expl_prob:
            out = torch.rand(out.shape, generator=self.generator,
                             device=self.device)
        if len(self.action_primitives) > 1 and (
                self.np_rng.random() < self.action_expl_prob):
            p = int(self.np_rng.integers(len(self.action_primitives)))
            keep = out[:, p]
            out = torch.full_like(out, out.min())
            out[:, p] = keep
        return out

    # -- checkpointing ------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "nets": {k: ns.state_dict() for k, ns in self.nets.items()},
            "action_expl_prob": self.action_expl_prob,
            "value_expl_prob": self.value_expl_prob,
        }

    def load_state_dict(self, d: Dict[str, Any]):
        for k, ns in self.nets.items():
            ns.load_state_dict(d["nets"][k])
        self.action_expl_prob = float(d.get("action_expl_prob", 0.0))
        self.value_expl_prob = float(d.get("value_expl_prob", 0.0))


def rotation_list(num_rotations: int,
                  primitives: Sequence[str] = ("fling",)) -> np.ndarray:
    """The rotations of the action space in degrees (simEnv.py:70-76):
    -90..90 with the fling, whose two grasp points make a half turn the
    same action; else a full turn, -180..180 - 360 / num_rotations."""
    if "fling" in primitives:
        return np.asarray([(2 * i / (num_rotations - 1) - 1) * 90
                           for i in range(num_rotations)], np.float32)
    return np.asarray([(2 * i / num_rotations - 1) * 180
                       for i in range(num_rotations)], np.float32)
