"""Dense action selection: masked argmax over the spatial action space
of one or several primitives (counterpart of flingbot_tpu/env/action.py).

Validity (in bounds after the inverse transform, arm reach, grasp circle
on cloth) is action-independent, so every mask is computed up front and
one masked argmax over (P, T, D, D), first index on ties, picks the
primitive and the action (get_max_value_valid_action, simEnv.py:560-661).
When nothing is valid the unmasked argmax is taken and the primitive
no-ops through its grasp flags.

Grasp-point geometry per primitive (get_action_params, simEnv.py:517-537):
  fling, stretchdrag: p1 / p2 = the selected pixel +- pix_grasp_dist rows;
                      the left arm reaches p1, the right arm p2, and at
                      least one grasp circle lands on cloth
  drag:               p2 = p1 + pix_drag_dist rows
  place:              p2 = p1 + pix_place_dist rows; for both, one arm
                      reaches p1 and p2, and p1's grasp circle is on cloth
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from flingbot_tpu_torch.engine.topology import shift2d
from flingbot_tpu_torch.env.observation import Observation
from flingbot_tpu_torch.learning.transforms import transform_pixels_to_source
from flingbot_tpu_torch.render.camera import pixel_to_world

NEG_INF = -1e30


class ActionSelection(NamedTuple):
    valid: torch.Tensor  # (B,) bool: a valid action existed
    prim_idx: torch.Tensor  # (B,) i64
    transform_idx: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    rotation: torch.Tensor  # (B,) degrees
    scale: torch.Tensor
    value: torch.Tensor
    p1_world: torch.Tensor  # (B, 3)
    p2_world: torch.Tensor
    p1_grasp: torch.Tensor  # (B,) bool
    p2_grasp: torch.Tensor
    pretransform_pixels: torch.Tensor  # (B, 2, 2) source (row, col)


def _pair_offsets(primitives: Sequence[str], pix_grasp_dist, pix_drag_dist,
                  pix_place_dist):
    """Per primitive: row offsets of p1 and p2 from the selected pixel and
    the pairing (0: left arm -> p1, right arm -> p2; 1: one arm reaches
    both) (_pair_offsets, action.py:56-80)."""
    o1, o2, pairing = [], [], []
    for p in primitives:
        if p in ("fling", "stretchdrag"):
            o1.append(pix_grasp_dist)
            o2.append(-pix_grasp_dist)
            pairing.append(0)
        elif p == "drag":
            o1.append(0)
            o2.append(pix_drag_dist)
            pairing.append(1)
        elif p == "place":
            o1.append(0)
            o2.append(pix_place_dist)
            pairing.append(1)
        else:
            raise ValueError(p)
    return tuple(o1), tuple(o2), tuple(pairing)


def select_action(value_maps: torch.Tensor, obs: Observation,
                  rotations: torch.Tensor,
                  primitives: Sequence[str] = ("fling",),
                  pix_grasp_dist: int = 8, pix_drag_dist: int = 10,
                  pix_place_dist: int = 10) -> ActionSelection:
    """value_maps (B, P, T, D, D), P = len(primitives) -> per-env
    selection (select_action, action.py:83)."""
    B, P, T, D, _ = value_maps.shape
    dev = value_maps.device
    o1s, o2s, pairings = _pair_offsets(primitives, pix_grasp_dist,
                                       pix_drag_dist, pix_place_dist)
    g = pix_grasp_dist
    reach_l = obs.mask_stack[:, :, 1] > 0.5
    reach_r = obs.mask_stack[:, :, 2] > 0.5
    grasp_w = obs.mask_stack[:, :, 3] > 0.5
    inb = obs.mask_stack[:, :, 4] > 0.5

    ri = torch.arange(D, device=dev)
    crop = (ri >= g) & (ri < D - g)
    crop2d = crop[:, None] & crop[None, :]

    def shifted(m, dy):
        return shift2d(m, dy, 0, fill=False)

    masks = []
    for o1, o2, pairing in zip(o1s, o2s, pairings):
        if pairing == 0:
            reach_ok = shifted(reach_l, o1) & shifted(reach_r, o2)
            grasp_ok = shifted(grasp_w, o1) | shifted(grasp_w, o2)
        else:
            reach_ok = ((shifted(reach_l, o1) & shifted(reach_l, o2))
                        | (shifted(reach_r, o1) & shifted(reach_r, o2)))
            grasp_ok = shifted(grasp_w, o1)
        masks.append(shifted(inb, o1) & shifted(inb, o2) & reach_ok
                     & grasp_ok & crop2d)
    valid = torch.stack(masks, 1)  # (B, P, T, D, D)

    flat_vm = value_maps.reshape(B, -1)
    masked = torch.where(valid.reshape(B, -1), flat_vm, NEG_INF)
    flat_idx = torch.argmax(masked, 1)
    best = masked.gather(1, flat_idx[:, None])[:, 0]
    any_valid = best > NEG_INF / 2
    flat_idx = torch.where(any_valid, flat_idx, torch.argmax(flat_vm, 1))
    value = flat_vm.gather(1, flat_idx[:, None])[:, 0]

    prim_idx = flat_idx // (T * D * D)
    rem = flat_idx % (T * D * D)
    t = rem // (D * D)
    rem = rem % (D * D)
    row = rem // D
    col = rem % D

    n_scales = obs.adaptive_scales.shape[1]
    rotation = rotations.to(dev)[t // n_scales]
    scale = obs.adaptive_scales.gather(1, (t % n_scales)[:, None])[:, 0]

    off1 = torch.tensor(o1s, device=dev)[prim_idx]
    off2 = torch.tensor(o2s, device=dev)[prim_idx]
    px_t = torch.stack([torch.stack([row + off1, col], -1),
                        torch.stack([row + off2, col], -1)],
                       1).to(torch.float32)
    S = obs.depth.shape[1]
    src_px = transform_pixels_to_source(px_t, rotation[:, None],
                                        scale[:, None], S, D)  # (B, 2, 2)

    ar = torch.arange(B, device=dev)

    def sample(img, px):
        r = torch.round(px[:, 0]).to(torch.int64).clamp(0, S - 1)
        c = torch.round(px[:, 1]).to(torch.int64).clamp(0, S - 1)
        return img[ar, r, c]

    d1 = sample(obs.depth, src_px[:, 0])
    d2 = sample(obs.depth, src_px[:, 1])
    p1w = pixel_to_world(src_px[:, 0, 0], src_px[:, 0, 1], d1, S)
    p2w = pixel_to_world(src_px[:, 1, 0], src_px[:, 1, 1], d2, S)
    g1 = sample(obs.grasp_ok, src_px[:, 0]) & any_valid
    g2 = sample(obs.grasp_ok, src_px[:, 1]) & any_valid
    return ActionSelection(
        valid=any_valid, prim_idx=prim_idx, transform_idx=t, row=row,
        col=col, rotation=rotation, scale=scale, value=value, p1_world=p1w,
        p2_world=p2w, p1_grasp=g1, p2_grasp=g2, pretransform_pixels=src_px)
