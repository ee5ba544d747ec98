"""Batched rotation/scale observation transforms (counterpart of
flingbot_tpu/learning/transforms.py).

All 96 views (12 rotations x 8 scales) of a rendered image are one
bilinear gather: output pixel (r, c) of view (theta, s) samples the source
at m @ ((r, c) - c_out) + c_src with m = rot(theta) * s * src/out.
`transform_pixels_to_source` is the exact inverse used to decode actions.
"""

from __future__ import annotations

import numpy as np
import torch

_DEG2RAD = float(np.float32(np.pi / 180.0))


def _affine(rotation_deg, scale, src_dim: int, out_dim: int):
    """(..., 2, 2) matrices mapping output (row, col) offsets to source."""
    t = rotation_deg * _DEG2RAD
    c, s = torch.cos(t), torch.sin(t)
    k = scale * src_dim / out_dim
    return torch.stack([torch.stack([c * k, -s * k], -1),
                        torch.stack([s * k, c * k], -1)], -2)


def _bilinear(img, rows, cols):
    """img (B, H, W, C) sampled at float rows/cols (B, M), edge-clamped ->
    (B, M, C)."""
    B, H, W, C = img.shape
    r0 = torch.floor(rows)
    c0 = torch.floor(cols)
    fr = (rows - r0)[..., None]
    fc = (cols - c0)[..., None]
    r0 = r0.to(torch.int64).clamp(0, H - 1)
    c0 = c0.to(torch.int64).clamp(0, W - 1)
    r1 = (r0 + 1).clamp(0, H - 1)
    c1 = (c0 + 1).clamp(0, W - 1)
    flat = img.reshape(B, H * W, C)

    def at(r, c):
        return flat.gather(1, (r * W + c)[..., None].expand(-1, -1, C))

    return (at(r0, c0) * (1 - fr) * (1 - fc) + at(r0, c1) * (1 - fr) * fc
            + at(r1, c0) * fr * (1 - fc) + at(r1, c1) * fr * fc)


def prepare_image(obs, rotations, scales, out_dim: int = 64,
                  with_valid: bool = False):
    """obs (B, H, W, C) -> (B, T, C[+1], out_dim, out_dim) over the
    product rotations x scales (rotation varies slowest).  rotations (R,)
    degrees; scales (B, S) or (S,).  With with_valid an extra channel marks
    samples that fell inside the source image (prepare_image,
    transforms.py:68)."""
    B, src_dim = obs.shape[0], obs.shape[1]
    scales = scales.reshape(-1, scales.shape[-1]).expand(B, -1)
    R, S = rotations.shape[0], scales.shape[1]
    rot = rotations.repeat_interleave(S)[None].expand(B, -1)  # (B, T)
    sc = scales.repeat(1, R)
    T = R * S
    m = _affine(rot, sc, src_dim, out_dim)  # (B, T, 2, 2)
    c_out = (out_dim - 1) / 2.0
    c_src = (src_dim - 1) / 2.0
    idx = torch.arange(out_dim, dtype=torch.float32, device=obs.device)
    dr = (idx - c_out).view(1, 1, out_dim, 1)
    dc = (idx - c_out).view(1, 1, 1, out_dim)
    mm = lambda i, j: m[:, :, i, j].view(B, T, 1, 1)  # noqa: E731
    src_r = mm(0, 0) * dr + mm(0, 1) * dc + c_src
    src_c = mm(1, 0) * dr + mm(1, 1) * dc + c_src
    out = _bilinear(obs, src_r.reshape(B, -1), src_c.reshape(B, -1))
    out = out.view(B, T, out_dim, out_dim, -1)
    if with_valid:
        ok = ((src_r >= 0) & (src_r <= src_dim - 1) & (src_c >= 0)
              & (src_c <= src_dim - 1))
        out = torch.cat([out, ok[..., None].to(out.dtype)], -1)
    return out.permute(0, 1, 4, 2, 3)


def transform_pixels_to_source(pixels, rotation_deg, scale, src_dim: int,
                               out_dim: int = 64):
    """(row, col) pixels (..., 2) of a transformed view -> source pixels.
    rotation_deg, scale broadcast against pixels[..., 0]."""
    m = _affine(rotation_deg, scale, src_dim, out_dim)
    c_out = (out_dim - 1) / 2.0
    c_src = (src_dim - 1) / 2.0
    d = pixels.to(torch.float32) - c_out
    src_r = m[..., 0, 0] * d[..., 0] + m[..., 0, 1] * d[..., 1] + c_src
    src_c = m[..., 1, 0] * d[..., 0] + m[..., 1, 1] * d[..., 1] + c_src
    return torch.stack([src_r, src_c], -1)
