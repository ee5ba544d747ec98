"""Plain reference of what an env step sees and decides: the top-down
RGB-D render, the 96-view observation stack with its validity masks, the
coverage reward, and the masked argmax that picks each env's fling.

The camera is flingbot's: top-down pinhole at (0, 2, 0), fov 39.5978 deg;
the cloth is rendered as a z-buffer of its particles and of dense
barycentric samples of its triangles, Lambertian-shaded with normals from
the depth buffer, over a domain-randomized floor.  Coverage is
flex_utils.py:358-395: the particle AABB in the ground plane on a 100 x
100 grid, each particle stamping the cells within its radius.  Imports
nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

CAMERA_FOV = 39.5978
CAMERA_HEIGHT = 2.0
LIGHT = (0.3, 0.8, 0.5)
NOISE_OCTAVES = (9, 17, 33)
LEFT_ARM_BASE = (0.765, 0.0, 0.0)
RIGHT_ARM_BASE = (-0.765, 0.0, 0.0)
NEG_INF = -1e30
GRID = 100
K_SPAN = 15
_DEG2RAD = float(np.float32(np.pi / 180.0))


def focal_length(S: int) -> float:
    return float((S / 2.0) / np.tan(np.pi * CAMERA_FOV / 180.0 / 2.0))


def pixel_to_world(row, col, depth, S: int):
    f = focal_length(S)
    c = S / 2.0
    return torch.stack([(col - c) * depth / f, CAMERA_HEIGHT - depth,
                        -(row - c) * depth / f], -1)


# --------------------------------------------------------------------------
# palette and render
# --------------------------------------------------------------------------

def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i, 6.0).to(torch.int64)
    sel = lambda *c: torch.stack(c, -1).gather(  # noqa: E731
        -1, i.clamp(max=5)[..., None])[..., 0]
    return torch.stack([sel(v, q, p, p, t, v), sel(t, v, v, q, p, p),
                        sel(p, p, t, v, v, q)], -1)


def palettes(seed: int, sizes, S: int, device) -> list:
    """Randomized cloth colours (n, 3) and floor textures (n, S, S, 3) for
    successive draws of sizes[k] envs from one CPU torch.Generator seeded
    with `seed`; each draw takes hue, saturation, value, two floor colours
    and three noise octaves, in that order."""
    g = torch.Generator().manual_seed(int(seed))
    return [_palette(g, n, S, device) for n in sizes]


def _palette(g, batch: int, S: int, device):
    u = lambda *shape: torch.rand(*shape, generator=g)  # noqa: E731
    h = u(batch)
    s = 0.45 + 0.55 * u(batch)
    v = 0.4 + 0.55 * u(batch)
    c1 = 0.15 + 0.85 * u(batch, 3)
    c2 = 0.15 + 0.85 * u(batch, 3)
    grids = [u(batch, n, n).to(device) for n in NOISE_OCTAVES]
    h, s, v, c1, c2 = (x.to(device) for x in (h, s, v, c1, c2))
    cloth = _hsv_to_rgb(h, s, v)
    total = torch.zeros(batch, S, S, device=device)
    amp, norm = 1.0, 0.0
    for grid in grids:
        up = F.interpolate(grid[:, None], size=(S, S), mode="bilinear",
                           align_corners=False)[:, 0]
        total = total + amp * up
        norm += amp
        amp *= 0.55
    t = total / norm
    floor = c1[:, None, None, :] + t[..., None] * (c2 - c1)[:, None, None, :]
    return cloth, floor


def _surface_points(positions, faces, tri_mask, S: int):
    m = max(2, int(np.ceil(S * 0.0062)))
    B = positions.shape[0]

    def corner(k):
        return positions.gather(2, faces[:, None, :, k].expand(B, 3, -1))

    a, b, c = corner(0), corner(1), corner(2)
    us, vs = [], []
    for i in range(m + 1):
        for j in range(m + 1 - i):
            us.append(i / m)
            vs.append(j / m)
    u = torch.tensor(us, dtype=positions.dtype,
                     device=positions.device).view(1, 1, -1, 1)
    v = torch.tensor(vs, dtype=positions.dtype,
                     device=positions.device).view(1, 1, -1, 1)
    pts = a[:, :, None] * (1.0 - u - v) + b[:, :, None] * u \
        + c[:, :, None] * v
    act = tri_mask[:, None].expand(B, len(us), -1)
    return pts.reshape(B, 3, -1), act.reshape(B, -1)


def _depth(positions, active, S: int):
    B = positions.shape[0]
    f = focal_length(S)
    c = S / 2.0
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    depth = CAMERA_HEIGHT - y
    safe = torch.clamp(depth, min=1e-4)
    col = torch.round(x * f / safe + c).to(torch.int64)
    row = torch.round(-z * f / safe + c).to(torch.int64)
    inside = (row >= 0) & (row < S) & (col >= 0) & (col < S) & active
    idx = torch.where(inside, row * S + col, S * S)
    buf = torch.full((B, S * S + 1), CAMERA_HEIGHT, dtype=positions.dtype,
                     device=positions.device)
    buf = buf.scatter_reduce(1, idx, depth, reduce="amin", include_self=True)
    return buf[:, :S * S].reshape(B, S, S)


def render(positions, active, faces, tri_mask, S: int, pal):
    """(rgb (B, S, S, 3), depth (B, S, S))."""
    pts, act = _surface_points(positions, faces, tri_mask, S)
    depth = _depth(torch.cat([positions, pts], 2), torch.cat([active, act],
                                                             1), S)
    is_cloth = depth < CAMERA_HEIGHT - 1e-4
    f = focal_length(S)
    dzdr = (torch.roll(depth, -1, 1) - torch.roll(depth, 1, 1)) * 0.5
    dzdc = (torch.roll(depth, -1, 2) - torch.roll(depth, 1, 2)) * 0.5
    px_world = depth / f
    nx = -dzdc / torch.clamp(px_world, min=1e-6)
    nz = dzdr / torch.clamp(px_world, min=1e-6)
    ny = torch.ones_like(depth)
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    light = torch.tensor(LIGHT, dtype=torch.float32, device=depth.device)
    light = light / torch.sqrt((light * light).sum())
    lam = torch.clamp((nx * light[0] + ny * light[1] + nz * light[2]) / norm,
                      0.0, 1.0)
    shade = 0.55 + 0.45 * lam
    cloth_c, floor = pal
    cloth = cloth_c[:, None, None, :] * shade[..., None]
    rgb = torch.where(is_cloth[..., None], cloth, floor.to(cloth.dtype))
    return torch.clamp(rgb, 0.0, 1.0), depth


# --------------------------------------------------------------------------
# the observation
# --------------------------------------------------------------------------

class Observation(NamedTuple):
    rgb: torch.Tensor
    depth: torch.Tensor
    obs_stack: torch.Tensor  # (B, T, 4, D, D)
    mask_stack: torch.Tensor  # (B, T, 5, D, D)
    grasp_ok: torch.Tensor  # (B, S, S)
    adaptive_scales: torch.Tensor  # (B, n_scales)


def _affine(rotation_deg, scale, src_dim: int, out_dim: int):
    t = rotation_deg * _DEG2RAD
    c, s = torch.cos(t), torch.sin(t)
    k = scale * src_dim / out_dim
    return torch.stack([torch.stack([c * k, -s * k], -1),
                        torch.stack([s * k, c * k], -1)], -2)


def _bilinear(img, rows, cols):
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


def views(img, rotations, scales, out_dim: int):
    """img (B, S, S, C) -> (B, T, C + 1, D, D): every rotation x scale
    view (rotation slowest) by one bilinear gather, plus a channel that
    marks samples inside the source."""
    B, src_dim = img.shape[0], img.shape[1]
    R, n_s = rotations.shape[0], scales.shape[1]
    rot = rotations.repeat_interleave(n_s)[None].expand(B, -1)
    sc = scales.repeat(1, R)
    T = R * n_s
    m = _affine(rot, sc, src_dim, out_dim)
    c_out = (out_dim - 1) / 2.0
    c_src = (src_dim - 1) / 2.0
    idx = torch.arange(out_dim, dtype=torch.float32, device=img.device)
    dr = (idx - c_out).view(1, 1, out_dim, 1)
    dc = (idx - c_out).view(1, 1, 1, out_dim)
    mm = lambda i, j: m[:, :, i, j].view(B, T, 1, 1)  # noqa: E731
    src_r = mm(0, 0) * dr + mm(0, 1) * dc + c_src
    src_c = mm(1, 0) * dr + mm(1, 1) * dc + c_src
    out = _bilinear(img, src_r.reshape(B, -1), src_c.reshape(B, -1))
    out = out.view(B, T, out_dim, out_dim, -1)
    ok = ((src_r >= 0) & (src_r <= src_dim - 1) & (src_c >= 0)
          & (src_c <= src_dim - 1))
    out = torch.cat([out, ok[..., None].to(out.dtype)], -1)
    return out.permute(0, 1, 4, 2, 3)


def _norm_last(x):
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                      + x[..., 2] * x[..., 2])


def observe(positions, active, faces, tri_mask, pal, rotations,
            scale_factors, S: int, D: int, grasp_radius: int = 1,
            reach: float = 1.2) -> Observation:
    """Render -> cloth mask -> adaptive scales (the crops shrink to fit the
    cloth) -> arm reach and the eroded grasp mask -> the 96-view stack."""
    rgb, depth = render(positions, active, faces, tri_mask, S, pal)
    cloth_mask = depth < CAMERA_HEIGHT - 1e-4
    B, dev = depth.shape[0], depth.device
    rows = cloth_mask.any(2)
    cols = cloth_mask.any(1)
    idx = torch.arange(S, device=dev)[None]
    rmin = torch.where(rows, idx, S).amin(1)
    rmax = torch.where(rows, idx, -1).amax(1)
    cmin = torch.where(cols, idx, S).amin(1)
    cmax = torch.where(cols, idx, -1).amax(1)
    croprow = torch.maximum(S - 2 * rmin, S - 2 * (S - rmax))
    cropcol = torch.maximum(S - 2 * cmin, S - 2 * (S - cmax))
    crop = torch.maximum(croprow, cropcol).to(torch.float32) * 1.5
    ratio = torch.where(rows.any(1) & (crop < S), crop / S, 1.0)
    scales = scale_factors.to(torch.float32)[None] * ratio[:, None]
    rr = torch.arange(S, dtype=torch.float32, device=dev).view(1, S, 1)
    cc = torch.arange(S, dtype=torch.float32, device=dev).view(1, 1, S)
    world = pixel_to_world(rr.expand(B, S, S), cc.expand(B, S, S), depth, S)
    left = torch.tensor(LEFT_ARM_BASE, dtype=torch.float32, device=dev)
    right = torch.tensor(RIGHT_ARM_BASE, dtype=torch.float32, device=dev)
    reach_l = _norm_last(world - left) < reach
    reach_r = _norm_last(world - right) < reach
    grasp_ok = cloth_mask
    for dy in range(-grasp_radius, grasp_radius + 1):
        for dx in range(-grasp_radius, grasp_radius + 1):
            if dy * dy + dx * dx > grasp_radius ** 2 or (dy == 0 and dx == 0):
                continue
            grasp_ok = grasp_ok & torch.roll(torch.roll(cloth_mask, dy, 1),
                                             dx, 2)
    src = torch.cat([rgb, depth[..., None], reach_l[..., None].to(rgb.dtype),
                     reach_r[..., None].to(rgb.dtype),
                     grasp_ok[..., None].to(rgb.dtype)], -1)
    warped = views(src, rotations, scales, D)
    return Observation(rgb=rgb, depth=depth, obs_stack=warped[:, :, :4],
                       mask_stack=warped[:, :, 3:], grasp_ok=grasp_ok,
                       adaptive_scales=scales)


# --------------------------------------------------------------------------
# coverage
# --------------------------------------------------------------------------

def coverage(positions, active, r: float = 0.00625):
    """Covered area (B,) in m^2."""
    out = []
    per = max(1, (1 << 25) // (positions.shape[2] * K_SPAN * K_SPAN))
    for s in range(0, positions.shape[0], per):
        out.append(_coverage(positions[s:s + per], active[s:s + per], r))
    return torch.cat(out)


def _coverage(p, active, r):
    B = p.shape[0]
    x, z = p[:, 0], p[:, 2]
    big = 1e9
    min_x = torch.where(active, x, big).amin(1, keepdim=True)
    max_x = torch.where(active, x, -big).amax(1, keepdim=True)
    min_z = torch.where(active, z, big).amin(1, keepdim=True)
    max_z = torch.where(active, z, -big).amax(1, keepdim=True)
    span_x = torch.clamp((max_x - min_x) / GRID, min=1e-6)
    span_z = torch.clamp((max_z - min_z) / GRID, min=1e-6)
    off_x = x - min_x
    off_z = z - min_z
    lo_x = torch.clamp(torch.round((off_x - r) / span_x).to(torch.int64),
                       min=0)
    hi_x = torch.clamp(torch.round((off_x + r) / span_x).to(torch.int64),
                       max=GRID)
    lo_z = torch.clamp(torch.round((off_z - r) / span_z).to(torch.int64),
                       min=0)
    hi_z = torch.clamp(torch.round((off_z + r) / span_z).to(torch.int64),
                       max=GRID)
    ks = torch.arange(K_SPAN, device=p.device)
    ix = torch.minimum(lo_x[..., None] + ks, hi_x[..., None])
    iz = torch.minimum(lo_z[..., None] + ks, hi_z[..., None])
    cell = torch.clamp(ix[..., :, None] * GRID + iz[..., None, :], 0,
                       GRID * GRID - 1)
    cell = torch.where(active[..., None, None], cell, GRID * GRID)
    grid = torch.zeros(B, GRID * GRID + 1, device=p.device, dtype=p.dtype)
    grid.scatter_(1, cell.reshape(B, -1), 1.0)
    stamped = grid[:, :GRID * GRID].sum(1, keepdim=True) * span_x * span_z
    r2 = 2.0 * r
    degenerate = ((span_x * (K_SPAN - 2) < r2)
                  & (span_z * (K_SPAN - 2) < r2))
    aabb = (max_x - min_x + r2) * (max_z - min_z + r2)
    return torch.where(degenerate, aabb, stamped)[:, 0]


# --------------------------------------------------------------------------
# the fling's action
# --------------------------------------------------------------------------

class Selection(NamedTuple):
    valid: torch.Tensor
    transform_idx: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    p1_world: torch.Tensor  # (B, 3)
    p2_world: torch.Tensor
    p1_grasp: torch.Tensor
    p2_grasp: torch.Tensor


def select_fling(value_maps, obs: Observation, rotations, g: int = 8):
    """value_maps (B, T, D, D) of the fling -> the best valid action: both
    grasp points (the pixel +- g rows) inside the view, the left arm
    reaching p1 and the right p2, one grasp circle on cloth; the first
    index wins ties; with nothing valid the unmasked argmax."""
    B, T, D, _ = value_maps.shape
    dev = value_maps.device

    def shifted(m, dy):
        H = m.shape[-2]
        out = torch.zeros_like(m)
        if dy >= 0:
            out[..., :H - dy, :] = m[..., dy:, :]
        else:
            out[..., -dy:, :] = m[..., :H + dy, :]
        return out

    reach_l = obs.mask_stack[:, :, 1] > 0.5
    reach_r = obs.mask_stack[:, :, 2] > 0.5
    grasp_w = obs.mask_stack[:, :, 3] > 0.5
    inb = obs.mask_stack[:, :, 4] > 0.5
    ri = torch.arange(D, device=dev)
    crop = (ri >= g) & (ri < D - g)
    valid = (shifted(inb, g) & shifted(inb, -g) & shifted(reach_l, g)
             & shifted(reach_r, -g)
             & (shifted(grasp_w, g) | shifted(grasp_w, -g))
             & crop[:, None] & crop[None, :])
    flat_vm = value_maps.reshape(B, -1)
    masked = torch.where(valid.reshape(B, -1), flat_vm, NEG_INF)
    flat_idx = torch.argmax(masked, 1)
    best = masked.gather(1, flat_idx[:, None])[:, 0]
    any_valid = best > NEG_INF / 2
    flat_idx = torch.where(any_valid, flat_idx, torch.argmax(flat_vm, 1))
    t = flat_idx // (D * D)
    rem = flat_idx % (D * D)
    row, col = rem // D, rem % D
    n_scales = obs.adaptive_scales.shape[1]
    rotation = rotations.to(dev)[t // n_scales]
    scale = obs.adaptive_scales.gather(1, (t % n_scales)[:, None])[:, 0]
    px = torch.stack([torch.stack([row + g, col], -1),
                      torch.stack([row - g, col], -1)], 1).to(torch.float32)
    S = obs.depth.shape[1]
    m = _affine(rotation[:, None], scale[:, None], S, D)
    c_out = (D - 1) / 2.0
    c_src = (S - 1) / 2.0
    d = px - c_out
    src = torch.stack([m[..., 0, 0] * d[..., 0] + m[..., 0, 1] * d[..., 1]
                       + c_src,
                       m[..., 1, 0] * d[..., 0] + m[..., 1, 1] * d[..., 1]
                       + c_src], -1)
    ar = torch.arange(B, device=dev)

    def sample(img, p):
        r = torch.round(p[:, 0]).to(torch.int64).clamp(0, S - 1)
        c = torch.round(p[:, 1]).to(torch.int64).clamp(0, S - 1)
        return img[ar, r, c]

    p1 = pixel_to_world(src[:, 0, 0], src[:, 0, 1],
                        sample(obs.depth, src[:, 0]), S)
    p2 = pixel_to_world(src[:, 1, 0], src[:, 1, 1],
                        sample(obs.depth, src[:, 1]), S)
    return Selection(any_valid, t, row, col, p1, p2,
                     sample(obs.grasp_ok, src[:, 0]) & any_valid,
                     sample(obs.grasp_ok, src[:, 1]) & any_valid)
