"""RGB-D renderer: z-buffered splatting of dense surface samples
(counterpart of flingbot_tpu/render/rasterizer.py).

Every cloth triangle is sampled on a barycentric lattice; each sample and
each particle marks the pixel that contains it in a depth buffer by a
scatter-min (`scatter_reduce("amin")`).  Pixels nothing covers read as the
floor (depth = camera_height).  Shading is Lambertian with normals taken
from the depth buffer by finite differences.  Layouts follow the JAX
package: rgb (B, S, S, 3), depth (B, S, S).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.render.camera import CAMERA_HEIGHT, focal_length

DEFAULT_CLOTH_COLOR = (0.35, 0.35, 0.85)
DEFAULT_FLOOR_COLOR = (0.9, 0.9, 0.9)
_LIGHT = (0.3, 0.8, 0.5)
NOISE_OCTAVES = (9, 17, 33)


def hsv_to_rgb(h, s, v):
    """(B,) HSV -> (B, 3) RGB."""
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i, 6.0).to(torch.int64)
    sel = lambda *c: torch.stack(c, -1).gather(  # noqa: E731
        -1, i.clamp(max=5)[..., None])[..., 0]
    r = sel(v, q, p, p, t, v)
    g = sel(t, v, v, q, p, p)
    b = sel(p, p, t, v, v, q)
    return torch.stack([r, g, b], -1)


def palette_from_uniforms(h, s, v, c1, c2, grids, image_size: int):
    """Domain-randomized (cloth (B, 3), floor (B, S, S, 3)) from uniform
    draws: h, s, v (B,) already scaled to their ranges, c1, c2 (B, 3), and
    `grids` a list of (B, g, g) noise octaves
    (domain_randomized_palette, rasterizer.py:69-85)."""
    cloth = hsv_to_rgb(h, s, v)
    total = torch.zeros(h.shape[0], image_size, image_size, device=h.device)
    amp, norm = 1.0, 0.0
    for grid in grids:
        up = F.interpolate(grid[:, None], size=(image_size, image_size),
                           mode="bilinear", align_corners=False)[:, 0]
        total = total + amp * up
        norm += amp
        amp *= 0.55
    t = total / norm
    floor = c1[:, None, None, :] + t[..., None] * (c2 - c1)[:, None, None, :]
    return cloth, floor


def domain_randomized_palette(generator: torch.Generator, batch: int,
                              image_size: int, device="cuda"):
    """Per-env randomized cloth colour and floor texture, drawn from a
    torch.Generator (on the CPU, then moved to `device`: CUDA unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    u = lambda *shape: torch.rand(*shape, generator=generator)  # noqa: E731
    h = u(batch)
    s = 0.45 + 0.55 * u(batch)
    v = 0.4 + 0.55 * u(batch)
    c1 = 0.15 + 0.85 * u(batch, 3)
    c2 = 0.15 + 0.85 * u(batch, 3)
    grids = [u(batch, g, g) for g in NOISE_OCTAVES]
    to = lambda x: x.to(device)  # noqa: E731
    return palette_from_uniforms(to(h), to(s), to(v), to(c1), to(c2),
                                 [to(g) for g in grids], image_size)


def surface_subdiv(image_size: int) -> int:
    """Barycentric subdivision level: samples < ~0.8 px apart."""
    return max(2, int(np.ceil(image_size * 0.0062)))


def surface_sample_points(positions, faces, tri_mask, m: int):
    """Dense barycentric surface samples of every face (lattice
    {(i/m, j/m): i + j <= m}).  positions (B, 3, N); faces (B, T, 3);
    tri_mask (B, T).  Returns (pts (B, 3, K*T), active (B, K*T))."""
    B = positions.shape[0]

    def corner(k):
        return positions.gather(2, faces[:, None, :, k].expand(B, 3, -1))

    a, b, c = corner(0), corner(1), corner(2)  # (B, 3, T)
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
        + c[:, :, None] * v  # (B, 3, K, T)
    act = tri_mask[:, None].expand(B, len(us), -1)
    return pts.reshape(B, 3, -1), act.reshape(B, -1)


def splat_depth(positions, active, image_size: int):
    """Scatter-min each point into the pixel that contains it: the depth
    buffer of _splat_depth (rasterizer.py:122-152) in its surface-sampled
    mode (one-pixel stamps).  positions (B, 3, M) -> (B, S, S)."""
    B = positions.shape[0]
    S = image_size
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


def render_rgbd(positions, active, faces, tri_mask, image_size: int = 400,
                palette=None):
    """(B, 3, N) particles of cloths with triangles `faces` (B, T, 3) /
    `tri_mask` (B, T) -> (rgb (B, S, S, 3) in [0, 1], depth (B, S, S)):
    the particles and dense barycentric samples of every triangle,
    z-buffered (render_rgbd, rasterizer.py:187-244, with faces).
    `palette` = (cloth (B, 3), floor (B, S, S, 3)) from
    domain_randomized_palette; None gives the fixed default colours."""
    pts, act = surface_sample_points(positions, faces, tri_mask,
                                     surface_subdiv(image_size))
    depth = splat_depth(torch.cat([positions, pts], 2),
                        torch.cat([active, act], 1), image_size)
    is_cloth = depth < CAMERA_HEIGHT - 1e-4

    f = focal_length(image_size)
    dzdr = (torch.roll(depth, -1, 1) - torch.roll(depth, 1, 1)) * 0.5
    dzdc = (torch.roll(depth, -1, 2) - torch.roll(depth, 1, 2)) * 0.5
    px_world = depth / f
    nx = -dzdc / torch.clamp(px_world, min=1e-6)
    nz = dzdr / torch.clamp(px_world, min=1e-6)
    ny = torch.ones_like(depth)
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    light = torch.tensor(_LIGHT, dtype=torch.float32, device=depth.device)
    light = light / torch.sqrt((light * light).sum())
    lam = torch.clamp((nx * light[0] + ny * light[1] + nz * light[2]) / norm,
                      0.0, 1.0)
    shade = 0.55 + 0.45 * lam

    if palette is not None:
        cloth_c, floor = palette
        cloth = cloth_c[:, None, None, :] * shade[..., None]
    else:
        cc_ = torch.tensor(DEFAULT_CLOTH_COLOR, device=depth.device)
        cloth = cc_ * shade[..., None]
        floor = torch.tensor(DEFAULT_FLOOR_COLOR,
                             device=depth.device).expand(cloth.shape)
    rgb = torch.where(is_cloth[..., None], cloth, floor)
    return torch.clamp(rgb, 0.0, 1.0), depth
