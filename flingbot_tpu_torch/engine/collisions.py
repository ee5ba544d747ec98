"""Self-collision contact group on Morton-sorted particles (counterpart of
the sort-based path of flingbot_tpu/engine/collisions.py).

One contact group: key every particle by the Morton code of its cell
(cell = rest_dist), stable-sort, gather positions / previous positions /
packed ids (and, for shirts, rest positions) into sorted order, run the
windowed pair projection (`kernels.contacts`), and scatter the result
back through the sort permutation.  The JAX package sorts twice (a
multi-operand forward sort and an inverse sort keyed by slot index)
because a TPU gathers slowly; here the forward sort returns the
permutation and the inverse is one scatter through it.
"""

from __future__ import annotations

import numpy as np
import torch

from flingbot_tpu_torch.engine import kernels
from flingbot_tpu_torch.engine.kernels import (
    PACK_IMMOBILE_BIT, PACK_INACTIVE_BIT)
from flingbot_tpu_torch.engine.state import SolverParams

INT32_BIG = 2 ** 30


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_code(cell: torch.Tensor) -> torch.Tensor:
    """cell (B, 3, N) int32 in [0, 1024) -> (B, N) int32 Morton codes."""
    return (_part1by2(cell[:, 0]) | (_part1by2(cell[:, 1]) << 1)
            | (_part1by2(cell[:, 2]) << 2))


def pack_lattice_ids(n: int, lattice_w: int, active: torch.Tensor,
                     immobile: torch.Tensor) -> torch.Tensor:
    """(B, n) int32 per-slot packed id: lattice x (bits 0-7), lattice y
    (bits 8-19), immobile flag (bit 20), inactive flag (bit 21)."""
    assert lattice_w <= 256, "packed lattice ids support max_dimx <= 256"
    i = torch.arange(n, dtype=torch.int32, device=active.device)
    iy = i // lattice_w
    ix = i % lattice_w
    return ((ix | (iy << 8))[None]
            | (immobile.to(torch.int32) << PACK_IMMOBILE_BIT)
            | ((~active).to(torch.int32) << PACK_INACTIVE_BIT))


def contact_params(params: SolverParams, rest_dist: float, batch: int,
                   device) -> torch.Tensor:
    """(B, 8) f32 contact kernel parameters (pallas_kernels.py:360-361)."""
    f = np.float32
    row = torch.tensor(
        [f(rest_dist), 1.0, f(params.particle_friction)
         * f(params.dynamic_friction), f(params.dynamic_friction),
         f(params.collision_distance), 0.0, 0.0, 0.0],
        dtype=torch.float32, device=device)
    return row.expand(batch, -1).contiguous()


def pack_slot_ids(n: int, active: torch.Tensor,
                  immobile: torch.Tensor) -> torch.Tensor:
    """(B, n) int32 packed id of the mesh mode: flat slot index (bits
    0-19), immobile flag (bit 20), inactive flag (bit 21)."""
    if n >= 1 << PACK_IMMOBILE_BIT:
        raise ValueError("mesh packed ids support < 2^20 particles")
    i = torch.arange(n, dtype=torch.int32, device=active.device)
    return (i[None] | (immobile.to(torch.int32) << PACK_IMMOBILE_BIT)
            | ((~active).to(torch.int32) << PACK_INACTIVE_BIT))


def sort_particles(P, prev, w, active, *, rest_dist, lattice_w=None,
                   rest_positions=None):
    """Morton-sort one contact group's inputs.  P, prev (B, 3, N); w
    (B, N); active (B, N) bool; exactly one of lattice_w (grid mode) and
    rest_positions (B, 3, N) (mesh mode).  Returns (order (B, N), [xs, ys,
    zs, pxs, pys, pzs, packed] + [rx, ry, rz] in mesh mode) with every
    array in sorted order.  The sort is stable, as jax.lax.sort: Morton
    keys tie often, and tie order decides which pairs fall inside the
    window."""
    if (lattice_w is None) == (rest_positions is None):
        raise ValueError("pass exactly one of lattice_w / rest_positions")
    n = P.shape[2]
    # divide by a device tensor: a CUDA division by a host scalar
    # multiplies by its reciprocal and can move a particle across a cell
    rd = torch.tensor(rest_dist, dtype=torch.float32, device=P.device)
    cell = torch.clamp(torch.floor(P / rd).to(torch.int32) + 512, 0, 1023)
    keys = torch.where(active, morton_code(cell),
                       torch.tensor(INT32_BIG, dtype=torch.int32,
                                    device=P.device))
    arrays = [P[:, 0], P[:, 1], P[:, 2], prev[:, 0], prev[:, 1], prev[:, 2]]
    if rest_positions is None:
        arrays.append(pack_lattice_ids(n, lattice_w, active, w <= 0))
    else:
        arrays.append(pack_slot_ids(n, active, w <= 0))
        arrays += [rest_positions[:, 0], rest_positions[:, 1],
                   rest_positions[:, 2]]
    _, order = torch.sort(keys, dim=1, stable=True)
    return order, [torch.gather(a, 1, order).contiguous() for a in arrays]


def contact_group(P, prev, w, active, params: SolverParams, *, rest_dist,
                  lattice_w=None, rest_positions=None, window: int = 12,
                  iterations: int = 4):
    """Full self-collision pass on lattice-ordered particles.

    P, prev (B, 3, N); w (B, N); active (B, N) bool.  Returns P' (B, 3, N).
    Assumes uniform particle mass (every flingbot scene); grasped particles
    (w == 0) are immobile.  SelfCollideFilter: pass lattice_w for grid
    cloths (lattice neighbours dropped by their packed ids) or
    rest_positions (B, 3, N) for shirts (pairs closer than rest_dist in the
    rest pose dropped: the kernel's mesh mode; the rest coordinates take
    the same sort)."""
    order, srt = sort_particles(P, prev, w, active, rest_dist=rest_dist,
                                lattice_w=lattice_w,
                                rest_positions=rest_positions)
    cp = contact_params(params, rest_dist, P.shape[0], P.device)
    ox, oy, oz = kernels.contacts(cp, *srt[:7], rests=srt[7:] or None,
                                  window=window, iterations=iterations)
    out = torch.empty_like(P)
    for c, o in enumerate((ox, oy, oz)):
        out[:, c].scatter_(1, order, o)
    return out
