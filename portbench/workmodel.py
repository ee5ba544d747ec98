"""Work models of the solver's two stages: the operations and bytes that a
cloth problem needs, whatever implements it, against the data-sheet peaks
of one H100 SXM.

A frozen copy of chip_smoke.py's `substeps_work`, `contacts_work` and
`bound`.  They count the problem (each constraint once per iteration, the
pairs inside the window of the particles that are active, every particle
once per pass), not the launches, so the yardstick stays when a kernel is
fused, split or replaced.  A frame's springs stage is one `substeps_work`
over all its substeps; its contacts stage is one `contacts_work` per
contact group.
"""

from __future__ import annotations

# f32 peak outside the tensor cores and HBM rate of one H100 SXM at 700 W
# (NVIDIA data sheet)
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12


def substeps_work(dims, H, W, n_sub, iterations, cheb=True):
    """(bytes, f32 ops) of `n_sub` substeps on cloths of `dims` [(dimx,
    dimy)] held on an H x W lattice.  Per constraint per iteration:
    difference 3, squared length 6, rsqrt 1, relaxation 2, two scalings 2,
    two endpoint updates 12 (FMA = 2 ops) = 26; per particle per
    iteration: count scaling 6, Chebyshev 9 (cheb only), plane 15 = 30;
    per particle per substep: integrate 12, velocity clamp 25, two picker
    spheres 30 = 67.  Bytes: P, V, w, params read once; P, V, prev written
    once."""
    B = len(dims)
    ops = 0
    per_particle = 30 if cheb else 21
    for dx, dy in dims:
        n = dx * dy
        cons = ((dx - 1) * dy + dx * (dy - 1) + (dx - 2) * dy + dx * (dy - 2)
                + 2 * (dx - 1) * (dy - 1))
        ops += n_sub * (iterations * (26 * cons + per_particle * n)
                        + 67 * n)
    nbytes = 4 * B * (3 * H * W * 2 + H * W + 21) + 4 * B * 3 * H * W * 3
    return nbytes, ops


def contacts_work(n_active, N, window, iterations, mesh=False):
    """(bytes, f32 ops) of one contact group over B envs of N slots with
    n_active [int] active particles each.  Per pair inside the window per
    iteration ~66 ops (distance 10, penetration 3, friction tangent 26,
    scale 6, two endpoint updates 12, count 2, masks 7); per particle per
    iteration 22 (Jacobi average 7, plane 15).  The mesh mode's rest-pose
    filter, once per pair per group: rest distance^2 6, rest_dist^2 1,
    compare 1 = 8.  Bytes: six coordinate arrays + packed ids + params
    (+ three rest coordinate arrays) read once, three written."""
    B = len(n_active)
    ops = 0
    for n in n_active:
        pairs = sum(max(0, n - k) for k in range(1, window + 1))
        ops += iterations * (66 * pairs + 22 * n) + (8 * pairs if mesh
                                                      else 0)
    nbytes = (4 * B * N * (10 if mesh else 7) + 4 * B * 8
              + 4 * B * N * 3)
    return nbytes, ops


def bound_seconds(nbytes, ops):
    """The least time the chip could take: the larger of bytes over the
    HBM rate and operations over the f32 peak."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32_OPS)
