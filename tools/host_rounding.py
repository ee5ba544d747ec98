"""How far the JAX package's own CPU results move with the host's float
rounding: the measurement behind the tolerances of the port tests that
compare against it.

XLA:CPU under `jax.jit` may compile a division by a constant as a
multiplication by its reciprocal and contract `a * b + c` into one fused
multiply-add.  Either changes float32 results in the last place, and
whether it happens depends on the host's instruction set.  numpy (and the
port's plain PyTorch paths) round each operation as IEEE 754 does.  This
script measures, with the JAX package and numpy alone:

  1. float32 `a / 100` and `a * b + c` under jax.jit against numpy;
  2. the coverage metric (env/coverage.py) under jax.jit against an IEEE
     recomputation of the same float32 formula (`coverage_ieee`), on
     seeded crumpled particle clouds;
  3. the spread of `pallas_substeps(interpret=True)` on the picker case of
     tests/test_torch_kernels.py::test_substeps_match_pallas under 1-ulp
     input noise (JAX against JAX).

Usage (CPU; prints one line per measurement and a JSON line last):
    JAX_PLATFORMS=cpu python -m tools.host_rounding
"""

from __future__ import annotations

import json

import numpy as np

GRID = 100
K_SPAN = 15

# the picker case of test_substeps_match_pallas
SUBSTEPS_CASE = dict(dim=16, picker=[[0.04, 0.1, 0.04], [-10.0] * 3],
                     n_sub=2, iterations=16, picker_last=False)


def coverage_ieee(positions, active, particle_radius=0.00625):
    """get_current_covered_area of the JAX package (env/coverage.py) in
    numpy float32, every operation rounded once as IEEE 754 does.
    positions (N, 3) float32, active (N,) bool -> float32 m^2."""
    f = np.float32
    p = np.asarray(positions, np.float32)
    x, z = p[:, 0], p[:, 2]
    big = f(1e9)
    min_x = np.where(active, x, big).min()
    max_x = np.where(active, x, -big).max()
    min_z = np.where(active, z, big).min()
    max_z = np.where(active, z, -big).max()
    span_x = max((max_x - min_x) / f(GRID), f(1e-6))
    span_z = max((max_z - min_z) / f(GRID), f(1e-6))
    r = f(particle_radius)
    off_x, off_z = x - min_x, z - min_z
    lo_x = np.maximum(np.round((off_x - r) / span_x).astype(np.int64), 0)
    hi_x = np.minimum(np.round((off_x + r) / span_x).astype(np.int64), GRID)
    lo_z = np.maximum(np.round((off_z - r) / span_z).astype(np.int64), 0)
    hi_z = np.minimum(np.round((off_z + r) / span_z).astype(np.int64), GRID)
    ks = np.arange(K_SPAN)
    ix = np.minimum(lo_x[:, None] + ks, hi_x[:, None])
    iz = np.minimum(lo_z[:, None] + ks, hi_z[:, None])
    cell = np.clip(ix[:, :, None] * GRID + iz[:, None, :], 0, GRID * GRID - 1)
    cells = np.unique(cell[np.asarray(active, bool)])
    stamped = f(len(cells)) * span_x * span_z
    r2 = f(2.0) * r
    degenerate = (span_x * f(K_SPAN - 2) < r2) & (span_z * f(K_SPAN - 2) < r2)
    aabb = (max_x - min_x + r2) * (max_z - min_z + r2)
    return f(aabb if degenerate else stamped)


def ulps(a, b):
    """|a - b| in float32 units in the last place of a."""
    a = np.asarray(a, np.float32)
    return np.abs(np.asarray(b, np.float32) - a) / np.spacing(np.abs(a))


def elementwise(n=100_000, seed=0):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    a, b, c = (rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3))
    div = np.asarray(jax.jit(lambda v: v / 100)(jnp.asarray(a)))
    fma = np.asarray(jax.jit(lambda u, v, w: u * v + w)(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    return dict(n=n,
                div_by_100_differ=int((div != a / np.float32(100)).sum()),
                mul_add_differ=int((fma != a * b + c).sum()))


def crumpled_clouds(n_clouds=200, seed=0):
    """Seeded particle clouds: 16x16 lattices, crumpled by a random
    height field and a random squeeze, some particles inactive."""
    rng = np.random.default_rng(seed)
    g = (np.arange(16) - 7.5) * np.float32(0.0125)
    zz, xx = np.meshgrid(g, g, indexing="ij")
    for _ in range(n_clouds):
        pos = np.stack([xx, np.zeros_like(xx), zz], -1).reshape(-1, 3)
        pos *= rng.uniform(0.3, 1.0, 3)
        pos += rng.normal(0, rng.uniform(1e-3, 2e-2), pos.shape)
        active = rng.random(len(pos)) > 0.05
        yield pos.astype(np.float32), active


def coverage_spread(n_clouds=200, seed=0):
    import jax
    import jax.numpy as jnp

    from flingbot_tpu.env.coverage import get_current_covered_area

    cov = jax.jit(get_current_covered_area)
    max_ulps, n_differ = 0.0, 0
    for pos, active in crumpled_clouds(n_clouds, seed):
        j = float(cov(jnp.asarray(pos), jnp.asarray(active)))
        ref = coverage_ieee(pos, active)
        n_differ += int(np.float32(j) != ref)
        max_ulps = max(max_ulps, float(ulps(ref, j)))
    return dict(clouds=n_clouds, coverage_differ=n_differ,
                coverage_max_ulps=max_ulps)


def substeps_inputs(dim, seed=0):
    """The inputs of tests/test_torch_kernels.py::_lattice."""
    from flingbot_tpu.engine.topology import grid_positions

    rng = np.random.default_rng(seed)
    pos = grid_positions(dim, dim, lower=(0.0, 0.1, 0.0)).reshape(dim, dim, 3)
    pos += rng.normal(0, 1e-3, pos.shape)
    P = np.ascontiguousarray(np.moveaxis(pos, -1, 0), np.float32)
    V = rng.normal(0, 1e-2, (3, dim, dim)).astype(np.float32)
    w = np.full((dim, dim), dim * dim / 0.5, np.float32)
    return P, V, w


def substeps_spread(n_noise=4, case=SUBSTEPS_CASE):
    """Largest |out(P + 1 ulp noise) - out(P)| over n_noise seeded noise
    draws, for each output (P, V, prev) of the Pallas substeps kernel in
    interpret mode."""
    import jax.numpy as jnp

    from flingbot_tpu.engine import solver as jsolver
    from flingbot_tpu.engine.pallas_kernels import (
        pack_sub_params, pallas_substeps)
    from flingbot_tpu.engine.state import SolverParams
    from flingbot_tpu.engine.topology import build_grid_topology

    dim = case["dim"]
    P, V, w = substeps_inputs(dim)
    jp = SolverParams()
    topo = build_grid_topology(dim, dim, max_dimx=dim, max_dimy=dim)
    vec = pack_sub_params(jp, topo, jnp.asarray(case["picker"], jnp.float32),
                          0.02, jp.dt / 4, jsolver.CHEBYSHEV_RHO)

    def run(p):
        out = pallas_substeps(
            vec[None], jnp.asarray(p)[None], jnp.asarray(V)[None],
            jnp.asarray(w)[None], n_sub=case["n_sub"],
            iterations=case["iterations"], cheb=True,
            picker_last=case["picker_last"], interpret=True)
        return [np.asarray(o) for o in out]

    base = run(P)
    spread = np.zeros(3)
    for s in range(n_noise):
        sign = np.random.default_rng(100 + s).choice([-1.0, 1.0], P.shape)
        noisy = np.nextafter(P, (sign * np.inf).astype(np.float32))
        for k, (a, b) in enumerate(zip(base, run(noisy))):
            spread[k] = max(spread[k], float(np.abs(a - b).max()))
    return dict(substeps_noise_draws=n_noise,
                substeps_spread_P=spread[0], substeps_spread_V=spread[1],
                substeps_spread_prev=spread[2])


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {}
    for fn in (elementwise, coverage_spread, substeps_spread):
        res = fn()
        for k, v in res.items():
            print(f"{k}: {v}")
        out.update(res)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
