"""Shared helpers of the tests that hold flingbot_tpu_torch against
flingbot_tpu: states built from the same numpy arrays on both sides, and
layout conversions (the JAX package keeps canonical (N, 3) state, the port
keeps lattice (B, 3, H*W) state).  No tests live here."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flingbot_tpu.engine.state import ClothState as JState
from flingbot_tpu.engine.topology import build_grid_topology as jax_topology
from flingbot_tpu_torch.engine.state import ClothState
from flingbot_tpu_torch.engine.topology import (
    build_grid_topology, gather_to_lattice, scatter_from_lattice)

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(2)

STIFF = (0.8, 1.0, 0.9)


def cloth_positions(dimx, dimy, rng, height=0.1, noise=4e-3):
    """(n, 3) flat grid centred at the origin with seeded height noise."""
    xs = np.arange(dimx) * 0.00625
    zs = np.arange(dimy) * 0.00625
    zz, xx = np.meshgrid(zs, xs, indexing="ij")
    pos = np.stack([xx, np.full_like(xx, height), zz], -1).reshape(-1, 3)
    pos[:, [0, 2]] -= pos[:, [0, 2]].mean(0)
    pos[:, 1] += rng.random(len(pos)) * noise
    return pos.astype(np.float32)


def make_pair(dims, max_dim, rng, **kw):
    """The same start states on both sides.  Returns (jax_states (list of
    canonical ClothState), jax_topos, port_state, port_topo)."""
    jstates, jtopos = [], []
    for dimx, dimy in dims:
        pos = cloth_positions(dimx, dimy, rng, **kw)
        n = dimx * dimy
        jstates.append(JState.create(pos, np.full(n, n / 0.5, np.float32),
                                     capacity=max_dim * max_dim))
        # traced-style dims: no full_grid fast path, so topologies stack
        jtopos.append(jax_topology(jnp.int32(dimx), jnp.int32(dimy),
                                   stiffness=STIFF,
                                   max_dimx=max_dim, max_dimy=max_dim))
    topo = build_grid_topology([d[0] for d in dims], [d[1] for d in dims],
                               stiffness=STIFF, max_dimx=max_dim,
                               max_dimy=max_dim, device="cpu")
    return jstates, jtopos, port_state(jstates, topo), topo


# XLA:CPU under jax.jit may multiply by the reciprocal of a constant
# divisor and contract a * b + c into an FMA, depending on the host; the
# JAX package's coverage then differs from an IEEE float32 evaluation of
# its formula by up to 3 ulps (python -m tools.host_rounding: 77 of 200
# crumpled clouds differ, at most 3 ulps, on an AVX-512 host).  4 eps
# relative is 4-8 ulps.
COVERAGE_RTOL = 4 * float(np.finfo(np.float32).eps)


def ieee_coverage(state) -> np.ndarray:
    """(B,) coverage of a port ClothState by the JAX package's formula,
    each float32 operation rounded once (tools/host_rounding.py)."""
    from tools.host_rounding import coverage_ieee

    pos = np.swapaxes(state.positions.numpy(), 1, 2)
    return np.array([coverage_ieee(p, a)
                     for p, a in zip(pos, state.active.numpy())])


def stack(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def port_state(jstates, topo) -> ClothState:
    """Canonical JAX states (list, or one batched state) -> lattice."""
    b = stack(jstates) if isinstance(jstates, (list, tuple)) else jstates
    lat = lambda a, fill=0.0: gather_to_lattice(t(a), topo, fill)  # noqa
    return ClothState(
        positions=lat(np.swapaxes(np.asarray(b.positions), 1, 2)),
        velocities=lat(np.swapaxes(np.asarray(b.velocities), 1, 2)),
        inv_mass=lat(b.inv_mass), rest_inv_mass=lat(b.rest_inv_mass),
        active=lat(b.active, False), picker_pos=t(b.picker_pos),
        picked_idx=lat_index(t(b.picked_idx, torch.int64), topo))


def lat_index(idx, topo):
    """Canonical particle indices (B, K) -> lattice slots (-1 kept)."""
    dx = topo.dimx.view(-1, 1)
    slot = (idx // dx) * topo.max_dimx + idx % dx
    return torch.where(idx >= 0, slot, -1)


def canonical(x, topo, base):
    """Port lattice (B, C, H*W) -> canonical (B, N, C) numpy."""
    base = t(np.swapaxes(np.asarray(base), 1, 2))
    return scatter_from_lattice(x, base, topo).transpose(1, 2).numpy()


def write_grid_tasks(path, dims, rng, difficulty="hard", height=0.02):
    """A flingbot-format HDF5 task file of small grid cloths lying near
    flat (the JAX package's write_task schema), seeded."""
    from flingbot_tpu.env.tasks import write_task

    for dimx, dimy in dims:
        n = dimx * dimy
        pos = cloth_positions(dimx, dimy, rng, height=height)
        pp = np.concatenate([pos, np.full((n, 1), n / 0.5, np.float32)], 1)
        write_task(path, dict(
            particle_pos=pp.reshape(-1),
            particle_vel=(rng.normal(0, 1e-3, n * 3)).astype(np.float32),
            initial_coverage=float(rng.uniform(0.2, 0.5)) * n * 0.00625 ** 2,
            shape_pos=np.zeros(28, np.float32),
            phase=np.zeros(n, np.int32), flatten_area=n * 0.00625 ** 2,
            flip_mesh=0, cloth_size=np.array([dimx, dimy]),
            cloth_stiff=np.asarray(STIFF, np.float64),
            cloth_mass=float(rng.uniform(0.3, 0.8)),
            task_difficulty=difficulty, mesh_verts=np.array([]),
            mesh_stretch_edges=np.array([]), mesh_bend_edges=np.array([]),
            mesh_shear_edges=np.array([]), mesh_faces=np.array([])))
    return path
