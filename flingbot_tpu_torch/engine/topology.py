"""Cloth topology (counterpart of flingbot_tpu/engine/topology.py): grid
cloths, layered-lattice shirts and generic meshes.

Grid springs are never materialized as edge lists: the solver walks the six
CreateSpringGrid stencil classes directly on the (H, W) lattice.  Dims are
per env, because the envs of one batch hold cloths of different sizes
(<= max_dimx x max_dimy).  Shirts (two-panel quad meshes) are laid onto one
layered lattice per batch, where every spring class is a fixed lattice
offset (LayeredGridTopology).  Any other quad mesh takes the generic mesh
path (MeshTopology): per-vertex incidence tables of its springs and
triangles, padded to one capacity per batch.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.engine.state import MAX_GRID_DIM, PARTICLE_RADIUS, f32

SQRT2 = float(np.sqrt(2.0))

# (dy, dx, rest_in_spacings, stiffness_class); classes 0=stretch 1=bend
# 2=shear (CreateSpringGrid, helpers.h:872-925)
GRID_STENCIL_CLASSES = (
    (0, 1, 1.0, 0),
    (1, 0, 1.0, 0),
    (0, 2, 2.0, 1),
    (2, 0, 2.0, 1),
    (1, 1, SQRT2, 2),
    (1, -1, SQRT2, 2),
)


@dataclasses.dataclass
class GridTopology:
    """Batched grid topology: dimx varies fastest (canonical flat index
    y * dimx + x; lattice slot y * max_dimx + x)."""

    dimx: torch.Tensor  # (B,) i64
    dimy: torch.Tensor  # (B,) i64
    stiffness: torch.Tensor  # (B, 3) f32: stretch, bend, shear
    spacing: float  # rest spacing between particles (float32 value)
    max_dimx: int = MAX_GRID_DIM
    max_dimy: int = MAX_GRID_DIM
    # every env has dimx == max_dimx and dimy == max_dimy: canonical and
    # lattice order coincide, so layout conversions are reshapes
    full_grid: bool = False

    @property
    def capacity(self) -> int:
        return self.max_dimx * self.max_dimy

    @property
    def batch(self) -> int:
        return self.dimx.shape[0]

    def index(self, idx) -> "GridTopology":
        return dataclasses.replace(
            self, dimx=self.dimx[idx], dimy=self.dimy[idx],
            stiffness=self.stiffness[idx])

    def to(self, device) -> "GridTopology":
        return dataclasses.replace(
            self, dimx=self.dimx.to(device), dimy=self.dimy.to(device),
            stiffness=self.stiffness.to(device))

    def set_slots(self, idx: torch.Tensor,
                  other: "GridTopology") -> "GridTopology":
        """This batch with env slots `idx` (K,) set from the K-env batch
        `other`, which shares the lattice."""
        if (other.max_dimx, other.max_dimy) != (self.max_dimx,
                                                 self.max_dimy):
            raise ValueError("grid topologies of one batch must share "
                             "their lattice")
        dimx = self.dimx.index_copy(0, idx, other.dimx)
        dimy = self.dimy.index_copy(0, idx, other.dimy)
        full = bool(((dimx == self.max_dimx)
                     & (dimy == self.max_dimy)).all())
        return dataclasses.replace(
            self, dimx=dimx, dimy=dimy, full_grid=full,
            stiffness=self.stiffness.index_copy(0, idx, other.stiffness))


def grid_positions(dimx: int, dimy: int, lower=(0.0, 0.0, 0.0),
                   spacing: float = PARTICLE_RADIUS) -> np.ndarray:
    """(dimx*dimy, 3) positions of a flat grid in the x-z plane, canonical
    flat index y * dimx + x (CreateSpringGrid layout)."""
    xs = np.arange(dimx) * spacing
    zs = np.arange(dimy) * spacing
    zz, xx = np.meshgrid(zs, xs, indexing="ij")
    pos = np.stack(
        [xx + lower[0], np.full_like(xx, lower[1]), zz + lower[2]], axis=-1)
    return pos.reshape(-1, 3).astype(np.float32)


def grid_spring_edges(dimx: int, dimy: int):
    """(edges (E, 2), rest in spacings (E,), stiffness class (E,)) of a grid
    cloth in canonical indices (grid_spring_edges, topology.py:169-202)."""
    idx = np.arange(dimx * dimy).reshape(dimy, dimx)
    edges, rests, clss = [], [], []
    for a, b, rest, c in (
            (idx[:, :-1], idx[:, 1:], 1.0, 0),
            (idx[:-1, :], idx[1:, :], 1.0, 0),
            (idx[:, :-2], idx[:, 2:], 2.0, 1),
            (idx[:-2, :], idx[2:, :], 2.0, 1),
            (idx[:-1, :-1], idx[1:, 1:], SQRT2, 2),
            (idx[:-1, 1:], idx[1:, :-1], SQRT2, 2)):
        e = np.stack([a.reshape(-1), b.reshape(-1)], axis=1)
        edges.append(e)
        rests.append(np.full(len(e), rest))
        clss.append(np.full(len(e), c, np.int64))
    return np.concatenate(edges), np.concatenate(rests), np.concatenate(clss)


def grid_triangles_np(dimx: int, dimy: int) -> np.ndarray:
    """(2 (dimx-1)(dimy-1), 3) canonical triangles of a grid cloth, two per
    quad (grid_triangles_np, topology.py:626-637)."""
    idx = np.arange(dimx * dimy).reshape(dimy, dimx)
    a, b = idx[:-1, :-1].reshape(-1), idx[:-1, 1:].reshape(-1)
    c, d = idx[1:, 1:].reshape(-1), idx[1:, :-1].reshape(-1)
    return np.stack([np.stack([a, b, c], 1), np.stack([a, c, d], 1)],
                    1).reshape(-1, 3)


def build_grid_topology(dimx, dimy, stiffness=(0.9, 1.0, 0.9),
                        spacing: float = PARTICLE_RADIUS,
                        max_dimx: int = MAX_GRID_DIM,
                        max_dimy: int = MAX_GRID_DIM,
                        device="cuda") -> GridTopology:
    """dimx, dimy: ints or per-env sequences; stiffness (3,) or (B, 3).
    The topology lives on `device`: CUDA unless the caller asks for the
    CPU."""
    device = resolve_device(device)
    dx = torch.as_tensor(np.atleast_1d(np.asarray(dimx, np.int64)))
    dy = torch.as_tensor(np.atleast_1d(np.asarray(dimy, np.int64)))
    B = max(dx.shape[0], dy.shape[0])
    dx = dx.expand(B).clone()
    dy = dy.expand(B).clone()
    assert int(dx.max()) <= max_dimx and int(dy.max()) <= max_dimy
    st = torch.as_tensor(np.asarray(stiffness, np.float32)).reshape(-1, 3)
    st = st.expand(B, 3).clone()
    full = bool((dx == max_dimx).all() and (dy == max_dimy).all())
    return GridTopology(
        dimx=dx.to(device), dimy=dy.to(device), stiffness=st.to(device),
        spacing=f32(spacing), max_dimx=max_dimx, max_dimy=max_dimy,
        full_grid=full)


def lattice_valid(dimx, dimy, H: int, W: int) -> torch.Tensor:
    """(B, H, W) bool: lattice slot lies inside the env's cloth."""
    dev = dimx.device
    iy = torch.arange(H, device=dev).view(1, H, 1)
    ix = torch.arange(W, device=dev).view(1, 1, W)
    return (iy < dimy.view(-1, 1, 1)) & (ix < dimx.view(-1, 1, 1))


def shift2d(a: torch.Tensor, dy: int, dx: int, fill=0) -> torch.Tensor:
    """out[..., y, x] = a[..., y + dy, x + dx]; out of range -> fill."""
    H, W = a.shape[-2], a.shape[-1]
    out = torch.full_like(a, fill)
    if abs(dy) >= H or abs(dx) >= W:
        return out
    out[..., max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)] = \
        a[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)]
    return out


def _canonical_of_lattice(topo: GridTopology):
    """(B, H*W) canonical flat index of each lattice slot, and validity."""
    H, W = topo.max_dimy, topo.max_dimx
    valid = lattice_valid(topo.dimx, topo.dimy, H, W)
    dev = topo.dimx.device
    iy = torch.arange(H, device=dev).view(1, H, 1)
    ix = torch.arange(W, device=dev).view(1, 1, W)
    flat = torch.where(valid, iy * topo.dimx.view(-1, 1, 1) + ix, 0)
    return flat.reshape(flat.shape[0], -1), valid.reshape(valid.shape[0], -1)


def gather_to_lattice(x: torch.Tensor, topo: GridTopology, fill=0.0):
    """Canonical (B, ..., N) -> lattice (B, ..., H*W); slots outside the
    cloth take `fill`.  (gather_to_lattice, solver.py:95-111.)"""
    if topo.full_grid:
        return x
    flat, valid = _canonical_of_lattice(topo)
    lead = x.shape[1:-1]
    idx = flat.view((flat.shape[0],) + (1,) * len(lead) + (-1,))
    idx = idx.expand(x.shape[:-1] + (flat.shape[1],))
    out = torch.gather(x, -1, idx)
    v = valid.view((valid.shape[0],) + (1,) * len(lead) + (-1,))
    return torch.where(v, out, torch.as_tensor(fill, dtype=x.dtype,
                                               device=x.device))


def scatter_from_lattice(lattice: torch.Tensor, x: torch.Tensor,
                         topo: GridTopology) -> torch.Tensor:
    """Lattice (B, ..., H*W) -> canonical (B, ..., N), keeping `x` where
    the canonical slot is padding.  (scatter_from_lattice, solver.py:
    113-136.)"""
    if topo.full_grid:
        return lattice
    flat, valid = _canonical_of_lattice(topo)
    n = x.shape[-1]
    lead = lattice.shape[1:-1]
    # slots outside the cloth land in one dropped extra column
    flat = torch.where(valid, flat, n)
    out = torch.cat([x, x[..., :1]], -1)
    idx = flat.view((flat.shape[0],) + (1,) * len(lead) + (-1,))
    out.scatter_(-1, idx.expand(lattice.shape), lattice)
    return out[..., :n]


def grid_triangles_dynamic(dimx, dimy, max_dimx: int, max_dimy: int):
    """Padded (B, T, 3) lattice-slot triangles + (B, T) mask of grid
    cloths with per-env dims; triangle t matches grid_triangles_dynamic
    (topology.py:602) with canonical ids replaced by lattice slots."""
    dev = dimx.device
    n_cells = (max_dimx - 1) * (max_dimy - 1)
    t = torch.arange(2 * n_cells, device=dev)
    cell = t // 2
    second = (t % 2) == 1
    cx = cell % (max_dimx - 1)
    cy = cell // (max_dimx - 1)
    ok = (cx[None] < dimx.view(-1, 1) - 1) & (cy[None] < dimy.view(-1, 1) - 1)
    a = cy * max_dimx + cx
    b = a + 1
    c = a + max_dimx + 1
    d = a + max_dimx
    tri = torch.where(second[:, None], torch.stack([a, c, d], 1),
                      torch.stack([a, b, c], 1))
    tri = torch.where(ok[..., None], tri[None], 0)
    return tri, ok


# --------------------------------------------------------------------------
# quad-mesh cloths (shirts) and the layered lattice they are solved on
# --------------------------------------------------------------------------

def load_cloth(path: str):
    """Load a quad-mesh cloth OBJ and derive its spring classes (numpy
    copy of flingbot_tpu.engine.topology.load_cloth, the reference loader's
    contract, environment/tasks.py:39-102).

    Returns (vertices (V, 3), triangle_faces (2F, 3), stretch_edges,
    bend_edges, shear_edges): stretch = the 4 sides of every quad, shear =
    its 2 diagonals, bend = every pair of distinct stretch neighbours of a
    vertex that is not already a shear edge."""
    vertices, faces = [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                vertices.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("f "):
                face = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                if len(face) != 4:
                    raise ValueError("load_cloth requires a quad mesh")
                faces.append(face)
    vertices = np.array(vertices, np.float64)
    faces = np.array(faces, np.int64)
    # interleaved (f0_t0, f0_t1, f1_t0, ...) triangle ordering
    tri = np.stack([faces[:, [0, 1, 2]], faces[:, [0, 2, 3]]],
                   axis=1).reshape(-1, 3)

    def as_sorted_set(pairs):
        return set(map(tuple, np.sort(pairs.reshape(-1, 2), axis=1).tolist()))

    stretch = as_sorted_set(np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 3]],
         faces[:, [3, 0]]]))
    shear = as_sorted_set(np.concatenate([faces[:, [0, 2]], faces[:, [1, 3]]]))
    neighbours = {v: set() for v in range(len(vertices))}
    for a, b in stretch:
        neighbours[a].add(b)
        neighbours[b].add(a)
    bend = set()
    for nbrs in neighbours.values():
        nbrs = sorted(nbrs)
        for i in range(len(nbrs) - 1):
            for j in range(i + 1, len(nbrs)):
                if (nbrs[i], nbrs[j]) not in shear:
                    bend.add((nbrs[i], nbrs[j]))

    def as_array(edges):
        return np.array(sorted(edges), np.int64).reshape(-1, 2)

    return vertices, tri, as_array(stretch), as_array(bend), as_array(shear)


@dataclasses.dataclass(frozen=True)
class LayeredSpec:
    """The static layered lattice shared by every shirt of a batch: extent,
    back-panel row offset, the union of spring offset classes, and padded
    capacities (flingbot_tpu.engine.topology.LayeredSpec)."""

    H: int
    W: int
    H2: int  # back-panel row offset
    offsets: tuple  # ((dy, dx), ...) lattice offset of each spring class
    vert_capacity: int
    tri_capacity: int


def _layered_layout(verts, stretch_edges):
    """Per-vertex integer (row, col, layer) of a 2-layer lattice mesh,
    recovered from its rest pose; None when the mesh is not one."""
    v = np.asarray(verts, np.float64).reshape(-1, 3)
    e = np.asarray(stretch_edges, np.int64).reshape(-1, 2)
    if len(v) == 0 or len(e) == 0:
        return None
    d = np.abs(v[e[:, 0]] - v[e[:, 1]])[:, [0, 2]]
    s = float(np.median(d.max(axis=1)))  # lattice spacing (xz projection)
    if not np.isfinite(s) or s < 1e-6:
        return None
    cf = (v[:, 0] - v[:, 0].min()) / s
    rf = (v[:, 2] - v[:, 2].min()) / s
    c = np.round(cf).astype(np.int64)
    r = np.round(rf).astype(np.int64)
    if np.abs(cf - c).max() > 0.25 or np.abs(rf - r).max() > 0.25:
        return None  # vertices off the lattice
    y = v[:, 1]
    thick = float(np.abs(y).max())
    if thick < 1e-9:
        layer = np.zeros(len(v), np.int64)  # a single flat sheet
    else:
        # sewn (y ~ 0) vertices live in the front layer (0)
        layer = np.where(y < -0.25 * thick, 1, 0).astype(np.int64)
    key = (layer << 40) | (r << 20) | c
    if len(np.unique(key)) != len(v):
        return None  # two vertices in one slot
    return r, c, layer


def _normalize_offset(dl, dy, dx):
    """Canonical direction of an edge (dlayer, drow, dcol): the base is the
    lexicographically smaller endpoint.  Returns (flip, key)."""
    if (dl, dy, dx) < (0, 0, 0):
        return True, (-dl, -dy, -dx)
    return False, (dl, dy, dx)


def _layered_edge_classes(verts, per_class_edges, stiffness):
    """Group every mesh edge by its (dlayer, drow, dcol) lattice offset.
    Returns (layout, {key: [(base, other, stiffness), ...]}) or None."""
    layout = _layered_layout(verts, per_class_edges[0])
    if layout is None:
        return None
    r, c, layer = layout
    groups = {}
    for cls, edges in enumerate(per_class_edges):
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        a, b = edges[:, 0], edges[:, 1]
        dl, dy, dx = layer[b] - layer[a], r[b] - r[a], c[b] - c[a]
        for i in range(len(edges)):
            flip, key = _normalize_offset(int(dl[i]), int(dy[i]), int(dx[i]))
            base, other = (b[i], a[i]) if flip else (a[i], b[i])
            groups.setdefault(key, []).append(
                (int(base), int(other), float(stiffness[cls])))
    return layout, groups


MESH_KEYS = ("mesh_verts", "mesh_stretch_edges", "mesh_bend_edges",
             "mesh_shear_edges", "mesh_faces")


def compute_layered_spec(task_arrays, round_to=8,
                         max_offset_classes=40) -> "LayeredSpec | None":
    """The LayeredSpec covering a list of task mesh-array dicts (keys
    MESH_KEYS); None when a mesh is not a 2-layer lattice or the offset
    class union is wider than max_offset_classes."""
    rmax = cmax = vmax = tmax = 0
    union = set()
    for t in task_arrays:
        verts = np.asarray(t["mesh_verts"], np.float64).reshape(-1, 3)
        per_class = [np.asarray(t[k], np.int64).reshape(-1, 2)
                     for k in MESH_KEYS[1:4]]
        out = _layered_edge_classes(verts, per_class, (1.0, 1.0, 1.0))
        if out is None:
            return None
        (r, c, _), groups = out
        rmax = max(rmax, int(r.max()))
        cmax = max(cmax, int(c.max()))
        vmax = max(vmax, len(verts))
        tmax = max(tmax, np.asarray(t["mesh_faces"]).size // 3)
        union |= set(groups)
    if not union or len(union) > max_offset_classes:
        return None
    H2 = rmax + 3  # >= 2 guard rows (bend offsets reach dy = 2)
    offsets = tuple(sorted((dl * H2 + dy, dx) for dl, dy, dx in union))

    def up(v, m):
        return int((v + m - 1) // m * m)

    return LayeredSpec(H=up(H2 + rmax + 1, round_to), W=up(cmax + 1, round_to),
                       H2=H2, offsets=offsets, vert_capacity=up(vmax, 256),
                       tri_capacity=up(tmax, 256))


@dataclasses.dataclass
class LayeredGridTopology:
    """Batched shirt topology on one layered lattice (counterpart of
    flingbot_tpu.engine.topology.LayeredGridTopology).  A two-panel garment
    gets one lattice slot per vertex (front panel and sewn vertices at row
    r, back panel at row H2 + r), so every spring joins two slots at one of
    the spec's fixed offsets.  Class k joins slot (y, x) to
    (y + dy_k, x + dx_k); stiff == 0 marks a slot with no such spring.

      rest, stiff     (B, K, H, W) f32
      count           (B, H, W) f32   springs per slot
      active          (B, H, W) bool  slot holds a vertex
      rest_positions  (B, 3, H*W) f32 rest pose, 1e6 on empty slots
      triangles       (B, T, 3) i64   lattice slots, padded
      tri_mask        (B, T) bool
      mesh_slot       (B, Vcap) i64   lattice slot of each mesh vertex
      num_verts       (B,) i64
      vert_tri        (B, Dt, H*W) i64  triangles incident to each slot
      vert_tri_mask   (B, Dt, H*W) bool (the mesh normals' gather)
    """

    rest: torch.Tensor
    stiff: torch.Tensor
    count: torch.Tensor
    active: torch.Tensor
    rest_positions: torch.Tensor
    triangles: torch.Tensor
    tri_mask: torch.Tensor
    mesh_slot: torch.Tensor
    num_verts: torch.Tensor
    vert_tri: torch.Tensor
    vert_tri_mask: torch.Tensor
    spec: LayeredSpec

    @property
    def offsets(self) -> tuple:
        return self.spec.offsets

    @property
    def H(self) -> int:
        return self.spec.H

    @property
    def W(self) -> int:
        return self.spec.W

    @property
    def capacity(self) -> int:
        return self.spec.H * self.spec.W

    @property
    def batch(self) -> int:
        return self.rest.shape[0]

    def _tensors(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name != "spec"}

    def index(self, idx) -> "LayeredGridTopology":
        return dataclasses.replace(
            self, **{k: v[idx] for k, v in self._tensors().items()})

    def to(self, device) -> "LayeredGridTopology":
        return dataclasses.replace(
            self, **{k: v.to(device) for k, v in self._tensors().items()})

    def set_slots(self, idx: torch.Tensor,
                  other: "LayeredGridTopology") -> "LayeredGridTopology":
        """This batch with env slots `idx` (K,) set from the K-env batch
        `other`, built under the same spec."""
        if other.spec != self.spec:
            raise ValueError("layered topologies of one batch must share "
                             "their LayeredSpec")
        return dataclasses.replace(self, **{
            k: v.index_copy(0, idx, other._tensors()[k])
            for k, v in self._tensors().items()})

    @staticmethod
    def cat(topos) -> "LayeredGridTopology":
        """One batch from topologies built under the same spec."""
        spec = topos[0].spec
        if any(t.spec != spec for t in topos):
            raise ValueError("layered topologies of one batch must share "
                             "their LayeredSpec")
        return LayeredGridTopology(spec=spec, **{
            k: torch.cat([t._tensors()[k] for t in topos])
            for k in topos[0]._tensors()})


def build_layered_topology(rest_positions, stretch_edges, bend_edges,
                           shear_edges, faces, stiffness, spec: LayeredSpec,
                           device="cuda") -> LayeredGridTopology:
    """A 2-layer lattice mesh as a batch-1 LayeredGridTopology under `spec`
    (build_layered_topology, flingbot_tpu/engine/topology.py:510-600).

    Raises ValueError when the mesh does not fit the spec (off-lattice
    vertices, an offset class the spec lacks, two springs in one slot,
    capacities): it never builds a wrong constraint system."""
    device = resolve_device(device)
    verts = np.asarray(rest_positions, np.float64).reshape(-1, 3)
    n = len(verts)
    per_class = [np.asarray(e, np.int64).reshape(-1, 2)
                 for e in (stretch_edges, bend_edges, shear_edges)]
    out = _layered_edge_classes(verts, per_class, stiffness)
    if out is None:
        raise ValueError("mesh is not layered-lattice representable")
    (r, c, layer), groups = out
    H, W, H2 = spec.H, spec.W, spec.H2
    if int(r.max()) >= H2 - 2 or int(c.max()) >= W:
        raise ValueError("mesh exceeds LayeredSpec lattice extent")
    off_index = {o: k for k, o in enumerate(spec.offsets)}
    K = len(spec.offsets)
    row = r + layer * H2  # lattice row of each vertex
    slot = row * W + c

    rest = np.zeros((K, H, W), np.float32)
    stiff = np.zeros((K, H, W), np.float32)
    count = np.zeros((H, W), np.float32)
    for (dl, dy, dx), items in groups.items():
        key = (dl * H2 + dy, dx)
        if key not in off_index:
            raise ValueError(f"offset {key} not in LayeredSpec.offsets")
        k = off_index[key]
        base = np.array([it[0] for it in items], np.int64)
        other = np.array([it[1] for it in items], np.int64)
        br, bc = row[base], c[base]
        if np.any(stiff[k, br, bc] != 0.0):
            raise ValueError("duplicate edge at one (offset, slot)")
        rest[k, br, bc] = np.linalg.norm(
            verts[base] - verts[other], axis=1).astype(np.float32)
        stiff[k, br, bc] = np.array([it[2] for it in items], np.float32)
        np.add.at(count, (br, bc), 1.0)
        np.add.at(count, (row[other], c[other]), 1.0)

    active = np.zeros((H, W), bool)
    active[row, c] = True
    rest_pad = np.full((H * W, 3), 1e6, np.float32)
    rest_pad[slot] = verts.astype(np.float32)
    if n > spec.vert_capacity:
        raise ValueError("mesh exceeds LayeredSpec.vert_capacity")
    mesh_slot = np.zeros(spec.vert_capacity, np.int64)
    mesh_slot[:n] = slot
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    nt = len(faces)
    if nt > spec.tri_capacity:
        raise ValueError("mesh exceeds LayeredSpec.tri_capacity")
    tri = np.zeros((spec.tri_capacity, 3), np.int64)
    tri[:nt] = slot[faces]
    vert_tri, vert_tri_mask = vertex_triangles(tri[:nt], H * W,
                                               TRI_DEGREE_CAPACITY)

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)[None]

    return LayeredGridTopology(
        rest=dev(rest), stiff=dev(stiff), count=dev(count),
        active=dev(active), rest_positions=dev(rest_pad.T.copy()),
        triangles=dev(tri), tri_mask=dev(np.arange(spec.tri_capacity) < nt),
        mesh_slot=dev(mesh_slot), num_verts=dev(np.int64(n)).reshape(1),
        vert_tri=dev(vert_tri), vert_tri_mask=dev(vert_tri_mask), spec=spec)


@functools.lru_cache(maxsize=8)
def layered_neighbours(offsets: tuple, H: int, W: int, device):
    """Flat-slot neighbour tables of the offset classes, built once per
    (spec, device): nbr[k, s] is the slot that class k joins to base slot s
    and inv[k, s] the base slot whose class-k spring ends at s (both
    clamped to s where they fall off the lattice); nbr_ok / inv_ok mark
    the slots where they lie on it.  (K, H*W) each."""
    y = torch.arange(H, device=device).view(H, 1).expand(H, W)
    x = torch.arange(W, device=device).view(1, W).expand(H, W)
    s = (y * W + x).reshape(-1)
    tables = []
    for sign in (1, -1):
        idx, ok = [], []
        for dy, dx in offsets:
            yy, xx = y + sign * dy, x + sign * dx
            inside = ((yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)).reshape(-1)
            idx.append(torch.where(inside, (yy * W + xx).reshape(-1), s))
            ok.append(inside)
        tables += [torch.stack(idx), torch.stack(ok)]
    return tuple(tables)


def incidence_table(owner: np.ndarray, value: np.ndarray, n: int, cap: int):
    """Per-owner lists of values as a padded (cap, n) table: column v holds,
    in order of appearance, the values of the entries whose owner is v
    (rank within the owner's group, as build_mesh_topology buckets its
    springs, topology.py:322-346).  Returns (table i64 (0 on padding), rank
    (per entry), mask (cap, n) bool)."""
    owner = np.asarray(owner, np.int64).reshape(-1)
    table = np.zeros((cap, n), np.int64)
    mask = np.zeros((cap, n), bool)
    if owner.size == 0:
        return table, np.zeros(0, np.int64), mask
    order = np.argsort(owner, kind="stable")
    v_sorted = owner[order]
    rank = np.arange(len(v_sorted)) - np.searchsorted(v_sorted, v_sorted)
    if int(rank.max()) >= cap:
        raise ValueError(f"an incidence list of {int(rank.max()) + 1} "
                         f"entries exceeds the table's capacity {cap}")
    table[rank, v_sorted] = np.asarray(value, np.int64).reshape(-1)[order]
    mask[rank, v_sorted] = True
    out_rank = np.empty_like(rank)
    out_rank[order] = rank
    return table, out_rank, mask


def vertex_triangles(triangles: np.ndarray, n: int, cap: int):
    """(cap, n) table of the triangles incident to each vertex and its mask:
    the gather that replaces mesh_normals' scatter-add (aero.py:59-63), so
    that the card sums each vertex's faces in one fixed order."""
    tri = np.asarray(triangles, np.int64).reshape(-1, 3)
    t_of_corner = np.repeat(np.arange(len(tri)), 3)
    table, _, mask = incidence_table(tri.reshape(-1), t_of_corner, n, cap)
    return table, mask


# the incidence-table width of the mesh normals: a vertex of the repo's
# shirts touches at most 10 triangles
TRI_DEGREE_CAPACITY = 16


@dataclasses.dataclass
class MeshTopology:
    """Batched generic-mesh topology (counterpart of
    flingbot_tpu.engine.topology.MeshTopology), padded to one vertex
    capacity N per batch.  The spring solve gathers through the
    vertex-centric incidence tables nbr_* (each vertex's <= D springs);
    the normals gather through vert_tri (each vertex's <= Dt triangles).

      edges           (B, E, 2) i64   spring endpoints (padding: 0, 0)
      rest, stiffness (B, E) f32      (padding: rest 1, stiffness 0)
      edge_mask       (B, E) bool
      degree          (B, N) f32      springs per vertex
      triangles       (B, T, 3) i64   padded with (0, 0, 0)
      tri_mask        (B, T) bool
      rest_positions  (B, 3, N) f32   rest pose, 1e6 on padding
      nbr_idx         (B, D, N) i64   neighbour of each incident spring
      nbr_rest, nbr_stiff (B, D, N) f32
      nbr_mask        (B, D, N) bool
      vert_tri        (B, Dt, N) i64  incident triangles of each vertex
      vert_tri_mask   (B, Dt, N) bool
    """

    edges: torch.Tensor
    rest: torch.Tensor
    stiffness: torch.Tensor
    edge_mask: torch.Tensor
    degree: torch.Tensor
    triangles: torch.Tensor
    tri_mask: torch.Tensor
    rest_positions: torch.Tensor
    nbr_idx: torch.Tensor
    nbr_rest: torch.Tensor
    nbr_stiff: torch.Tensor
    nbr_mask: torch.Tensor
    vert_tri: torch.Tensor
    vert_tri_mask: torch.Tensor

    @property
    def batch(self) -> int:
        return self.degree.shape[0]

    @property
    def capacity(self) -> int:
        return self.degree.shape[1]

    def _tensors(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def index(self, idx) -> "MeshTopology":
        return MeshTopology(**{k: v[idx] for k, v in self._tensors().items()})

    def to(self, device) -> "MeshTopology":
        return MeshTopology(**{k: v.to(device)
                               for k, v in self._tensors().items()})

    def set_slots(self, idx: torch.Tensor,
                  other: "MeshTopology") -> "MeshTopology":
        """This batch with env slots `idx` (K,) set from the K-env batch
        `other`, padded to the same capacities."""
        for k, v in self._tensors().items():
            if v.shape[1:] != other._tensors()[k].shape[1:]:
                raise ValueError("mesh topologies of one batch must share "
                                 f"their capacities ({k})")
        return MeshTopology(**{k: v.index_copy(0, idx, other._tensors()[k])
                               for k, v in self._tensors().items()})

    @staticmethod
    def cat(topos) -> "MeshTopology":
        """One batch from topologies padded to the same capacities."""
        return MeshTopology(**{k: torch.cat([t._tensors()[k] for t in topos])
                               for k in topos[0]._tensors()})


def build_mesh_topology(rest_positions, stretch_edges, bend_edges,
                        shear_edges, faces, stiffness=(0.9, 1.0, 0.9),
                        capacity=None, edge_capacity=None, tri_capacity=None,
                        degree_capacity=None,
                        tri_degree_capacity: int = TRI_DEGREE_CAPACITY,
                        device="cuda") -> MeshTopology:
    """A quad mesh as a batch-1 MeshTopology (build_mesh_topology,
    topology.py:265-361): springs of the three classes with their
    stiffness, rest lengths measured on the rest pose, per-vertex degree
    and incidence tables (each spring listed under both endpoints, in
    edge order), all padded to the capacities given (default: the mesh's
    own sizes).  Built on the host in numpy; the tables live on
    `device`."""
    device = resolve_device(device)
    rest_positions = np.asarray(rest_positions, np.float32).reshape(-1, 3)
    n = rest_positions.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"mesh of {n} vertices exceeds capacity {cap}")
    per_class = [np.asarray(e, np.int64).reshape(-1, 2)
                 for e in (stretch_edges, bend_edges, shear_edges)]
    edges = np.concatenate(per_class)
    stiff = np.concatenate([np.full(len(e), stiffness[c], np.float32)
                            for c, e in enumerate(per_class)])
    rest = np.linalg.norm(rest_positions[edges[:, 0]]
                          - rest_positions[edges[:, 1]],
                          axis=1).astype(np.float32)
    ne = len(edges)
    ecap = edge_capacity or ne
    if ecap < ne:
        raise ValueError(f"mesh of {ne} springs exceeds edge capacity {ecap}")
    degree = np.zeros(cap, np.float32)
    np.add.at(degree, edges[:, 0], 1.0)
    np.add.at(degree, edges[:, 1], 1.0)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    nt = len(faces)
    tcap = tri_capacity or nt
    if tcap < nt:
        raise ValueError(f"mesh of {nt} triangles exceeds capacity {tcap}")
    deg_cap = degree_capacity or max(int(degree.max()) if ne else 1, 1)
    # each spring under both endpoints: (vertex, other end, edge id)
    ends = np.concatenate([edges, edges[:, ::-1]])
    eid = np.concatenate([np.arange(ne), np.arange(ne)])
    nbr_idx, rank, nbr_mask = incidence_table(ends[:, 0], ends[:, 1], cap,
                                              deg_cap)
    nbr_rest = np.ones((deg_cap, cap), np.float32)
    nbr_stiff = np.zeros((deg_cap, cap), np.float32)
    nbr_rest[rank, ends[:, 0]] = rest[eid]
    nbr_stiff[rank, ends[:, 0]] = stiff[eid]
    vert_tri, vert_tri_mask = vertex_triangles(faces, cap,
                                               tri_degree_capacity)

    def pad(a, size, fill):
        out = np.full((size,) + a.shape[1:], fill, a.dtype)
        out[:len(a)] = a
        return out

    rest_pad = pad(rest_positions, cap, np.float32(1e6))

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)[None]

    return MeshTopology(
        edges=dev(pad(edges, ecap, 0)), rest=dev(pad(rest, ecap, 1.0)),
        stiffness=dev(pad(stiff, ecap, 0.0)),
        edge_mask=dev(np.arange(ecap) < ne), degree=dev(degree),
        triangles=dev(pad(faces, tcap, 0)),
        tri_mask=dev(np.arange(tcap) < nt), rest_positions=dev(rest_pad.T),
        nbr_idx=dev(nbr_idx), nbr_rest=dev(nbr_rest),
        nbr_stiff=dev(nbr_stiff), nbr_mask=dev(nbr_mask),
        vert_tri=dev(vert_tri), vert_tri_mask=dev(vert_tri_mask))


def grid_mesh_topology(dimx: int, dimy: int, stiffness=(0.9, 1.0, 0.9),
                       spacing: float = PARTICLE_RADIUS, device="cuda",
                       **caps) -> MeshTopology:
    """A grid cloth through the generic mesh path (grid_mesh_topology,
    topology.py:364-380): its springs and triangles in canonical order."""
    edges, _, cls = grid_spring_edges(dimx, dimy)
    return build_mesh_topology(
        grid_positions(dimx, dimy, spacing=spacing),
        *(edges[cls == c] for c in range(3)),
        grid_triangles_np(dimx, dimy), stiffness=stiffness, device=device,
        **caps)
