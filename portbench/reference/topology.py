"""The cloth topologies the reference solves on, worked out from the task
file's raw arrays.

Grid cloths (flingbot-rect): each env's dimx x dimy particles in the
corner of an H x W lattice (slot y * W + x), six stencil classes of
springs (CreateSpringGrid, PyFlex helpers.h:872-925: stretch to the 1-
neighbours, bend to the 2-neighbours, shear to the diagonals) at rest
lengths of 1, 2 and sqrt(2) spacings.

Shirts (flingbot-shirt): a two-panel quad mesh whose vertices lie on a
lattice in the xz rest pose; the front panel and the sewn vertices take
row r, the back panel row H2 + r, so every spring joins two slots at one
of a few fixed offsets.  The layout is recovered from the rest pose, the
springs grouped by offset, and all classes are solved at once by gathers
through neighbour tables.  Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.physics import EPS, PARTICLE_RADIUS, f32

MESH_KEYS = ("mesh_verts", "mesh_stretch_edges", "mesh_bend_edges",
             "mesh_shear_edges", "mesh_faces")


def read_tasks(path: str):
    """{task key: {name: array}} of a task archive, keys sorted."""
    tasks = {}
    with np.load(path, allow_pickle=False) as z:
        for entry in z.files:
            key, name = entry.split("/", 1)
            tasks.setdefault(key, {})[name] = z[entry]
    return [tasks[k] for k in sorted(tasks)]


@dataclasses.dataclass
class GridTopo:
    dimx: torch.Tensor  # (B,) i64
    dimy: torch.Tensor
    stiffness: torch.Tensor  # (B, 3) stretch, bend, shear
    spacing: float
    H: int
    W: int
    layered: bool = False

    def triangles(self):
        """(B, T, 3) lattice-slot triangles, two per quad, and their mask
        (B, T)."""
        H, W = self.H, self.W
        dev = self.dimx.device
        t = torch.arange(2 * (W - 1) * (H - 1), device=dev)
        cell = t // 2
        second = (t % 2) == 1
        cx = cell % (W - 1)
        cy = cell // (W - 1)
        ok = ((cx[None] < self.dimx.view(-1, 1) - 1)
              & (cy[None] < self.dimy.view(-1, 1) - 1))
        a = cy * W + cx
        tri = torch.where(second[:, None],
                          torch.stack([a, a + W + 1, a + W], 1),
                          torch.stack([a, a + 1, a + W + 1], 1))
        return torch.where(ok[..., None], tri[None], 0), ok


def grid_topology(tasks, H: int, W: int, device) -> GridTopo:
    dims = np.array([[int(v) for v in t["cloth_size"][:2]] for t in tasks])
    stiff = np.stack([np.asarray(t["cloth_stiff"], np.float32)[:3]
                      for t in tasks])
    return GridTopo(dimx=torch.as_tensor(dims[:, 0], device=device),
                    dimy=torch.as_tensor(dims[:, 1], device=device),
                    stiffness=torch.as_tensor(stiff, device=device),
                    spacing=f32(PARTICLE_RADIUS), H=H, W=W)


# --------------------------------------------------------------------------
# layered shirts
# --------------------------------------------------------------------------

def _layout(verts, stretch_edges):
    """Integer (row, col, layer) of each vertex from its rest pose."""
    v = np.asarray(verts, np.float64).reshape(-1, 3)
    e = np.asarray(stretch_edges, np.int64).reshape(-1, 2)
    d = np.abs(v[e[:, 0]] - v[e[:, 1]])[:, [0, 2]]
    s = float(np.median(d.max(axis=1)))
    cf = (v[:, 0] - v[:, 0].min()) / s
    rf = (v[:, 2] - v[:, 2].min()) / s
    c = np.round(cf).astype(np.int64)
    r = np.round(rf).astype(np.int64)
    if np.abs(cf - c).max() > 0.25 or np.abs(rf - r).max() > 0.25:
        raise ValueError("a shirt vertex lies off the lattice")
    y = v[:, 1]
    thick = float(np.abs(y).max())
    if thick < 1e-9:
        layer = np.zeros(len(v), np.int64)
    else:
        layer = np.where(y < -0.25 * thick, 1, 0).astype(np.int64)
    return r, c, layer


def _edge_groups(verts, per_class_edges, stiffness):
    """{(dlayer, drow, dcol): [(base, other, stiffness)]}: every spring by
    its lattice offset, the base the lexicographically smaller end."""
    r, c, layer = _layout(verts, per_class_edges[0])
    groups = {}
    for cls, edges in enumerate(per_class_edges):
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        a, b = edges[:, 0], edges[:, 1]
        dl, dy, dx = layer[b] - layer[a], r[b] - r[a], c[b] - c[a]
        for i in range(len(edges)):
            key = (int(dl[i]), int(dy[i]), int(dx[i]))
            flip = key < (0, 0, 0)
            if flip:
                key = (-key[0], -key[1], -key[2])
            base, other = (b[i], a[i]) if flip else (a[i], b[i])
            groups.setdefault(key, []).append(
                (int(base), int(other), float(stiffness[cls])))
    return (r, c, layer), groups


@dataclasses.dataclass
class LayeredTopo:
    offsets: tuple  # ((dy, dx), ...) of each spring class
    H: int
    W: int
    rest: torch.Tensor  # (B, K, N)
    stiff: torch.Tensor  # (B, K, N)
    count: torch.Tensor  # (B, N) springs per slot
    active: torch.Tensor  # (B, N)
    rest_positions: torch.Tensor  # (B, 3, N), 1e6 on empty slots
    triangles_: torch.Tensor  # (B, T, 3)
    tri_mask: torch.Tensor  # (B, T)
    layered: bool = True

    def triangles(self):
        return self.triangles_, self.tri_mask

    def planes(self, w):
        """The per-frame constants of the layered spring solve for inverse
        masses w (B, N)."""
        B, N = w.shape
        K = len(self.offsets)
        H, W, dev = self.H, self.W, w.device
        y = torch.arange(H, device=dev).view(H, 1).expand(H, W)
        x = torch.arange(W, device=dev).view(1, W).expand(H, W)
        s = (y * W + x).reshape(-1)
        tables = []
        for sign in (1, -1):
            idx, ok = [], []
            for dy, dx in self.offsets:
                yy, xx = y + sign * dy, x + sign * dx
                inside = ((yy >= 0) & (yy < H) & (xx >= 0)
                          & (xx < W)).reshape(-1)
                idx.append(torch.where(inside, (yy * W + xx).reshape(-1), s))
                ok.append(inside)
            tables += [torch.stack(idx), torch.stack(ok)]
        nbr, nbr_ok, inv, inv_ok = tables
        stiff = self.stiff.to(w.dtype)
        wb = torch.where(nbr_ok, w[:, nbr], 0.0)
        wsum = w[:, None] + wb
        k_base = torch.arange(K, device=dev).view(K, 1) * N
        inv_flat = torch.where(inv_ok, inv + k_base, K * N).reshape(-1)
        return dict(nbr=nbr.reshape(-1), inv=inv_flat, stiff=stiff,
                    rest=self.rest.to(w.dtype), wb=wb,
                    live=(stiff > 0) & (wsum > 0), den=wsum + EPS,
                    count=torch.clamp(self.count.to(w.dtype), min=1.0))


def layered_topology(tasks, order, device, round_to: int = 8) -> LayeredTopo:
    """The lattice shared by every shirt of a task file, and the spring
    planes of tasks[i] for each i of `order` (one env each) on it."""
    per_task, rmax, cmax, tmax, union = [], 0, 0, 0, set()
    for t in tasks:
        # the scene holds the rest pose in float32: rest lengths are taken
        # from those values
        verts = np.asarray(t["mesh_verts"], np.float32).astype(
            np.float64).reshape(-1, 3)
        per_class = [np.asarray(t[k], np.int64).reshape(-1, 2)
                     for k in MESH_KEYS[1:4]]
        stiff = np.asarray(t["cloth_stiff"], np.float32)[:3]
        (r, c, layer), groups = _edge_groups(verts, per_class,
                                             [float(v) for v in stiff])
        per_task.append((verts, r, c, layer, groups, t))
        rmax = max(rmax, int(r.max()))
        cmax = max(cmax, int(c.max()))
        tmax = max(tmax, np.asarray(t["mesh_faces"]).size // 3)
        union |= set(groups)
    H2 = rmax + 3

    def up(v, m):
        return int((v + m - 1) // m * m)

    H, W = up(H2 + rmax + 1, round_to), up(cmax + 1, round_to)
    offsets = tuple(sorted((dl * H2 + dy, dx) for dl, dy, dx in union))
    off_index = {o: k for k, o in enumerate(offsets)}
    K, N = len(offsets), H * W
    T = up(tmax, 256)
    out = {k: [] for k in ("rest", "stiff", "count", "active", "rest_pos",
                           "tri", "tri_mask")}
    for i in order:
        verts, r, c, layer, groups, t = per_task[i]
        row = r + layer * H2
        slot = row * W + c
        rest = np.zeros((K, H, W), np.float32)
        stiff = np.zeros((K, H, W), np.float32)
        count = np.zeros((H, W), np.float32)
        for (dl, dy, dx), items in groups.items():
            k = off_index[(dl * H2 + dy, dx)]
            base = np.array([it[0] for it in items], np.int64)
            other = np.array([it[1] for it in items], np.int64)
            br, bc = row[base], c[base]
            rest[k, br, bc] = np.linalg.norm(
                verts[base] - verts[other], axis=1).astype(np.float32)
            stiff[k, br, bc] = np.array([it[2] for it in items], np.float32)
            np.add.at(count, (br, bc), 1.0)
            np.add.at(count, (row[other], c[other]), 1.0)
        active = np.zeros((H, W), bool)
        active[row, c] = True
        rest_pad = np.full((N, 3), 1e6, np.float32)
        rest_pad[slot] = verts.astype(np.float32)
        faces = np.asarray(t["mesh_faces"], np.int64).reshape(-1, 3)
        tri = np.zeros((T, 3), np.int64)
        tri[:len(faces)] = slot[faces]
        out["rest"].append(rest.reshape(K, N))
        out["stiff"].append(stiff.reshape(K, N))
        out["count"].append(count.reshape(N))
        out["active"].append(active.reshape(N))
        out["rest_pos"].append(rest_pad.T)
        out["tri"].append(tri)
        out["tri_mask"].append(np.arange(T) < len(faces))
    dev = lambda k: torch.as_tensor(np.stack(out[k]), device=device)  # noqa
    return LayeredTopo(offsets=offsets, H=H, W=W, rest=dev("rest"),
                       stiff=dev("stiff"), count=dev("count"),
                       active=dev("active"), rest_positions=dev("rest_pos"),
                       triangles_=dev("tri"), tri_mask=dev("tri_mask"))
