"""Where a solver frame on the card departs from the same frame on the CPU.

    python tools/frame_divergence.py [--device cpu]

Needs a CUDA card (--device cpu holds the CPU against itself: every
difference 0, a check of the script).  Takes the two frames of
chip_smoke.py's phase 12 that sit furthest from the CPU, at chip_smoke's solver knobs: 4 shirts of
data_r3/shirt_eval_16.npz on the generic mesh path (pallas backend, sort
contacts) and 4 tasks of data_r3/rect_eval_hard_100.npz on the xla
backend (Gauss-Seidel springs, sort contacts).  For each, on the same
inputs, card against CPU (max abs difference):

  springs    one spring pass (solve_springs_mesh; mesh only)
  normals    mesh_normals of the start positions (mesh only)
  no-contact the frame without self-collision
  frame      the whole frame
  frame-xla  the whole frame on the xla backend (no kernel; mesh only)
  pass       one contact pass (4 iterations, window 12) on one sorted input
             built on the CPU: the card's contacts kernel and its plain
             version on the card, each against the plain version on the CPU
  sort       the Morton sort of the two no-contact frames' positions: the
             particles whose cell differs and the slots whose particle
             differs

and beside the two frames, how far NOISE (1e-7) relative noise on the
input positions moves the CPU frame (chip_smoke's noise gate, seed 0),
under each of the noise seeds 0-3.
"""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from flingbot_tpu_torch.engine import aero, collisions, kernels  # noqa: E402
from flingbot_tpu_torch.engine.solver import (  # noqa: E402
    solve_springs_mesh, step)
from flingbot_tpu_torch.engine.state import SolverParams, f32  # noqa: E402
from flingbot_tpu_torch.env.scene import make_batch, scene_task  # noqa: E402
from flingbot_tpu_torch.env.tasks import (  # noqa: E402
    TaskLoader, detect_mesh_caps)

SOLVER = dict(substeps=4, iterations=16, contact_every=2,
              contact_iterations=4, contact_window=12)
NOISE = 1e-7
SEEDS = 4


def gap(a, b) -> float:
    return float((a.cpu() - b.cpu()).abs().max())


def noisy(state, seed):
    P = state.positions
    n = P * (1 + NOISE * torch.randn(
        P.shape, generator=torch.Generator().manual_seed(seed)))
    return state.replace(positions=torch.where(state.active[:, None], n, P))


def frames(st, tp, params, card, **kw):
    """(card vs CPU, the CPU spreads under noise of each seed, card frame,
    CPU frame)."""
    kw = dict(SOLVER, **kw)
    g = step(st.to(card), tp.to(card), params, **kw)
    c = step(st, tp, params, **kw)
    spreads = ", ".join(
        f"{gap(step(noisy(st, s), tp, params, **kw).positions, c.positions):.3e}"
        for s in range(SEEDS))
    return gap(g.positions, c.positions), spreads, g, c


def sort_flips(Pg, Pc, st, params, lattice_w, rest):
    """Particles whose Morton cell differs, and sorted slots whose particle
    differs, between the CPU sorts of two frames' positions."""
    w = torch.where(st.active, st.inv_mass, 0.0)
    rd = torch.tensor(params.radius, dtype=torch.float32)
    cells = [torch.floor(P / rd) for P in (Pg, Pc)]
    moved = int(((cells[0] != cells[1]).any(1) & st.active).sum())
    orders = [collisions.sort_particles(
        P, st.positions, w, st.active, rest_dist=params.radius,
        lattice_w=lattice_w, rest_positions=rest)[0] for P in (Pg, Pc)]
    return moved, int((orders[0] != orders[1]).sum())


def one_pass(st, tp, params, card, rest):
    """One contact pass on a sorted input made on the CPU: (kernel on the
    card vs plain on the CPU, plain on the card vs plain on the CPU)."""
    moved = step(st, tp, params, self_collision=False, **SOLVER)
    w = torch.where(st.active, st.inv_mass, 0.0)
    _, srt = collisions.sort_particles(
        moved.positions, st.positions, w, st.active, rest_dist=params.radius,
        lattice_w=None if rest is not None else tp.max_dimx,
        rest_positions=rest)
    B = st.batch
    kw = dict(window=12, iterations=4)
    if rest is not None:
        kw["rests"] = srt[7:]
    out_c = kernels.contacts_plain(
        kernels.contact_params(params, params.radius, B, "cpu"),
        *srt[:7], **kw)
    on_card = [a.to(card) for a in srt]
    if rest is not None:
        kw["rests"] = on_card[7:]
    cp = kernels.contact_params(params, params.radius, B, card)
    out_k = kernels.contacts(cp, *on_card[:7], **kw) if rest is not None \
        else None
    out_p = kernels.contacts_plain(cp, *on_card[:7], **kw)
    k = None if out_k is None else max(gap(a, b)
                                       for a, b in zip(out_k, out_c))
    return k, max(gap(a, b) for a, b in zip(out_p, out_c))


def report(label, st, tp, params, card, rest, **kw):
    print(f"== {label}: {st.batch} envs x {st.num_particles} slots")
    if rest is not None:
        w = torch.where(st.active, st.inv_mass, 0.0)
        relax = float(f32(params.relaxation_factor))
        spr = [solve_springs_mesh(st.positions.to(d), w.to(d), tp.to(d),
                                  relax) for d in (card, "cpu")]
        print(f"  springs    {gap(*spr):.3e} m")
        nrm = [aero.mesh_normals(x.positions, x.triangles, x.tri_mask,
                                 x.active, x.vert_tri, x.vert_tri_mask)
               for x in (_Both(st.to(card), tp.to(card)), _Both(st, tp))]
        print(f"  normals    {gap(*nrm):.3e}")
    d0, s0, g0, c0 = frames(st, tp, params, card, self_collision=False,
                            **kw)
    print(f"  no-contact {d0:.3e} m (CPU spreads under noise {s0})")
    d1, s1, _, _ = frames(st, tp, params, card, **kw)
    print(f"  frame      {d1:.3e} m (CPU spreads under noise {s1})")
    if rest is not None:
        xla = step(st.to(card), tp.to(card), params,
                   **dict(SOLVER, backend="xla", **kw))
        cpu = step(st, tp, params, **dict(SOLVER, **kw))
        print(f"  frame-xla  {gap(xla.positions, cpu.positions):.3e} m")
    k, p = one_pass(st, tp, params, card, rest)
    print(f"  pass       kernel {k if k is None else f'{k:.3e}'}, "
          f"plain {p:.3e} m")
    cells, slots = sort_flips(g0.positions.cpu(), c0.positions, st, params,
                              None if rest is not None else tp.max_dimx,
                              rest)
    print(f"  sort       {cells} particles in another cell, {slots} sorted "
          "slots with another particle")


class _Both:
    """A state and its MeshTopology's fields under one name."""

    def __init__(self, st, tp):
        self.positions, self.active = st.positions, st.active
        self.triangles, self.tri_mask = tp.triangles, tp.tri_mask
        self.vert_tri, self.vert_tri_mask = tp.vert_tri, tp.vert_tri_mask


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    card = torch.device("cpu" if argv == ["--device", "cpu"] else "cuda")
    if card.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("frame_divergence needs a CUDA card")
    params = SolverParams()
    path = os.path.join(ROOT, "data_r3", "shirt_eval_16.npz")
    loader = TaskLoader(path)
    tp, st = make_batch([scene_task(loader.get_next_task())
                         for _ in range(4)], mesh_caps=detect_mesh_caps(path),
                        device="cpu")
    report("generic mesh, pallas backend, sort contacts", st, tp, params,
           card, tp.rest_positions)
    loader = TaskLoader(os.path.join(ROOT, "data_r3",
                                     "rect_eval_hard_100.npz"))
    tp, st = make_batch([scene_task(loader.get_next_task())
                         for _ in range(4)], device="cpu")
    report("hard tasks, xla backend, gs springs, sort contacts", st, tp,
           params, card, None, backend="xla", contact_mode="sort",
           spring_mode="gs")


if __name__ == "__main__":
    main()
