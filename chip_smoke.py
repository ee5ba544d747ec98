#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flingbot_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line with its wall seconds:
  0  card name and power limit (nvidia-smi), torch and CUDA versions
  1  build both CUDA kernels from csrc/ with nvcc (parallel); each
     kernel's registers and spill bytes (fails on a spill), and the
     clusters of the substeps kernel the card runs at once
  2  each kernel against its plain PyTorch version on the card, at the
     shapes of its path: the grid kernels at the rect path's (128 envs,
     104x104 lattice, dims 64-104), the aero launch of the substeps kernel
     (one substep) there too, its Jacobi launch (spring_mode "jacobi"
     without self-collision: 4 plain substeps) at phase 3's (512 full
     100x100 grids), the mesh mode of the contacts kernel at the shirt
     path's (16 shirts of data/shirts/*.obj on the 96x64 layered lattice):
     max abs error against the stated tolerance, CUDA-event times; the
     no-self-collision launch and contacts at window 16 / 8 iterations
     checked too; plus one aero frame of 4 of the grid kernels' compressed
     synthetic cloths on the card against the plain path on the CPU
  3  the port's bench (flingbot_tpu_torch.bench) at the root bench.py's
     operating point: 512 envs of 100x100, 4 substeps x 16 Chebyshev
     iterations, contacts 4/12/every 2 -> the rate of 5 windows of 20
     frames and their median; then one frame with spring_mode "jacobi"
     and no self-collision
  4  the main path: BatchSimEnv of 128 crumpled cloths (64-104) at
     production knobs (render 400, obs 64, 96 views, 16x8 value net,
     seeded init): reset -> batch_value_maps -> step, launch counters
     zeroed before and read after; plus one frame of 4 envs on the card
     against the plain path on the CPU
  5  torch.profiler over 16 interpreter steps of the main path: time per
     step, device time by kernel, the device's busy share
  6  the shirt path: BatchSimEnv of the 16 layered shirts of the shirt
     eval set (data_r3/shirt_eval_16.npz, through TaskLoader and
     detect_topology_buckets) at production knobs: reset ->
     batch_value_maps -> step, launch counters zeroed before and read
     after; plus one frame of 4 of those shirts and one of 4 crumpled
     data/shirts/*.obj shirts on the card against the CPU, and phase 5's
     profile of 16 interpreter steps
  7  the aero path: phase 4's start states with drag and lift set (an
     option of the solver; flingbot scenes run none): one frame of 4 envs
     on the card against the CPU, then reset -> batch_value_maps -> step
     through the one-substep launches
  8  the eval path: one frame of 4 of the hard eval set's tasks
     (data_r3/rect_eval_hard_100.npz) on the card against the CPU; then
     episodes of 2 steps on that set in 16 env slots under heuristic
     value maps, reloading finished slots, until 16 episodes are done;
     launch counters zeroed before and read after; the replay record's
     statistics printed as eval_quality's JSON line
  9  the train path: flingbot_tpu_torch.run_sim from the round-4
     checkpoint exported from the JAX package (runs/round4/latest_ckpt.npz;
     16 channels, 8 blocks, obs 64, 96 transforms) on the hard eval set,
     64 envs, episodes of 2 steps, batch 128, 2 batches per update, D4
     augmentation, render 256: 4 rounds, of which at least 2 optimize;
     launch counters zeroed before and read after the phase; the saved
     checkpoint reloaded into a fresh policy gives bit-equal value maps;
     then one --eval round from it.  Prints each round's act / step /
     optimize seconds, ms per train step at batch 128 and a profile of 3
     of them, s per dataset batch, and value-map inference ms at 64 envs
     x 96 transforms with and without test-time averaging
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero.
Exits non-zero without a result when CUDA is unavailable.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# f32 peak outside the tensor cores and HBM rate of one H100 SXM at 700 W
# (NVIDIA data sheet)
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

# tolerances of kernel vs plain version on the same inputs (see PERF.md).
# Built without FMA contraction (engine/build.py, -fmad=false) and summing
# in the same order, the two have measured bit-identical; the bounds leave
# room for a last-place difference that 32 Chebyshev iterations amplify
# (P, prev), for V = (P - prev) / dt_sub multiplying it by 400, and for 4
# contact iterations (contacts).  They hold only for that build: with FMA
# contraction a rounding change flips the discontinuous velocity clamp and
# contact counts (measured 0.28 m/s in V, 7e-5 m in contacts), so such a
# build must be held instead by phase 4's one frame of the card against
# the CPU path, at 1e-4 m
TOL = {"substeps.P": 1e-5, "substeps.prev": 1e-5, "substeps.V": 4e-3,
       "contacts.xyz": 2e-6, "substeps_aero.P": 1e-5,
       "substeps_aero.prev": 1e-5, "substeps_aero.V": 4e-3,
       "contacts_mesh.xyz": 2e-6}
# the launches phase 2 adds hold to the bounds of their kind
for _kind in ("substeps_jacobi", "substeps_nocontact"):
    TOL.update({f"{_kind}.{k}": TOL[f"substeps.{k}"]
                for k in ("P", "prev", "V")})
TOL["contacts_w16.xyz"] = TOL["contacts.xyz"]
# the card's frame against the CPU plain path: the card's rsqrt is
# approximate and CUDA divides by a host scalar through its reciprocal
FRAME_TOL = 1e-4
# a frame whose contacts are dense (phase 2's compressed cloths) amplifies
# a last-place rounding difference past FRAME_TOL: such a frame is held
# against NOISE_FACTOR times what NOISE relative noise on its input
# positions moves the CPU frame by
NOISE, NOISE_FACTOR = 1e-7, 2.0
SHIRT_COPIES = 4  # copies of each data/shirts/*.obj
SHIRT_TASKS = "data_r3/shirt_eval_16.npz"  # exported task sets
RECT_TASKS = "data_r3/rect_eval_hard_100.npz"
EVAL_ENVS, EVAL_LENGTH, EVAL_EPISODES = 16, 2, 16
ROUND4_CKPT = "runs/round4/latest_ckpt.npz"
TRAIN_ENVS, TRAIN_ROUNDS, TRAIN_BATCH = 64, 4, 128
AERO = dict(drag=8.0, lift=4.0, wind=(0.5, 0.0, -0.25))
SMOKE_ENVS = 128
BENCH_ENVS, BENCH_DIM, BENCH_STEPS, BENCH_WINDOWS = 512, 100, 20, 5
SOLVER = dict(substeps=4, iterations=16, contact_every=2,
              contact_iterations=4, contact_window=12)
SCALES = (1.0, 1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 2.75)


def log(msg: str):
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"[phase {self.name}] start")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"[phase {self.name}] done in "
                f"{time.perf_counter() - self.t0:.2f} s")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# work models for the bounds: operations and bytes this data needs
# --------------------------------------------------------------------------

def substeps_work(dims, H, W, n_sub, iterations, cheb=True):
    """(bytes, f32 ops) of one substeps launch.  Per constraint per
    iteration: difference 3, squared length 6, rsqrt 1, relaxation 2,
    two scalings 2, two endpoint updates 12 (FMA = 2 ops) = 26; per
    particle per iteration: count scaling 6, Chebyshev 9 (cheb only),
    plane 15 = 30; per particle per substep: integrate 12, velocity clamp
    25, two picker spheres 30 = 67.  Bytes: P, V, w, params read once; P,
    V, prev written once."""
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
    """(bytes, f32 ops) of one contacts launch.  Per pair inside the
    window per iteration ~66 ops (distance 10, penetration 3, friction
    tangent 26, scale 6, two endpoint updates 12, count 2, masks 7); per
    particle per iteration 22 (Jacobi average 7, plane 15).  The mesh
    mode's rest-pose filter, once per pair per launch: rest distance^2 6,
    rest_dist^2 1, compare 1 = 8.  Bytes: six coordinate arrays + packed
    ids + params (+ three rest coordinate arrays) read once, three
    written."""
    B = len(n_active)
    ops = 0
    for n in n_active:
        pairs = sum(max(0, n - k) for k in range(1, window + 1))
        ops += iterations * (66 * pairs + 22 * n) + (8 * pairs if mesh
                                                      else 0)
    nbytes = (4 * B * N * (10 if mesh else 7) + 4 * B * 8
              + 4 * B * N * 3)
    return nbytes, ops


def bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_card():
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(out[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return out[0]


def phase_build(device):
    import re

    from flingbot_tpu_torch.engine import build, kernels

    t0 = time.perf_counter()
    kernels.build()
    log(f"built {list(kernels.KERNELS)} in {time.perf_counter() - t0:.2f} s "
        f"into {build.build_dir()}")
    spills = 0
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {name}: {line.strip()}")
            spills += sum(int(v) for v in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
    if spills:
        raise AssertionError(f"a kernel spills registers ({spills} bytes)")
    for H in (104, BENCH_DIM):
        band, smem = kernels.substeps_band(H, H)
        n = kernels.substeps_max_clusters(device.index or 0, smem)
        log(f"  substeps at {H}x{H}, cluster of {kernels.SUBSTEPS_CLUSTER} "
            f"CTAs: band {band} rows, {smem} B shared memory per CTA, "
            f"cudaOccupancyMaxActiveClusters {n}")


def synthetic_inputs(B, H, W, gen, device, full=False):
    """Wrinkled, compressed cloths (so contacts fire) of seeded dims in
    64..H (full: H x W), an active picker touching each, seeded
    velocities."""
    import torch

    from flingbot_tpu_torch.engine.solver import pack_sub_params
    from flingbot_tpu_torch.engine.state import SolverParams
    from flingbot_tpu_torch.engine.topology import (
        build_grid_topology, lattice_valid)

    dims = torch.randint(64, H + 1, (B, 2), generator=gen)
    if full:
        dims = torch.tensor([[W, H]] * B)
    topo = build_grid_topology(dims[:, 0].numpy(), dims[:, 1].numpy(),
                               max_dimx=W, max_dimy=H, device=device)
    iy = torch.arange(H).view(1, H, 1).float()
    ix = torch.arange(W).view(1, 1, W).float()
    sp = 0.00625 * 0.8
    P = torch.stack([
        (ix - dims[:, 0].view(-1, 1, 1) / 2) * sp + 0 * iy,
        0.05 + 0.01 * torch.sin(ix * 0.7 + iy * 0.3)
        + 0.005 * torch.rand(B, H, W, generator=gen),
        (iy - dims[:, 1].view(-1, 1, 1) / 2) * sp + 0 * ix], 1)
    V = 0.05 * torch.randn(B, 3, H, W, generator=gen)
    valid = lattice_valid(topo.dimx.cpu(), topo.dimy.cpu(), H, W)
    n = (dims[:, 0] * dims[:, 1]).float().view(-1, 1, 1)
    w = torch.where(valid, n / 0.5, 0.0)
    w[:, 0, 0] = 0.0  # a grasped particle
    picker = torch.stack([P[:, :, 0, 0] + torch.tensor([0.0, 0.02, 0.0]),
                          torch.full((B, 3), -10.0)], 1)
    pvec = pack_sub_params(SolverParams(), topo, picker.to(device), 0.02,
                           0.0025)
    to = lambda x: x.to(device).contiguous()  # noqa: E731
    return topo, pvec, to(P), to(V), to(w), valid.to(device), to(picker)


def synthetic_state(P, V, w, valid, picker):
    """synthetic_inputs' cloths as a ClothState, particle 0 grasped by
    picker 0."""
    import torch

    from flingbot_tpu_torch.engine.state import ClothState

    B = P.shape[0]
    n = valid.reshape(B, -1).sum(1, keepdim=True).float()
    rest = torch.where(valid.reshape(B, -1), n / 0.5, 0.0)
    picked = torch.full((B, 2), -1, dtype=torch.int64, device=P.device)
    picked[:, 0] = 0
    return ClothState(
        positions=P.reshape(B, 3, -1), velocities=V.reshape(B, 3, -1),
        inv_mass=w.reshape(B, -1), rest_inv_mass=rest,
        active=valid.reshape(B, -1), picker_pos=picker, picked_idx=picked)


def phase_kernels(device):
    import torch

    from flingbot_tpu_torch.engine import collisions, kernels
    from flingbot_tpu_torch.engine.state import SolverParams

    gen = torch.Generator().manual_seed(1)
    B, H, W = SMOKE_ENVS, 104, 104
    topo, pvec, P, V, w, valid, picker = synthetic_inputs(B, H, W, gen,
                                                          device)
    dims = list(zip(topo.dimx.tolist(), topo.dimy.tolist()))
    err = {}
    rows = {}
    for name, kw in (
            ("substeps", dict(n_sub=2, iterations=16, picker_last=False)),
            ("substeps_aero", dict(n_sub=1, iterations=16,
                                   picker_last=False))):
        rows[name], out = kernel_substeps(name, pvec, P, V, w, dims, err, kw)
        if name == "substeps":
            out_k = out
    # the no-self-collision launch of the Chebyshev path (checked, not a
    # row: the same kernel and arithmetic as substeps_jacobi's launch)
    kernel_substeps("substeps_nocontact", pvec, P, V, w, dims, err,
                    dict(n_sub=4, iterations=16, picker_last=True),
                    timed=False)
    # spring_mode "jacobi" without self-collision: one launch of all 4
    # substeps, plain Jacobi, the last picker push included, at the shapes
    # of phase 3's Jacobi frame, which counts its launches
    _, jpvec, jP, jV, jw, _, _ = synthetic_inputs(
        BENCH_ENVS, BENCH_DIM, BENCH_DIM, gen, device, full=True)
    rows["substeps_jacobi"], _ = kernel_substeps(
        "substeps_jacobi", jpvec, jP, jV, jw,
        [(BENCH_DIM, BENCH_DIM)] * BENCH_ENVS, err,
        dict(n_sub=4, iterations=16, cheb=False, picker_last=True))
    del jP, jV, jw

    # contacts on the Morton-sorted state the substeps left behind
    params = SolverParams()
    Pn, _, prev = out_k
    order, srt = collisions.sort_particles(
        Pn.reshape(B, 3, -1), prev.reshape(B, 3, -1), w.reshape(B, -1),
        valid.reshape(B, -1), rest_dist=params.radius, lattice_w=W)
    cp = collisions.contact_params(params, params.radius, B, device)
    ckw = dict(window=12, iterations=4)
    ok_ = kernels.contacts(cp, *srt, **ckw)
    op_ = kernels.contacts_plain(cp, *srt, **ckw)
    torch.cuda.synchronize()
    err["contacts.xyz"] = max(float((a - b).abs().max())
                              for a, b in zip(ok_, op_))
    moved = max(float((a - s).abs().max()) for a, s in zip(ok_, srt))
    ms_k = cuda_ms(lambda: kernels.contacts(cp, *srt, **ckw), 10)
    ms_p = cuda_ms(lambda: kernels.contacts_plain(cp, *srt, **ckw), 3)
    n_active = [dx * dy for dx, dy in dims]
    b_ms, b_by = bound(*contacts_work(n_active, H * W, 12, 4))
    rows["contacts"] = dict(max_abs_err=err["contacts.xyz"], ms=ms_k,
                            plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by, B=B)
    log_tiles("contacts", B, H * W, **ckw)
    # the flex-parity knobs: window 16, 8 iterations (halo 128)
    wkw = dict(window=16, iterations=8)
    err["contacts_w16.xyz"] = max(
        float((a - b).abs().max()) for a, b in zip(
            kernels.contacts(cp, *srt, **wkw),
            kernels.contacts_plain(cp, *srt, **wkw)))
    log(f"  contacts at window 16, 8 iterations: "
        f"{cuda_ms(lambda: kernels.contacts(cp, *srt, **wkw), 10):.3f} ms")
    rows.update(kernel_mesh(device, err))
    # the aero path's frame on these compressed cloths, card against CPU
    frame_check(synthetic_state(P, V, w, valid, picker), topo,
                SolverParams(**AERO), "compressed synthetic grid, aero",
                ill_conditioned=True)
    for k, v in err.items():
        log(f"  {k}: max abs err {v:.3e} (tolerance {TOL[k]:.0e})")
    log(f"  contacts moved particles by up to {moved:.3e} m")
    for name, r in rows.items():
        log(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) at "
            f"B={r['B']}")
    bad = {k: v for k, v in err.items() if not v <= TOL[k]}
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    if not moved > 0 or not rows["contacts_mesh"]["moved"] > 0:
        raise AssertionError("contacts fired on no pair")
    return rows


def kernel_substeps(name, pvec, P, V, w, dims, err, kw, timed=True):
    """One launch configuration of the substeps kernel against its plain
    version on the same inputs: max abs error of P, V, prev into err,
    CUDA-event times and the bound.  Returns (row, outputs)."""
    import torch

    from flingbot_tpu_torch.engine import kernels

    B, _, H, W = P.shape
    out_k = kernels.substeps(pvec, P, V, w, **kw)
    out_p = kernels.substeps_plain(pvec, P, V, w, **kw)
    torch.cuda.synchronize()
    for o, a, b in zip(("P", "V", "prev"), out_k, out_p):
        err[f"{name}.{o}"] = float((a - b).abs().max())
        assert torch.isfinite(a).all(), (name, o)
    if not timed:
        return None, out_k
    ms_k = cuda_ms(lambda: kernels.substeps(pvec, P, V, w, **kw), 10)
    ms_p = cuda_ms(lambda: kernels.substeps_plain(pvec, P, V, w, **kw), 3)
    b_ms, b_by = bound(*substeps_work(dims, H, W, kw["n_sub"],
                                      kw["iterations"], kw.get("cheb", True)))
    by_out = {k: err[f"{name}.{k}"] for k in ("P", "V", "prev")}
    return dict(max_abs_err=max(by_out.values()),
                max_abs_err_by_output=by_out, ms=ms_k, plain_ms=ms_p,
                bound_ms=b_ms, bound_by=b_by, B=B), out_k


def log_tiles(name, B, N, window, iterations):
    """Log the contacts kernel's tiling at these shapes; returns its block
    count."""
    from flingbot_tpu_torch.engine import kernels

    tile, halo, n_tiles = kernels.contact_tiles(N, window, iterations)
    log(f"  {name}: {B} envs x {N} slots in tiles of {tile} + 2 x {halo} "
        f"halo slots: {B * n_tiles} blocks of "
        f"{kernels.contact_smem(tile, halo)} B shared memory")
    return B * n_tiles


def shirt_batch(device):
    """16 layered shirts: SHIRT_COPIES of each data/shirts/*.obj, lifted
    0.1 m, on the lattice of one shared LayeredSpec."""
    import glob

    from flingbot_tpu_torch.env.scene import make_batch, shirt_task

    paths = sorted(glob.glob(os.path.join(ROOT, "data", "shirts",
                                          "shirt_*_processed.obj")))
    if len(paths) != 4:
        raise AssertionError(f"expected 4 shirt OBJs, found {paths}")
    return make_batch([shirt_task(p) for p in paths
                       for _ in range(SHIRT_COPIES)], device=device)


def kernel_mesh(device, err):
    """The mesh mode of the contacts kernel at the shirt path's shapes:
    16 shirts pressed to 40% of their width with a 1 cm wrinkle (so that
    pairs that the rest-pose filter keeps collide), one layered frame,
    then Morton-sorted with their rest coordinates."""
    import torch

    from flingbot_tpu_torch.engine import collisions, kernels
    from flingbot_tpu_torch.engine.solver import step
    from flingbot_tpu_torch.engine.state import SolverParams

    params = SolverParams()
    topo, state = shirt_batch(device)
    P0 = state.positions.clone()
    P0[:, 0] *= 0.4
    P0[:, 2] *= 0.4
    P0[:, 1] += 0.01 * torch.sin(P0[:, 0] * 150.0) + 0.02
    state = state.replace(positions=torch.where(state.active[:, None], P0,
                                                state.positions))
    moved = step(state, topo, params, **SOLVER)
    B, _, N = state.positions.shape
    w = torch.where(state.active, state.inv_mass, 0.0)
    _, srt = collisions.sort_particles(
        moved.positions, state.positions, w, state.active,
        rest_dist=params.radius, rest_positions=topo.rest_positions)
    cp = collisions.contact_params(params, params.radius, B, device)
    kw = dict(rests=srt[7:], window=12, iterations=4)
    out_k = kernels.contacts(cp, *srt[:7], **kw)
    out_p = kernels.contacts_plain(cp, *srt[:7], **kw)
    torch.cuda.synchronize()
    err["contacts_mesh.xyz"] = max(float((a - b).abs().max())
                                   for a, b in zip(out_k, out_p))
    shift = max(float((a - b).abs().max()) for a, b in zip(out_k, srt))
    ms_k = cuda_ms(lambda: kernels.contacts(cp, *srt[:7], **kw), 10)
    ms_p = cuda_ms(lambda: kernels.contacts_plain(cp, *srt[:7], **kw), 3)
    n_active = state.active.sum(1).tolist()
    b_ms, b_by = bound(*contacts_work(n_active, N, 12, 4, mesh=True))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if log_tiles("contacts_mesh", B, N, window=12, iterations=4) < sms:
        raise AssertionError(f"the shirt path's contacts leave SMs idle "
                             f"({sms} SMs)")
    log(f"  shirts: lattice {topo.H}x{topo.W} ({N} slots), "
        f"{len(topo.offsets)} spring classes, {min(n_active)}-"
        f"{max(n_active)} vertices; mesh contacts moved particles by up "
        f"to {shift:.3e} m")
    return {"contacts_mesh": dict(
        max_abs_err=err["contacts_mesh.xyz"], ms=ms_k, plain_ms=ms_p,
        bound_ms=b_ms, bound_by=b_by, B=B, moved=shift)}


def frame_check(state, topo, params, what, ill_conditioned=False):
    """One solver frame of 4 envs on the card against the plain path on
    the CPU: max |dP| within FRAME_TOL, coverage to 6 digits.  Beside it,
    the frame's own conditioning: how far the CPU frame moves when the
    active positions carry a seeded relative noise of NOISE.  For inputs
    marked ill_conditioned, where that spread exceeds FRAME_TOL, the card
    must instead stay within NOISE_FACTOR times the spread."""
    import torch

    from flingbot_tpu_torch.engine.solver import step
    from flingbot_tpu_torch.env.coverage import get_current_covered_area

    sub = torch.arange(min(4, state.batch), device=state.device)
    st4, tp4 = state.index(sub).to("cpu"), topo.index(sub).to("cpu")
    gpu = step(st4.to(state.device), tp4.to(state.device), params, **SOLVER)
    cpu = step(st4, tp4, params, **SOLVER)
    P = st4.positions
    noisy = P * (1 + NOISE * torch.randn(
        P.shape, generator=torch.Generator().manual_seed(0)))
    cpu_n = step(st4.replace(positions=torch.where(st4.active[:, None],
                                                   noisy, P)),
                 tp4, params, **SOLVER)
    err = float((gpu.positions.cpu() - cpu.positions).abs().max())
    spread = float((cpu_n.positions - cpu.positions).abs().max())
    cov_g = get_current_covered_area(gpu.positions, gpu.active).cpu()
    cov_c = get_current_covered_area(cpu.positions, cpu.active)
    log(f"  one frame, 4 envs ({what}), card vs CPU plain path: max |dP| "
        f"{err:.3e} m (the CPU frame moves {spread:.3e} m under {NOISE:.0e}"
        f" relative input noise); coverage {cov_g.tolist()} vs "
        f"{cov_c.tolist()}")
    if ill_conditioned:
        if not err <= NOISE_FACTOR * spread:
            raise AssertionError(f"card frame disagrees with the CPU: {err}"
                                 f" > {NOISE_FACTOR} x {spread}")
        return gpu
    if not err < FRAME_TOL:
        raise AssertionError(f"card frame disagrees with the CPU: {err}")
    if not torch.allclose(cov_g, cov_c, rtol=1e-6, atol=0.0):
        raise AssertionError("card coverage disagrees with the CPU")
    return gpu


def phase_bench(device):
    """flingbot_tpu_torch.bench at its operating point (512 envs of
    100x100): each window's rate and their median; then one frame with
    spring_mode "jacobi" and no self-collision from the bench's last
    state."""
    import statistics

    import torch

    from flingbot_tpu_torch import bench
    from flingbot_tpu_torch.engine import kernels
    from flingbot_tpu_torch.engine.solver import step
    from flingbot_tpu_torch.engine.state import SolverParams

    d = BENCH_DIM
    kernels.reset_launch_counts()
    rates, state, topo = bench.measure(BENCH_ENVS, d, BENCH_STEPS,
                                       BENCH_WINDOWS, device=device)
    assert torch.isfinite(state.positions).all()
    rate = statistics.median(rates)
    log(f"  {BENCH_ENVS} envs x {d}x{d}, windows of {BENCH_STEPS} frames: "
        f"{', '.join(f'{r:.1f}' for r in rates)} env-steps/s, median "
        f"{rate:.1f}; launches {dict(kernels.LAUNCHES)} over "
        f"{BENCH_STEPS * BENCH_WINDOWS + 1} frames")
    params = SolverParams()
    # spring_mode "jacobi" without self-collision: one launch of all 4
    # plain-Jacobi substeps per frame (a warm-up frame, then the counted
    # and timed one)
    jkw = dict(SOLVER, spring_mode="jacobi", self_collision=False)
    step(state, topo, params, **jkw)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = step(state, topo, params, **jkw)
    torch.cuda.synchronize()
    ms_j = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    assert torch.isfinite(out.positions).all()
    log(f"  one frame, spring_mode jacobi, no self-collision: {ms_j:.3f} ms"
        f" -> {BENCH_ENVS / (ms_j / 1e3):.1f} env-steps/s; launches "
        f"{launches}")
    if launches["substeps"] != 1 or launches["contacts"] != 0:
        raise AssertionError(f"jacobi frame launches: {launches}")
    return rate, launches["substeps"]


def phase_slice(device):
    import numpy as np
    import torch

    from flingbot_tpu_torch.engine.state import SolverParams
    from flingbot_tpu_torch.env.scene import crumple, flat_tasks, make_batch

    rng = np.random.default_rng(0)
    sizes = [tuple(int(v) for v in rng.integers(64, 105, 2))
             for _ in range(SMOKE_ENVS)]
    params = SolverParams()
    t0 = time.perf_counter()
    topo, state = make_batch(flat_tasks(sizes), device=device)
    state = crumple(state, topo, params, torch.Generator().manual_seed(0),
                    SOLVER)
    torch.cuda.synchronize()
    log(f"  crumpled {SMOKE_ENVS} cloths in {time.perf_counter() - t0:.2f} s")
    frame_check(state, topo, params, "grid")
    launches, env, vm = drive_path((state, topo), device, ("substeps",
                                                          "contacts"))
    return launches, (env, vm), (state, topo)


def drive_path(start, device, kernels_of_path, params=None, **env_kw):
    """reset -> batch_value_maps -> step of a BatchSimEnv at production
    knobs, from start = (state, topo), or from file tasks when start is
    () and env_kw holds the task source; launch counters zeroed just
    before and read just after; fails if a kernel of the path never
    launched."""
    import torch

    from flingbot_tpu_torch.engine import kernels
    from flingbot_tpu_torch.env.batch_env import BatchSimEnv
    from flingbot_tpu_torch.learning.nets import MaximumValuePolicy

    env = BatchSimEnv(device=device, scale_factors=SCALES,
                      solver_params=params, **SOLVER, **env_kw)
    policy = MaximumValuePolicy(["fling"], 64, seed=0, device=device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = [time.perf_counter()]

    def lap():
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        return t[-1] - t[-2]

    obs = env.reset(*start)
    s_reset = lap()
    vm = policy.batch_value_maps(obs)
    s_policy = lap()
    obs = env.step(vm)
    s_step = lap()
    launches = dict(kernels.LAUNCHES)

    last = env.last
    B = env.state.batch
    T = 12 * len(SCALES)
    assert tuple(obs.shape) == (B, T, 4, 64, 64), obs.shape
    assert tuple(vm.shape) == (B, 1, T, 64, 64), vm.shape
    for name, x in (("obs", obs), ("value maps", vm),
                    ("positions", env.state.positions),
                    ("pre coverage", last.pre_coverage),
                    ("post coverage", last.post_coverage)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite {name}")
    pre, post = last.pre_coverage.cpu(), last.post_coverage.cpu()
    steps = last.sim_steps.cpu().float()
    log(f"  reset {s_reset:.2f} s, value maps {s_policy:.2f} s, step "
        f"{s_step:.2f} s ({last.chunks} chunks of {env.chunk_steps} "
        f"interpreter steps)")
    log(f"  sim steps per env: mean {steps.mean():.1f} max {steps.max():.0f}")
    log(f"  coverage m^2: pre mean {pre.mean():.5f} min {pre.min():.5f} "
        f"max {pre.max():.5f}; post mean {post.mean():.5f} min "
        f"{post.min():.5f} max {post.max():.5f}; grasped "
        f"{int((last.selection.p1_grasp | last.selection.p2_grasp).sum())}"
        f"/{B}; terminated {int(last.terminate.sum())}")
    log(f"  launches on the path: {launches}")
    if not (pre > 0).all():
        raise AssertionError("zero pre-action coverage")
    for name in kernels_of_path:
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched on the path")
    return launches, env, vm


def phase_shirts(device):
    """The shirt path: the 16 shirts of the shirt eval set, read through
    TaskLoader and detect_topology_buckets, through the fling; then a
    profile of 16 interpreter steps."""
    import torch

    from flingbot_tpu_torch.engine.state import SolverParams
    from flingbot_tpu_torch.env.scene import crumple
    from flingbot_tpu_torch.env.tasks import (
        TaskLoader, detect_topology_buckets)

    path = os.path.join(ROOT, SHIRT_TASKS)
    buckets = detect_topology_buckets(path)
    spec = buckets["layered_spec"]
    if spec is None:
        raise AssertionError(f"{SHIRT_TASKS} holds no layered shirts")
    loader = TaskLoader(path)
    log(f"  {len(loader)} shirt tasks on a {spec.H}x{spec.W} lattice, "
        f"{len(spec.offsets)} spring classes")
    env_kw = dict(get_task_fn=loader.get_next_task, num_envs=len(loader),
                  **buckets)
    launches, env, vm = drive_path((), device, ("contacts_mesh",),
                                   **env_kw)
    params = SolverParams()
    # one frame of 4 of these shirts from their file states on the card
    # against the CPU: dense contacts in the crumpled file states make
    # that frame ill-conditioned (a last-place difference flips a contact:
    # 1.356e-4 m on an H100 against a CPU spread of 9.521e-5 m), so it is
    # held against NOISE_FACTOR x the CPU spread
    loader.curr_task_idx = 0
    topo, state = env.load_scenes(
        [loader.get_next_task() for _ in range(4)])
    frame_check(state, topo, params, "eval-set shirts",
                ill_conditioned=True)
    # and, as before, one frame of crumpled OBJ shirts at FRAME_TOL
    topo, state = shirt_batch(device)
    state = crumple(state, topo, params, torch.Generator().manual_seed(0),
                    SOLVER)
    frame_check(state, topo, params, "crumpled OBJ shirts")
    phase_profile(env, vm)
    return launches


def phase_eval(device):
    """The eval path: one settle frame of 4 file tasks on the card against
    the CPU; then episodes of EVAL_LENGTH steps on the hard eval set
    through heuristic value maps, EVAL_ENVS slots reloaded as their
    episodes end, until EVAL_EPISODES episodes are done; launch counters
    zeroed before and read after; then the replay record's statistics
    (collect_stats), and every episode's recorded init coverage against
    its task in the file."""
    import tempfile

    import torch

    from flingbot_tpu_torch.engine import kernels
    from flingbot_tpu_torch.engine.state import SolverParams
    from flingbot_tpu_torch.env.batch_env import BatchSimEnv
    from flingbot_tpu_torch.env.scene import make_batch, scene_task
    from flingbot_tpu_torch.env.tasks import (
        TaskLoader, detect_topology_buckets, read_task_arrays)
    from flingbot_tpu_torch.eval_quality import (
        heuristic_value_maps, json_line)
    from flingbot_tpu_torch.learning.memory import read_step, step_keys
    from flingbot_tpu_torch.utils.stats import collect_stats

    path = os.path.join(ROOT, RECT_TASKS)
    loader = TaskLoader(path)
    # the settle frame of 4 file tasks on the card against the CPU: dense
    # contacts in crumpled file states make it ill-conditioned, as in
    # phase 6
    topo, state = make_batch([scene_task(loader.get_next_task())
                              for _ in range(4)], device=device)
    frame_check(state, topo, SolverParams(), "hard eval-set tasks",
                ill_conditioned=True)
    loader.curr_task_idx = 0
    with tempfile.TemporaryDirectory(suffix="_replay") as replay:
        env = BatchSimEnv(
            get_task_fn=loader.get_next_task, num_envs=EVAL_ENVS,
            replay_buffer_path=replay, episode_length=EVAL_LENGTH,
            **detect_topology_buckets(path), render_dim=256,
            chunk_steps=192, scale_factors=SCALES, device=device, **SOLVER)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        obs = env.reset()
        steps = reloads = 0
        while env.episodes_done < EVAL_EPISODES:
            done = env.episodes_done
            obs = env.step(heuristic_value_maps(obs))
            steps += 1
            reloads += env.episodes_done > done
            if not bool(torch.isfinite(obs).all()):
                raise AssertionError("non-finite observation")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        stats = collect_stats(replay, num_points=10 ** 9) or {}
        tasks = read_task_arrays(path)
        for key in step_keys(replay):
            if key.endswith("_last"):
                a, _ = read_step(replay, key, arrays=False)
                want = float(tasks[a["task_name"]]["@initial_coverage"])
                if a["init_coverage"] != want:
                    raise AssertionError(f"{key}: init coverage "
                                         f"{a['init_coverage']} != {want}")
    log(f"  {env.episodes_done} episodes ({env.episodes_terminated} ended "
        f"early) in {steps} steps of {EVAL_ENVS} envs, {reloads} reload "
        f"rounds, {seconds:.2f} s; launches {launches}")
    log("  eval stats: " + json.dumps(json_line(stats, env.episodes_done,
                                                 seconds)))
    if reloads < 1:
        raise AssertionError("no reload round")
    for name in ("substeps", "contacts"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched on the "
                                 "eval path")
    if "best_coverage/hard/mean" not in stats:
        raise AssertionError("the replay record has no best coverage")


def phase_train(device):
    """The train path through run_sim.main: TRAIN_ROUNDS rounds from the
    round-4 checkpoint on the hard eval set, then the checkpoint it saved
    reloaded and one --eval round from it; launch counters zeroed before
    and read after.  Returns the launches."""
    import statistics
    import tempfile

    import torch

    from flingbot_tpu_torch import run_sim
    from flingbot_tpu_torch.engine import kernels
    from flingbot_tpu_torch.learning.dataset import GraspDataset
    from flingbot_tpu_torch.learning.memory import step_keys
    from flingbot_tpu_torch.learning.nets import MaximumValuePolicy
    from flingbot_tpu_torch.learning.train import train_on_batch
    from flingbot_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt0 = os.path.join(ROOT, ROUND4_CKPT)
    start = MaximumValuePolicy(["fling"], 64, device=device)
    load_checkpoint(ckpt0, start)
    common = ["--tasks", os.path.join(ROOT, RECT_TASKS), "--num_envs",
              str(TRAIN_ENVS), "--render_dim", "256", "--chunk_steps", "192",
              "--lr", "1e-3", "--seed", "0", "--device", str(device)]
    with tempfile.TemporaryDirectory(suffix="_train") as tmp:
        log_dir = os.path.join(tmp, "train")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        policy, history = run_sim.main(common + [
            "--log", log_dir, "--load", ckpt0, "--episode_length", "2",
            "--warmup", "0", "--batch_size", str(TRAIN_BATCH),
            "--batches_per_update", "2", "--dihedral_augment"],
            max_rounds=TRAIN_ROUNDS)
        seconds = time.perf_counter() - t0
        for r in history:
            opt = ("-" if r["optimize"] is None
                   else f"{r['optimize']:.3f} s")
            log(f"  round {r['round']}: act {r['act']:.3f} s, step "
                f"{r['step']:.3f} s, optimize {opt}; replay "
                f"{r['dataset_size']} steps; losses {r['losses']}")
        trained = sum(r["optimize"] is not None for r in history)
        losses = [v for r in history for v in r["losses"].values()]
        log(f"  {len(history)} rounds in {seconds:.2f} s, {trained} "
            f"optimized; steps {start.steps()} -> {policy.steps()}")
        if len(history) != TRAIN_ROUNDS or trained < 2:
            raise AssertionError(f"{trained} of {len(history)} rounds "
                                 "optimized")
        if policy.steps() - start.steps() < 4:
            raise AssertionError("the policy took fewer than 4 steps")
        if not losses or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses {losses}")

        # the saved checkpoint reloads bit for bit
        ckpt = os.path.join(log_dir, "latest_ckpt.pth")
        fresh = MaximumValuePolicy(["fling"], 64, device=device)
        load_checkpoint(ckpt, fresh)
        gen = torch.Generator(device).manual_seed(0)
        obs = torch.rand((TRAIN_ENVS, 96, 4, 64, 64), generator=gen,
                         device=device)
        obs[:, :, 3] = 1.99 + 0.01 * obs[:, :, 3]
        if not torch.equal(policy.batch_value_maps(obs),
                           fresh.batch_value_maps(obs)):
            raise AssertionError("the reloaded checkpoint's value maps "
                                 "differ")
        log(f"  {ckpt} reloaded: value maps bit-equal at {TRAIN_ENVS} "
            "envs x 96 transforms")

        # layer times: a dataset batch, a train step, value-map inference
        ds = GraspDataset(os.path.join(log_dir, "replay_buffer"),
                          rgb_only=True, dihedral_augment=True)
        t0 = time.perf_counter()
        batch = ds.sample_batch(TRAIN_BATCH)
        s_batch = time.perf_counter() - t0
        ms = []
        for i in range(23):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_on_batch(fresh.nets["fling"], *batch)
            torch.cuda.synchronize()
            if i >= 3:
                ms.append((time.perf_counter() - t0) * 1e3)
        profile_steps(lambda: [train_on_batch(fresh.nets["fling"], *batch)
                               for _ in range(3)], 3,
                      f"3 train steps at batch {TRAIN_BATCH}")
        ms_vm = cuda_ms(lambda: policy.batch_value_maps(obs), 3)
        policy.tta = True
        ms_tta = cuda_ms(lambda: policy.batch_value_maps(obs), 2)
        log(f"  dataset batch of {TRAIN_BATCH}: {s_batch:.3f} s; train "
            f"step at batch {TRAIN_BATCH}: median {statistics.median(ms):.3f}"
            f" ms (min {min(ms):.3f}, max {max(ms):.3f}, 20 steps); value "
            f"maps at {TRAIN_ENVS} envs x 96 transforms: {ms_vm:.3f} ms, "
            f"with TTA {ms_tta:.3f} ms")

        # one --eval round from the saved checkpoint
        t0 = time.perf_counter()
        run_sim.main(common + ["--log", log_dir, "--eval", "--load", ckpt,
                               "--episode_length", "1"], max_rounds=1)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        replay = os.path.join(log_dir, "latest_ckpt_eval_0", "replay_buffer")
        n_eval = len(step_keys(replay))
        log(f"  eval round: {n_eval} episodes in {replay} in "
            f"{time.perf_counter() - t0:.2f} s; launches in the phase "
            f"{launches}")
        if n_eval != TRAIN_ENVS:
            raise AssertionError(f"the eval round wrote {n_eval} episodes")
    for name in ("substeps", "contacts"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched on the "
                                 "train path")
    return launches


def phase_aero(state, topo, device):
    """The aero path: the rect path's crumpled start states with drag, lift
    and wind set, through the one-substep launches; first one frame of 4
    envs on the card against the CPU."""
    from flingbot_tpu_torch.engine.solver import step
    from flingbot_tpu_torch.engine.state import SolverParams

    params = SolverParams(**AERO)
    aero = frame_check(state, topo, params, "grid, aero")
    still = step(state.index(slice(0, 4)), topo.index(slice(0, 4)),
                 SolverParams(), **SOLVER)
    kick = float((aero.velocities - still.velocities).abs().max())
    log(f"  the aero pass changed V by up to {kick:.3e} m/s in that frame")
    if not kick > 1e-3:
        raise AssertionError("the aero pass changed nothing")
    launches, _, _ = drive_path((state, topo), device, ("substeps",),
                                params)
    return launches


def phase_profile(env, vm, steps: int = 16):
    """torch.profiler over `steps` interpreter steps of a fresh fling
    program on the main path's envs."""
    import torch

    from flingbot_tpu_torch.env.primitives import (
        STABLE_MAX_STEPS, program_chunk)
    from flingbot_tpu_torch.env.sim_env import step_begin

    _, _, _, carry, prog = step_begin(env.state, vm, env.obs, env.rotations,
                                      env.prim_cfg, env.pix_grasp_dist)
    kw = dict(max_steps=env.prim_cfg.max_program_steps + STABLE_MAX_STEPS,
              sim_kw=env.sim_kw)
    carry, _ = program_chunk(carry, env.topo, env.params, prog,
                             chunk_steps=2, **kw)
    torch.cuda.synchronize()
    profile_steps(lambda: program_chunk(carry, env.topo, env.params, prog,
                                        chunk_steps=steps, **kw),
                  steps, f"{steps} interpreter steps at B={env.state.batch}")


def profile_steps(fn, steps: int, what: str):
    """torch.profiler over fn(), which runs `steps` steps: wall and device
    time per step, the port's kernels' share of it, the device's busy
    share, and the device kernels that take the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: an aten op's own entry repeats the time of
    # the kernels it launched
    dev = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                            getattr(e, "self_cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev(e) > 0]
    total = sum(dev(e) for e in events) / 1e3  # ms
    ours = sum(dev(e) for e in events
               if "substeps_kernel" in e.key or "contacts_kernel" in e.key)
    log(f"  {what}: wall {wall * 1e3 / steps:.3f} ms per step, device "
        f"{total / steps:.3f} ms per step (the port's kernels "
        f"{ours / 1e3 / steps:.3f}), device busy share "
        f"{total / (wall * 1e3):.3f}, {len(events)} device kernel kinds")
    for e in sorted(events, key=dev, reverse=True)[:8]:
        log(f"    {dev(e) / 1e3 / steps:8.3f} ms/step  {e.count // steps:4d}"
            f" launches/step  {e.key[:70]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import flingbot_tpu_torch  # noqa: F401  (fails outside the repo)

    device = torch.device("cuda")
    with Phase("0 card"):
        phase_card()
    with Phase("1 build"):
        phase_build(device)
    with Phase("2 kernels vs plain"):
        rows = phase_kernels(device)
    with Phase("3 physics frame"):
        _, jacobi_launches = phase_bench(device)
    with Phase("4 main path"):
        launches, (env, vm), (state, topo) = phase_slice(device)
    with Phase("5 profile"):
        phase_profile(env, vm)
    with Phase("6 shirt path"):
        launches["contacts_mesh"] = phase_shirts(device)["contacts_mesh"]
    with Phase("7 aero path"):
        launches["substeps_aero"] = phase_aero(state, topo,
                                               device)["substeps"]
    with Phase("8 eval path"):
        phase_eval(device)
    with Phase("9 train path"):
        train = phase_train(device)
    for name in ("substeps", "contacts"):
        launches[name] += train[name]
    launches["substeps_jacobi"] = jacobi_launches

    sources = {
        "substeps": ("flingbot_tpu_torch/csrc/substeps.cu",
                     "flingbot_tpu/engine/pallas_kernels.py:314"),
        "contacts": ("flingbot_tpu_torch/csrc/contacts.cu",
                     "flingbot_tpu/engine/pallas_kernels.py:563"),
        # the rest-pose filter of _contacts_kernel's mesh mode
        "contacts_mesh": ("flingbot_tpu_torch/csrc/contacts.cu",
                          "flingbot_tpu/engine/pallas_kernels.py:442"),
        # the one-substep launches of the aero loop
        "substeps_aero": ("flingbot_tpu_torch/csrc/substeps.cu",
                          "flingbot_tpu/engine/solver.py:637"),
        # cheb=False: the plain Jacobi loop of _substeps_kernel
        "substeps_jacobi": ("flingbot_tpu_torch/csrc/substeps.cu",
                            "flingbot_tpu/engine/pallas_kernels.py:229")}
    table = []
    for name in ("substeps", "contacts", "contacts_mesh", "substeps_aero",
                 "substeps_jacobi"):
        r = rows[name]
        table.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
        if "max_abs_err_by_output" in r:
            table[-1]["max_abs_err_by_output"] = r["max_abs_err_by_output"]
        assert all(isinstance(v, (int, float)) and math.isfinite(v)
                   for k, v in table[-1].items()
                   if k in ("ms", "plain_ms", "bound_ms", "max_abs_err"))
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
