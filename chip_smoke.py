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
     no-self-collision launch checked too; the task generator's launches
     (substeps at 30 iterations on the 104 lattice and, at 64 envs of
     112-127, on the 128 lattice; contacts at window 16 / 8 iterations on
     both); the mesh mode of the contacts kernel at the generic mesh
     path's shape (contacts_mesh_generic: the 16 shirts of the shirt eval
     set built as a MeshTopology padded to detect_mesh_caps' vertex
     capacity); the single env's launches (substeps_single,
     contacts_single: B = 1, one cloth of the hard eval set's first
     task's dims on the 104 lattice, at the main path's knobs); the
     solver-stage profiler's launches (substeps_profile, contacts_profile:
     64 full 100x100 cloths, one substep of 30 iterations, contacts 8 x
     window 16, the launches of phase 14 (a)); plus one
     aero frame of 4 of the grid kernels' compressed synthetic cloths on
     the card against the plain path on the CPU
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
     batch_value_maps -> a step whose fling runs 18 interpreter steps,
     the last 16 profiled as in phase 5, then the step's end (post
     coverage, termination, observation, replay record, reloads), launch
     counters zeroed before and read after (the whole fling ran here
     until phase 12 was added: the script keeps its time; the shirt eval
     job runs it, PERF.md); plus one frame of 4 of those shirts and one
     of 4 crumpled data/shirts/*.obj shirts on the card against the CPU
  7  the aero path: phase 4's start states with drag and lift set (an
     option of the solver; flingbot scenes run none): one frame of 4 envs
     on the card against the CPU, then reset -> batch_value_maps -> a
     step through the one-substep launches whose fling runs 18
     interpreter steps, the last 16 profiled, before the step's end (the
     whole fling ran here until phase 13 was added: the script keeps its
     time)
  8  the eval path: one frame of 4 of the hard eval set's tasks
     (data_r3/rect_eval_hard_100.npz) on the card against the CPU; then
     episodes of 2 steps on that set in 16 env slots under heuristic
     value maps, reloading finished slots, until 16 episodes are done;
     launch counters zeroed before and read after; the replay record's
     statistics printed as eval_quality's JSON line
  9  the train path: flingbot_tpu_torch.run_sim from the round-4
     checkpoint exported from the JAX package (runs/round4/latest_ckpt.npz;
     16 channels, 8 blocks, obs 64, 96 transforms) on the hard eval set,
     64 envs, episodes of 1 step, batch 64, 2 batches per update, D4
     augmentation, render 256: 2 rounds, both optimizing (3 rounds of
     2-step episodes at batch 128 until phase 12 was added);
     launch counters zeroed before and read after the phase; the saved
     checkpoint reloaded into a fresh policy gives bit-equal value maps;
     then one 16-env --eval round from it.  Prints each round's act /
     step / optimize seconds, ms per train step at batch 128, a profile of 3
     of them, s per dataset batch, and value-map inference ms at 64 envs
     x 96 transforms with and without test-time averaging
 10  the action-space path: 32 tasks of the hard eval set at production
     knobs through one BatchSimEnv.step with all four primitives (fling,
     stretchdrag, drag, place), seeded value maps steering env i to
     primitive i mod 4, launch counters zeroed before and read after;
     the same step replayed from its start, one interpreter step at a
     time, to see which envs' pickers held cloth (the last 16 steps
     profiled); then 2 rounds of run_sim.main with --action_primitives
     place drag and non-default observation knobs (grasp radius 2, no
     adaptive scaling, reach 1.0 m), counters zeroed before and read
     after.  Fails if a primitive is never selected or never grasps, if
     substeps or contacts never launch, or if a net is left untrained
 11  the task generation path: generate_tasks_batch makes 32 hard tasks on
     the 104 lattice and 16 large tasks (112-127 a side) on the 128
     lattice at the full schedule (sweep 200, hold 120, settle <= 300),
     launch counters zeroed before and read after each; both sets read
     back through TaskLoader; one 16-env heuristic eval step on the large
     tasks; profiles of 16 sweep and 16 settle frames at 100 envs on
     the 104 lattice and 64 on the 128 lattice.  Fails if a
     kernel never launches, a batch keeps no task, a coverage ratio
     falls outside (0, 1.2], or the read-back differs
 12  the generic mesh path and the xla backend: one frame of 4 shirts of
     the shirt eval set through the generic mesh step (a MeshTopology at
     detect_mesh_caps' bucket) on the card against the CPU; a BatchSimEnv
     of the 16 shirts on that bucket at production knobs: reset ->
     batch_value_maps -> a step of phase 6's kind (18 interpreter steps,
     16 profiled, then the step's end), launch counters zeroed before and
     read after; one frame of each xla
     contact mode (block, sweep, table, sort) with Gauss-Seidel springs
     on 4 tasks of the hard eval set on the card against the CPU, which
     must launch no kernel; one sequential shirt task (the generator of
     the shirt set, python -m flingbot_tpu_torch.generate_sets --sets
     shirt) at the full schedule from data/shirts, read back.  Fails if
     the mesh env never launches the contacts kernel, a frame disagrees,
     or the read-back differs
 13  the single-env path: (a) a SimEnv of the hard eval set's tasks at
     the production knobs (render 400, obs 64, 96 views) with
     dump_visualizations, driven by the round-4 checkpoint through
     MaximumValuePolicy.act: reset and 2 steps (an episode of 2 steps
     ends, on_episode_end writes its video), launch counters zeroed
     before and read after; the video read back with cv2; (b) the frames
     a step recorded rendered on the card into uint8 256 px frames, one
     held against its render on the CPU; (c) a recording BatchSimEnv step
     of 4 hard tasks, its programs cut to 400 sim steps before the
     settle, each env's recorded frames against the count its sim steps
     imply; (d) pyflex_compat: one hard task, 8 steps, a
     position round trip, render, and one frame on the card against the
     CPU.  Fails if a kernel never launches, a video or frame count
     disagrees, fewer than 2 rendered frames differ or a frame disagrees
 14  the last modules: (a) utils.profiling.profile_solver_stages at its
     defaults (64 envs of 100x100; JAX solver.step's defaults: 4 x 30
     Gauss-Seidel iterations, block contacts 8 x 16) with the card's name
     and power limit, every stage finite and full step [pallas] launching
     both kernels (counters zeroed before, read after: the
     substeps_profile and contacts_profile rows), and one trace()
     of a pallas step listing its kernels; (b) init_distributed at world
     1 over NCCL and one make_dp_train_step from the round-4 checkpoint at
     batch 128 of 4x64x64, bit-equal to train_on_batch in loss, weights
     and BatchNorm statistics (deterministic cuDNN), and both timed; (c)
     parallel.dryrun at world 1: 16 hard-set envs, 1-step episodes, the
     fling programs cut as in phase 13 (c), the replay read back, one dp
     step (counters zeroed before, read after: 16 envs at phase 4's
     knobs on the 104 lattice, counted in the substeps and contacts
     rows); (d) offline_train over
     phase 9's run directory, 4 batches of 64 saved every 2, the last
     checkpoint reloading bit-equal; (e) native: built with g++, the
     covered area of a settled hard task within 1e-6 m^2 of its numpy
     copy, load_cloth equal to the Python loader on a data/shirts OBJ; (f)
     a RealWorldEnv on real_world.fakes' rig (a 1024x1600 RGB-D frame, a
     recording UR5 pair and RG2 grippers): reset -> value_maps of the
     round-4 checkpoint -> step, the transformed obs on the card, an
     action within MIN_GRASP_WIDTH..MAX_GRASP_WIDTH, URScript received,
     the replay written.  The chip machine has one card, so the dp step
     and the dry run run at world 1; 2 ranks run on the CPU in the tests
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
       "contacts_mesh.xyz": 2e-6, "contacts_mesh_generic.xyz": 2e-6}
# the launches phase 2 adds hold to the bounds of their kind
for _kind in ("substeps_jacobi", "substeps_nocontact"):
    TOL.update({f"{_kind}.{k}": TOL[f"substeps.{k}"]
                for k in ("P", "prev", "V")})
for _kind in ("substeps_gen", "substeps_gen128", "substeps_single",
              "substeps_profile"):
    TOL.update({f"{_kind}.{k}": TOL[f"substeps.{k}"]
                for k in ("P", "prev", "V")})
for _kind in ("contacts_gen", "contacts_gen128", "contacts_single",
              "contacts_profile"):
    TOL[f"{_kind}.xyz"] = TOL["contacts.xyz"]
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
# 2 rounds of 1-step episodes at a training batch of 64, both optimizing,
# then an eval round of 16 envs (4 rounds before phase 10 was added, 3
# rounds of 2-step episodes at batch 128 and a 64-env eval round before
# phase 12: the script keeps its time); the layer timings stay at a batch
# of TRAIN_BATCH
TRAIN_ENVS, TRAIN_ROUNDS, TRAIN_LENGTH, TRAIN_BATCH = 64, 2, 1, 128
TRAIN_RUN_BATCH, TRAIN_EVAL_ENVS = 64, 16
AERO = dict(drag=8.0, lift=4.0, wind=(0.5, 0.0, -0.25))
ACTION_PRIMS = ("fling", "stretchdrag", "drag", "place")
# the replay's interpreter steps: drag and place grasp ~210 steps in,
# after their arm's 0.73 m to the pre-grasp point and 0.28 m down at
# 5e-3 m a step
ACTION_ENVS, ACTION_REPLAY_STEPS = 32, 320
SMOKE_ENVS = 128
# phase 12's profile of the generic-mesh env: 16 interpreter steps (64
# took 137 s on an H100 with host-side tracing, nearly all of it the
# profiler's own cost of ~3,000 launches a step)
MESH_PROFILE_STEPS = 16
# the task generator (phase 11): 32 hard tasks on the 104 lattice, 16
# large ones (112-127 a side) on the 128 lattice, in one batch each, at
# the full schedule; the large set's generator batch is 64 (phase 2's
# 128-lattice rows)
GEN_HARD, GEN_LARGE, GEN_CHUNK = 32, 16, 96
LARGE_DIM, LARGE_ENVS = 128, 64
# the generator batches of the hard and large sets: (envs, lattice,
# smallest and largest cloth side)
GEN_PROFILES = ((100, 104, 64, 104), (LARGE_ENVS, LARGE_DIM, 112, 128))
MAX_RATIO = 1.2  # initial coverage / flatten area of a generated task
BENCH_ENVS, BENCH_DIM, BENCH_STEPS, BENCH_WINDOWS = 512, 100, 20, 5
# the single-env path (phase 13): one episode of SINGLE_LENGTH steps, a
# recording BatchSimEnv step of SINGLE_BATCH envs, PYFLEX_STEPS
# pyflex_compat frames; a recorded frame's card render against the CPU
# within RENDER_TOL levels of 255 (the depth buffer is exact, shading
# differs in the last place: CUDA divides by a host scalar through its
# reciprocal)
SINGLE_LENGTH, SINGLE_BATCH, PYFLEX_STEPS, RENDER_TOL = 2, 4, 8, 1
# the recording BatchSimEnv step's programs stop after this many sim
# steps, then settle (the whole step took 22.37 s on an H100)
SINGLE_BATCH_PROGRAM = 400
# phase 14: the profiler at its defaults (flingbot_tpu/utils/profiling.py),
# the dry run's envs on the hard eval set
PROFILE_ENVS, PROFILE_DIM, DRYRUN_ENVS = 64, 100, 16
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


def covered_area_plain(positions: np.ndarray,
                       radius: float = 0.00625) -> float:
    """fb_covered_area in numpy, operation for operation (double
    arithmetic on the float32 coordinates, lround, the 100 x 100 grid
    indexed cx * 100 + cz with the reference's wrap of cz = 100): the plain
    version the native result is held against."""
    import numpy as np

    pos = np.asarray(positions, np.float32)
    if len(pos) == 0:
        return 0.0
    x = pos[:, 0].astype(np.float64)
    z = pos[:, 2].astype(np.float64)
    span_x = (x.max() - x.min()) / 100.0
    span_z = (z.max() - z.min()) / 100.0
    if span_x <= 0 or span_z <= 0:
        return 0.0

    def lround(v):  # half away from zero where it matters: v >= 0
        f = np.floor(v)
        return (f + (v - f >= 0.5)).astype(np.int64)

    ox, oz = x - x.min(), z - z.min()
    lo_x = np.maximum(lround((ox - radius) / span_x), 0)
    hi_x = np.minimum(lround((ox + radius) / span_x), 100)
    lo_z = np.maximum(lround((oz - radius) / span_z), 0)
    hi_z = np.minimum(lround((oz + radius) / span_z), 100)
    grid = np.zeros(10000, bool)
    for a, b, c, d in zip(lo_x, hi_x, lo_z, hi_z):
        idx = (np.arange(a, b + 1)[:, None] * 100
               + np.arange(c, d + 1)[None]).reshape(-1)
        grid[idx[idx < 10000]] = True
    return float(grid.sum() * span_x * span_z)


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
    for H in (104, BENCH_DIM, LARGE_DIM):
        band, smem = kernels.substeps_band(H, H)
        n = kernels.substeps_max_clusters(device.index or 0, smem)
        log(f"  substeps at {H}x{H}, cluster of {kernels.SUBSTEPS_CLUSTER} "
            f"CTAs: band {band} rows, {smem} B shared memory per CTA, "
            f"cudaOccupancyMaxActiveClusters {n}")


def synthetic_inputs(B, H, W, gen, device, full=False, lo=64, size=None):
    """Wrinkled, compressed cloths (so contacts fire) of seeded dims in
    lo..H (full: H x W; size: this (dimx, dimy) for every env), an active
    picker touching each, seeded velocities."""
    import torch

    from flingbot_tpu_torch.engine.solver import pack_sub_params
    from flingbot_tpu_torch.engine.state import SolverParams
    from flingbot_tpu_torch.engine.topology import (
        build_grid_topology, lattice_valid)

    dims = torch.randint(lo, H + 1, (B, 2), generator=gen)
    if full:
        dims = torch.tensor([[W, H]] * B)
    if size is not None:
        dims = torch.tensor([list(size)] * B)
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

    # contacts on the Morton-sorted state the substeps left behind, at
    # the env's knobs and at the generator's (window 16, 8 iterations:
    # halo 128)
    rows["contacts"], moved = kernel_contacts(
        "contacts", out_k, w, valid, dims, err, window=12, iterations=4)
    rows["contacts_gen"], _ = kernel_contacts(
        "contacts_gen", out_k, w, valid, dims, err, window=16, iterations=8)
    # the generator's substeps (30 iterations) on the 104 lattice, and on
    # the large set's 128 lattice at its batch (64 envs of 112-127)
    rows["substeps_gen"], _ = kernel_substeps(
        "substeps_gen", pvec, P, V, w, dims, err,
        dict(n_sub=2, iterations=30, picker_last=False))
    _, lpvec, lP, lV, lw, lvalid, _ = synthetic_inputs(
        LARGE_ENVS, LARGE_DIM, LARGE_DIM, gen, device, lo=112)
    ldims = [(int(v[0]), int(v[1])) for v in
             lpvec[:, 10:12].to(torch.int64).tolist()]
    rows["substeps_gen128"], lout = kernel_substeps(
        "substeps_gen128", lpvec, lP, lV, lw, ldims, err,
        dict(n_sub=2, iterations=30, picker_last=False))
    rows["contacts_gen128"], _ = kernel_contacts(
        "contacts_gen128", lout, lw, lvalid, ldims, err, window=16,
        iterations=8)
    del lP, lV, lw, lout
    # the single env's launches (SimEnv, phase 13): B = 1, one cloth of
    # the hard eval set's first task's dims, on the 104 lattice
    from flingbot_tpu_torch.env.tasks import TaskLoader

    size = tuple(int(v) for v in TaskLoader(
        os.path.join(ROOT, RECT_TASKS)).get_next_task().cloth_size)
    _, spvec, sP, sV, sw, svalid, _ = synthetic_inputs(1, H, W, gen, device,
                                                       size=size)
    rows["substeps_single"], sout = kernel_substeps(
        "substeps_single", spvec, sP, sV, sw, [size], err,
        dict(n_sub=2, iterations=16, picker_last=False))
    rows["contacts_single"], _ = kernel_contacts(
        "contacts_single", sout, sw, svalid, [size], err, window=12,
        iterations=4)
    # the solver-stage profiler's full step [pallas] (phase 14 (a),
    # tasks.SEQ_SIM_KW): a frame is 4 one-substep launches of 30
    # iterations, each followed by contacts 8 x window 16, on
    # PROFILE_ENVS full PROFILE_DIM x PROFILE_DIM cloths
    _, ppvec, pP, pV, pw, pvalid, _ = synthetic_inputs(
        PROFILE_ENVS, PROFILE_DIM, PROFILE_DIM, gen, device, full=True)
    pdims = [(PROFILE_DIM, PROFILE_DIM)] * PROFILE_ENVS
    rows["substeps_profile"], pout = kernel_substeps(
        "substeps_profile", ppvec, pP, pV, pw, pdims, err,
        dict(n_sub=1, iterations=30, picker_last=False))
    rows["contacts_profile"], _ = kernel_contacts(
        "contacts_profile", pout, pw, pvalid, pdims, err, window=16,
        iterations=8)
    del pP, pV, pw, pout
    rows.update(kernel_mesh(device, err))
    rows.update(kernel_mesh_generic(device, err))
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
    if not moved > 0 or not all(rows[k]["moved"] > 0 for k in (
            "contacts_mesh", "contacts_mesh_generic")):
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


def kernel_contacts(name, out_sub, w, valid, dims, err, *, window,
                    iterations):
    """The grid mode of the contacts kernel against its plain version on
    the Morton-sorted state that a substeps launch left behind
    (out_sub = (P, V, prev)): max abs error into err, CUDA-event times
    and the bound.  Returns (row, how far the kernel moved particles)."""
    import torch

    from flingbot_tpu_torch.engine import collisions, kernels
    from flingbot_tpu_torch.engine.state import SolverParams

    params = SolverParams()
    Pn, _, prev = out_sub
    B, _, H, W = Pn.shape
    _, srt = collisions.sort_particles(
        Pn.reshape(B, 3, -1), prev.reshape(B, 3, -1), w.reshape(B, -1),
        valid.reshape(B, -1), rest_dist=params.radius, lattice_w=W)
    cp = collisions.contact_params(params, params.radius, B, Pn.device)
    kw = dict(window=window, iterations=iterations)
    out_k = kernels.contacts(cp, *srt, **kw)
    out_p = kernels.contacts_plain(cp, *srt, **kw)
    torch.cuda.synchronize()
    err[f"{name}.xyz"] = max(float((a - b).abs().max())
                             for a, b in zip(out_k, out_p))
    moved = max(float((a - s).abs().max()) for a, s in zip(out_k, srt))
    ms_k = cuda_ms(lambda: kernels.contacts(cp, *srt, **kw), 10)
    ms_p = cuda_ms(lambda: kernels.contacts_plain(cp, *srt, **kw), 3)
    b_ms, b_by = bound(*contacts_work([dx * dy for dx, dy in dims], H * W,
                                      window, iterations))
    log_tiles(name, B, H * W, **kw)
    return dict(max_abs_err=err[f"{name}.xyz"], ms=ms_k, plain_ms=ms_p,
                bound_ms=b_ms, bound_by=b_by, B=B), moved


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

    topo, state = shirt_batch(device)
    P0 = state.positions.clone()
    P0[:, 0] *= 0.4
    P0[:, 2] *= 0.4
    P0[:, 1] += 0.01 * torch.sin(P0[:, 0] * 150.0) + 0.02
    state = state.replace(positions=torch.where(state.active[:, None], P0,
                                                state.positions))
    row = mesh_contacts_row("contacts_mesh", state, topo, err, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if row["blocks"] < sms:
        raise AssertionError(f"the shirt path's contacts leave SMs idle "
                             f"({sms} SMs)")
    log(f"  shirts: lattice {topo.H}x{topo.W} ({state.num_particles} "
        f"slots), {len(topo.offsets)} spring classes")
    return {"contacts_mesh": row}


def generic_mesh_batch(device, n=None):
    """The first n (all) shirts of the shirt eval set through the generic
    mesh path: a MeshTopology at detect_mesh_caps' bucket."""
    from flingbot_tpu_torch.env.scene import make_batch, scene_task
    from flingbot_tpu_torch.env.tasks import TaskLoader, detect_mesh_caps

    path = os.path.join(ROOT, SHIRT_TASKS)
    caps = detect_mesh_caps(path)
    loader = TaskLoader(path)
    n = n or len(loader)
    topo, state = make_batch([scene_task(loader.get_next_task())
                              for _ in range(n)], mesh_caps=caps,
                             device=device)
    return topo, state, caps


def kernel_mesh_generic(device, err):
    """The mesh mode of the contacts kernel at the generic mesh path's
    shape: the 16 eval-set shirts (crumpled file states) padded to the
    bucket's vertex capacity, one mesh frame, Morton-sorted with their
    rest coordinates."""
    topo, state, caps = generic_mesh_batch(device)
    row = mesh_contacts_row("contacts_mesh_generic", state, topo, err,
                            device)
    log(f"  generic mesh bucket {caps} (verts, edges, tris): "
        f"{topo.nbr_idx.shape[1]} incidence slots per vertex")
    return {"contacts_mesh_generic": row}


def mesh_contacts_row(name, state, topo, err, device):
    """The contacts kernel's mesh mode against its plain version on the
    Morton-sorted state one frame of `state` leaves behind: max abs error
    into err, CUDA-event times, the bound and the block count."""
    import torch

    from flingbot_tpu_torch.engine import collisions, kernels
    from flingbot_tpu_torch.engine.solver import step
    from flingbot_tpu_torch.engine.state import SolverParams

    params = SolverParams()
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
    err[f"{name}.xyz"] = max(float((a - b).abs().max())
                             for a, b in zip(out_k, out_p))
    shift = max(float((a - b).abs().max()) for a, b in zip(out_k, srt))
    ms_k = cuda_ms(lambda: kernels.contacts(cp, *srt[:7], **kw), 10)
    ms_p = cuda_ms(lambda: kernels.contacts_plain(cp, *srt[:7], **kw), 3)
    n_active = state.active.sum(1).tolist()
    b_ms, b_by = bound(*contacts_work(n_active, N, 12, 4, mesh=True))
    blocks = log_tiles(name, B, N, window=12, iterations=4)
    log(f"  {name}: {min(n_active)}-{max(n_active)} vertices of {N} "
        f"slots; mesh contacts moved particles by up to {shift:.3e} m")
    return dict(max_abs_err=err[f"{name}.xyz"], ms=ms_k, plain_ms=ms_p,
                bound_ms=b_ms, bound_by=b_by, B=B, moved=shift,
                blocks=blocks)


def frame_check(state, topo, params, what, ill_conditioned=False, **kw):
    """One solver frame of 4 envs on the card against the plain path on
    the CPU: max |dP| within FRAME_TOL, coverage to 6 digits.  For inputs
    marked ill_conditioned, a frame that misses FRAME_TOL passes if it
    stays within NOISE_FACTOR times the frame's own spread: how far the
    CPU frame moves when the active positions carry a seeded relative
    noise of NOISE; its coverage then within NOISE_FACTOR times the
    coverage spread that noise makes (the most of any env) beside the 6
    digits.  kw override the SOLVER step keywords."""
    import torch

    from flingbot_tpu_torch.engine.solver import step
    from flingbot_tpu_torch.env.coverage import get_current_covered_area

    kw = dict(SOLVER, **kw)
    sub = torch.arange(min(4, state.batch), device=state.device)
    st4, tp4 = state.index(sub).to("cpu"), topo.index(sub).to("cpu")
    gpu = step(st4.to(state.device), tp4.to(state.device), params, **kw)
    cpu = step(st4, tp4, params, **kw)
    err = float((gpu.positions.cpu() - cpu.positions).abs().max())
    cov_g = get_current_covered_area(gpu.positions, gpu.active).cpu()
    cov_c = get_current_covered_area(cpu.positions, cpu.active)
    tol, cov_tol = FRAME_TOL, 1e-6 * cov_c.abs()
    note = "inside FRAME_TOL" if err < FRAME_TOL else "outside FRAME_TOL"
    if ill_conditioned and not err < FRAME_TOL:
        P = st4.positions
        noisy = P * (1 + NOISE * torch.randn(
            P.shape, generator=torch.Generator().manual_seed(0)))
        cpu_n = step(st4.replace(positions=torch.where(
            st4.active[:, None], noisy, P)), tp4, params, **kw)
        spread = float((cpu_n.positions - cpu.positions).abs().max())
        cov_spread = float((get_current_covered_area(
            cpu_n.positions, cpu_n.active) - cov_c).abs().max())
        tol = NOISE_FACTOR * spread
        cov_tol = cov_tol + NOISE_FACTOR * cov_spread
        note = (f"the CPU frame moves {spread:.3e} m, its coverage "
                f"{cov_spread:.3e} m^2, under {NOISE:.0e} relative input "
                "noise")
    log(f"  one frame, 4 envs ({what}), card vs CPU plain path: max |dP| "
        f"{err:.3e} m ({note}); coverage {cov_g.tolist()} vs "
        f"{cov_c.tolist()}")
    if not (err < FRAME_TOL or err <= tol):
        raise AssertionError(f"card frame disagrees with the CPU: {err} "
                             f">= {FRAME_TOL} and > {tol}")
    if not bool(((cov_g - cov_c).abs() <= cov_tol).all()):
        raise AssertionError(f"card coverage disagrees with the CPU: "
                             f"{cov_g.tolist()} vs {cov_c.tolist()}")
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


def drive_path(start, device, kernels_of_path, params=None, steps=None,
               **env_kw):
    """reset -> batch_value_maps -> step of a BatchSimEnv at production
    knobs, from start = (state, topo) or, with start (), from its task
    source; launch counters zeroed just before and read just after; fails
    if a kernel of the path never launched or a result is not finite.
    With `steps`, the step's programs run only 2 + `steps` interpreter
    steps, the last `steps` profiled (profile_program), before the rest of
    the step (BatchSimEnv.end_step: post coverage, termination, the next
    observation, the replay record and reloads): the whole fling of a
    shirt batch costs 90-120 s of host launches (PERF.md section 5)."""
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
    if steps is None:
        obs = env.step(vm)
        what = "step"
    else:
        begun, carry = profile_program(env, vm, steps)
        if not bool(torch.isfinite(carry.state.positions).all()):
            raise AssertionError("non-finite positions after the profile")
        obs = env.end_step(begun, carry, 2)
        what = f"{steps + 2} interpreter steps and the step's end"
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
    sim = last.sim_steps.cpu().float()
    log(f"  reset {s_reset:.2f} s, value maps {s_policy:.2f} s, {what} "
        f"{s_step:.2f} s ({last.chunks} chunks)")
    log(f"  sim steps per env: mean {sim.mean():.1f} max {sim.max():.0f}")
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
    TaskLoader and detect_topology_buckets: reset, value maps, 18
    interpreter steps of their fling (16 profiled) and the step's end
    (drive_path)."""
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
    launches, env, _ = drive_path((), device, ("contacts_mesh",),
                                  steps=16, **env_kw)
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


def phase_train(device, keep_dir=None):
    """The train path through run_sim.main: TRAIN_ROUNDS rounds from the
    round-4 checkpoint on the hard eval set, then the checkpoint it saved
    reloaded and one --eval round from it; launch counters zeroed before
    and read after.  Returns the launches.  With keep_dir, the run's log
    directory (args.pkl, the replay directory, latest_ckpt.pth) is moved
    there for phase 14's offline training."""
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
            "--log", log_dir, "--load", ckpt0, "--episode_length",
            str(TRAIN_LENGTH),
            "--warmup", "0", "--batch_size", str(TRAIN_RUN_BATCH),
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
                               "--episode_length", "1", "--num_envs",
                               str(TRAIN_EVAL_ENVS)], max_rounds=1)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        replay = os.path.join(log_dir, "latest_ckpt_eval_0", "replay_buffer")
        n_eval = len(step_keys(replay))
        log(f"  eval round: {n_eval} episodes in {replay} in "
            f"{time.perf_counter() - t0:.2f} s; launches in the phase "
            f"{launches}")
        if n_eval != TRAIN_EVAL_ENVS:
            raise AssertionError(f"the eval round wrote {n_eval} episodes")
        if keep_dir is not None:
            import shutil

            shutil.move(log_dir, keep_dir)
    for name in ("substeps", "contacts"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched on the "
                                 "train path")
    return launches


def phase_action_space(device):
    """The action-space path: one BatchSimEnv.step of ACTION_ENVS hard
    tasks with all four primitives, env i steered to primitive i mod 4;
    a replay of that step from its start state tracking which pickers
    held cloth; then 2 run_sim rounds training a place and a drag net
    with non-default observation knobs.  Returns the launches of both
    parts."""
    import tempfile

    import torch

    from flingbot_tpu_torch import run_sim
    from flingbot_tpu_torch.engine import kernels
    from flingbot_tpu_torch.env.batch_env import BatchSimEnv
    from flingbot_tpu_torch.env.primitives import (
        STABLE_MAX_STEPS, program_chunk)
    from flingbot_tpu_torch.env.sim_env import step_begin
    from flingbot_tpu_torch.env.tasks import (
        TaskLoader, detect_topology_buckets)

    path = os.path.join(ROOT, RECT_TASKS)
    B, P = ACTION_ENVS, len(ACTION_PRIMS)
    env = BatchSimEnv(
        get_task_fn=TaskLoader(path).get_next_task, num_envs=B,
        action_primitives=ACTION_PRIMS, **detect_topology_buckets(path),
        render_dim=256, chunk_steps=192, scale_factors=SCALES,
        device=device, **SOLVER)
    obs = env.reset()
    gen = torch.Generator(device).manual_seed(0)
    vm = torch.rand((B, P, obs.shape[1], 64, 64), generator=gen,
                    device=device)
    ar = torch.arange(B, device=device)
    vm[ar, ar % P] += 10.0
    start = (env.state, env.topo, env.obs)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    env.step(vm)
    torch.cuda.synchronize()
    s_step = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    last = env.last
    prim = last.selection.prim_idx.cpu()
    steps = last.sim_steps.cpu()
    term = last.terminate.cpu()
    for name, x in (("obs", env.obs.obs_stack),
                    ("positions", env.state.positions),
                    ("post coverage", last.post_coverage)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite {name}")
    log(f"  one step of {B} envs, {P} primitives: {s_step:.2f} s "
        f"({last.chunks} chunks of {env.chunk_steps}); launches {launches}")

    # the same step from its start, one interpreter step at a time: which
    # envs' pickers held a particle (kernels are deterministic, so the
    # replay selects and runs the same programs); its last 16 steps
    # profiled
    state, topo, obs0 = start
    sel, _, _, carry, prog = step_begin(
        state, vm, obs0, env.rotations, env.prim_cfg, env.pix_grasp_dist,
        env.action_primitives, env.pix_drag_dist, env.pix_place_dist)
    if not torch.equal(sel.prim_idx.cpu(), prim):
        raise AssertionError("the replay selected other primitives")
    kw = dict(chunk_steps=1, sim_kw=env.sim_kw,
              max_steps=env.prim_cfg.max_program_steps + STABLE_MAX_STEPS)
    held = torch.zeros(B, dtype=torch.bool, device=device)

    def replay(n):
        nonlocal carry, held
        for _ in range(n):
            carry, _ = program_chunk(carry, topo, env.params, prog, **kw)
            held |= (carry.state.picked_idx >= 0).any(1)

    replay(ACTION_REPLAY_STEPS - 16)
    torch.cuda.synchronize()
    profile_steps(lambda: replay(16), 16,
                  f"16 interpreter steps of {P} primitives at B={B}")
    held = held.cpu()
    for p, name in enumerate(ACTION_PRIMS):
        mine = prim == p
        if not mine.any():
            raise AssertionError(f"{name} was never selected")
        s = steps[mine].float()
        log(f"  {name}: {int(mine.sum())} envs, {int(held[mine].sum())} "
            f"held cloth within {ACTION_REPLAY_STEPS} steps, "
            f"{int(term[mine].sum())} terminated; program sim steps mean "
            f"{s.mean():.1f} min {s.min():.0f} max {s.max():.0f}")
        if not held[mine].any():
            raise AssertionError(f"{name} never grasped the cloth")
    for name in ("substeps", "contacts"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched on the "
                                 "action-space path")

    # 2 training rounds of a place and a drag net; uniform value maps
    # (value exploration 1) pick each env's primitive at random
    with tempfile.TemporaryDirectory(suffix="_train") as tmp:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        policy, history = run_sim.main([
            "--tasks", path, "--num_envs", str(B), "--render_dim", "256",
            "--chunk_steps", "192", "--seed", "0", "--device", str(device),
            "--log", os.path.join(tmp, "train"), "--episode_length", "1",
            "--warmup", "0", "--batch_size", "8", "--value_expl_prob", "1",
            "--value_expl_decay", "1", "--action_primitives", "place",
            "drag", "--conservative_grasp_radius", "2",
            "--no-use_adaptive_scaling", "--reach_distance_limit", "1.0"],
            max_rounds=2)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        trained = dict(kernels.LAUNCHES)
    for r in history:
        log(f"  round {r['round']}: act {r['act']:.3f} s, step "
            f"{r['step']:.3f} s, optimize {r['optimize']}; replay "
            f"{r['dataset_size']} steps; losses {r['losses']}")
    steps_by_net = {k: ns.steps for k, ns in policy.nets.items()}
    log(f"  2 rounds in {seconds:.2f} s; train steps {steps_by_net}; "
        f"launches {trained}")
    for name, n in steps_by_net.items():
        if n < 1:
            raise AssertionError(f"the {name} net was left untrained")
    losses = [v for r in history for v in r["losses"].values()]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    for name in ("substeps", "contacts"):
        if trained[name] <= 0:
            raise AssertionError(f"{name} kernel never launched in the "
                                 "place / drag training rounds")
        launches[name] += trained[name]
    return launches


def phase_generate(device):
    """The task generation path: generate_tasks_batch (the entry point of
    python -m flingbot_tpu_torch.env.tasks and of generate_sets) makes
    GEN_HARD hard tasks on the 104 lattice and GEN_LARGE large tasks on
    the 128 lattice at the full schedule into a temporary directory,
    launch counters zeroed before and read after each; each set read back
    through TaskLoader (every task's coverage recomputed from its stored
    particles equals its stored initial coverage); then one GEN_LARGE-env
    heuristic eval step on the large tasks, counters zeroed before and
    read after; then profiles of 16 sweep frames and 16 settle frames at
    each of GEN_PROFILES.
    Fails if a kernel never launched, a batch kept no task, a task's
    coverage ratio falls outside (0, MAX_RATIO], or the read-back
    differs."""
    import contextlib
    import io
    import re
    import tempfile

    import numpy as np
    import torch

    from flingbot_tpu_torch.engine import kernels
    from flingbot_tpu_torch.engine.state import SolverParams
    from flingbot_tpu_torch.env import tasks
    from flingbot_tpu_torch.env.batch_env import BatchSimEnv
    from flingbot_tpu_torch.env.coverage import get_current_covered_area
    from flingbot_tpu_torch.env.scene import make_batch, scene_task
    from flingbot_tpu_torch.eval_quality import heuristic_value_maps
    from flingbot_tpu_torch.generate_sets import SETS, set_stats

    launches = {}
    params = SolverParams(dynamic_friction=tasks.GEN_FRICTION)
    with tempfile.TemporaryDirectory(suffix="_tasks") as out:
        for name, num, row in (("hard", GEN_HARD, "gen"),
                               ("large", GEN_LARGE, "gen128")):
            _, _, diff, mins, maxs, strict, grid, seed = SETS[name]
            path = os.path.join(out, f"{name}.npz")
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                tasks.generate_tasks_batch(
                    path, num, batch=num, seed=seed, min_cloth_size=mins,
                    max_cloth_size=maxs, strict_min_edge_length=strict,
                    task_difficulty=diff, max_grid_dim=grid,
                    backend="pallas", contact_mode="sort",
                    chunk_steps=GEN_CHUNK, solver_params=params,
                    device=device)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[f"substeps_{row}"] = kernels.LAUNCHES["substeps"]
            launches[f"contacts_{row}"] = kernels.LAUNCHES["contacts"]
            for line in text.getvalue().splitlines():
                log(f"  {line}")
            kept = [int(k) for k in re.findall(r"\((\d+) of \d+ kept",
                                               text.getvalue())]
            stats = set_stats(path)
            log(f"  {name}: {stats['n']} tasks on the {grid} lattice in "
                f"{seconds:.2f} s; {json.dumps(stats)}; launches "
                f"substeps {launches[f'substeps_{row}']} contacts "
                f"{launches[f'contacts_{row}']}")
            if not kept or min(kept) == 0 or stats["n"] != num:
                raise AssertionError(f"{name}: a batch kept no task {kept}")
            for k in ("substeps", "contacts"):
                if launches[f"{k}_{row}"] <= 0:
                    raise AssertionError(f"{k} kernel never launched in "
                                         f"the {name} generator")
            loader = tasks.TaskLoader(path)
            read = [loader.get_next_task() for _ in range(len(loader))]
            ratios = np.array([t.initial_coverage / t.flatten_area
                               for t in read])
            if not ((ratios > 0) & (ratios <= MAX_RATIO)).all():
                raise AssertionError(f"{name}: coverage ratios {ratios}")
            _, state = make_batch([scene_task(t) for t in read],
                                  max_grid_dim=grid, device=device)
            cov = get_current_covered_area(state.positions,
                                           state.active).cpu().numpy()
            stored = np.array([t.initial_coverage for t in read],
                              np.float32)
            if not (np.array_equal(cov, stored)
                    and bool(torch.isfinite(state.positions).all())):
                raise AssertionError(f"{name}: the read-back differs")
        # one heuristic eval step on the generated large tasks
        env = BatchSimEnv(get_task_fn=loader.get_next_task,
                          num_envs=GEN_LARGE, max_grid_dim=LARGE_DIM,
                          render_dim=256, chunk_steps=192,
                          scale_factors=SCALES, device=device, **SOLVER)
        loader.curr_task_idx = 0
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        obs = env.step(heuristic_value_maps(env.reset()))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for k in ("substeps", "contacts"):
            launches[k] = kernels.LAUNCHES[k]
            if launches[k] <= 0:
                raise AssertionError(f"{k} kernel never launched in the "
                                     "eval step on the 128 lattice")
        last = env.last
        log(f"  eval step, {GEN_LARGE} generated large tasks on the "
            f"{LARGE_DIM} lattice: reset + step {seconds:.2f} s; coverage "
            f"pre {last.pre_coverage.mean():.5f} post "
            f"{last.post_coverage.mean():.5f} m^2; launches "
            f"{dict(kernels.LAUNCHES)}")
        if not bool(torch.isfinite(obs).all()):
            raise AssertionError("non-finite observation")
    # sweep frames 16-31 of each set's batch, then 16 settle frames from
    # there
    sweep = tasks.SCHEDULES["hard"][0]
    for B, grid, lo, hi in GEN_PROFILES:
        draw = tasks.draw_batch(np.random.default_rng(0), B, lo, hi, lo,
                                "hard", 10)
        topo, state = tasks.flat_batch(draw, grid, device)
        slot = tasks.lattice_slot(torch.tensor(draw.picks, device=device),
                                  topo.dimx, grid)
        p0 = torch.tensor(np.stack(draw.starts), device=device)
        p1 = torch.tensor(np.stack(draw.targets), device=device)
        kw = dict(params=params, sim_kw=tasks.GEN_SIM_KW)
        saved_w = state.inv_mass[torch.arange(B, device=device), slot]
        state = tasks.anchored_chunk(
            tasks.set_inv_mass(state, slot, torch.zeros_like(saved_w)),
            topo, slot, p0, p1, 0, n_steps=16, sweep_steps=sweep, **kw)
        released = tasks.set_inv_mass(state, slot, saved_w)
        k = torch.zeros(B, dtype=torch.int64, device=device)
        profile_steps(lambda: tasks.anchored_chunk(
            state, topo, slot, p0, p1, 16, n_steps=16, sweep_steps=sweep,
            **kw), 16, f"16 sweep frames at B={B} on {grid}")
        profile_steps(lambda: tasks.settle_chunk(
            released, topo, k, n_steps=16, max_settle=300,
            tol=tasks.SETTLE_TOL, **kw), 16,
            f"16 settle frames at B={B} on {grid}")
    return launches


def phase_generic_mesh(device):
    """The generic mesh path and the xla backend (see the module
    docstring, phase 12).  Returns the contacts kernel's launches on the
    generic-mesh env's drive."""
    import random
    import tempfile

    import numpy as np
    import torch

    from flingbot_tpu_torch.engine import kernels
    from flingbot_tpu_torch.engine.state import SolverParams
    from flingbot_tpu_torch.engine.topology import MeshTopology
    from flingbot_tpu_torch.env import tasks
    from flingbot_tpu_torch.env.coverage import get_current_covered_area
    from flingbot_tpu_torch.env.scene import make_batch, scene_task

    params = SolverParams()
    t0 = time.perf_counter()
    topo, state, caps = generic_mesh_batch(device, 4)
    frame_check(state, topo, params, "generic-mesh eval-set shirts",
                ill_conditioned=True)
    log(f"  generic-mesh frame check: {time.perf_counter() - t0:.2f} s")
    loader = tasks.TaskLoader(os.path.join(ROOT, SHIRT_TASKS))
    launches, env, _ = drive_path(
        (), device, ("contacts_mesh",), steps=MESH_PROFILE_STEPS,
        get_task_fn=loader.get_next_task, num_envs=len(loader),
        mesh_caps=caps)
    if not isinstance(env.topo, MeshTopology):
        raise AssertionError("the mesh_caps env is not on the mesh path")

    # the xla backend's contact modes with Gauss-Seidel springs
    rect = tasks.TaskLoader(os.path.join(ROOT, RECT_TASKS))
    topo, state = make_batch([scene_task(rect.get_next_task())
                              for _ in range(4)], device=device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for mode in ("block", "sweep", "table", "sort"):
        t0 = time.perf_counter()
        frame_check(state, topo, params, f"xla backend, gs springs, {mode} "
                    "contacts, hard eval-set tasks", ill_conditioned=True,
                    backend="xla", contact_mode=mode, spring_mode="gs")
        log(f"  xla {mode}: frame check in {time.perf_counter() - t0:.2f} s")
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"the xla backend launched a kernel: "
                             f"{kernels.LAUNCHES}")

    # one sequential shirt task, as the shirt set makes them
    with tempfile.TemporaryDirectory(suffix="_shirt") as out:
        path = os.path.join(out, "shirt.npz")
        random.seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tasks.generate_tasks(
            path, 1, seed=500, task_difficulty="hard", cloth_type="mesh",
            cloth_mesh_path=os.path.join(ROOT, "data", "shirts"),
            params=SolverParams(dynamic_friction=tasks.GEN_FRICTION),
            device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        task = tasks.TaskLoader(path).get_next_task()
        seq_caps = tasks.detect_mesh_caps(path)
        _, st = make_batch([scene_task(task)], mesh_caps=seq_caps,
                           device=device)
        cov = float(get_current_covered_area(st.positions, st.active)[0])
        ratio = task.initial_coverage / task.flatten_area
        log(f"  one sequential shirt task ({task.mesh_verts.size // 3} "
            f"vertices, bucket {seq_caps}) in {seconds:.2f} s: coverage "
            f"{task.initial_coverage:.5f} m^2, ratio {ratio:.4f}")
        if not (0 < ratio <= MAX_RATIO and np.float32(cov)
                == np.float32(task.initial_coverage)
                and bool(torch.isfinite(st.positions).all())):
            raise AssertionError("the sequential shirt task's read-back "
                                 "differs")
    return launches["contacts_mesh"]


def read_video(path: str) -> int:
    """Frames of a video, counted by decoding them."""
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def phase_single_env(device):
    """The single-env path (see the module docstring, phase 13): a SimEnv
    episode with its video, its recorded frames rendered on the card and
    held against the CPU, a recording BatchSimEnv step, and
    pyflex_compat.  Returns the kernels' launches of the SimEnv episode.
    The card machine has cv2 (4.13.0, with a VP9 webm writer): the
    videos are written and read back."""
    import tempfile

    import numpy as np
    import torch

    from flingbot_tpu_torch import pyflex_compat as pyflex
    from flingbot_tpu_torch.engine import kernels
    from flingbot_tpu_torch.engine.state import SolverParams
    from flingbot_tpu_torch.env.batch_env import BatchSimEnv
    from flingbot_tpu_torch.env.sim_env import (
        SimEnv, render_frames, video_dir)
    from flingbot_tpu_torch.env.tasks import SEQ_SIM_KW, TaskLoader
    from flingbot_tpu_torch.learning.nets import MaximumValuePolicy
    from flingbot_tpu_torch.utils.checkpoint import load_checkpoint

    path = os.path.join(ROOT, RECT_TASKS)
    production = dict(backend="pallas", spring_mode="chebyshev",
                      contact_mode="sort", **SOLVER)
    policy = MaximumValuePolicy(["fling"], 64, device=device)
    load_checkpoint(os.path.join(ROOT, ROUND4_CKPT), policy)
    with tempfile.TemporaryDirectory(suffix="_single") as tmp:
        # (a) one episode of SINGLE_LENGTH steps
        replay = os.path.join(tmp, "replay")
        env = SimEnv(TaskLoader(path).get_next_task,
                     replay_buffer_path=replay, scale_factors=SCALES,
                     episode_length=SINGLE_LENGTH, dump_visualizations=True,
                     device=device, **production)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        obs = env.reset()
        torch.cuda.synchronize()
        log(f"  reset {time.perf_counter() - t0:.2f} s; init coverage "
            f"{env.init_coverage:.5f} m^2; obs {tuple(obs.shape)}")
        # frames recorded per step of the first episode; the list a step
        # leaves behind when its episode goes on
        episode, first_episode, chunks = [], None, None
        for k in range(SINGLE_LENGTH):
            t0 = time.perf_counter()
            obs = env.step(policy.act([obs])[0])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            last = env.env.last
            sim = int(last.sim_steps[0])
            frames = min(-(-sim // env.record_every), env.record_frames)
            episode.append(frames)
            if env.current_timestep == 0:  # the episode ended
                if first_episode is None:
                    first_episode = sum(episode)
                episode = []
            else:
                chunks = [c.copy() for c in env.env.frames[0]]
            log(f"  step {k}: {seconds:.2f} s, {sim} sim steps, {frames} "
                f"frames recorded, reward "
                f"{float(last.post_coverage[0] - last.pre_coverage[0]):+.5f}"
                f" m^2, terminate {bool(last.terminate[0])}, episodes "
                f"{env.episode_count}")
            if not bool(torch.isfinite(obs).all()):
                raise AssertionError("non-finite observation")
        launches = dict(kernels.LAUNCHES)
        log(f"  launches of the episode: {launches}")
        for name in ("substeps", "contacts"):
            if launches[name] <= 0:
                raise AssertionError(f"{name} kernel never launched by "
                                     "SimEnv")
        if env.episode_count < 1:
            raise AssertionError("no episode ended")
        video = os.path.join(video_dir(replay), "000000000.webm")
        n_video = read_video(video)
        log(f"  episode video: {n_video} frames ({os.path.getsize(video)} "
            f"B), {first_episode} recorded; replay steps "
            f"{len(os.listdir(replay))}")
        if n_video != first_episode or n_video <= 0:
            raise AssertionError("the episode video lacks frames")

        # (b) recorded frames rendered on the card, one against the CPU
        if chunks is None:
            raise AssertionError("no step left its frames in the list")
        positions = np.concatenate(chunks)
        if not np.isfinite(positions).all():
            raise AssertionError("non-finite recorded positions")
        active = env.state.active[0]
        palette = tuple(p[0] for p in env.env.palette)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb = render_frames(positions, active, palette)
        torch.cuda.synchronize()
        s_render = time.perf_counter() - t0
        cpu = render_frames(positions[:1], active.cpu(),
                            tuple(p.cpu() for p in palette))
        diff = int(np.abs(rgb[:1].astype(np.int16) - cpu).max())
        distinct = len({f.tobytes() for f in rgb})
        log(f"  rendered {len(rgb)} frames {rgb.shape[1:]} on the card in "
            f"{s_render:.3f} s ({distinct} distinct); frame 0 card vs CPU "
            f"max |d| {diff} of 255 (tolerance {RENDER_TOL})")
        if distinct < 2 or diff > RENDER_TOL:
            raise AssertionError("the recorded frames render wrongly")

        # (c) a recording BatchSimEnv step
        benv = BatchSimEnv(
            get_task_fn=TaskLoader(path).get_next_task,
            num_envs=SINGLE_BATCH, replay_buffer_path=os.path.join(
                tmp, "batch", "replay"), episode_length=2,
            render_dim=256, scale_factors=SCALES, chunk_steps=192,
            max_program_steps=SINGLE_BATCH_PROGRAM,
            dump_visualizations=True, device=device, **SOLVER)
        t0 = time.perf_counter()
        benv.step(policy.batch_value_maps(benv.reset()))
        torch.cuda.synchronize()
        sims = benv.last.sim_steps.tolist()
        implied = [min(-(-s // benv.record_every), benv.record_frames)
                   for s in sims]
        got = []
        for i, term in enumerate(benv.last.terminate.tolist()):
            got.append(read_video(os.path.join(
                video_dir(benv.replay_buffer_path), sorted(
                    f for f in os.listdir(video_dir(
                        benv.replay_buffer_path)) if f"_env{i}." in f)[0]))
                       if term else sum(len(c) for c in benv.frames[i]))
        log(f"  BatchSimEnv step of {SINGLE_BATCH}: "
            f"{time.perf_counter() - t0:.2f} s; frames per env {got}, "
            f"implied by the sim steps {implied}")
        if got != implied:
            raise AssertionError("recorded frames differ from the sim steps")

    # (d) pyflex_compat on one hard task
    task = TaskLoader(path).get_next_task()
    t0 = time.perf_counter()
    pyflex.init(True, True, 256, 256, device=device)
    pyflex.set_scene_config(task.get_config(), task.get_state())
    for _ in range(PYFLEX_STEPS):
        pyflex.step()
    pos = pyflex.get_positions()
    pyflex.set_positions(pos)
    if not np.array_equal(pyflex.get_positions(), pos):
        raise AssertionError("pyflex_compat positions do not round-trip")
    rgba, depth = pyflex.render()
    log(f"  pyflex_compat: {PYFLEX_STEPS} steps and render in "
        f"{time.perf_counter() - t0:.2f} s; {len(pos) // 4} particles, "
        f"rgba {rgba.shape}, depth {depth.shape}")
    if rgba.shape != (256 * 256 * 4,) or depth.shape != (256 * 256,):
        raise AssertionError("pyflex_compat render shapes")
    frame_check(pyflex._sim.state, pyflex._sim.topo, SolverParams(),
                "pyflex_compat, one hard task", ill_conditioned=True,
                **SEQ_SIM_KW)
    return launches


def phase_last_modules(device, card, train_dir):
    """The last modules (see the module docstring, phase 14): (a) the
    solver-stage profiler and a trace, (b) the dp train step at world 1
    over NCCL against train_on_batch, (c) the dry run at world 1, (d)
    offline training over phase 9's run directory, (e) the native host
    runtime, (f) a RealWorldEnv on a fake rig.  Returns the kernels'
    launches: (a)'s as substeps_profile and contacts_profile, (c)'s (16
    envs at phase 4's knobs on the 104 lattice) as substeps and
    contacts."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from flingbot_tpu_torch import native, offline_train
    from flingbot_tpu_torch.engine import kernels
    from flingbot_tpu_torch.engine.solver import step
    from flingbot_tpu_torch.engine.state import SolverParams
    from flingbot_tpu_torch.engine.topology import load_cloth
    from flingbot_tpu_torch.env.scene import flat_tasks, make_batch, scene_task
    from flingbot_tpu_torch.env.tasks import SEQ_SIM_KW, TaskLoader
    from flingbot_tpu_torch.learning.memory import step_keys
    from flingbot_tpu_torch.learning.nets import MaximumValuePolicy
    from flingbot_tpu_torch.learning.train import train_on_batch
    from flingbot_tpu_torch.parallel import dryrun, mesh
    from flingbot_tpu_torch.real_world import RealWorldEnv, fakes
    from flingbot_tpu_torch.real_world import setup as rw_setup
    from flingbot_tpu_torch.utils import profiling
    from flingbot_tpu_torch.utils.checkpoint import load_checkpoint

    hard = os.path.join(ROOT, RECT_TASKS)
    launches = {}

    def count(what, suffix=""):
        for k in ("substeps", "contacts"):
            launches[k + suffix] = kernels.LAUNCHES[k]
        log(f"  launches of {what}: {dict(kernels.LAUNCHES)}")

    # (a) the solver-stage profiler at its defaults, and one traced step
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = profiling.profile_solver_stages(PROFILE_ENVS, PROFILE_DIM,
                                             device=device)
    log(f"  profile_solver_stages({PROFILE_ENVS} envs, {PROFILE_DIM}x"
        f"{PROFILE_DIM}) in {time.perf_counter() - t0:.2f} s on {card}:")
    for line in profiling.format_report(report, PROFILE_ENVS).splitlines():
        log("    " + line)
    if not all(math.isfinite(v) and v > 0 for v in report.values()):
        raise AssertionError(f"a stage is not finite: {report}")
    if min(kernels.LAUNCHES[k] for k in ("substeps", "contacts")) <= 0:
        raise AssertionError("full step [pallas] launched no kernel")
    count("the profiler (full step [pallas] only)", "_profile")
    topo, state = make_batch(flat_tasks([(PROFILE_DIM, PROFILE_DIM)] * 8),
                             device=device)
    kw = {**SEQ_SIM_KW, "backend": "pallas"}
    with tempfile.TemporaryDirectory(suffix="_trace") as tmp:
        with profiling.trace(tmp):
            step(state, topo, SolverParams(), **kw)
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    names = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    log(f"  trace() of one pallas step at 8 envs: {len(events)} events, "
        f"{len(names)} kernel names: "
        + ", ".join(n[:40] for n in names[:12]))
    if not any("substeps_kernel" in n for n in names) or not any(
            "contacts_kernel" in n for n in names):
        raise AssertionError("the trace lacks the port's kernels")

    # (b) the dp train step at world 1 over NCCL against train_on_batch
    dev = mesh.init_distributed(f"tcp://localhost:{mesh.free_port()}", 1, 0,
                                device=device)
    try:
        group = mesh.make_mesh()
        ckpt = os.path.join(ROOT, ROUND4_CKPT)
        a, b = (MaximumValuePolicy(["fling"], 64, device=dev)
                for _ in range(2))
        load_checkpoint(ckpt, a)
        load_checkpoint(ckpt, b)
        gen = torch.Generator(dev).manual_seed(1)
        obs = torch.rand((TRAIN_BATCH, 4, 64, 64), generator=gen, device=dev)
        obs[:, 3] = 1.99 + 0.01 * obs[:, 3]
        mask = torch.zeros((TRAIN_BATCH, 64, 64), device=dev)
        hit = torch.randint(0, 64, (TRAIN_BATCH, 2), generator=gen,
                            device=dev)
        mask[torch.arange(TRAIN_BATCH, device=dev), hit[:, 0], hit[:, 1]] = 1
        reward = torch.rand(TRAIN_BATCH, generator=gen, device=dev) - 0.3
        # deterministic cuDNN algorithms on both sides: the comparison is
        # bit for bit
        was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            dp = mesh.make_dp_train_step(b.nets["fling"].net,
                                         b.nets["fling"].optimizer, group)
            loss_a = train_on_batch(a.nets["fling"], obs, mask, reward)
            loss_b = dp(obs, mask, reward)
        finally:
            torch.backends.cudnn.deterministic = was
        sa = a.nets["fling"].net.state_dict()
        sb = b.nets["fling"].net.state_dict()
        same = loss_a == loss_b and all(torch.equal(sa[k], sb[k]) for k in sa)
        log(f"  dp step (world 1, {dist.get_backend(group)}) at batch "
            f"{TRAIN_BATCH}: loss {loss_b!r} vs train_on_batch {loss_a!r}; "
            f"weights and BatchNorm statistics bit-equal: {same}")
        if not same:
            raise AssertionError("the dp step differs from train_on_batch")
        ms_dp = cuda_ms(lambda: dp(obs, mask, reward), 10, warmup=2)
        ms_one = cuda_ms(lambda: train_on_batch(a.nets["fling"], obs, mask,
                                                reward), 10, warmup=2)
        log(f"  dp step {ms_dp:.3f} ms vs train_on_batch {ms_one:.3f} ms at "
            f"batch {TRAIN_BATCH} on {card} (10 steps after 2)")

        # (c) the dry run at world 1: collect, replay, one dp step
        with tempfile.TemporaryDirectory(suffix="_dryrun") as tmp:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = dryrun.dryrun(tmp, group, tasks=hard, num_envs=DRYRUN_ENVS,
                                env_kw=dict(
                                    max_grid_dim=104, render_dim=256,
                                    num_rotations=12, scale_factors=SCALES,
                                    chunk_steps=192, self_collision=True,
                                    fling_speed=6e-3,
                                    max_program_steps=SINGLE_BATCH_PROGRAM,
                                    **SOLVER))
            torch.cuda.synchronize()
            log(f"  dry run at world 1: {out} in "
                f"{time.perf_counter() - t0:.2f} s")
            count("the dry run")
            if out["episodes"] != DRYRUN_ENVS or min(
                    kernels.LAUNCHES[k] for k in ("substeps",
                                                  "contacts")) <= 0:
                raise AssertionError("the dry run's collect fell short")
    finally:
        dist.destroy_process_group()

    # (d) offline training over phase 9's run directory
    before = set(os.listdir(train_dir))
    t0 = time.perf_counter()
    trained = offline_train.main([
        "--log", train_dir, "--steps", "4", "--batch_size", "64",
        "--save_every", "2", "--device", str(device)])
    torch.cuda.synchronize()
    saved = sorted(f for f in set(os.listdir(train_dir)) - before
                   if f.startswith("ckpt_"))
    back = MaximumValuePolicy(["fling"], 64, device=device)
    load_checkpoint(os.path.join(train_dir, "latest_ckpt.pth"), back)
    sa = trained.nets["fling"].net.state_dict()
    sb = back.nets["fling"].net.state_dict()
    same = all(torch.equal(sa[k], sb[k]) for k in sa)
    log(f"  offline_train: 4 batches of 64 over "
        f"{len(step_keys(os.path.join(train_dir, 'replay_buffer')))} "
        f"transitions in {time.perf_counter() - t0:.2f} s; wrote {saved}; "
        f"latest_ckpt.pth reloads bit-equal: {same}")
    if len(saved) != 2 or not same:
        raise AssertionError("offline training's checkpoints")

    # (e) the native host runtime
    if not native.available:
        raise AssertionError("fbnative did not build")
    task = TaskLoader(hard).get_next_task()
    topo, state = make_batch([scene_task(task)], device=device)
    state = step(state, topo, SolverParams(), **SOLVER)
    pos = state.positions[0].T[state.active[0]].cpu().numpy()
    t0 = time.perf_counter()
    got = native.covered_area(pos)
    s_native = time.perf_counter() - t0
    want = covered_area_plain(pos)
    obj = os.path.join(ROOT, "data", "shirts", "shirt_00_processed.obj")
    loaded = all(np.array_equal(x, y) for x, y in zip(
        native.load_cloth(obj), load_cloth(obj)))
    log(f"  native: {native.lib_path()}; covered_area of a settled hard task"
        f" ({len(pos)} particles) {got!r} m^2 in {s_native * 1e3:.3f} ms, "
        f"numpy copy {want!r}; load_cloth equal to the Python loader: "
        f"{loaded}")
    if abs(got - want) > 1e-6 or not loaded:
        raise AssertionError("the native runtime disagrees")

    # (f) a RealWorldEnv on a fake rig, driven by the round-4 checkpoint
    rgb, depth, front, intr, c2w = fakes.synthetic_scene()
    pair, grippers = fakes.recording_rig()
    policy = MaximumValuePolicy(["fling"], 64, device=device)
    load_checkpoint(os.path.join(ROOT, ROUND4_CKPT), policy)
    with tempfile.TemporaryDirectory(suffix="_real") as tmp:
        env = RealWorldEnv(
            replay_buffer_path=tmp, scale_factors=SCALES, render_dim=256,
            top_camera=fakes.FakeCamera(rgb, depth),
            front_camera=fakes.FakeCamera(rgb, front), ur5_pair=pair,
            grippers=grippers, cam_intrinsics=intr, cam_extrinsics=c2w,
            episode_length=1, device=device)
        t0 = time.perf_counter()
        obs = env.reset()
        vm = policy.value_maps(obs)
        action = env._select_action(vm)
        env.step(vm)
        torch.cuda.synchronize()
        sent = pair.left.sent + pair.right.sent
        written = step_keys(tmp)
    log(f"  RealWorldEnv on a {rgb.shape} frame: obs {tuple(obs.shape)} on "
        f"{obs.device}; action "
        + ("none" if action is None else
           f"width {action['width']:.4f} m, rotation {action['rotation']}, "
           f"scale {action['scale']}")
        + f"; {len(sent)} URScript programs sent; replay {written}; "
        f"{time.perf_counter() - t0:.2f} s")
    if obs.device.type != "cuda" or tuple(obs.shape) != (96, 4, 64, 64):
        raise AssertionError("the transformed obs are not on the card")
    if action is None or not (rw_setup.MIN_GRASP_WIDTH <= action["width"]
                              <= rw_setup.MAX_GRASP_WIDTH):
        raise AssertionError(f"no action within the grasp width: {action}")
    if not any(p.startswith("def wp():") for p in sent) or len(written) != 1:
        raise AssertionError("the rig got no fling or the replay is empty")
    return launches


def phase_aero(state, topo, device):
    """The aero path: the rect path's crumpled start states with drag, lift
    and wind set, through the one-substep launches (18 interpreter steps
    of the fling, 16 profiled, and the step's end); first one frame of 4
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
                                params, steps=16)
    return launches


def phase_profile(env, vm, steps: int = 16):
    """torch.profiler over `steps` interpreter steps of a fresh fling
    program on the main path's envs (the env is left as it was)."""
    profile_program(env, vm, steps)


def profile_program(env, vm, steps: int):
    """The programs value maps vm select on env (BatchSimEnv.begin_step),
    run 2 interpreter steps, then `steps` under torch.profiler
    (profile_steps) -> (the step's start, the carry after them)."""
    import torch

    begun = env.begin_step(vm)
    carry, _ = env.run_program(begun, begun.carry, 2)
    torch.cuda.synchronize()
    carry, _ = profile_steps(
        lambda: env.run_program(begun, carry, steps), steps,
        f"{steps} interpreter steps at B={env.state.batch}")
    return begun, carry


def profile_steps(fn, steps: int, what: str):
    """torch.profiler over fn(), which runs `steps` steps: wall and device
    time per step, the port's kernels' share of it, the device's busy
    share, and the device kernels that take the most time.  Returns what
    fn returns.  Only the device is traced: host-side op records cost
    ~2 s of processing a step at the ~3,000 launches of a mesh step, and
    slow the host they measure."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (the runtime API's entries have no device
    # time)
    dev = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                            getattr(e, "self_cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev(e) > 0]
    if not events:
        raise AssertionError(f"{what}: the profiler saw no device time")
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
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import flingbot_tpu_torch  # noqa: F401  (fails outside the repo)

    device = torch.device("cuda")
    with Phase("0 card"):
        card = phase_card()
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
    import tempfile

    kept = tempfile.TemporaryDirectory(suffix="_kept")
    train_dir = os.path.join(kept.name, "train")
    with Phase("9 train path"):
        train = phase_train(device, keep_dir=train_dir)
    with Phase("10 action-space path"):
        action = phase_action_space(device)
    with Phase("11 task generation"):
        gen = phase_generate(device)
    with Phase("12 generic mesh path, xla backend"):
        launches["contacts_mesh_generic"] = phase_generic_mesh(device)
    with Phase("13 single-env path"):
        single = phase_single_env(device)
    with Phase("14 last modules"):
        last = phase_last_modules(device, card, train_dir)
    kept.cleanup()
    launches["substeps_single"] = single["substeps"]
    launches["contacts_single"] = single["contacts"]
    for name in ("substeps", "contacts"):
        launches[name] += (train[name] + action[name] + gen.pop(name)
                           + last.pop(name))
    launches.update(last)
    launches["substeps_jacobi"] = jacobi_launches
    launches.update(gen)

    sources = {
        "substeps": ("flingbot_tpu_torch/csrc/substeps.cu",
                     "flingbot_tpu/engine/pallas_kernels.py:314"),
        "contacts": ("flingbot_tpu_torch/csrc/contacts.cu",
                     "flingbot_tpu/engine/pallas_kernels.py:563"),
        # the rest-pose filter of _contacts_kernel's mesh mode
        "contacts_mesh": ("flingbot_tpu_torch/csrc/contacts.cu",
                          "flingbot_tpu/engine/pallas_kernels.py:442"),
        # the same mode on the generic mesh path (_step_mesh's contact
        # group, flingbot_tpu/engine/solver.py:830-836)
        "contacts_mesh_generic": ("flingbot_tpu_torch/csrc/contacts.cu",
                                  "flingbot_tpu/engine/pallas_kernels.py:442"),
        # the one-substep launches of the aero loop
        "substeps_aero": ("flingbot_tpu_torch/csrc/substeps.cu",
                          "flingbot_tpu/engine/solver.py:637"),
        # cheb=False: the plain Jacobi loop of _substeps_kernel
        "substeps_jacobi": ("flingbot_tpu_torch/csrc/substeps.cu",
                            "flingbot_tpu/engine/pallas_kernels.py:229")}
    # the task generator's launches: 30 iterations, contacts 8 x window 16
    # (flingbot_tpu/env/tasks.py:729-731), on the 104 and 128 lattices;
    # the single env's (B = 1) on the 104 lattice; the profiler's
    # (SEQ_SIM_KW: one substep of 30 iterations, contacts 8 x window 16)
    # on its 100 lattice
    for lattice in ("gen", "gen128", "single", "profile"):
        sources[f"substeps_{lattice}"] = sources["substeps"]
        sources[f"contacts_{lattice}"] = sources["contacts"]
    table = []
    for name in ("substeps", "contacts", "contacts_mesh", "substeps_aero",
                 "substeps_jacobi", "substeps_gen", "contacts_gen",
                 "substeps_gen128", "contacts_gen128",
                 "contacts_mesh_generic", "substeps_single",
                 "contacts_single", "substeps_profile", "contacts_profile"):
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
