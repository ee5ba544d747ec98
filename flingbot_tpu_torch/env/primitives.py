"""Manipulation primitives as trajectory programs run by a batched
interpreter (counterpart of flingbot_tpu/env/primitives.py): fling,
drag, place and stretch-drag.

A primitive is a program, a fixed-length array of instructions; the
interpreter keeps one program counter per env and runs ONE solver step per
body call for every env that simulates.  An env that has finished its
program is a no-op, kept with torch.where(run, new, old) exactly as the
vmapped while_loop keeps it.  `program_chunk` runs up to `chunk_steps`
body calls and returns a (B,) done mask; the host reads it once per chunk.
Each env may run another primitive: `build_selected_program` builds every
primitive's program for the whole batch, pads them to one length and
gathers each env's own by its prim_idx.

  kind 0  MOVE       servo to base + cd * grasp_dist + ch * fling_height
  kind 1  STRETCH    widen the grasp until the cloth midpoint is stable
  kind 2  LIFT       raise the fling height until the cloth clears the floor
  kind 3  CHECKGRASP cloth not lifted (max y < 0.2) -> terminate + jump
  kind 4  CONDJUMP   jump if a build-time condition holds
  kind 5  DRAGREL    servo to picker_pos + base, taken at phase entry
                     (stretch-drag); like the JAX interpreter, the phase
                     ends after one step
  kind 6  STABILIZE  release, park the arms, simulate until max |v| < tol
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from flingbot_tpu_torch.engine.picker import picker_step, release_all
from flingbot_tpu_torch.engine.solver import step as solver_step
from flingbot_tpu_torch.engine.state import (
    ClothState, SolverParams, where_state)

MOVE, STRETCH, LIFT, CHECKGRASP, CONDJUMP, DRAGREL, STABILIZE = range(7)

EPS = 1e-4
DEFAULT_SPEED = 0.1
PHASE_LIMIT = 1000
STRETCH_INCREMENT = 0.02
STRETCH_MAX_DIST = 0.7
STRETCH_STABLE_TOL = 1.5e-2
LIFT_INCREMENT = 0.05
LIFT_MAX_HEIGHT = 0.7
LIFT_CLEAR = 0.02
GRASP_CHECK_HEIGHT = 0.2
STABLE_TOL = 1e-2
STABLE_MAX_STEPS = 300

_RESET_TARGETS = ((0.5, 0.5, -0.5), (-0.5, 0.5, -0.5))
_OTHER_PARK = (-0.2, 0.3, -0.2)  # the idle arm of drag and place
_CD_X = ((0.5, 0.0, 0.0), (-0.5, 0.0, 0.0))
_CH_Y = ((0.0, 1.0, 0.0), (0.0, 1.0, 0.0))


class Program(NamedTuple):
    """(B, I)-leading instruction arrays."""

    kind: torch.Tensor  # (B, I) i64
    base: torch.Tensor  # (B, I, 2, 3) f32
    cd: torch.Tensor  # (B, I, 2, 3) coefficient on grasp_dist
    ch: torch.Tensor  # (B, I, 2, 3) coefficient on fling_height
    grasp: torch.Tensor  # (B, I, 2) grasp flags during the phase
    speed: torch.Tensor  # (B, I) m per sim step
    min_steps: torch.Tensor  # (B, I) i64
    jump: torch.Tensor  # (B, I) i64 jump target for kinds 3/4
    cond: torch.Tensor  # (B, I) build-time condition for kind 4

    @property
    def num_instructions(self) -> int:
        return self.kind.shape[1]


class PrimitiveConfig(NamedTuple):
    """Static primitive parameters (SimEnv defaults, simEnv.py:51-57)."""

    grasp_height: float = 0.02
    fling_speed: float = 6e-3
    fixed_fling_height: float = -1.0
    stretchdrag_dist: float = 0.3
    max_program_steps: int = 4000


def _mk(B, dev, kind, base=None, cd=None, ch=None, grasp=(0.0, 0.0),
        speed=DEFAULT_SPEED, min_steps=0, jump=0, cond=0.0):
    def vec(v, shape):
        if v is None:
            return torch.zeros((B,) + shape, device=dev)
        t = torch.as_tensor(v, dtype=torch.float32, device=dev)
        return t.reshape((-1,) + shape).expand((B,) + shape)

    def scal(v, dtype):
        return torch.as_tensor(v, dtype=dtype, device=dev).reshape(-1) \
            .expand(B)

    return (scal(kind, torch.int64), vec(base, (2, 3)), vec(cd, (2, 3)),
            vec(ch, (2, 3)), vec(grasp, (2,)),
            scal(np.float32(speed), torch.float32),
            scal(min_steps, torch.int64), scal(jump, torch.int64),
            scal(np.float32(cond) if not torch.is_tensor(cond) else cond,
                 torch.float32))


def _pack(instrs) -> Program:
    return Program(*(torch.stack(leaves, 1) for leaves in zip(*instrs)))


def build_fling_program(p1, p2, g1, g2, cfg: PrimitiveConfig):
    """pick_and_fling (simEnv.py:283-318) + fling_primitive (262-281).
    p1, p2 (B, 3); g1, g2 (B,) bool.  Returns (Program, init fling
    height (B,))."""
    B, dev = p1.shape[0], p1.device
    gh = cfg.grasp_height
    p1 = p1.clone()
    p2 = p2.clone()
    p1[:, 1] = gh
    p2[:, 1] = gh
    gflags = torch.stack([g1, g2], 1).to(torch.float32)
    any_grasp = (g1 | g2).to(torch.float32)
    fixed_h = cfg.fixed_fling_height >= 0
    mk = lambda *a, **k: _mk(B, dev, *a, **k)  # noqa: E731
    end_pc = 11 if fixed_h else 12
    instrs = [
        # skip everything if neither point grasps cloth
        mk(CONDJUMP, cond=1.0 - any_grasp, jump=end_pc),
        # approach the grasp points, no grasp yet
        mk(MOVE, base=torch.stack([p1, p2], 1)),
        # lift to pre-fling with the grasp flags engaged
        mk(MOVE, base=[[0, 0.3, -0.3], [0, 0.3, -0.3]], cd=_CD_X,
           grasp=gflags, speed=5e-3),
        # abort if the cloth did not come up
        mk(CHECKGRASP, grasp=gflags, jump=end_pc),
        # stretch until taut
        mk(STRETCH, grasp=gflags, speed=5e-4, min_steps=20),
    ]
    if not fixed_h:
        instrs.append(mk(LIFT, base=[[0, 0, -0.3], [0, 0, -0.3]], cd=_CD_X,
                         ch=_CH_Y, grasp=gflags, speed=1e-3))
    instrs += [
        mk(MOVE, base=[[0, 0, -0.2], [0, 0, -0.2]], cd=_CD_X, ch=_CH_Y,
           grasp=gflags, speed=cfg.fling_speed),
        mk(MOVE, base=[[0, 0, 0.2], [0, 0, 0.2]], cd=_CD_X, ch=_CH_Y,
           grasp=gflags, speed=cfg.fling_speed),
        mk(MOVE, base=[[0, 0, 0.2], [0, 0, 0.2]], cd=_CD_X, ch=_CH_Y,
           grasp=gflags, speed=1e-2, min_steps=4),
        # lower + release
        mk(MOVE, base=[[0, 2 * gh, -0.2], [0, 2 * gh, -0.2]], cd=_CD_X,
           grasp=gflags, speed=1e-2),
        mk(MOVE, base=[[0, 2 * gh, -0.25], [0, 2 * gh, -0.25]], cd=_CD_X,
           grasp=gflags, speed=5e-3),
        # reset the end effectors, grasp released
        mk(MOVE, base=_RESET_TARGETS, speed=5e-3),
    ]
    init_fh = cfg.fixed_fling_height if fixed_h else 0.3
    return _pack(instrs), torch.full((B,), float(np.float32(init_fh)),
                                     device=dev)


def _at_height(p, y):
    """(B, 3) points with y set to y."""
    p = p.clone()
    p[:, 1] = y
    return p


def _single_arm(g1, path):
    """The single-arm programs of drag and place: skip all unless p1's
    grasp circle is on cloth (g1), then visit `path` with the other arm
    parked (each entry: point (B, 3), grasp flag of the first arm), then
    reset the arms."""
    B, dev = g1.shape[0], g1.device
    other = torch.tensor(_OTHER_PARK, device=dev).expand(B, 3)
    mk = lambda *a, **k: _mk(B, dev, *a, **k)  # noqa: E731
    instrs = [mk(CONDJUMP, cond=1.0 - g1.to(torch.float32),
                 jump=len(path) + 2)]
    instrs += [mk(MOVE, base=torch.stack([p, other], 1),
                  grasp=(float(g), 0.0), speed=5e-3) for p, g in path]
    instrs.append(mk(MOVE, base=_RESET_TARGETS, speed=5e-3))
    return _pack(instrs), torch.full((B,), float(np.float32(0.3)),
                                     device=dev)


def build_drag_program(p1, p2, g1, g2, cfg: PrimitiveConfig):
    """pick_and_drag (simEnv.py:320-344): one arm drags p1 along the
    ground to p2."""
    gh = cfg.grasp_height
    p1, p2 = _at_height(p1, gh), _at_height(p2, gh)
    path = [(_at_height(p1, 0.3), 0), (p1, 0), (p2, 1),
            (_at_height(p2, 0.3), 0)]
    return _single_arm(g1, path)


def build_place_program(p1, p2, g1, g2, cfg: PrimitiveConfig):
    """pick_and_place (simEnv.py:346-372): one arm lifts p1 0.2 m and puts
    it down at p2."""
    gh = cfg.grasp_height
    p1, p2 = _at_height(p1, gh), _at_height(p2, gh)
    prepick, preplace = _at_height(p1, 0.2), _at_height(p2, 0.2)
    path = [(prepick, 0), (p1, 0), (prepick, 1), (preplace, 1), (p2, 1),
            (preplace, 0)]
    return _single_arm(g1, path)


def build_stretchdrag_program(p1, p2, g1, g2, cfg: PrimitiveConfig):
    """pick_stretch_drag (simEnv.py:374-429): grasp both points, stretch
    when both are on cloth, drag perpendicular to the grasp line.
    Returns the grasp height as the initial fling height: the stretch runs
    at grasp height (simEnv.py:405-406)."""
    B, dev = p1.shape[0], p1.device
    gh = cfg.grasp_height
    p1, p2 = _at_height(p1, gh), _at_height(p2, gh)
    pre1, pre2 = _at_height(p1, 0.3), _at_height(p2, 0.3)
    gflags = torch.stack([g1, g2], 1).to(torch.float32)
    both = (g1 & g2).to(torch.float32)
    any_grasp = (g1 | g2).to(torch.float32)
    # drag direction: cross(p1 - p2, up), scaled (simEnv.py:409-412), then
    # 0.1 m up to keep the arms above the cloth (:418)
    up = torch.tensor([0.0, 1.0, 0.0], device=dev).expand(B, 3)
    drag = torch.linalg.cross(p1 - p2, up, dim=-1)
    drag = cfg.stretchdrag_dist * drag / torch.clamp(_norm(drag),
                                                     min=1e-9)[:, None]
    drag = drag + torch.tensor([0.0, 0.1, 0.0], device=dev)
    mk = lambda *a, **k: _mk(B, dev, *a, **k)  # noqa: E731
    instrs = [
        mk(CONDJUMP, cond=1.0 - any_grasp, jump=8),
        mk(MOVE, base=torch.stack([pre1, pre2], 1)),
        mk(MOVE, base=torch.stack([p1, p2], 1), speed=2e-3),
        # stretch only if both points grasp cloth; the grasp flags stay on
        # through the jump
        mk(CONDJUMP, cond=1.0 - both, jump=5, grasp=gflags),
        mk(STRETCH, grasp=gflags, speed=5e-4, min_steps=20),
        mk(DRAGREL, base=torch.stack([drag, drag], 1), grasp=gflags,
           speed=2e-3),
        # lift away from the drop point
        mk(MOVE, base=torch.stack([pre1 + drag, pre2 + drag], 1)),
        mk(MOVE, base=_RESET_TARGETS, speed=5e-3),
    ]
    return _pack(instrs), torch.full((B,), float(np.float32(gh)),
                                     device=dev)


PROGRAM_BUILDERS = {
    "fling": build_fling_program,
    "drag": build_drag_program,
    "place": build_place_program,
    "stretchdrag": build_stretchdrag_program,
}


def _append(prog: Program, instr) -> Program:
    return Program(*(torch.cat([a, b[:, None]], 1)
                     for a, b in zip(prog, instr)))


def append_stabilize(prog: Program) -> Program:
    """Append a STABILIZE phase at the program end: abort jumps target the
    old end, so they land on the stabilize (simEnv.py:466-477)."""
    B, dev = prog.kind.shape[0], prog.kind.device
    return _append(prog, _mk(B, dev, STABILIZE, base=_RESET_TARGETS))


def pad_program(prog: Program, num_instructions: int) -> Program:
    """Pad to num_instructions with terminators (a CONDJUMP past the end),
    so programs of several primitives stack (pad_program,
    primitives.py:303)."""
    B, dev = prog.kind.shape[0], prog.kind.device
    term = _mk(B, dev, CONDJUMP, cond=1.0, jump=num_instructions)
    for _ in range(num_instructions - prog.num_instructions):
        prog = _append(prog, term)
    return prog


def build_selected_program(primitives, prim_idx, p1, p2, g1, g2,
                           cfg: PrimitiveConfig):
    """Every primitive's program for the whole batch, each ending in
    STABILIZE (appended before padding, so abort jumps land on it), padded
    to one length and gathered per env by prim_idx (B,)
    (build_selected_program, primitives.py:316).  Returns (Program,
    init fling height (B,))."""
    progs, fhs = [], []
    for prim in primitives:
        prog, fh = PROGRAM_BUILDERS[prim](p1, p2, g1, g2, cfg)
        progs.append(append_stabilize(prog))
        fhs.append(fh)
    num_i = max(p.num_instructions for p in progs)
    progs = [pad_program(p, num_i) for p in progs]
    ar = torch.arange(p1.shape[0], device=p1.device)
    prog = Program(*(torch.stack(leaves)[prim_idx, ar]
                     for leaves in zip(*progs)))
    return prog, torch.stack(fhs)[prim_idx, ar]


@dataclasses.dataclass
class Carry:
    state: ClothState
    pc: torch.Tensor  # (B,) i64
    phase_step: torch.Tensor
    total_steps: torch.Tensor
    targets: torch.Tensor  # (B, 2, 3) current servo targets
    grasp_dist: torch.Tensor  # (B,)
    fling_height: torch.Tensor
    stretch_mid: torch.Tensor  # (B, 3)
    stretch_dir: torch.Tensor
    cloth_mid: torch.Tensor
    stable_steps: torch.Tensor
    terminate: torch.Tensor  # (B,) bool
    # recorded positions (B, F, 3, N), or None when nothing is recorded,
    # and each env's count of recorded frames (B,)
    frames: torch.Tensor | None
    frame_idx: torch.Tensor


def init_program_carry(state: ClothState, init_grasp_dist,
                       init_fling_height, record_frames: int = 0) -> Carry:
    """A fresh interpreter carry; record_frames > 0 allocates that many
    frame slots per env (init_program_carry, primitives.py:585-602)."""
    B, dev = state.batch, state.device
    z = torch.zeros(B, dtype=torch.int64, device=dev)
    frames = None
    if record_frames > 0:
        frames = torch.zeros((B, record_frames) + state.positions.shape[1:],
                             dtype=state.positions.dtype, device=dev)
    return Carry(
        state=state, pc=z, phase_step=z.clone(), total_steps=z.clone(),
        targets=state.picker_pos.clone(),
        grasp_dist=torch.as_tensor(init_grasp_dist, dtype=torch.float32,
                                   device=dev).expand(B).clone(),
        fling_height=torch.as_tensor(init_fling_height, dtype=torch.float32,
                                     device=dev).expand(B).clone(),
        stretch_mid=torch.zeros(B, 3, device=dev),
        stretch_dir=torch.tensor([1.0, 0.0, 0.0], device=dev).expand(
            B, 3).clone(),
        cloth_mid=torch.full((B, 3), float("inf"), device=dev),
        stable_steps=z.clone(),
        terminate=torch.zeros(B, dtype=torch.bool, device=dev),
        frames=frames, frame_idx=z.clone())


def _where_carry(mask, a: Carry, b: Carry) -> Carry:
    """a where mask, else b; the frames are a's (body leaves them alone,
    and program_chunk records into them)."""
    out = {}
    for f in dataclasses.fields(Carry):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "frames":
            out[f.name] = va
        elif f.name == "state":
            out[f.name] = where_state(mask, va, vb)
        else:
            out[f.name] = torch.where(
                mask.view((-1,) + (1,) * (va.dim() - 1)), va, vb)
    return Carry(**out)


def _norm(x):
    """Euclidean norm over the last axis of size 3, summed in order."""
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                      + x[..., 2] * x[..., 2])


def _b(x, like):
    """(B,) -> broadcastable against `like` (B, ...)."""
    return x.view((-1,) + (1,) * (like.dim() - 1))


def _release_and_park(st: ClothState) -> ClothState:
    st = release_all(st)
    return st.replace(picker_pos=torch.tensor(
        _RESET_TARGETS, dtype=torch.float32, device=st.device).expand(
            st.batch, -1, -1).clone())


def body(c: Carry, topo, params: SolverParams, program: Program,
         sim_kw: dict) -> Carry:
    """One interpreter step for every env (_make_body, primitives.py:370)."""
    st = c.state
    B, dev = st.batch, st.device
    ar = torch.arange(B, device=dev)
    num_instr = program.num_instructions
    pcc = c.pc.clamp(0, num_instr - 1)
    ins = Program(*(a[ar, pcc] for a in program))
    kind = ins.kind
    entry = c.phase_step == 0

    is_stab = kind == STABILIZE
    st = where_state(entry & is_stab, _release_and_park(st), st)

    gd = c.grasp_dist[:, None, None]
    fh = c.fling_height[:, None, None]
    static_target = ins.base + ins.cd * gd + ins.ch * fh

    left = st.picker_pos[:, 0].clone()
    left[:, 1] = c.fling_height
    right = st.picker_pos[:, 1].clone()
    right[:, 1] = c.fling_height
    s_mid = (left + right) / 2
    s_dir = left - right
    s_dir = s_dir / torch.clamp(_norm(s_dir), min=1e-9)[:, None]
    s_targets = torch.stack([left, right], 1)

    is_stretch = kind == STRETCH
    is_lift = kind == LIFT
    is_dragrel = kind == DRAGREL
    drag_target = st.picker_pos + ins.base
    targets = torch.where(
        entry[:, None, None],
        torch.where(is_stretch[:, None, None], s_targets,
                    torch.where(is_dragrel[:, None, None], drag_target,
                                static_target)),
        torch.where((is_stretch | is_lift | is_dragrel)[:, None, None],
                    c.targets, static_target))
    es = entry & is_stretch
    stretch_mid = torch.where(es[:, None], s_mid, c.stretch_mid)
    stretch_dir = torch.where(es[:, None], s_dir, c.stretch_dir)
    grasp_dist_eff = torch.where(
        es, _norm(st.picker_pos[:, 0] - st.picker_pos[:, 1]), c.grasp_dist)
    cloth_mid = torch.where(es[:, None], float("inf"), c.cloth_mid)
    stable = torch.where(es, 0, c.stable_steps)

    dists = _norm(targets - st.picker_pos)  # (B, 2)
    reached = (dists < EPS).all(1) & (c.phase_step >= ins.min_steps)
    timeout = c.phase_step >= PHASE_LIMIT

    pos, act = st.positions, st.active
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]

    # STRETCH bookkeeping (simEnv.py:156-184)
    high = act & (py > (c.fling_height - 0.1)[:, None])
    any_high = high.any(1)
    single_grasp = any_high & (torch.where(high, px < 0, True).all(1)
                               | torch.where(high, px > 0, True).all(1))
    d2 = ((px - stretch_mid[:, 0:1]) ** 2 + (pz - stretch_mid[:, 2:3]) ** 2)
    d2 = torch.where(act, d2, float("inf"))
    amin = torch.argmin(d2, 1)
    new_mid = pos[ar, :, amin]  # (B, 3)
    mid_stable = _norm(new_mid - cloth_mid) < STRETCH_STABLE_TOL
    stable_next = torch.where(mid_stable, stable + 1, 0)
    stretched = stable_next > 2
    over = grasp_dist_eff + STRETCH_INCREMENT > STRETCH_MAX_DIST
    stretch_done = reached & (stretched | single_grasp | over)
    widen = reached & ~stretch_done
    gd_next = torch.where(widen, grasp_dist_eff + STRETCH_INCREMENT,
                          grasp_dist_eff)
    half = (gd_next / 2)[:, None]
    widen_left = stretch_mid + stretch_dir * half
    widen_right = stretch_mid - stretch_dir * half
    widen_left[:, 1] = c.fling_height
    widen_right[:, 1] = c.fling_height
    widen_targets = torch.stack([widen_left, widen_right], 1)

    # LIFT bookkeeping (simEnv.py:186-200)
    min_y = torch.where(act, py, float("inf")).amin(1)
    clear = min_y > LIFT_CLEAR
    at_max = c.fling_height >= LIFT_MAX_HEIGHT
    lift_done = reached & (clear | at_max)
    raise_h = reached & ~lift_done
    fh_next = torch.where(raise_h, c.fling_height + LIFT_INCREMENT,
                          c.fling_height)

    # CHECKGRASP (simEnv.py:305-307, 809-813)
    max_y = torch.where(act, py, float("-inf")).amax(1)
    grasp_failed = max_y < GRASP_CHECK_HEIGHT

    # STABILIZE completion (wait_until_stable, flex_utils.py:430-441)
    vmax = torch.where(st.active[:, None], st.velocities, 0.0).abs().amax(
        (1, 2))
    stab_done = (vmax < STABLE_TOL) | (c.phase_step >= STABLE_MAX_STEPS)

    done = torch.where(
        kind == MOVE, reached,
        torch.where(is_stretch, stretch_done,
                    torch.where(is_lift, lift_done,
                                torch.where(is_stab, stab_done, True))))
    done = done | timeout
    failed = (kind == CHECKGRASP) & grasp_failed
    jumping = failed | ((kind == CONDJUMP) & (ins.cond > 0.5))
    next_pc = torch.where(done, torch.where(jumping, ins.jump, c.pc + 1),
                          c.pc)
    terminate = c.terminate | failed

    targets = torch.where((is_stretch & widen)[:, None, None], widen_targets,
                          targets)
    lift_target = ins.base + ins.cd * gd + ins.ch * fh_next[:, None, None]
    targets = torch.where((is_lift & raise_h)[:, None, None], lift_target,
                          targets)

    # servo + one solver step, unless this was a pure jump or a finished
    # STABILIZE (wait_until_stable tests before it steps)
    is_jump_kind = (kind == CHECKGRASP) | (kind == CONDJUMP) | (is_stab & done)
    delta_t = targets - st.picker_pos
    dd = _norm(delta_t)[..., None]
    speed = ins.speed[:, None, None]
    move = torch.where(dd < speed, delta_t,
                       delta_t / torch.clamp(dd, min=1e-9) * speed)
    action = torch.cat([move, ins.grasp[..., None]], -1)
    sim = solver_step(picker_step(st, action, dt=params.dt), topo, params,
                      **sim_kw)
    st = where_state(is_jump_kind, st, sim)

    hold = kind == STRETCH
    return Carry(
        state=st, pc=next_pc,
        phase_step=torch.where(done, 0, c.phase_step + 1),
        total_steps=c.total_steps + (~is_jump_kind).to(torch.int64),
        targets=targets, grasp_dist=gd_next, fling_height=fh_next,
        stretch_mid=stretch_mid, stretch_dir=stretch_dir,
        cloth_mid=torch.where((hold & reached)[:, None], new_mid, cloth_mid),
        stable_steps=torch.where(hold & reached, stable_next, stable),
        terminate=terminate, frames=c.frames, frame_idx=c.frame_idx)


def running(c: Carry, program: Program, max_steps: int) -> torch.Tensor:
    return (c.pc < program.num_instructions) & (c.total_steps < max_steps)


def record_frame(old: Carry, new: Carry, record_every: int) -> Carry:
    """Write each env's positions after a sim step into its next frame
    slot when the step simulated, its count of sim steps before it is a
    multiple of record_every and a slot is free (the frame slots of
    _make_body, primitives.py:551-556).  In place: one (3, N) slot per
    env."""
    F = new.frames.shape[1]
    rec = ((new.total_steps > old.total_steps)
           & (old.total_steps % record_every == 0) & (new.frame_idx < F))
    ar = torch.arange(rec.shape[0], device=rec.device)
    slot = new.frame_idx.clamp(max=F - 1)
    new.frames[ar, slot] = torch.where(rec[:, None, None],
                                       new.state.positions,
                                       new.frames[ar, slot])
    new.frame_idx = new.frame_idx + rec.to(torch.int64)
    return new


def program_chunk(carry: Carry, topo, params: SolverParams,
                  program: Program, *, chunk_steps: int = 64,
                  max_steps: int = 4000, sim_kw: dict | None = None,
                  record_every: int = 8):
    """Run at most `chunk_steps` interpreter steps; envs that are done
    stay as they are.  A carry with frames records every record_every-th
    sim step (record_frame).  Returns (carry', done (B,) bool)."""
    sim_kw = sim_kw or {}
    for _ in range(chunk_steps):
        run = running(carry, program, max_steps)
        new = _where_carry(run, body(carry, topo, params, program, sim_kw),
                           carry)
        if new.frames is not None:
            new = record_frame(carry, new, record_every)
        carry = new
    return carry, ~running(carry, program, max_steps)
