"""Plain reference of the fling primitive: the program built from a
selected action, and one step of the batched interpreter that runs it
(the trajectory program of flingbot's pick_and_fling / fling_primitive,
simEnv.py:262-318, with the STABILIZE wait of flex_utils.py:430-441).

The program is an instruction array per env; one interpreter step moves
both pickers one servo step toward the phase's target, runs one solver
frame and advances the program counter.  Envs whose program has ended are
left as they are.  Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import physics

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
GRASP_HEIGHT = 0.02
FLING_SPEED = 6e-3
RESET_TARGETS = ((0.5, 0.5, -0.5), (-0.5, 0.5, -0.5))
_CD_X = ((0.5, 0.0, 0.0), (-0.5, 0.0, 0.0))
_CH_Y = ((0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
PROGRAM_FIELDS = ("kind", "base", "cd", "ch", "grasp", "speed", "min_steps",
                  "jump", "cond")


class Program(NamedTuple):
    kind: torch.Tensor  # (B, I) i64
    base: torch.Tensor  # (B, I, 2, 3)
    cd: torch.Tensor
    ch: torch.Tensor
    grasp: torch.Tensor  # (B, I, 2)
    speed: torch.Tensor  # (B, I)
    min_steps: torch.Tensor  # (B, I) i64
    jump: torch.Tensor  # (B, I) i64
    cond: torch.Tensor  # (B, I)


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


def fling_program(p1, p2, g1, g2):
    """The fling's instructions for grasp points p1, p2 (B, 3) with grasp
    flags g1, g2 (B,), ending in STABILIZE; returns (Program, the initial
    fling height (B,))."""
    B, dev = p1.shape[0], p1.device
    gh = GRASP_HEIGHT
    p1 = p1.clone()
    p2 = p2.clone()
    p1[:, 1] = gh
    p2[:, 1] = gh
    gflags = torch.stack([g1, g2], 1).to(torch.float32)
    any_grasp = (g1 | g2).to(torch.float32)
    mk = lambda *a, **k: _mk(B, dev, *a, **k)  # noqa: E731
    end_pc = 12
    instrs = [
        mk(CONDJUMP, cond=1.0 - any_grasp, jump=end_pc),
        mk(MOVE, base=torch.stack([p1, p2], 1)),
        mk(MOVE, base=[[0, 0.3, -0.3], [0, 0.3, -0.3]], cd=_CD_X,
           grasp=gflags, speed=5e-3),
        mk(CHECKGRASP, grasp=gflags, jump=end_pc),
        mk(STRETCH, grasp=gflags, speed=5e-4, min_steps=20),
        mk(LIFT, base=[[0, 0, -0.3], [0, 0, -0.3]], cd=_CD_X, ch=_CH_Y,
           grasp=gflags, speed=1e-3),
        mk(MOVE, base=[[0, 0, -0.2], [0, 0, -0.2]], cd=_CD_X, ch=_CH_Y,
           grasp=gflags, speed=FLING_SPEED),
        mk(MOVE, base=[[0, 0, 0.2], [0, 0, 0.2]], cd=_CD_X, ch=_CH_Y,
           grasp=gflags, speed=FLING_SPEED),
        mk(MOVE, base=[[0, 0, 0.2], [0, 0, 0.2]], cd=_CD_X, ch=_CH_Y,
           grasp=gflags, speed=1e-2, min_steps=4),
        mk(MOVE, base=[[0, 2 * gh, -0.2], [0, 2 * gh, -0.2]], cd=_CD_X,
           grasp=gflags, speed=1e-2),
        mk(MOVE, base=[[0, 2 * gh, -0.25], [0, 2 * gh, -0.25]], cd=_CD_X,
           grasp=gflags, speed=5e-3),
        mk(MOVE, base=RESET_TARGETS, speed=5e-3),
        mk(STABILIZE, base=RESET_TARGETS),
    ]
    prog = Program(*(torch.stack(leaves, 1) for leaves in zip(*instrs)))
    return prog, torch.full((B,), float(np.float32(0.3)), device=dev)


@dataclasses.dataclass
class Carry:
    state: physics.State
    pc: torch.Tensor  # (B,) i64
    phase_step: torch.Tensor
    total_steps: torch.Tensor
    targets: torch.Tensor  # (B, 2, 3)
    grasp_dist: torch.Tensor  # (B,)
    fling_height: torch.Tensor
    stretch_mid: torch.Tensor  # (B, 3)
    stretch_dir: torch.Tensor
    cloth_mid: torch.Tensor
    stable_steps: torch.Tensor
    terminate: torch.Tensor  # (B,) bool


CARRY_FIELDS = tuple(f.name for f in dataclasses.fields(Carry)
                     if f.name != "state")


def _norm(x):
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                      + x[..., 2] * x[..., 2])


def _where_carry(mask, a: Carry, b: Carry) -> Carry:
    out = {"state": physics.where_state(mask, a.state, b.state)}
    for name in CARRY_FIELDS:
        va, vb = getattr(a, name), getattr(b, name)
        out[name] = torch.where(mask.view((-1,) + (1,) * (va.dim() - 1)),
                                va, vb)
    return Carry(**out)


def _release_and_park(st: physics.State) -> physics.State:
    st = physics.release_all(st)
    return st.replace(picker_pos=torch.tensor(
        RESET_TARGETS, dtype=st.picker_pos.dtype,
        device=st.positions.device).expand(st.positions.shape[0], -1,
                                           -1).clone())


def body(c: Carry, topo, params, program: Program, knobs: dict) -> Carry:
    """One interpreter step of every env."""
    st = c.state
    B, dev = st.positions.shape[0], st.positions.device
    ar = torch.arange(B, device=dev)
    num_instr = program.kind.shape[1]
    pcc = c.pc.clamp(0, num_instr - 1)
    ins = Program(*(a[ar, pcc] for a in program))
    kind = ins.kind
    entry = c.phase_step == 0

    is_stab = kind == STABILIZE
    st = physics.where_state(entry & is_stab, _release_and_park(st), st)

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

    dists = _norm(targets - st.picker_pos)
    reached = (dists < EPS).all(1) & (c.phase_step >= ins.min_steps)
    timeout = c.phase_step >= PHASE_LIMIT

    pos, act = st.positions, st.active
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]

    high = act & (py > (c.fling_height - 0.1)[:, None])
    any_high = high.any(1)
    single_grasp = any_high & (torch.where(high, px < 0, True).all(1)
                               | torch.where(high, px > 0, True).all(1))
    d2 = ((px - stretch_mid[:, 0:1]) ** 2 + (pz - stretch_mid[:, 2:3]) ** 2)
    d2 = torch.where(act, d2, float("inf"))
    amin = torch.argmin(d2, 1)
    new_mid = pos[ar, :, amin]
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

    min_y = torch.where(act, py, float("inf")).amin(1)
    clear = min_y > LIFT_CLEAR
    at_max = c.fling_height >= LIFT_MAX_HEIGHT
    lift_done = reached & (clear | at_max)
    raise_h = reached & ~lift_done
    fh_next = torch.where(raise_h, c.fling_height + LIFT_INCREMENT,
                          c.fling_height)

    max_y = torch.where(act, py, float("-inf")).amax(1)
    grasp_failed = max_y < GRASP_CHECK_HEIGHT

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

    is_jump_kind = (kind == CHECKGRASP) | (kind == CONDJUMP) | (is_stab & done)
    delta_t = targets - st.picker_pos
    dd = _norm(delta_t)[..., None]
    speed = ins.speed[:, None, None]
    move = torch.where(dd < speed, delta_t,
                       delta_t / torch.clamp(dd, min=1e-9) * speed)
    action = torch.cat([move, ins.grasp[..., None]], -1)
    sim = physics.frame(physics.picker_step(st, action, dt=params.dt), topo,
                        params, knobs)
    st = physics.where_state(is_jump_kind, st, sim)

    hold = kind == STRETCH
    return Carry(
        state=st, pc=next_pc,
        phase_step=torch.where(done, 0, c.phase_step + 1),
        total_steps=c.total_steps + (~is_jump_kind).to(torch.int64),
        targets=targets, grasp_dist=gd_next, fling_height=fh_next,
        stretch_mid=stretch_mid, stretch_dir=stretch_dir,
        cloth_mid=torch.where((hold & reached)[:, None], new_mid, cloth_mid),
        stable_steps=torch.where(hold & reached, stable_next, stable),
        terminate=terminate)


def interpreter_step(c: Carry, topo, params, program: Program, knobs: dict,
                     max_steps: int) -> Carry:
    """One step of the interpreter: envs still running take body's step,
    the others keep their carry."""
    run = (c.pc < program.kind.shape[1]) & (c.total_steps < max_steps)
    return _where_carry(run, body(c, topo, params, program, knobs), c)
