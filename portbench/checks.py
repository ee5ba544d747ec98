"""The comparisons that decide `correct`: what the timed path produced,
judged stage by stage against the plain reference (portbench/reference)
on the same inputs.

The cloth is chaotic (a 1e-7 change reaches 2e-2 m within ~15 frames), so
no stage is compared over a span longer than one step: each stage is
given the program's own input to that stage, taken inside the window, and
its output is compared with the reference's output for that input.  The
stages:

  interpreter step  one step of the primitive interpreter (pickers, grasp,
                    program counters, one solver frame through the
                    kernels) from a carry the window produced
  frame             one solver frame from a state the window produced
  render            the observation of the state the window's program
                    ended in (render, 96 views, masks)
  coverage          pre- and post-action coverage of the window's step
  value maps        the net on the observation the window rendered
  action            the selection and the program built from the window's
                    value maps

Each returns plain numbers; `control` puts the reference computed one
precision lower (bfloat16; TF32 for the value net) in the program's
place, which has to fail.
"""

from __future__ import annotations

import torch

from portbench.reference import interp, physics, policy, topology, vision

CONTROL_DTYPE = torch.bfloat16


def _state(st, dtype) -> physics.State:
    f = lambda t: t.detach().to(dtype)  # noqa: E731
    return physics.State(
        positions=f(st.positions), velocities=f(st.velocities),
        inv_mass=f(st.inv_mass), rest_inv_mass=f(st.rest_inv_mass),
        active=st.active.clone(), picker_pos=f(st.picker_pos),
        picked_idx=st.picked_idx.clone())


def _carry(c, dtype) -> interp.Carry:
    kw = {}
    for name in interp.CARRY_FIELDS:
        v = getattr(c, name)
        kw[name] = v.to(dtype) if v.is_floating_point() else v.clone()
    return interp.Carry(state=_state(c.state, dtype), **kw)


def _program(p) -> interp.Program:
    return interp.Program(*(getattr(p, f) for f in interp.PROGRAM_FIELDS))


def _gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def reference_topology(ctx, order):
    """The topology of env slots holding tasks[i] for i in order, from
    the raw task file."""
    tasks = ctx.ref_tasks()
    if ctx.layered:
        return topology.layered_topology(tasks, order, ctx.device)
    H = W = ctx.config["max_grid_dim"]
    return topology.grid_topology([tasks[i] for i in order], H, W,
                                  ctx.device)


# --------------------------------------------------------------------------
# stages: each returns the reference's outputs for the program's inputs
# --------------------------------------------------------------------------

def frame(ctx, ev, dtype) -> dict:
    topo = reference_topology(ctx, ev["order"])
    out = physics.frame(_state(ev["before"], dtype), topo, ctx.params,
                        ctx.knobs)
    return {"positions": out.positions.float(),
            "velocities": out.velocities.float()}


def interpreter_step(ctx, ev, dtype) -> dict:
    topo = reference_topology(ctx, ev["order"])
    out = interp.interpreter_step(_carry(ev["before"], dtype), topo,
                                  ctx.params, _program(ev["program"]),
                                  ctx.knobs, ev["max_steps"])
    res = {"positions": out.state.positions.float(),
           "velocities": out.state.velocities.float(),
           "picked_idx": out.state.picked_idx,
           "picker_pos": out.state.picker_pos.float()}
    for name in interp.CARRY_FIELDS:
        res[name] = getattr(out, name)
    return res


def observation(ctx, ev, dtype) -> dict:
    cfg = ctx.config
    topo = reference_topology(ctx, ev["order"])
    faces, mask = topo.triangles()
    S, B = cfg["render_dim"], len(ev["order"])
    # the env draws every slot's palette at reset, then one per reloaded
    # slot at each reload, from one generator seeded with the run's seed
    redraws = ev["palette_redraws"]
    draws = vision.palettes(ctx.seed, [B] + [len(i) for i in redraws], S,
                            ctx.device)
    pal = draws[0]
    for idx, fresh in zip(redraws, draws[1:]):
        idx = torch.as_tensor(idx, device=ctx.device)
        pal = tuple(p.index_copy(0, idx, f) for p, f in zip(pal, fresh))
    st = ev["state"]
    outs = []
    for s in range(0, B, 16):
        sl = slice(s, s + 16)
        o = vision.observe(st.positions[sl].to(dtype), st.active[sl],
                           faces[sl], mask[sl],
                           (pal[0][sl].to(dtype), pal[1][sl].to(dtype)),
                           ctx.rotations, ctx.scale_factors, S,
                           cfg["obs_dim"])
        outs.append((o.obs_stack.float(), o.mask_stack.float()))
    return {"obs_stack": torch.cat([o[0] for o in outs]),
            "mask_stack": torch.cat([o[1] for o in outs])}


def coverage(ctx, ev, dtype) -> dict:
    return {k: vision.coverage(ev[k + "_positions"].to(dtype),
                               ev["active"]).float() for k in ("pre", "post")}


def value_maps(ctx, ev, dtype) -> dict:
    obs = ev["obs_stack"]
    B, T = obs.shape[:2]
    flat = obs.reshape((B * T,) + obs.shape[2:]).to(dtype)
    vm = policy.value_maps(ctx.weights(), flat)
    return {"value_maps": vm.float().reshape(B, T, *vm.shape[-2:])}


def action(ctx, ev, dtype) -> dict:
    obs = ev["obs"]
    o = vision.Observation(
        rgb=None, depth=obs.depth.to(dtype), obs_stack=None,
        mask_stack=obs.mask_stack.to(dtype), grasp_ok=obs.grasp_ok,
        adaptive_scales=obs.adaptive_scales.to(dtype))
    sel = vision.select_fling(ev["value_maps"][:, 0].to(dtype), o,
                              ctx.rotations.to(dtype))
    p = ev["selection"]
    prog, fh = interp.fling_program(p.p1_world.to(dtype),
                                    p.p2_world.to(dtype), p.p1_grasp,
                                    p.p2_grasp)
    d = p.p1_world.to(dtype) - p.p2_world.to(dtype)
    gd = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    return {"selection": sel, "program": prog, "fling_height": fh,
            "grasp_dist": gd}


# --------------------------------------------------------------------------
# comparisons: program (or control) outputs against the reference's
# --------------------------------------------------------------------------

def _envs_differing(pairs, B) -> int:
    bad = torch.zeros(B, dtype=torch.bool, device=pairs[0][0].device)
    for a, b in pairs:
        diff = (a.float() != b.float()).reshape(B, -1).any(1)
        bad |= diff
    return int(bad.sum())


def compare(stage: str, got: dict, ref: dict) -> dict:
    """Numbers of one stage: got (the program's outputs, or the control's)
    against the reference's."""
    if stage in ("frame", "interpreter_step"):
        out = {"frame_pos_gap_m": _gap(got["positions"], ref["positions"]),
               "frame_vel_gap_mps": _gap(got["velocities"],
                                         ref["velocities"])}
        if stage == "interpreter_step":
            B = got["pc"].shape[0]
            # the interpreter's own state: counters, flags, grasps and
            # every servo quantity, exactly
            out["interp_envs_differing"] = _envs_differing(
                [(got[k], ref[k]) for k in interp.CARRY_FIELDS
                 + ("picked_idx", "picker_pos")], B)
        return out
    if stage == "observation":
        return {"obs_gap": max(_gap(got["obs_stack"], ref["obs_stack"]),
                               _gap(got["mask_stack"], ref["mask_stack"]))}
    if stage == "coverage":
        return {"coverage_rel_gap": max(
            float(((got[k] - ref[k]).abs() / ref[k].abs().clamp(
                min=1e-12)).max()) for k in ref)}
    if stage == "value_maps":
        scale = float(ref["value_maps"].abs().max())
        return {"value_rel_gap": _gap(got["value_maps"], ref["value_maps"])
                / max(scale, 1e-30)}
    if stage == "action":
        s, r = got["selection"], ref["selection"]
        B = s.row.shape[0]
        pairs = [(getattr(s, f), getattr(r, f)) for f in (
            "valid", "transform_idx", "row", "col", "p1_world", "p2_world",
            "p1_grasp", "p2_grasp")]
        pairs += [(getattr(got["program"], f), getattr(ref["program"], f))
                  for f in interp.PROGRAM_FIELDS]
        pairs += [(got[k], ref[k]) for k in ("fling_height", "grasp_dist")]
        return {"action_envs_differing": _envs_differing(pairs, B)}
    raise ValueError(stage)


def program_outputs(stage: str, ev: dict) -> dict:
    """The program's own outputs of a stage, as the evidence holds them."""
    if stage in ("frame", "interpreter_step"):
        after = ev["after"]
        st = after.state if stage == "interpreter_step" else after
        out = {"positions": st.positions, "velocities": st.velocities}
        if stage == "interpreter_step":
            out["picked_idx"] = st.picked_idx
            out["picker_pos"] = st.picker_pos
            for k in interp.CARRY_FIELDS:
                out[k] = getattr(after, k)
        return out
    if stage == "observation":
        return {"obs_stack": ev["obs"].obs_stack,
                "mask_stack": ev["obs"].mask_stack}
    if stage == "coverage":
        return {"pre": ev["pre_coverage"], "post": ev["post_coverage"]}
    if stage == "value_maps":
        return {"value_maps": ev["value_maps"][:, 0]}
    if stage == "action":
        sel = ev["selection"]
        prog = ev["program"]
        return {"selection": vision.Selection(
                    sel.valid, sel.transform_idx, sel.row, sel.col,
                    sel.p1_world, sel.p2_world, sel.p1_grasp, sel.p2_grasp),
                "program": _program(prog),
                "fling_height": ev["carry0"].fling_height,
                "grasp_dist": ev["carry0"].grasp_dist}
    raise ValueError(stage)


# the numbers that each stage's comparison gives
NUMBERS = {
    "frame": ("frame_pos_gap_m", "frame_vel_gap_mps"),
    "interpreter_step": ("frame_pos_gap_m", "frame_vel_gap_mps",
                         "interp_envs_differing"),
    "observation": ("obs_gap",),
    "coverage": ("coverage_rel_gap",),
    "value_maps": ("value_rel_gap",),
    "action": ("action_envs_differing",),
}

STAGES = {"frame": frame, "interpreter_step": interpreter_step,
          "observation": observation, "coverage": coverage,
          "value_maps": value_maps, "action": action}


def _control(ctx, stage, fn, ev):
    """The reference one precision below what the configuration states:
    TF32 for the value net's float32 convolutions (stated with TF32 off),
    bfloat16 for every other float32 stage."""
    if stage != "value_maps":
        return fn(ctx, ev, CONTROL_DTYPE)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn(ctx, ev, torch.float32)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def judge(ctx, evidence: dict, control: bool = False) -> dict:
    """{number name: value} over every stage the window left evidence of.
    With control, the reference one precision lower stands in for the
    program."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    numbers = {}
    for stage, ev in evidence.items():
        fn = STAGES[stage]
        ref = fn(ctx, ev, torch.float32)
        got = _control(ctx, stage, fn, ev) if control else \
            program_outputs(stage, ev)
        numbers.update(compare(stage, got, ref))
        del ref, got
    return numbers
