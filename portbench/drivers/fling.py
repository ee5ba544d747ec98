"""The collect and eval loop of FlingBot, closed: every env slot runs
fling episodes, each step chosen by the value net on the env's 96-view
observation (BatchSimEnv.begin_step -> run_program chunks -> end_step,
MaximumValuePolicy.batch_value_maps).

Set-up: the task set and the checkpoint, the env reset (scene load,
settle, render, views), the value maps of the first observation, and one
begin_step and one program chunk, whose results are dropped (every shape
the window uses, warmed).  The window then starts again at that
begin_step and runs whole chunks, with each end of step and the next
step's value maps and begin_step between them, until `seconds` have
passed and every stage whose numbers the cell's limits name has left its
evidence: a first program longer than `seconds` lengthens the window to
its end of step and one chunk after it.  One chunk of the window, drawn
from the seed, is a single interpreter step, whose input and output the
correctness check keeps.

Work: the env-frames the programs advanced (Carry.total_steps), so envs
whose program has ended count nothing.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import checks, harness

# the stages of checks.py whose evidence this driver leaves
STAGES = ("interpreter_step", "observation", "coverage", "value_maps",
          "action")


def _slot_tasks(env, index_of):
    return [index_of[t.name] for t in env.tasks]


def run(ctx):
    torch = ctx.torch
    from flingbot_tpu_torch.env.batch_env import BatchSimEnv
    from flingbot_tpu_torch.env.tasks import (
        TaskLoader, detect_topology_buckets)
    from flingbot_tpu_torch.learning.nets import MaximumValuePolicy
    from flingbot_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    task_path = ctx.cell.data_path("tasks")
    loader = TaskLoader(task_path, repeat=True)
    tasks = [loader.get_next_task() for _ in range(len(loader))]
    index_of = {t.name: i for i, t in enumerate(tasks)}
    B = int(tr["num_envs"])

    def task_source():
        block = 0
        while True:
            for i in harness.task_order(len(tasks), B, ctx.seed, block):
                yield tasks[int(i)]
            block += 1

    source = task_source()
    policy = MaximumValuePolicy(["fling"], cfg["obs_dim"], device=dev)
    load_checkpoint(ctx.cell.data_path("policy"), policy)
    policy.action_expl_prob = policy.value_expl_prob = 0.0
    env = BatchSimEnv(
        get_task_fn=lambda: next(source), num_envs=B,
        replay_buffer_path=None, episode_length=int(tr["episode_length"]),
        max_grid_dim=cfg["max_grid_dim"], **detect_topology_buckets(
            task_path),
        obs_dim=cfg["obs_dim"], num_rotations=cfg["num_rotations"],
        scale_factors=tuple(cfg["scale_factors"]),
        action_primitives=tuple(tr["primitives"]),
        render_dim=cfg["render_dim"], chunk_steps=int(tr["chunk_steps"]),
        max_program_steps=int(tr["max_program_steps"]),
        seed=ctx.seed, device=dev, **ctx.knobs)
    obs = env.reset()
    vm = policy.batch_value_maps(obs)
    warm = env.begin_step(vm)
    env.run_program(warm, warm.carry, env.chunk_steps)
    del warm
    ctx.sync()

    rng = np.random.default_rng([int(ctx.seed), 1])
    check_chunk = int(rng.integers(1, ctx.cell.cell["check_chunk_max"] + 1))
    limits = set(ctx.cell.cell["limits"])
    needed = {s for s in STAGES if limits & set(checks.NUMBERS[s])}
    spans = harness.Spans()
    evidence, programs = {}, []
    redraws = []
    frames = interp_steps = chunks = 0
    window = ctx.window()
    with window:
        deadline = window.t0 + ctx.seconds
        over = False
        while not over:
            ts = time.perf_counter()
            start = env.begin_step(vm)
            order = _slot_tasks(env, index_of)
            carry, n_chunks = start.carry, 0
            ctx.sync()
            spans.add("begin_step", ts, time.perf_counter())
            evidence["action"] = dict(
                obs=env.obs, value_maps=vm, selection=start.selection,
                program=start.prog, carry0=start.carry)
            programs.append((env.topo, env.state.active, start))
            done_all = False
            while not done_all:
                ts = time.perf_counter()
                one = chunks == check_chunk
                steps = 1 if one else env.chunk_steps
                before = ctx.clone(carry) if one else None
                carry, done = env.run_program(start, carry, steps)
                done_all = bool(done.all())
                te = time.perf_counter()
                spans.add("run_program", ts, te)
                if one:
                    evidence["interpreter_step"] = dict(
                        before=before, after=carry, program=start.prog,
                        max_steps=start.max_steps, order=order)
                chunks += 1
                n_chunks += 1
                frames += steps
                interp_steps += steps
                if te >= deadline and needed <= evidence.keys():
                    over = True
                    break
            programs[-1] = programs[-1] + (carry.total_steps,)
            if over:
                break
            ts = time.perf_counter()
            obs = env.end_step(start, carry, n_chunks)
            reloaded = np.flatnonzero(env.timesteps == 0)
            if len(reloaded):
                redraws.append(reloaded)
            ctx.sync()
            spans.add("end_step", ts, time.perf_counter())
            if "observation" not in evidence:
                evidence["observation"] = dict(
                    state=env.state, obs=env.obs,
                    order=_slot_tasks(env, index_of),
                    palette_redraws=list(redraws))
                evidence["coverage"] = dict(
                    pre_positions=start.pre_positions,
                    post_positions=carry.state.positions,
                    active=carry.state.active,
                    pre_coverage=start.pre_coverage,
                    post_coverage=env.last.post_coverage)
            ts = time.perf_counter()
            vm = policy.batch_value_maps(obs)
            ctx.sync()
            spans.add("value_maps", ts, time.perf_counter())
            if "value_maps" not in evidence:
                evidence["value_maps"] = dict(obs_stack=obs, value_maps=vm)
    env_frames = 0
    springs, contacts = [0, 0], [0, 0]
    for topo, active, start, total in programs:
        per_env = total.cpu().numpy()
        env_frames += int(per_env.sum())
        sw, cw = ctx.stage_work(topo, active)
        for k in range(2):
            springs[k] += float(np.dot(per_env, sw[k]))
            contacts[k] += float(np.dot(per_env, cw[k]))
    failed = int((~torch.isfinite(carry.state.positions)).reshape(
        B, -1).any(1).sum())
    run = harness.Run(window_s=window.seconds, setup_s=window.setup_s,
                      env_frames=env_frames, frames=frames,
                      frame_spans=("run_program",),
                      interp_steps=interp_steps,
                      chunk_s=spans.total("run_program"), spans=spans,
                      stage_work={"springs": tuple(springs),
                                  "contacts": tuple(contacts)},
                      trace=window.trace_summary(spans),
                      window_peak_bytes=window.peak_bytes)
    attempted = B * len(programs)
    del env, policy, obs, start, carry
    return run, evidence, attempted, failed
