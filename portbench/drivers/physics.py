"""Raw physics: the task set's crumpled start states, pickers parked, one
engine.solver.step frame after another at the production knobs, so the
cloths fall and settle (the task generator's settle traffic).  No
interpreter, env step, render or policy.

Set-up: the task set, the batch's scene (make_batch), one frame.  The
window runs frames back to back until `seconds` have passed and ends in a
device synchronize; its solver_step spans follow each other without a
gap, the last one ending in that synchronize.  One frame of the window,
drawn from the seed, keeps its input and output for the correctness
check.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import harness


def run(ctx):
    from flingbot_tpu_torch.engine.solver import step
    from flingbot_tpu_torch.engine.state import SolverParams
    from flingbot_tpu_torch.env.scene import make_batch, scene_task
    from flingbot_tpu_torch.env.tasks import TaskLoader

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    loader = TaskLoader(ctx.cell.data_path("tasks"), repeat=True)
    tasks = [loader.get_next_task() for _ in range(len(loader))]
    B = int(tr["num_envs"])
    order = [int(i) for i in harness.task_order(len(tasks), B, ctx.seed)]
    topo, state = make_batch([scene_task(tasks[i]) for i in order],
                             max_grid_dim=cfg["max_grid_dim"], device=dev)
    params = SolverParams()
    state = step(state, topo, params, **ctx.knobs)
    ctx.sync()

    rng = np.random.default_rng([int(ctx.seed), 1])
    check_frame = int(rng.integers(1, ctx.cell.cell["check_frame_max"] + 1))
    spans = harness.Spans()
    evidence = {}
    frames = 0
    window = ctx.window()
    with window:
        deadline = window.t0 + ctx.seconds
        ts = time.perf_counter()
        while True:
            before = ctx.clone(state) if frames == check_frame else None
            state = step(state, topo, params, **ctx.knobs)
            if before is not None:
                evidence["frame"] = dict(before=before, after=state,
                                         order=order)
            frames += 1
            over = time.perf_counter() >= deadline and "frame" in evidence
            if over:
                ctx.sync()
            # the spans tile the window: the frames run on the device
            # behind the host, and the last span waits for them
            te = time.perf_counter()
            spans.add("solver_step", ts, te)
            ts = te
            if over:
                break
    sw, cw = ctx.stage_work(topo, state.active)
    run = harness.Run(window_s=window.seconds, setup_s=window.setup_s,
                      env_frames=frames * B, frames=frames, spans=spans,
                      frame_spans=("solver_step",),
                      stage_work={
                          "springs": (frames * float(np.sum(sw[0])),
                                      frames * float(np.sum(sw[1]))),
                          "contacts": (frames * float(np.sum(cw[0])),
                                       frames * float(np.sum(cw[1])))},
                      trace=window.trace_summary(spans),
                      window_peak_bytes=window.peak_bytes)
    failed = int((~ctx.torch.isfinite(state.positions)).reshape(
        B, -1).any(1).sum())
    del state, topo
    return run, evidence, B * frames, failed
