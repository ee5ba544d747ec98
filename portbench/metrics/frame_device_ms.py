"""frame_device_ms: device ms per solver frame, the device operations
(torch.profiler) that ran inside the spans in which the window's frames
ran (run_program chunks, or solver steps), over those batched frames.
The end of step, render, views and value net are not in it; in a fling
cell the interpreter's own per-frame operations are (no span yet
separates them from solver.step's)."""


def read(run):
    if run.trace is None or not run.frames or not run.frame_spans:
        return None
    secs, _ = run.trace.in_spans(run.frame_spans)
    return 1e3 * secs / run.frames if secs > 0 else None
