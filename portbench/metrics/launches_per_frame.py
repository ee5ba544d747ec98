"""launches_per_frame: device kernels that ran inside the spans in which
the window's frames ran, per batched solver frame (a count; copies and
fills not included)."""


def read(run):
    if run.trace is None or not run.frames or not run.frame_spans:
        return None
    _, count = run.trace.in_spans(run.frame_spans)
    return count / run.frames if count else None
