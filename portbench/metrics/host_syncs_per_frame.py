"""host_syncs_per_frame: the program's host_syncs counter over the window
(the blocking uploads of flingbot_tpu_torch.utils.trace.upload, each of
which waits on a card until the device has drained its stream) per
batched solver frame; read from run.program, the program's record that
portbench.stages attaches, None without it."""


def read(run):
    p = getattr(run, "program", None)
    if p is None or not run.frames or "host_syncs" not in p.counts:
        return None
    return p.counts["host_syncs"] / run.frames
