"""A stage's share of its roofline: the least time its work could take on
the chip (portbench.workmodel: bytes over the HBM rate or f32 operations
over the f32 peak, whichever is larger) over the device time of the
kernels that kernel_maps/ assign to the stage."""

from portbench import workmodel


def share(run, stage):
    if run.trace is None:
        return None
    secs = run.trace.stage_s.get(stage, 0.0)
    nbytes, ops = run.stage_work.get(stage, (0.0, 0.0))
    if secs <= 0 or ops <= 0:
        return None
    return 100.0 * workmodel.bound_seconds(nbytes, ops) / secs
