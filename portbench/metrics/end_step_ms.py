"""end_step_ms: host-clock ms of one end of step, the harness's spans
around BatchSimEnv.end_step (post coverage, render, 96 views, replay
record, reloads) and the next begin_step (selection, program build), each
ending in a synchronize; the value maps are not in it."""


def read(run):
    ends = run.spans.durations("end_step")
    if not ends:
        return None
    begins = run.spans.durations("begin_step")[1:len(ends) + 1]
    return 1e3 * (sum(ends) + sum(begins)) / len(ends)
