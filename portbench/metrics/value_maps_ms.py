"""value_maps_ms: host-clock ms of MaximumValuePolicy.batch_value_maps on
the window's observations (the net on every env's 96 views), the
harness's span ending in a synchronize."""


def read(run):
    d = run.spans.durations("value_maps")
    return 1e3 * sum(d) / len(d) if d else None
