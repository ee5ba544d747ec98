"""The port's tracer: named spans on the host clock, kept in memory, and
counters of the program's events.

    from flingbot_tpu_torch.utils import trace

    trace.enable()
    ...                                  # solver frames record their spans
    spans, counts = trace.drain()        # and empties the record
    trace.disable()

A span is the tuple (name, id, parent id, frame id, t0, t1): t0 and t1 on
`time.perf_counter`, the clock a device trace can be tied to; the parent
is the innermost span open when it began (None for a root), and the frame
id is the id of the root span that holds it (a root's own id).  Spans are
recorded only while tracing is on, which is not the default: off, `span`
returns one shared object that reads no clock and records nothing.

Counters are always on: `count(name)` adds to COUNTS, and the kernel
wrappers of `engine.kernels` add their launches to LAUNCHES (which is
`kernels.LAUNCHES`: this module imports nothing of the engine).
`host_syncs` counts the uploads of `upload`, each a copy from host memory
that on a card waits until the device has run every operation queued
before it; `const_hits` counts the solver's constants that
`engine.state.device_constant` found already on the device, with no
upload.
"""

from __future__ import annotations

import time

import torch

COUNTS: dict = {}
LAUNCHES: dict = {}  # kernel launches by kernel name, kept by engine.kernels

_on = False
_spans: list = []
_open: list = []  # (name, id, frame id, t0) of the spans open now
_next_id = 0


class _Off:
    """The span while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _next_id
        _next_id += 1
        frame = _open[0][2] if _open else _next_id
        _open.append((self.name, _next_id, frame, time.perf_counter()))
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        name, sid, frame, t0 = _open.pop()
        parent = _open[-1][1] if _open else None
        _spans.append((name, sid, parent, frame, t0, t1))
        return False


def span(name: str):
    """A context manager that records `name` around its block while
    tracing is on."""
    return _Span(name) if _on else _OFF


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def count(name: str, n: int = 1):
    COUNTS[name] = COUNTS.get(name, 0) + n


def drain():
    """(spans, counts): the spans ended since the last drain, in the order
    they ended, and the counters since then (COUNTS, host_syncs and
    const_hits among them even where they stayed 0, and a copy of the
    kernel launch counters under "launches"); empties both records."""
    spans = list(_spans)
    _spans.clear()
    counts = dict({"host_syncs": 0, "const_hits": 0}, **COUNTS,
                  launches=dict(LAUNCHES))
    COUNTS.clear()
    return spans, counts


def upload(data, *, dtype, device) -> torch.Tensor:
    """torch.tensor(data, dtype=dtype, device=device), counted under
    host_syncs and recorded as a solver.sync span: on a card the copy from
    pageable host memory returns only after the device has drained its
    stream.  engine.state.device_constant calls it for each constant of
    the solver the first time the process meets its value."""
    count("host_syncs")
    with span("solver.sync"):
        return torch.tensor(data, dtype=dtype, device=device)
