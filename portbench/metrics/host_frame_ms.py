"""host_frame_ms: the host's own ms per solver frame: each solver.step
span's length less the time inside its solver.sync spans (the blocking
uploads, in which the host waits for the device), averaged over the
window's frames; read from run.program's spans, None without them."""


def read(run):
    p = getattr(run, "program", None)
    if p is None:
        return None
    own = {s[1]: s[5] - s[4] for s in p.spans if s[0] == "solver.step"}
    for s in p.spans:
        if s[0] == "solver.sync" and s[3] in own:
            own[s[3]] -= s[5] - s[4]
    return 1e3 * sum(own.values()) / len(own) if own else None
