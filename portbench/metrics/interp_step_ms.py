"""interp_step_ms: host-clock ms per interpreter step, the wall of whole
run_program chunks (each ending in the host's read of the done mask)
over the interpreter steps they ran."""


def read(run):
    if not run.interp_steps:
        return None
    return 1e3 * run.chunk_s / run.interp_steps
