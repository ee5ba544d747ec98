"""glue_device_ms: device ms per batched solver frame launched outside
the two kernels' and the sort's spans: in solver.prep (the lattice mask,
inverse masses, kernel parameters), in solver.contacts.apply (the scatter
back, the plane, the clamped velocity add, the picker push) and in
solver.step outside any child span (portbench.stages.GLUE)."""

from portbench.stages import GLUE, device_ms


def read(run):
    return device_ms(run, GLUE)
