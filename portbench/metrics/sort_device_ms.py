"""sort_device_ms: device ms per batched solver frame launched inside the
program's solver.contacts.sort spans: the Morton keys, the segmented
radix sort and the gathers into sorted order (portbench.stages ties each
device operation to the stage that launched it)."""

from portbench.stages import device_ms


def read(run):
    return device_ms(run, ("solver.contacts.sort",))
