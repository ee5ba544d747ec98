"""substeps_roofline: the springs stage's share of its roofline
(the grid cloths' substeps_work over the kernels mapped to "springs")."""

from portbench.metrics._roofline import share


def read(run):
    return share(run, "springs")
