"""contacts_roofline: the contacts stage's share of its roofline
(contacts_work of the active particles over the kernels mapped to
"contacts")."""

from portbench.metrics._roofline import share


def read(run):
    return share(run, "contacts")
