"""K3's share of its roofline in the traced window of a selfplay cell, in %:
its frozen bound for the env resets it did there over its device time
(cogbench.roofline)."""
from cogbench.roofline import share


def read(run):
    return share(run, "k3")
