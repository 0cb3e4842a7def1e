"""K1's share of its roofline in the traced window, in %: its frozen
bound for the work it did there over its device time (cogbench.roofline)."""
from cogbench.roofline import share


def read(run):
    return share(run, "k1")
