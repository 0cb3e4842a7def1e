"""Host microseconds of K1-act's count read (the ``ed.k1act.read`` span:
the round's one wait on the card), summed inside the ``ed.step`` spans
over their number: the mean read, one a step."""
from cogbench import spans as S


def read(run):
    if run.trace is None:
        return None
    steps = S.intervals(run.trace, "ed.step")
    if not steps:
        return None
    reads = S.inside(S.intervals(run.trace, "ed.k1act.read"), steps)
    return S.total_us(reads) / len(steps)
