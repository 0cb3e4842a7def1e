"""The device's idle time inside a chunk boundary's count read (the
``ed.queue.count_read`` span: the host reading back how many envs the
queue takes), in microseconds, the mean over the traced boundaries."""
from cogbench import spans as S


def read(run):
    if run.trace is None:
        return None
    reads = S.intervals(run.trace, "ed.queue.count_read")
    if not reads:
        return None
    idle = S.Idle(run.trace)
    return sum(idle.within(a, b) for a, b in reads) / len(reads)
