"""Host microseconds of ``VecEnv.step`` less its count read and its reset
queue (an ``ed.step`` span less its ``ed.k1act.read`` and ``ed.reset``
children: the checks, K1-act's launch, the done compare and the sort), the
mean over the ``ed.step`` spans. With ``learner.count_read_us`` and
``learner.reset_host_us`` it sums to the mean ``ed.step`` span."""
from cogbench import spans as S


def read(run):
    if run.trace is None:
        return None
    steps = S.intervals(run.trace, "ed.step")
    if not steps:
        return None
    children = S.inside(S.intervals(run.trace, "ed.k1act.read")
                        + S.intervals(run.trace, "ed.reset"), steps)
    return (S.total_us(steps) - S.total_us(children)) / len(steps)
