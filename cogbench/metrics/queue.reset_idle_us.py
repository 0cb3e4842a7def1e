"""The device's idle time inside a chunk boundary's reset queue (an
``ed.reset`` span inside ``ed.rollout`` and not inside ``ed.rollout.end``:
the host building and launching K3 and K2; the sweep's resets are left
out), in microseconds, the mean over those queues."""
from cogbench import spans as S


def read(run):
    if run.trace is None:
        return None
    ends = S.intervals(run.trace, "ed.rollout.end")
    queues = [iv for iv in S.inside(S.intervals(run.trace, "ed.reset"),
                                    S.intervals(run.trace, "ed.rollout"))
              if not S.within(iv, ends)]
    if not queues:
        return None
    idle = S.Idle(run.trace)
    return sum(idle.within(a, b) for a, b in queues) / len(queues)
