"""The device's idle time inside a ``rollout_chunked`` call's start and end
spans (``ed.rollout.begin``: the batch split and the loop's allocations;
``ed.rollout.end``: the last queues, the map-failure reads, the sweep and
the merge), in microseconds, summed per call and averaged over the traced
calls (``ed.rollout`` spans)."""
from cogbench import spans as S


def read(run):
    if run.trace is None:
        return None
    calls = S.intervals(run.trace, "ed.rollout")
    if not calls:
        return None
    idle = S.Idle(run.trace)
    edges = S.intervals(run.trace, "ed.rollout.begin") \
        + S.intervals(run.trace, "ed.rollout.end")
    return sum(idle.within(a, b) for a, b in edges) / len(calls)
