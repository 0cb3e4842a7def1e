"""The device's gap from the end of one K1 launch to the start of the next,
in microseconds, the mean over the gaps that lie wholly inside one
``ed.rollout`` span: the chunk boundary alone, without a call's edge
(``queue.boundary_us`` with the gaps between calls left out)."""
from cogbench import spans as S


def read(run):
    if run.trace is None:
        return None
    calls = S.intervals(run.trace, "ed.rollout")
    k1 = run.trace.kernels(run.work("k1")["trace_name"])
    gaps = [(a + d, b) for (a, d), (b, _) in zip(k1, k1[1:])]
    inner = S.inside(gaps, calls)
    return S.total_us(inner) / len(inner) if inner else None
