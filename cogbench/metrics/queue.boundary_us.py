"""The device's gap from the end of one chunk's K1 launch to the start of
the next, in microseconds, the mean over the traced boundaries: the chunk
boundary's sort, count read, K3, K2 and host work as the card sees them
(a call's end and the next call's start included)."""


def read(run):
    if run.trace is None:
        return None
    k1 = run.trace.kernels(run.work("k1")["trace_name"])
    gaps = [b[0] - (a[0] + a[1]) for a, b in zip(k1, k1[1:])]
    return sum(gaps) / len(gaps) if gaps else None
