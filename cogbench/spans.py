"""What the program's own spans say in a traced run.

The port marks its steps with named host spans (``ed.rollout``,
``ed.queue.count_read``, ``ed.step`` and kin), which the profiler writes
as ``user_annotation`` events on the clock of the device's operations, so
`Trace.host` holds them beside the device's kernels. This module finds
them by name, tells which lie inside which, and measures the device's
idle time inside a host interval. A trace of a program without the spans
gives empty lists, and the metrics that read them return None.
"""
from __future__ import annotations

import bisect

# the trace's times are whole nanoseconds in microseconds: a child span
# whose end rounds past its parent's by less than this is inside it
EPS_US = 1e-3


def intervals(trace, name: str) -> list:
    """(start us, end us) of every host span called ``name``, in start
    order."""
    return sorted((ts, ts + d) for n, ts, d in trace.host if n == name)


def within(iv, outer: list) -> bool:
    """Whether the interval ``iv`` lies inside one of ``outer`` (intervals
    in start order that do not overlap one another)."""
    i = bisect.bisect_right(outer, (iv[0] + EPS_US, float("inf"))) - 1
    return i >= 0 and outer[i][0] <= iv[0] + EPS_US \
        and iv[1] <= outer[i][1] + EPS_US


def inside(spans: list, outer: list) -> list:
    """The intervals of ``spans`` that lie inside one of ``outer``."""
    return [iv for iv in spans if within(iv, outer)]


def total_us(spans: list) -> float:
    return sum(b - a for a, b in spans)


class Idle:
    """The device's idle time inside host intervals: an interval's length
    less its overlap with the union of the device's operations."""

    def __init__(self, trace):
        busy = trace.busy_intervals()
        self.starts = [a for a, _ in busy]
        self.ends = [b for _, b in busy]
        self.before = [0.0]
        for a, b in busy:
            self.before.append(self.before[-1] + b - a)

    def busy(self, a: float, b: float) -> float:
        """Microseconds of [a, b] in which some device operation ran."""
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if j <= i:
            return 0.0
        out = self.before[j] - self.before[i]
        out -= max(0.0, a - self.starts[i])
        out -= max(0.0, self.ends[j - 1] - b)
        return out

    def within(self, a: float, b: float) -> float:
        """Microseconds of [a, b] in which no device operation ran."""
        return max(0.0, b - a - self.busy(a, b))
