"""Host microseconds of the round's reset queue (the ``ed.reset`` spans
inside ``ed.step``: K3's prelude and launch, K2's launch, the map flags),
summed over the number of ``ed.step`` spans: per round, so near 0 where
games are long."""
from cogbench import spans as S


def read(run):
    if run.trace is None:
        return None
    steps = S.intervals(run.trace, "ed.step")
    if not steps:
        return None
    resets = S.inside(S.intervals(run.trace, "ed.reset"), steps)
    return S.total_us(resets) / len(steps)
