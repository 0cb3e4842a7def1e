"""The share of the traced window of a learner cell in which no operation ran
on the device, in %: 1 - (the union of its operations' intervals) / the
window."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
