"""Host microseconds of one ``VecEnv.step()`` call (K1-act, the count read
back, and the round's reset queue), the mean over the window's rounds."""


def read(run):
    return run.counters.get("step_us")
