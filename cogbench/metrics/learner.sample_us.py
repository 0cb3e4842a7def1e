"""Host microseconds of one ``VecEnv.sample()`` call, the mean over the
window's rounds."""


def read(run):
    return run.counters.get("sample_us")
