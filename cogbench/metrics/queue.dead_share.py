"""The window's dead env-steps (ended envs waiting for their reset, exact
mode's count) as a share of all its env-steps, in %."""


def read(run):
    return run.counters.get("dead_share")
