"""The share of K3's lane-time that its queued envs spend finished while
the launch waits for its slowest env, in %: 100 * (1 - trips / slowest-lane
trips), over every queued reset of the process's chunked rollouts, as the
system counts them (`eldorado_tpu_torch.vec.queue_work`: the generator
trips of each queued env, and each queue's count times its most trips).
None where the system has no such count or reset no env."""


def read(run):
    from eldorado_tpu_torch import vec
    queue_work = getattr(vec, "queue_work", None)
    if queue_work is None:
        return None
    w = queue_work()
    if not w["slowest_lane_trips"]:
        return None
    return 100.0 * (1.0 - w["trips"] / w["slowest_lane_trips"])
