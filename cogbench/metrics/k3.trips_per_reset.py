"""K3's generator trips an env reset, over every queued reset of the
process's chunked rollouts, as the system counts them
(`eldorado_tpu_torch.vec.queue_work`). None where the system has no such
count or reset no env."""


def read(run):
    from eldorado_tpu_torch import vec
    queue_work = getattr(vec, "queue_work", None)
    if queue_work is None:
        return None
    w = queue_work()
    if not w["resets"]:
        return None
    return w["trips"] / w["resets"]
