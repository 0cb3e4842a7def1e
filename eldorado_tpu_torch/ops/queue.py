"""The chunk loop's reset queue on the card: `select` and `settle`
(csrc/queue.cu), around K3 and K2 launched at the queue's capacity with
its count in device memory, so that a chunk boundary reads nothing back.
`vec.VecEnv`'s step takes a queue by `select` alone (K3 writes each env's
own map flags there, and no tally is kept).

A queue is ``idx`` ((q_cap,) int32) and ``count`` ((1,) int32): the envs
in ``idx[:count]``, ascending, then the batch size ``n`` in every slot past
them. ``tally`` ((3,) int64) accumulates a loop's queues: episodes (envs
reset), whether a map generation failed, whether one overflowed. The
optional ``counters`` = (work, sums) accumulate K3's work: ``work``
((q_cap, 2) int32) holds each queued env's generator trips and retries as
K3 wrote them, and ``sums`` ((2,) int64) gains the queue's trips and
count x its most trips (the lanes' time K3's launch holds while it waits
for its slowest env).

Each function dispatches on the device of its tensors: CPU tensors take
the plain torch version (`select_plain`, `settle_plain`), CUDA tensors
launch the kernel. `launch_select` and `launch_settle` are the launches
alone, on tensors `check` has checked. Launches are counted in
``select.launches`` and ``settle.launches``.
"""
from __future__ import annotations

import torch

from . import build
from .step_kernel import _check, _device_of

_i32 = torch.int32


def _queue_args(n, idx, count, inflight) -> list:
    q_cap = idx.shape[0]
    if not 1 <= q_cap <= 1024:
        raise ValueError(f"a queue holds 1 to 1024 envs, not {q_cap}")
    _check(idx, "idx", (q_cap,))
    _check(count, "count", (1,))
    if inflight is None:
        return [idx, count]
    _check(inflight, "inflight", (n,), torch.bool)
    return [idx, count, inflight]


def _select_args(done, inflight, idx, count) -> list:
    _check(done, "done", (done.shape[0],))
    return [done] + _queue_args(done.shape[0], idx, count, inflight)


def _settle_args(idx, count, ok, overflow, inflight, tally,
                 counters=None) -> list:
    n = ok.shape[0]
    _check(ok, "ok", (n,), torch.bool)
    _check(overflow, "overflow", (n,), torch.bool)
    _check(tally, "tally", (3,), torch.int64)
    args = [ok, overflow, tally] + _queue_args(n, idx, count, inflight)
    if counters is None:
        return args
    work, sums = counters
    _check(work, "work", (idx.shape[0], 2))
    _check(sums, "sums", (2,), torch.int64)
    return args + [work, sums]


def check(done, inflight, idx, count, ok, overflow, tally, counters=None):
    """The checks of a queue's tensors for a batch of n envs: ``done``
    (n,) int32 (the carry's done row), ``inflight`` (n,) bool or None,
    ``idx`` (q_cap,) and ``count`` (1,) int32 with 1 <= q_cap <= 1024,
    ``ok`` / ``overflow`` (n,) bool (the batch's map flags), ``tally``
    (3,) int64, ``counters`` None or (work (q_cap, 2) int32, sums (2,)
    int64). Returns their device."""
    return _device_of(_select_args(done, inflight, idx, count)
                      + _settle_args(idx, count, ok, overflow, inflight,
                                     tally, counters))


def select_plain(done, inflight, idx, count):
    """Plain version of `select`."""
    take = done != 0
    if inflight is not None:
        take &= ~inflight
    rows = torch.nonzero(take).flatten()[:idx.shape[0]]
    idx.fill_(done.shape[0])
    idx[:rows.numel()] = rows.to(_i32)
    count.fill_(rows.numel())
    if inflight is not None:
        inflight[rows] = True


def check_select(done, inflight, idx, count):
    """`select`'s checks of its tensors (`check`'s first half, for a queue
    that no settle follows). Returns their device."""
    return _device_of(_select_args(done, inflight, idx, count))


def select(done, inflight, idx, count):
    """Take the next queue: the lowest-indexed envs that are done (``done``
    != 0) and, with ``inflight``, not in flight, up to q_cap, into ``idx``
    and ``count``; with ``inflight``, mark them in flight. One block on
    the card."""
    if check_select(done, inflight, idx, count).type == "cpu":
        return select_plain(done, inflight, idx, count)
    launch_select(done, inflight, idx, count)


def launch_select(done, inflight, idx, count) -> None:
    """`select`'s launch alone, on checked CUDA tensors."""
    with torch.cuda.device(done.device):
        err = build.load().ed_queue_select(
            done.data_ptr(), None if inflight is None else inflight.data_ptr(),
            idx.data_ptr(), count.data_ptr(), done.shape[0], idx.shape[0],
            torch.cuda.current_stream(done.device).cuda_stream)
    build.check(err, "queue_select")
    select.launches += 1


select.launches = 0


def settle_plain(idx, count, ok, overflow, inflight, tally, counters=None):
    """Plain version of `settle`."""
    k = int(count)
    if not k:
        return
    rows = idx[:k].long()
    all_ok, any_over = ok[rows].all(), overflow[rows].any()
    ok[rows] = all_ok
    overflow[rows] = any_over
    tally[0] += k
    tally[1] |= (~all_ok).long()
    tally[2] |= any_over.long()
    if inflight is not None:
        inflight[rows] = False
    if counters is not None:
        work, sums = counters
        trips = work[:k, 0].long()
        sums[0] += trips.sum()
        sums[1] += k * trips.max()


def settle(idx, count, ok, overflow, inflight, tally, counters=None):
    """Settle a queue after its K3 and K2: every env of it records the
    whole queue's map outcome in ``ok`` / ``overflow`` (all ok; any
    overflow), as the JAX package's reset queue does (vec.py:_apply_q);
    ``tally`` gains the queue's envs, its failure and its overflow; with
    ``inflight``, its envs leave flight; with ``counters``, their sums
    gain the queue's K3 work. One block on the card."""
    args = _settle_args(idx, count, ok, overflow, inflight, tally, counters)
    if _device_of(args).type == "cpu":
        return settle_plain(idx, count, ok, overflow, inflight, tally,
                            counters)
    launch_settle(idx, count, ok, overflow, inflight, tally, counters)


def launch_settle(idx, count, ok, overflow, inflight, tally,
                  counters=None) -> None:
    """`settle`'s launch alone, on checked CUDA tensors."""
    work, sums = counters or (None, None)
    with torch.cuda.device(idx.device):
        err = build.load().ed_queue_settle(
            idx.data_ptr(), count.data_ptr(), ok.data_ptr(),
            overflow.data_ptr(),
            None if inflight is None else inflight.data_ptr(),
            tally.data_ptr(), None if work is None else work.data_ptr(),
            None if sums is None else sums.data_ptr(), idx.shape[0],
            torch.cuda.current_stream(idx.device).cuda_stream)
    build.check(err, "queue_settle")
    settle.launches += 1


settle.launches = 0
