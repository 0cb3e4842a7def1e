"""`rollout_chunked(reset_mode="async")` against the JAX package, tolerance
zero, and the deferred reset it is built on.

The async mode resets each boundary's queue one boundary later, after the
next chunk's K1 launch, with an in-flight mask keeping the queued envs
out of the next queue. On CPU tensors (plain K1 and K2) it is held to the
JAX package's ``rollout_chunked(backend="kernel", block=8,
interpret=True, reset_mode="async")`` with ``exact`` off here and on in
test_torch_async_exact.py (a file of its own, so that the two JAX
programs, about 45 s each to build, build on two workers): every EnvState
field, the sampler engines, the episodes and the dead steps, with resets
queued at three or more boundaries. The queues themselves are checked
where more envs finish than a queue holds, a queued env's reset one chunk
late is checked against its immediate reset, an empty queue leaves the
sync result, an unknown mode raises, and so does a queue whose map
generation fails.
"""
import numpy as np
import pytest
import torch

import eldorado_tpu_torch as et
from eldorado_tpu import vec as JV
from eldorado_tpu_torch import convert, vec
from eldorado_tpu_torch.core import engine as E
from eldorado_tpu_torch.ops.step_kernel import fused_step
from test_torch_vec import assert_states_equal

# test_api_surfaces' async setting (the same JAX program), with 8-turn
# games so that every boundary queues resets
N, PLAYERS, PIECES, MAX_STEPS, STEPS, CHUNK = 8, 4, 1, 8, 200, 50
_i32 = torch.int32


class Queues:
    """Records the envs of every queued reset that was not empty (the
    chunk loop's `vec._ChunkLoop._reset`, the first ``count`` slots of its
    queue) while it is entered; the final sweep is not one."""

    def __enter__(self):
        self.seen, self._orig = [], vec._ChunkLoop._reset

        def spy(loop, ci, queue):
            idx, count = queue
            if int(count):
                self.seen.append(idx[:int(count)].tolist())
            return self._orig(loop, ci, queue)
        vec._ChunkLoop._reset = spy
        return self.seen

    def __exit__(self, *exc):
        vec._ChunkLoop._reset = self._orig


def check_against_jax(exact: bool):
    with Queues() as queues:
        ours = et.rollout_chunked(
            et.vec_reset(5, N, PLAYERS, PIECES, 0, MAX_STEPS, device="cpu"),
            et.sampler_init(11, N, device="cpu"), STEPS, CHUNK, exact=exact,
            reset_mode="async")
    theirs = JV.rollout_chunked(
        JV.vec_reset(5, N, PLAYERS, PIECES, 0, MAX_STEPS),
        JV.sampler_init(11, N), STEPS, CHUNK, backend="kernel", block=8,
        interpret=True, reset_mode="async", exact=exact)
    assert_states_equal(ours[0], theirs[0])
    assert np.array_equal(convert.rngs_to_numpy(ours[1]),
                          np.asarray(theirs[1]))
    assert ours[2:] == tuple(theirs[2:])
    assert len(queues) >= 3   # resets queued at three boundaries
    # the deferred resets are not the sync mode's
    sync = et.rollout_chunked(
        et.vec_reset(5, N, PLAYERS, PIECES, 0, MAX_STEPS, device="cpu"),
        et.sampler_init(11, N, device="cpu"), STEPS, CHUNK, exact=exact)
    assert sync[2] != ours[2]


def test_async_equals_jax():
    check_against_jax(exact=False)


def test_queue_overflow_defers_the_rest():
    """160 one-turn games over 8-step chunks: more than Q = 128 envs
    finish by the first boundary, whose queue takes the lowest 128; the
    rest stay done and unqueued until a later boundary. Each queue is taken lowest index first, holds no env of the
    queue still in flight before it, and every queued env is reset, the
    last queue after the last chunk."""
    n = 160
    with Queues() as queues:
        s, _, episodes = et.rollout_chunked(
            et.vec_reset(5, n, 2, 1, 0, 1, device="cpu"),
            et.sampler_init(11, n, device="cpu"), 24, 8, reset_mode="async")
    assert not bool(s.done.any())
    vec.check_map_generation(s)
    assert len(queues) == 3 and len(queues[0]) == vec._q_cap(n)
    assert max(queues[1]) > max(queues[0])   # a finisher beyond Q
    for q in queues:
        assert q == sorted(set(q))
    for q, nxt in zip(queues, queues[1:]):
        assert not set(q) & set(nxt)
    assert episodes == sum(map(len, queues))


def test_deferred_reset_equals_immediate():
    """A finished env's reset one chunk late, after K1 has dead-stepped
    it through another chunk, writes the values its reset at once does,
    in every field of its column and its static rows, and settles the
    same tally: the async chunk loop's queue (`vec._ChunkLoop`: select,
    then K3, K2 and settle with the queue's count, on CPU tensors their
    plain versions)."""
    n = 8
    s = et.vec_reset(5, n, PLAYERS, PIECES, 0, 20, device="cpu")
    static, carry = vec._split(s)
    srng = et.sampler_init(11, n, device="cpu")
    for _ in range(30):
        carry, srng, _ = fused_step(carry, srng, *vec._params(static), 10)
        done = carry[vec._OFF["done"]] != 0
        if bool(done.any()) and not bool(done.all()):
            break
    rows = torch.nonzero(done).flatten()
    assert 0 < rows.numel() < n
    ended = vec._merge(static, carry)

    def queued():
        """A loop whose first boundary queued the done envs."""
        loop = vec._ChunkLoop(ended, srng, 10, "storage", False,
                              deferred=True)
        loop.boundary(0)
        idx, count = loop.pending
        assert int(count) == rows.numel()
        assert torch.equal(idx[:rows.numel()].long(), rows)
        return loop
    now = queued()
    now._reset(0, now.pending)
    late = queued()
    before = late.carry.clone()
    late.launch(1)
    assert torch.equal(late.carry[:, rows], before[:, rows])
    late.boundary(1)   # resets the queue pending since boundary 0
    assert torch.equal(late.carry[:, rows], now.carry[:, rows])
    for f in static:
        assert torch.equal(late.static[f][rows], now.static[f][rows]), f
    assert torch.equal(late.tally[:3], now.tally[:3])
    assert not bool(late.inflight[rows].any())


def test_async_without_finishers_equals_sync():
    """No game ends, so every queue is empty: the async mode leaves the
    sync mode's result."""
    out = [et.rollout_chunked(
        et.vec_reset(3, 8, 4, 3, 0, 100000, device="cpu"),
        et.sampler_init(4, 8, device="cpu"), 60, 20, exact=True,
        reset_mode=mode) for mode in ("sync", "async")]
    assert out[0][2:] == out[1][2:] == (0, 0)
    for f in E.FIELDS:
        assert torch.equal(getattr(out[0][0], f), getattr(out[1][0], f)), f
    assert torch.equal(out[0][1], out[1][1])


def test_unknown_reset_mode_raises():
    s = et.vec_reset(5, 4, 2, 1, 0, 10, device="cpu")
    with pytest.raises(ValueError, match="reset_mode"):
        et.rollout_chunked(s, et.sampler_init(1, 4, device="cpu"), 20, 10,
                           reset_mode="deferred")


def test_failed_generation_in_a_queue_raises():
    """Two envs ask for 4 EASY pieces (only 3 exist): their first reset
    fails unchecked, and when their games end the async queue's failure
    raises, as the sync queue's does."""
    s = et.vec_reset_varied([3, 4, 5, 6], 2, [1, 4, 1, 4], 0, 1,
                            check_maps=False, device="cpu")
    for mode in ("sync", "async"):
        with pytest.raises(et.GenerateMapFailure):
            et.rollout_chunked(s, et.sampler_init(1, 4, device="cpu"), 40,
                               10, reset_mode=mode)
