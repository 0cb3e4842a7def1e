"""The chunk loop's device-resident reset queue on CPU tensors (the plain
versions of its kernels): `ops.queue.select` against the sort it replaces
(the JAX package's choice, element for element) over random done and
in-flight masks, with more than a queue's capacity done, none and all;
`ops.queue.settle` against the flags and tally written out by hand; K3 and
K2 given a device count against the same calls on the counted envs; and
the loop's counters: no host read at any boundary but on the keyframes
path.
"""
import numpy as np
import pytest
import torch

import eldorado_tpu_torch as et
from eldorado_tpu_torch import stream as S
from eldorado_tpu_torch import vec as V
from eldorado_tpu_torch.core import engine as E
from eldorado_tpu_torch.ops import queue as Q
from eldorado_tpu_torch.ops import step_kernel as K

CPU = dict(device="cpu")
_i32 = torch.int32


def sorted_queue(done, inflight, q_cap):
    """The choice the sort made: the q_cap smallest keys of
    where(done & ~inflight, id, n), and how many are envs."""
    n = done.shape[0]
    take = done != 0
    if inflight is not None:
        take &= ~inflight
    key = torch.where(take, torch.arange(n), n)
    idx = torch.sort(key).values[:q_cap].to(_i32)
    return idx, int((idx < n).sum())


# (n, q_cap, share of envs done): more than q_cap done, none, all, sparse
CASES = [(160, 128, 0.9), (4096, 128, 0.03), (4096, 128, 0.5),
         (300, 128, 0.0), (300, 128, 1.0), (40, 40, 0.7), (5000, 156, 0.04)]


@pytest.mark.parametrize("n,q_cap,share", CASES)
@pytest.mark.parametrize("deferred", [False, True])
def test_select_equals_the_sort(n, q_cap, share, deferred):
    rng = np.random.default_rng(n + q_cap + int(100 * share))
    done = torch.as_tensor(rng.random(n) < share).to(_i32)
    inflight = (torch.as_tensor(rng.random(n) < 0.3) if deferred else None)
    before = None if inflight is None else inflight.clone()
    want, k = sorted_queue(done, inflight, q_cap)
    idx = torch.full((q_cap,), -7, dtype=_i32)
    count = torch.full((1,), -7, dtype=_i32)
    Q.select(done, inflight, idx, count)
    assert torch.equal(idx, want) and int(count) == k
    if inflight is not None:   # the taken envs are now in flight
        marked = before.clone()
        marked[want[:k].long()] = True
        assert torch.equal(inflight, marked)


def test_settle_writes_the_queue_outcome():
    n, q_cap = 12, 5
    ok = torch.tensor([1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1], dtype=torch.bool)
    over = torch.zeros(n, dtype=torch.bool)
    over[7] = True
    tally = torch.zeros(3, dtype=torch.int64)
    inflight = torch.zeros(n, dtype=torch.bool)
    inflight[[2, 3, 9]] = True
    # a queue of two envs that both generated
    Q.settle(torch.tensor([3, 9, n, n, n], dtype=_i32),
             torch.tensor([2], dtype=_i32), ok, over, inflight, tally)
    assert tally.tolist() == [2, 0, 0]
    assert inflight.nonzero().flatten().tolist() == [2]
    # a queue with a failure and an overflow: every env takes both
    Q.settle(torch.tensor([2, 5, 7, n, n], dtype=_i32),
             torch.tensor([3], dtype=_i32), ok, over, None, tally)
    assert tally.tolist() == [5, 1, 1]
    assert ok.tolist() == [1, 1, 0, 1, 1, 0, 1, 0, 1, 1, 1, 1]
    assert over.nonzero().flatten().tolist() == [2, 5, 7]
    # an empty queue changes nothing
    Q.settle(torch.full((q_cap,), n, dtype=_i32),
             torch.zeros(1, dtype=_i32), ok, over, inflight, tally)
    assert tally.tolist() == [5, 1, 1]


@pytest.mark.parametrize("k", [0, 3, 6])
def test_k3_and_k2_with_a_count_reset_the_counted_envs(k):
    """K3's and K2's plain versions given a device count (the chunk loop's
    CPU path) write what `reset_map_prelude_rows` and `fused_reset` write
    on the first ``count`` envs, and nothing else."""
    s = et.vec_reset(5, 10, 4, 1, 0, 30, **CPU)
    carry, _, _ = K.fused_step(E.pack_dyn(E.split_state(s)[1]),
                               et.sampler_init(3, 10, **CPU), s.map_ids,
                               s.min_xy, s.n_players, s.max_steps, 40)
    idx = torch.tensor([1, 4, 5, 7, 8, 9], dtype=_i32)

    def reset(rows, count):
        c = carry.clone()
        maps = [getattr(s, f).clone() for f in V._MAP_FIELDS]
        k3 = (c[V._OFF["rng"]], s.n_pieces, s.difficulty, s.n_players, rows,
              maps)
        if count is not None:
            pre = E._prelude_out(rows.shape[0], "cpu")
            E.reset_map_prelude_rows_plain(*k3, count, pre)
            K.fused_reset_plain(c, s.n_players, *pre, rows, count)
        elif rows.numel():
            pxy, ball = E.reset_map_prelude_rows(*k3)
            K.fused_reset(c, s.n_players, pxy, *ball, idx=rows)
        return [c] + maps
    got = reset(idx, torch.tensor([k], dtype=_i32))
    for a, b in zip(got, reset(idx[:k], None)):
        assert torch.equal(a, b)
    assert torch.equal(got[0][:, [0, 2, 3, 6]], carry[:, [0, 2, 3, 6]])


def test_a_count_needs_an_in_place_queue():
    s = et.vec_reset(5, 4, 4, 1, 0, 30, **CPU)
    carry = E.pack_dyn(E.split_state(s)[1])
    pre = E._prelude_out(4, "cpu")
    with pytest.raises(ValueError, match="in-place"):
        K.check_fused_reset(carry, s.n_players, *pre,
                            count=torch.ones(1, dtype=_i32))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_no_boundary_reads_the_device(mode):
    """Over a chunked rollout whose every boundary queues resets, the loop
    counts each boundary and no host read among them."""
    b0, r0 = V._ChunkLoop.boundaries, V._ChunkLoop.boundary_reads
    _, _, episodes = et.rollout_chunked(
        et.vec_reset(5, 8, 2, 1, 0, 1, **CPU), et.sampler_init(11, 8, **CPU),
        40, 8, reset_mode=mode)
    assert episodes > 0
    assert V._ChunkLoop.boundaries - b0 == 5
    assert V._ChunkLoop.boundary_reads == r0


def test_keyframes_read_once_a_reset():
    """The keyframes path (`stream_rollout(record="full")`) reads each
    queue's count back to size its frame: one read a boundary."""
    b0, r0 = V._ChunkLoop.boundaries, V._ChunkLoop.boundary_reads
    _, _, _, cons = S.stream_rollout(
        et.vec_reset(5, 8, 4, 1, 0, 6, **CPU), et.sampler_init(11, 8, **CPU),
        80, 20, steps_per_push=20, record="full", consume=lambda b: None)
    assert cons.keyframes
    assert V._ChunkLoop.boundaries - b0 == 4
    assert V._ChunkLoop.boundary_reads - r0 == 4
