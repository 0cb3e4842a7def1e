"""K3's work counts on a batch whose envs play different levels, on the CPU.

Each reset's map generation counts its generator trips (until the env
finishes or aborts) and its retries (child frames pushed: the reference's
``generate(..., failures + 1, ...)`` calls, the one that aborts included).
Here: the plain generator's counts on engine words of the three levels of
the curriculum batch (EASY/3, MEDIUM/8, HARD/3) and on words that retry,
written down; the retries against the reference's own recursion
(`cogbench.reference`'s ``RefMap.generate``, wrapped and counted); settle's
two sums written out by hand; the level screen's counts; and a chunked rollout of six envs at the
three levels whose totals (`vec.queue_work`) are the sum of its queues'
counts, each env ending where the reference's replay of its own level
does. K3 itself is held to the same counts by test_torch_mapgen_host.py
(its header built with g++) and, on the card, by test_torch_cuda.py.
"""
import functools

import torch

import eldorado_tpu_torch as et
from cogbench import check as C
from cogbench.reference import engine as RE
from cogbench.reference import replay
from eldorado_tpu_torch import vec as V
from eldorado_tpu_torch.core import engine as E
from eldorado_tpu_torch.core import mapgen as MG
from eldorado_tpu_torch.ops import queue as Q
from eldorado_tpu_torch.ops.rng import seed

CPU = dict(device="cpu")
_i32 = torch.int32
LEVELS = ((3, 0), (8, 1), (3, 2))   # (n_pieces, difficulty) of the batch

# (engine word, n_pieces, difficulty, trips, retries, ok). The first two
# are words of EASY/3 and MEDIUM/8, which retried on none of 4000 random
# words each (numpy default_rng(7), through generate_map_plain); HARD/3
# retried on 41 of 4000, the first two of which follow. HARD/8's word
# failed map generation on the card and in the reference alike, after five
# nested retries.
WORDS = ((12345, 3, 0, 7, 0, True),
         (12346, 8, 1, 12, 0, True),
         (1772700083, 3, 2, 14, 1, True),
         (730903253, 3, 2, 14, 1, True),
         (1920435500, 8, 2, 13, 5, False))


@functools.lru_cache(maxsize=None)
def plain_counts():
    """generate_map_plain over `WORDS` as one batch: (trips, retries, ok)
    as lists."""
    words, pieces, diff = (torch.tensor([w[k] for w in WORDS])
                           for k in range(3))
    gen = MG.generate_map_plain(seed(words, **CPU), pieces, diff)
    return gen.trips.tolist(), gen.retries.tolist(), gen.ok.tolist()


def test_plain_counts_on_the_written_words():
    trips, retries, ok = plain_counts()
    assert trips == [w[3] for w in WORDS]
    assert retries == [w[4] for w in WORDS]
    assert ok == [w[5] for w in WORDS]


def test_retries_are_the_reference_recursion(monkeypatch):
    """The reference's ``generate`` calls with failures >= 1 (the one that
    throws included) are the plain generator's retries, word for word."""
    calls = []
    generate = RE.RefMap.generate

    def counted(self, n_pieces, difficulty, failures, max_failures, rng):
        calls.append(failures)
        return generate(self, n_pieces, difficulty, failures, max_failures,
                        rng)
    monkeypatch.setattr(RE.RefMap, "generate", counted)
    _, retries, ok = plain_counts()
    for (word, n_pieces, diff, *_), want, good in zip(WORDS, retries, ok):
        calls.clear()
        try:
            RE.RefMap().generate(n_pieces, diff, 0, RE.MAX_FAILURES,
                                 RE.MinstdRng(word))
            failed = False
        except RE.GenerateMapFailure:
            failed = True
        assert sum(f > 0 for f in calls) == want, word
        assert failed == (not good), word


def test_settle_sums_the_queue_work():
    """settle's counters: the queue's trips and count x its most trips,
    added to the sums; slots past the count are not read."""
    n = 10
    ok = torch.ones(n, dtype=torch.bool)
    over = torch.zeros(n, dtype=torch.bool)
    tally = torch.zeros(3, dtype=torch.int64)
    sums = torch.zeros(2, dtype=torch.int64)
    work = torch.tensor([[7, 0], [12, 0], [14, 1], [99, 9], [99, 9]],
                        dtype=_i32)
    Q.settle(torch.tensor([1, 4, 8, n, n], dtype=_i32),
             torch.tensor([3], dtype=_i32), ok, over, None, tally,
             (work, sums))
    assert tally.tolist() == [3, 0, 0]
    assert sums.tolist() == [7 + 12 + 14, 3 * 14]
    work[:2] = torch.tensor([[7, 0], [7, 0]], dtype=_i32)
    Q.settle(torch.tensor([0, 2, n, n, n], dtype=_i32),
             torch.tensor([2], dtype=_i32), ok, over, None, tally,
             (work, sums))
    assert sums.tolist() == [33 + 14, 42 + 2 * 7]
    # an empty queue adds nothing
    Q.settle(torch.full((5,), n, dtype=_i32), torch.zeros(1, dtype=_i32),
             ok, over, None, tally, (work, sums))
    assert sums.tolist() == [47, 56] and tally.tolist() == [5, 0, 0]


def test_rollout_totals_are_its_queues_counts(monkeypatch):
    """A chunked rollout of six envs at the three levels, games of two
    turns: every level resets, a queue holds envs of several levels, the
    loop's totals are the sum of its queues' counts (settle's sums, read
    once at the end), and every env ends where the reference's replay of
    its own level ends."""
    n, steps, chunk, turns = 6, 64, 16, 2
    pieces = [LEVELS[i % 3][0] for i in range(n)]
    diff = [LEVELS[i % 3][1] for i in range(n)]
    queues = []
    rows_plain = E.reset_map_prelude_rows_plain

    def recorded(rng, n_pieces, difficulty, n_players, idx, maps,
                 count=None, prelude=None, work=None):
        out = rows_plain(rng, n_pieces, difficulty, n_players, idx, maps,
                         count, prelude, work)
        if work is not None and int(count):
            k = int(count)
            queues.append((idx[:k].tolist(), work[:k].tolist()))
        return out
    monkeypatch.setattr(E, "reset_map_prelude_rows_plain", recorded)
    s0 = et.vec_reset_varied([101 + i for i in range(n)], 4, pieces, diff,
                             turns, **CPU)
    before = V.queue_work()
    s, r, episodes, dead = et.rollout_chunked(
        s0, et.sampler_init(55, n, **CPU), steps, chunk, exact=True)
    got = {k: v - before[k] for k, v in V.queue_work().items()}

    envs = [i for rows, _ in queues for i in rows]
    assert {i % 3 for i in envs} == {0, 1, 2}
    assert any(len({i % 3 for i in rows}) > 1 for rows, _ in queues)
    want = {"resets": len(envs),
            "trips": sum(t for _, w in queues for t, _ in w),
            "slowest_lane_trips": sum(len(w) * max(t for t, _ in w)
                                      for _, w in queues)}
    assert got == want
    assert got["slowest_lane_trips"] > got["trips"]
    assert episodes >= got["resets"]

    fields = C.host_fields(s, list(range(n)))
    for i in range(n):
        start = {"seed": 101 + i, "sampler_seed": 55 + i,
                 "params": {"n_players": 4, "n_pieces": pieces[i],
                            "difficulty": diff[i], "max_steps": turns}}
        res = replay.run({"kind": "play", "env": i,
                          "params": start["params"], "start": start,
                          "steps": steps, "exact_steps": False,
                          "want": fields[i], "want_sampler": int(r[i])})
        assert res["ok"], (i, res["why"])


def test_learner_and_full_resets_count_nothing():
    """Only the chunk loop's queues count: `vec_reset` and the learner's
    round (`VecEnv.step`, its own host-sized queue) pass K3 no buffer."""
    before = V.queue_work()
    env = et.VecEnv(3, **CPU)
    env.reset(seed=7, n_players=2, n_pieces=1, max_steps=2)
    ended = sum(bool(env.step(env.sample()).any()) for _ in range(12))
    assert ended > 0
    assert V.queue_work() == before


def test_level_screen_counts_on_the_cpu():
    """The level screen's counting (tools/level_screen.py) on the plain
    generator: EASY/3 takes 7 trips a reset and never retries; HARD/3 at
    256 words retries on some, each retry a whole second map of 7 trips,
    and p is the share of attempts that failed."""
    from eldorado_tpu_torch.tools import level_screen as LS
    gen = torch.Generator().manual_seed(4)
    cpu = torch.device("cpu")
    easy, hard = (LS.screen(n_pieces, diff, 256, 128, gen, cpu)
                  for n_pieces, diff in ((3, 0), (3, 2)))
    assert easy["resets"] == hard["resets"] == 256
    assert easy["trips"] == 7 * 256 and easy["retries"] == 0
    assert easy["by_retries"] == [256] + [0] * (LS.BINS - 1)
    assert hard["retries"] > 0 and hard["failures"] == 0
    assert sum(hard["by_retries"]) == 256
    assert hard["trips"] == 7 * (256 + hard["retries"])
    assert hard["p"] == hard["retries"] / (256 + hard["retries"])
