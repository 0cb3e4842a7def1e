"""The CUDA kernels against their plain versions on the card: K1 (with and
without the learner feed's records, and with the trajectory record), K2
(new columns and in place, at widths 1 to 4097 on unsorted columns), K3
(map generation and its prelude, in every launch shape), the learner's
step and sampler (K1-act at widths that
take each staging path, K1-sample from mask words and from the carry) and
K1's cost probes (K1-null, P1 null copy, P2 op chain, P3
step prefix); the rollout, the feed, VecEnv and rollout / kernel_rollout,
CUDA against CPU; the card path (K1, then K3 and K2 at every game's end)
against the 11 trajectory goldens at full length; the city_of_gold
surface (cog_env on the card against the numpy reference engine,
compat.vec CUDA against CPU); rollout_chunked(reset_mode="async")
CUDA against CPU; the sharded path (eldorado_tpu_torch.parallel): a
1-card mesh equal to the unsharded path, four shards of the card equal to
their slices' runs, make_mesh's card count, and the sharded paths CUDA
against CPU; the profiler's host and device clocks against each other
through K1-act's count-read span; and the chunk loop's device-resident
reset queue: select and settle (csrc/queue.cu) and K3 and K2 given a
device count against their plain versions, K3's per-slot trips and
retries and settle's sums of them against theirs, the loop CUDA against
CPU where the queue overflows (sync and async, exact or not, two shards),
no torch op and no host read between chunks; and the learner's reset
queue on the card (select, K3 and K2 on VecEnv's buffers): its launches,
and its result against the host path and against the CPU over 200
rounds.

Marked ``cuda``: skipped where torch sees no GPU. On the machine with the
card: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""
import json
import statistics

import numpy as np
import pytest
import torch

import eldorado_tpu_torch as et
import learner_queue as LQ
import traj_replay as TR
from eldorado_tpu_torch import stream as S
from eldorado_tpu_torch.core import engine as TE
from eldorado_tpu_torch.core import mapgen as MG
from eldorado_tpu_torch.ops import probes as P
from eldorado_tpu_torch.ops import step_kernel as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("mask_src,gate_dead",
                         [("storage", False), ("sel", False),
                          ("storage", True)])
def test_fused_step_equals_plain(dev, mask_src, gate_dead):
    s = et.vec_reset(9, 256, 2, 1, 0, 10, device=dev)
    carry = TE.pack_dyn(TE.split_state(s)[1])
    st = (s.map_ids, s.min_xy, s.n_players, s.max_steps)
    r = et.sampler_init(4, 256, device=dev)
    outs = []
    for fn in (K.fused_step, K.fused_step_plain):
        dead = torch.zeros(1, dtype=torch.int64, device=dev)
        outs.append(fn(carry, r, *st, 100, mask_src, gate_dead, dead)
                    + (dead,))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[0][3]) > 0   # max_steps=10: envs finish and dead-step


@pytest.mark.parametrize("mask_src,gate_dead",
                         [("storage", False), ("sel", False),
                          ("storage", True)])
def test_fused_step_records_equal_plain(dev, mask_src, gate_dead):
    """K1's compact and full records == the plain version's, and the
    carry, srng, actions and dead steps are those of K1 without records."""
    T, n = 100, 256
    s = et.vec_reset(9, n, 2, 1, 0, 10, device=dev)
    args = (TE.pack_dyn(TE.split_state(s)[1]), et.sampler_init(4, n,
                                                               device=dev),
            s.map_ids, s.min_xy, s.n_players, s.max_steps, T, mask_src,
            gate_dead)
    dead = torch.zeros(1, dtype=torch.int64, device=dev)
    want = K.fused_step(*args, dead) + (dead,)
    plain = torch.zeros((T, n, S.RECORD_WORDS_FULL), dtype=torch.int32,
                        device=dev)
    K.fused_step_plain(*args, record="full", records=plain)
    for record, words in S.RECORD_WIDTH.items():
        recs = torch.full((T, n, words), -1, dtype=torch.int32, device=dev)
        dead = torch.zeros(1, dtype=torch.int64, device=dev)
        got = K.fused_step(*args, dead, record=record, records=recs)
        assert torch.equal(recs, plain[..., :words]), record
        for a, b in zip(got + (dead,), want):
            assert torch.equal(a, b), record
    if mask_src == "storage":   # envs ended, so the dead-step records ran
        assert bool(((plain[..., 0] >> 25) & 1).any())


@pytest.mark.parametrize("n", [1, 33, 4097, 16384])
def test_fused_step_slotted_launch_equals_plain(dev, n):
    """K1 launches one warp per block with each env in shared memory: at
    env counts that leave a ragged last block (1, 33, 4097) and at 16384
    envs, more blocks than the card holds at once, so a second wave
    follows. Every field, srng, actions and dead steps equal plain's."""
    steps = 40 if n <= 4097 else 8
    s = et.vec_reset(9, n, 2, 1, 0, 10, device=dev)
    carry = TE.pack_dyn(TE.split_state(s)[1])
    st = (s.map_ids, s.min_xy, s.n_players, s.max_steps)
    r = et.sampler_init(4, n, device=dev)
    outs = []
    for fn in (K.fused_step, K.fused_step_plain):
        dead = torch.zeros(1, dtype=torch.int64, device=dev)
        outs.append(fn(carry, r, *st, steps, "storage", False, dead)
                    + (dead,))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    shape = K.fused_step_shape(n)
    assert shape["threads"] == 32
    assert shape["blocks"] == (n + 31) // 32
    assert shape["smem_bytes"] == 32 * 571 * 4
    assert shape["blocks_per_sm"] >= 1


def test_stream_cuda_equals_cpu(dev):
    """stream_rollout(record="full") over the ring, and on-device
    delivery, at 64 envs with mid-run resets: records, keyframes,
    episodes, final states and the stats carry equal on both devices."""
    outs = []
    for d in (dev, torch.device("cpu")):
        blocks = []
        s = et.vec_reset(5, 64, 4, 1, 0, 30, device=d)
        r = et.sampler_init(11, 64, device=d)
        ring = S.stream_rollout(s, r, 200, 50, steps_per_push=25,
                                record="full",
                                consume=lambda b: blocks.append(b.copy()))
        device = S.stream_rollout(s, r, 200, 50, deliver="device")
        outs.append((ring, np.concatenate(blocks), device))
    ((sa, ra, ea, ca), reca, da), ((sb, rb, eb, cb), recb, db) = outs
    assert np.array_equal(reca, recb) and ea == eb > 0
    assert [k for k, _ in ca.keyframes] == [k for k, _ in cb.keyframes]
    for (_, x), (_, y) in zip(ca.keyframes, cb.keyframes):
        assert np.array_equal(x, y)
    for f in TE.FIELDS:
        assert torch.equal(getattr(sa, f).cpu(), getattr(sb, f)), f
    assert torch.equal(ra.cpu(), rb)
    for x, y in zip(da[3], db[3]):
        assert torch.equal(x.cpu(), y)


def test_fused_reset_equals_plain(dev):
    st = TE.make_state(torch.arange(300, device=dev), 3, 3, 2, 100)
    carry = TE.pack_dyn(TE.split_state(st)[1])
    _, xy, (req, nr, end) = TE.reset_map_prelude(st.rng, st.n_pieces,
                                                 st.difficulty, st.n_players)
    args = (carry, st.n_players, xy, req, nr, end)
    assert torch.equal(K.fused_reset(*args), K.fused_reset_plain(*args))


def test_fused_reset_in_place_equals_plain(dev):
    """K2 with idx: 100 scattered columns of a 300-env mid-game carry
    reset in place == gather, fused_reset_plain, scatter; the other
    columns untouched."""
    s = et.vec_reset(3, 300, 3, 2, 1, 100, device=dev)
    carry, _, _ = K.fused_step(TE.pack_dyn(TE.split_state(s)[1]),
                               et.sampler_init(5, 300, device=dev),
                               s.map_ids, s.min_xy, s.n_players, s.max_steps,
                               60)
    idx = torch.randperm(300, generator=torch.Generator().manual_seed(0))[
        :100].to(device=dev, dtype=torch.int32)
    rows = idx.long()
    _, xy, (req, nr, end) = TE.reset_map_prelude(
        carry[0][rows], s.n_pieces[rows], s.difficulty[rows],
        s.n_players[rows])
    want = carry.clone()
    want[:, rows] = K.fused_reset_plain(want[:, rows], s.n_players[rows], xy,
                                        req, nr, end)
    got = carry.clone()
    out = K.fused_reset(got, s.n_players, xy, req, nr, end, idx=idx)
    assert out is got and torch.equal(got, want)


@pytest.fixture
def k2_batch(dev):
    """A 4100-env mid-game batch of mixed parameters (1-4 players, 1-16
    pieces, difficulties 0-2; maps that failed kept), 40 steps after its
    reset."""
    seeds, players, pieces, diffs = MG.mixed_batch(4100)
    s = et.vec_reset_varied(seeds, players, pieces, diffs, 100,
                            check_maps=False, device=dev)
    carry, _, _ = K.fused_step(TE.pack_dyn(TE.split_state(s)[1]),
                               et.sampler_init(5, 4100, device=dev),
                               s.map_ids, s.min_xy, s.n_players, s.max_steps,
                               40)
    return carry, s


@pytest.mark.parametrize("q", [1, 31, 33, 4097])
def test_fused_reset_widths_equal_plain(dev, k2_batch, q):
    """K2 at q envs, a warp each: in place on q unsorted columns of the
    batch (the kernel must not depend on their order) == gather,
    fused_reset_plain, scatter, every other column untouched; and into a
    new carry from those columns == fused_reset_plain."""
    carry, s = k2_batch
    cols = torch.randperm(4100, generator=torch.Generator().manual_seed(q))[
        :q].to(dev)
    idx = cols.to(torch.int32)
    assert q == 1 or not bool((cols[1:] > cols[:-1]).all())
    _, xy, ball = TE.reset_map_prelude(carry[0][cols], s.n_pieces[cols],
                                       s.difficulty[cols], s.n_players[cols])
    got = K.fused_reset(carry.clone(), s.n_players, xy, *ball, idx=idx)
    want = K.fused_reset_plain(carry.clone(), s.n_players, xy, *ball,
                               idx=idx)
    assert torch.equal(got, want)
    keep = torch.ones(4100, dtype=torch.bool, device=dev)
    keep[cols] = False
    assert torch.equal(got[:, keep], carry[:, keep])
    new = (carry[:, cols].contiguous(), s.n_players[cols], xy, *ball)
    assert torch.equal(K.fused_reset(*new), K.fused_reset_plain(*new))


def _k3_equals_plain(rng, n_pieces, difficulty, n_players):
    gen, xy, ball = TE.reset_map_prelude(rng, n_pieces, difficulty,
                                         n_players)
    pgen, pxy, pball = TE.reset_map_prelude_plain(rng, n_pieces, difficulty,
                                                  n_players)
    for f in ("ids", "min_xy", "player_start_xy", "player_start_no", "ok",
              "overflow"):
        assert torch.equal(getattr(gen, f), getattr(pgen, f)), f
    assert torch.equal(xy, pxy)
    for a, b in zip(ball, pball):
        assert torch.equal(a, b)
    return pgen


@pytest.mark.parametrize("n", [1, 33, 129, 4097])
def test_k3_equals_plain(dev, n):
    """K3 (one launch: generation and prelude, one warp per env) == the
    plain generator and prelude on the card, every lane and field, at env
    counts that are no multiple of the block's envs."""
    before = MG.generate_map.launches
    st = TE.make_state(torch.arange(n, device=dev) + 12345, 4, 3, 0, 100)
    _k3_equals_plain(st.rng, st.n_pieces, st.difficulty, st.n_players)
    assert MG.generate_map.launches == before + 1
    shape = MG.launch_shape(n)
    assert shape["threads"] == 32 * shape["envs_per_block"]
    assert shape["blocks"] == -(-n // shape["envs_per_block"])
    assert shape["blocks_per_sm"] >= 1


@pytest.mark.parametrize("ovl_shared", [False, True])
@pytest.mark.parametrize("envs", [1, 2, 3, 4])
def test_k3_launch_shapes_equal_plain(dev, envs, ovl_shared):
    """Every launch shape (1-4 envs a block; the pair table through L1 or
    in shared memory) writes the plain version's rows on a ragged queue of
    the mixed batch (aborted and overflow lanes), and no other row."""
    seeds, players, pieces, diff = MG.mixed_batch(300, seed=5)
    st = TE.make_state(torch.as_tensor(seeds, device=dev), players, pieces,
                       diff, 100)
    idx = torch.cat([torch.arange(0, 252, 2), torch.arange(297, 300)]).to(
        device=dev, dtype=torch.int32)   # 129 rows, the overflow lanes last
    rows = idx.long()
    maps = [t.clone() for t in (st.map_ids, st.min_xy, st.map_ok,
                                st.map_overflow)]
    before = [t.clone() for t in maps]
    pre = TE._prelude_out(idx.shape[0], dev)
    MG.launch(st.rng, st.n_pieces, st.difficulty, maps, idx=idx,
              n_players=st.n_players, prelude=pre, shape=(envs, ovl_shared))
    pgen, pxy, pball = TE.reset_map_prelude_plain(
        st.rng[rows], st.n_pieces[rows], st.difficulty[rows],
        st.n_players[rows])
    keep = torch.ones(300, dtype=torch.bool, device=dev)
    keep[rows] = False
    for t, b, want in zip(maps, before, (pgen.ids, pgen.min_xy, pgen.ok,
                                         pgen.overflow)):
        assert torch.equal(t[rows], want)
        assert torch.equal(t[keep], b[keep])
    assert torch.equal(pre[0], pxy)
    for a, b in zip(pre[1:], pball):
        assert torch.equal(a, b)
    assert bool(pgen.overflow[-3:].all())
    shape = MG.launch_shape(129, (envs, ovl_shared))
    assert shape["blocks"] == -(-129 // envs)
    assert shape["smem_bytes"] >= envs * (4 * TE.GRIDSIZE ** 2) + (
        4 * MG._K(dev).ovl.numel() if ovl_shared else 0)


@pytest.mark.parametrize("mask_src", [0, 1])
def test_card_path_replays_trajectory_goldens(dev, mask_src):
    """The probe loop on the card, one env per golden of the mask source,
    at each golden's full length: one K1 launch per step, then K3 and K2
    on the envs whose game ended (tests/traj_replay.py). Every compared
    field of every step and every reset map equal to the oracle's,
    traj_win_storage's 20,000 steps with its two won games included."""
    names = [n for n in TR.NAMES if TR.probe_params(n)[0] == mask_src]
    ds = {n: TR.load(n) for n in names}
    steps = max(TR.header(d)[-1] for d in ds.values())
    before = MG.generate_map.launches, K.fused_reset.launches
    trajs = TR.replay(names, steps, dev)
    for name, traj in zip(names, trajs):
        TR.check(name, ds[name], traj, TR.header(ds[name])[-1])
    resets = sum(len(t.maps) - 1 for t in trajs)
    assert resets > 0
    assert MG.generate_map.launches - before[0] > 0
    assert K.fused_reset.launches - before[1] > 0


def test_k3_mixed_batch_equals_plain(dev):
    """1-4 players, 1-16 pieces, difficulties 0-2: aborted lanes and
    MAX_PLACED-overflow lanes included."""
    seeds, players, pieces, diff = MG.mixed_batch(256)
    st = TE.make_state(torch.as_tensor(seeds, device=dev), players, pieces,
                       diff, 100)
    gen = _k3_equals_plain(st.rng, st.n_pieces, st.difficulty, st.n_players)
    assert bool(gen.overflow[-3:].all())
    assert bool((~gen.ok & ~gen.overflow).any()) and bool(gen.ok.any())


def test_k3_queue_rows_equal_plain(dev):
    """The queue form: K3 writes the map rows of the envs idx of a batch
    in place, and nothing else."""
    seeds, players, pieces, diff = MG.mixed_batch(200, seed=4)
    st = TE.make_state(torch.as_tensor(seeds, device=dev), players, pieces,
                       diff, 100)
    idx = torch.arange(199, 0, -3, device=dev, dtype=torch.int32)
    rows = idx.long()
    maps = [t.clone() for t in (st.map_ids, st.min_xy, st.map_ok,
                                st.map_overflow)]
    before = [t.clone() for t in maps]
    xy, ball = TE.reset_map_prelude_rows(st.rng, st.n_pieces, st.difficulty,
                                         st.n_players, idx, maps)
    pgen, pxy, pball = TE.reset_map_prelude_plain(
        st.rng[rows], st.n_pieces[rows], st.difficulty[rows],
        st.n_players[rows])
    for t, b, want in zip(maps, before, (pgen.ids, pgen.min_xy, pgen.ok,
                                         pgen.overflow)):
        assert torch.equal(t[rows], want)
        keep = torch.ones(200, dtype=torch.bool, device=dev)
        keep[rows] = False
        assert torch.equal(t[keep], b[keep])
    assert torch.equal(xy, pxy)
    for a, b in zip(ball, pball):
        assert torch.equal(a, b)


def test_rollout_cuda_equals_cpu(dev):
    outs = []
    for d in (dev, torch.device("cpu")):
        s = et.vec_reset(5, 16, 4, 1, 0, 30, device=d)
        outs.append(et.rollout_chunked(s, et.sampler_init(11, 16, device=d),
                                       200, 50, exact=True))
    (a, ra, *ca), (b, rb, *cb) = outs
    for f in TE.FIELDS:
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert torch.equal(ra.cpu(), rb) and ca == cb and ca[0] > 0


def test_rollout_512_cuda_equals_cpu(dev):
    """rollout_chunked at 512 envs, games of at most 10 turns: the reset
    queues run K3 and K2 on the card, and every field, srng and the
    episode count equal the CPU run's."""
    outs = []
    launches = MG.generate_map.launches
    for d in (dev, torch.device("cpu")):
        s = et.vec_reset(7, 512, 4, 3, 0, 10, device=d)
        outs.append(et.rollout_chunked(s, et.sampler_init(8, 512, device=d),
                                       120, 40))
    assert MG.generate_map.launches > launches + 1
    (a, ra, ea), (b, rb, eb) = outs
    for f in TE.FIELDS:
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert torch.equal(ra.cpu(), rb) and ea == eb > 0


@pytest.fixture
def probe_state(dev):
    """256 envs 50 steps into 2-player games that end at 10 turns: some
    are done, most are not."""
    s = et.vec_reset(9, 256, 2, 1, 0, 10, device=dev)
    static = (s.map_ids, s.min_xy, s.n_players, s.max_steps)
    carry = TE.pack_dyn(TE.split_state(s)[1])
    carry, r, _ = K.fused_step(carry, et.sampler_init(4, 256, device=dev),
                               *static, 50)
    done = TE.unpack_dyn(carry)[TE.DYN_FIELDS.index("done")]
    assert 0 < int(done.sum()) < 256
    return carry, r, static


def test_null_body_equals_plain(dev, probe_state):
    carry, r, static = probe_state
    outs = []
    for fn in (K.fused_step, K.fused_step_plain):
        dead = torch.full((1,), 5, dtype=torch.int64, device=dev)
        outs.append(fn(carry, r, *static, 100, "storage", False, dead,
                       null_body=True) + (dead,))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][0], carry) and torch.equal(outs[0][1], r)
    assert int(outs[0][3]) == 5 and not bool(outs[0][2].any())


def test_null_copy_equals_plain(dev, probe_state):
    """P1 on the probe carry, a ragged width (the word path), and random
    carries of the main path's width and just past it (a partial last
    block)."""
    carry = probe_state[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    wide = [torch.randint(-2 ** 31, 2 ** 31 - 1, (570, n), generator=gen,
                          dtype=torch.int32, device=dev) for n in (4096, 4100)]
    for c in [carry, carry[:, :255].contiguous()] + wide:
        assert torch.equal(P.null_copy(c), P.null_copy_plain(c))


def test_step_actions_equal_plain(dev, probe_state):
    """K1-act against step_actions_plain over 30 steps of the probe state
    (some envs done): sampled actions on odd steps, random actions inside
    the heads (mostly forbidden by the masks) on even ones; the carry and
    the done count equal, one launch a step."""
    carry, r, static = probe_state
    gen = np.random.default_rng(2)
    widths = np.asarray(K.HEAD_WIDTHS)
    launches = K.step_actions.launches
    for t in range(30):
        if t % 2:
            act, r, _ = K.sample(r, K.mask_words(carry, "storage"))
        else:
            act = torch.as_tensor(gen.integers(0, 1 << 20, (256, 5)) % widths,
                                  dtype=torch.int32, device=dev)
        got, n_done = K.step_actions(carry, act, *static)
        want, counts = K.step_actions_plain(carry, act, *static)
        assert torch.equal(got, want), t
        assert n_done == int(counts[1]) and int(counts[0]) == 0, t
        carry = got
    assert K.step_actions.launches == launches + 30
    assert 0 < n_done < 256


def test_step_actions_refuses_out_of_range(dev, probe_state):
    """An action outside its head raises ValueError on the card and on the
    CPU alike, and the carry passed in is untouched."""
    carry, _, static = probe_state
    for d in (dev, torch.device("cpu")):
        c = carry.to(d)
        before = c.clone()
        for h, bad in enumerate((-1, 22, 22, 7, 19)):
            act = torch.zeros((256, 5), dtype=torch.int32, device=d)
            act[100, h] = bad
            with pytest.raises(ValueError):
                K.step_actions(c, act, *(t.to(d) for t in static))
        assert torch.equal(c, before)


def _act_state(dev, n):
    """n envs 40 sampled steps into 2-player games that end at 12 turns."""
    s = et.vec_reset(17, n, 2, 1, 0, 12, device=dev)
    static = (s.map_ids, s.min_xy, s.n_players, s.max_steps)
    carry, r, _ = K.fused_step(TE.pack_dyn(TE.split_state(s)[1]),
                               et.sampler_init(6, n, device=dev), *static, 40)
    return carry, r, static


@pytest.mark.parametrize("n", [1, 3, 31, 4096, 4097, 4100])
def test_step_actions_staging_equal_plain(dev, n):
    """K1-act against step_actions_plain over 6 steps (sampled actions on
    odd steps, random in-head actions on even ones): the carry and the
    done count after each; staged by 16-byte units where n % 4 == 0, by
    words elsewhere."""
    carry, r, static = _act_state(dev, n)
    gen = np.random.default_rng(n)
    widths = np.asarray(K.HEAD_WIDTHS)
    for t in range(6):
        if t % 2:
            act, r, _ = K.sample(r, K.mask_words(carry, "storage"))
        else:
            act = torch.as_tensor(gen.integers(0, 1 << 20, (n, 5)) % widths,
                                  dtype=torch.int32, device=dev)
        got, n_done = K.step_actions(carry, act, *static)
        want, counts = K.step_actions_plain(carry, act, *static)
        assert torch.equal(got, want), t
        assert n_done == int(counts[1]) and int(counts[0]) == 0, t
        assert K.step_actions.last_path == ("word", "16-byte")[n % 4 == 0]
        carry = got


@pytest.mark.parametrize("mask_src", ["storage", "sel"])
@pytest.mark.parametrize("live", [False, True])
def test_sample_carry_equal_plain(dev, probe_state, mask_src, live):
    """K1-sample reading its masks from the carry, one launch, against
    mask_words + sample_plain + the OR into rng_tainted, on the probe
    state with rng_tainted set at random: actions, srng and the carry."""
    carry, r, _ = probe_state
    n = carry.shape[1]
    gen = np.random.default_rng(5)
    carry = carry.clone()
    row = [o for f, _, _, o, _ in TE.DYN_LAYOUT if f == "rng_tainted"][0]
    carry[row] = torch.as_tensor(gen.random(n) < 0.5, dtype=torch.int32,
                                 device=dev)
    flags = (torch.as_tensor(gen.random(n) < 0.7, device=dev) if live
             else None)
    got_c, want_c = carry.clone(), carry.clone()
    launches = (K.sample.launches, K.sample.carry_launches)
    got = K.sample_carry(r, got_c, mask_src, flags)
    want = K.sample_carry_plain(r, want_c, mask_src, flags)
    assert (K.sample.launches, K.sample.carry_launches) == (
        launches[0] + 1, launches[1] + 1)
    for a, b in zip(got + (got_c,), want + (want_c,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("live", [False, True])
def test_sample_equal_plain(dev, live):
    """K1-sample against sample_plain on 4097 random masks (some heads
    empty), with and without the live flags."""
    n = 4097
    rng = np.random.default_rng(3)
    bits = rng.random((n, TE.MASK_LEN)) < rng.random((n, 1))
    words = TE.pack_mask(torch.as_tensor(bits, device=dev))
    srng = et.sampler_init(9, n, device=dev)
    flags = (torch.as_tensor(rng.random(n) < 0.7, device=dev) if live
             else None)
    launches = K.sample.launches
    got = K.sample(srng, words, flags)
    want = K.sample_plain(srng, words, flags)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert K.sample.launches == launches + 1


@pytest.mark.parametrize("mask_src", ["storage", "sel"])
def test_fused_step_traj_records_equal_plain(dev, mask_src):
    """K1 with the trajectory record == the plain record; carry, srng and
    actions as without records."""
    T, n = 100, 256
    s = et.vec_reset(9, n, 2, 1, 0, 10, device=dev)
    args = (TE.pack_dyn(TE.split_state(s)[1]),
            et.sampler_init(4, n, device=dev), s.map_ids, s.min_xy,
            s.n_players, s.max_steps, T, mask_src)
    want = K.fused_step(*args)
    plain = torch.zeros((T, n, K.TRAJ_WORDS), dtype=torch.int32, device=dev)
    K.fused_step_plain(*args, record="traj", records=plain)
    recs = torch.full_like(plain, -1)
    got = K.fused_step(*args, record="traj", records=recs)
    assert torch.equal(recs, plain)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(K.unpack_traj(plain)[1].any())


def test_vec_surface_cuda_equals_cpu(dev):
    """VecEnv's sample / step loop (64 envs, 60 steps, 5-turn games, both
    mask sources), rollout in both modes and kernel_rollout: CUDA == CPU
    on every field, srng and output; the card ran K1-sample, K1-act, K1
    with the trajectory record, K3 and K2."""
    counts = (K.sample.launches, K.step_actions.launches,
              K.fused_step.record_launches["traj"], MG.generate_map.launches)
    res = {}
    for d in (dev, torch.device("cpu")):
        out = []
        for mask_src in ("storage", "sel"):
            env = et.VecEnv(64, mask_src, device=d)
            env.reset(seed=3, n_players=3, n_pieces=2, max_steps=5,
                      sampler_seed=8)
            dones = [env.step(env.sample()) for _ in range(60)]
            out.append((env.states, env.sampler_rngs, (torch.stack(dones),)))
        s = et.vec_reset(5, 64, 4, 1, 0, 6, device=d)
        r = et.sampler_init(11, 64, device=d)
        out += [et.rollout(s, r, 40, m, a) for m in ("storage", "sel")
                for a in ("none", "step")]
        out.append(et.kernel_rollout(s, r, 40))
        res[d.type] = out
    for got, want in zip(res["cuda"], res["cpu"]):
        for f in TE.FIELDS:
            assert torch.equal(getattr(got[0], f).cpu(),
                               getattr(want[0], f)), f
        assert torch.equal(got[1].cpu(), want[1])
        for a, b in zip(got[2], want[2]):
            assert torch.equal(a.cpu(), b)
    assert bool(res["cpu"][0][2][0].any())   # VecEnv reset envs on the way
    after = (K.sample.launches, K.step_actions.launches,
             K.fused_step.record_launches["traj"], MG.generate_map.launches)
    assert after[:3] == (counts[0] + 120, counts[1] + 120,
                         counts[2] + 2 * (1 + 40) + 1)
    assert after[3] > counts[3]


@pytest.mark.parametrize("op", P.OPS)
@pytest.mark.parametrize("shape,k", [((8, 64), 64), ((32, 512), 4096)])
def test_op_chain_equals_plain(dev, shape, k, op):
    rng = np.random.default_rng(1)
    x, y = (torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, shape),
                            dtype=torch.int32, device=dev) for _ in range(2))
    assert torch.equal(P.op_chain(x, y, k, op), P.op_chain_plain(x, y, k, op))


@pytest.mark.parametrize("cut", P.CUTS)
def test_step_prefix_equals_plain(dev, probe_state, cut):
    carry, r, static = probe_state
    assert torch.equal(P.step_prefix(carry, r, *static, 20, cut),
                       P.step_prefix_plain(carry, r, *static, 20, cut))


def _compat_fields(env):
    """Everything cog_env shows, as bytes."""
    return (env.observations.tobytes(), env.infos.tobytes(),
            env.selected_action_mask.tobytes(), env.rewards.tobytes(),
            env.get_done(), env.agent_selection)


@pytest.mark.parametrize("params", [(21, 4, 1, 0, 12), (77, 3, 2, 1, 6),
                                    (5, 2, 3, 2, 4)])
def test_cog_env_cuda_equals_ref(dev, params):
    """cog_env on the card (K1-act, K3 and K2 on one env) in lockstep with
    the numpy reference engine (backend="ref") over 400 storage-mask
    steps; short games so resets fire; then a full-parameter reset, which
    keeps the finished game's rewards and infos, and 100 more steps."""
    from eldorado_tpu_torch import compat
    from eldorado_tpu_torch.core.ref_engine import RefSampler
    seed, n_players, n_pieces, difficulty, max_steps = params
    envs = [compat.cog_env(seed, n_players, n_pieces, difficulty, max_steps,
                           backend=b, device=dev) for b in ("device", "ref")]
    launches = K.step_actions.launches
    for e in envs:
        e.reset()
    sam, resets, full = RefSampler(seed + 1), 0, False
    for t in range(500):
        ref = envs[1]._env
        a = sam.sample(ref.storage_masks[ref.agent])
        for e in envs:
            e.step(a)
        assert _compat_fields(envs[0]) == _compat_fields(envs[1]), t
        if envs[1].get_done():
            resets += 1
            once = not full and t >= 400   # after a finished game
            full |= once
            for e in envs:
                if once:
                    e.reset(seed + 7, 4, 1, 0, 3)
                else:
                    e.reset()
            assert _compat_fields(envs[0]) == _compat_fields(envs[1]), t
    assert resets > 1 and full
    assert K.step_actions.launches == launches + 500


def test_compat_vec_cuda_equals_cpu(dev):
    """compat.vec's env and sampler (K1-sample, K1-act, K3 and K2) at 64
    envs for 30 steps of 2-turn games: every getter CUDA == CPU."""
    from eldorado_tpu_torch.compat import vec as cvec
    res = []
    for d in (dev, torch.device("cpu")):
        venv = cvec.get_vec_env(64, device=d)
        venv.reset(seed=21, n_pieces=2, max_steps=2)
        sampler = cvec.get_vec_sampler(64, device=d)
        sampler.seed(9)
        rec = []
        for _ in range(30):
            a = sampler.sample(venv.get_selected_action_masks())
            rec.append(venv.step(a).tobytes() + a.tobytes()
                       + venv.get_observations().tobytes()
                       + venv.get_infos().tobytes()
                       + venv.get_rewards().tobytes()
                       + venv.get_agent_selections().tobytes())
        res.append(rec)
    assert res[0] == res[1]


@pytest.mark.parametrize("exact", [False, True])
def test_async_cuda_equals_cpu(dev, exact):
    """rollout_chunked(reset_mode="async") at 256 envs, 10-turn games, 300
    steps in chunks of 50: each queue resets through K3 and K2 on the
    card one boundary late; every field, srng, the episodes and dead steps
    equal the CPU run's."""
    outs = []
    k2, k3 = K.fused_reset.launches, MG.generate_map.launches
    for d in (dev, torch.device("cpu")):
        s = et.vec_reset(7, 256, 4, 3, 0, 10, device=d)
        outs.append(et.rollout_chunked(s, et.sampler_init(8, 256, device=d),
                                       300, 50, exact=exact,
                                       reset_mode="async"))
    assert K.fused_reset.launches > k2 + 1
    assert MG.generate_map.launches > k3 + 1
    (a, ra, *ca), (b, rb, *cb) = outs
    for f in TE.FIELDS:
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert torch.equal(ra.cpu(), rb) and ca == cb and ca[0] > 0


def _same(a, b):
    for f in TE.FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f).to(
            getattr(a, f).device)), f


# (envs, steps, chunk, max_steps): 20-turn games at 64 envs so that queues
# fire; the main path at 4096
MESH_CASES = [(64, 600, 100, 20), (4096, 4500, 1500, 100000)]


@pytest.mark.parametrize("n,steps,chunk,turns", MESH_CASES)
def test_one_device_mesh_equals_unsharded(dev, n, steps, chunk, turns):
    """sharded_kernel_rollout on a 1-card mesh == rollout_chunked, exact
    off and on: every field, srng, episodes, dead steps, and the same K1,
    K3 and K2 launches."""
    from eldorado_tpu_torch.parallel import mesh as M, runner as R
    mesh = M.make_mesh(1)
    assert mesh.local_devices == (dev,)
    for exact in (False, True):
        outs, counts = [], []
        for run in (lambda s, r: et.rollout_chunked(s, r, steps, chunk,
                                                    exact=exact),
                    lambda s, r: R.sharded_kernel_rollout(
                        mesh, s, r, steps, chunk, exact=exact)):
            before = (K.fused_step.launches, MG.generate_map.launches,
                      K.fused_reset.launches)
            outs.append(run(et.vec_reset(12345, n, 4, 3, 0, turns,
                                         device=dev),
                            et.sampler_init(42, n, device=dev)))
            counts.append([a - b for a, b in zip(
                (K.fused_step.launches, MG.generate_map.launches,
                 K.fused_reset.launches), before)])
        (s1, r1, *c1), (s2, r2, *c2) = outs
        _same(s1, s2[0])
        assert torch.equal(r1, r2[0])
        assert c1 == c2 and c1[0] > 0
        assert counts[0] == counts[1] and min(counts[1]) > 0


def test_four_shards_on_one_card_equal_their_slices(dev):
    """The main path as 4 shards of 1024 envs on cuda:0 (a 128-env queue
    each): every shard == rollout_chunked of its own rows and seeds."""
    from eldorado_tpu_torch.parallel import mesh as M, runner as R
    mesh = M.make_mesh(devices=[dev] * 4)
    shards, srngs, episodes = R.sharded_kernel_rollout(
        mesh, et.vec_reset(12345, 4096, 4, 3, 0, 100000, device=dev),
        et.sampler_init(42, 4096, device=dev), 4500, 1500)
    total = 0
    for i, (d, a, b) in enumerate(M.env_sharding(mesh, 4096)):
        want = et.rollout_chunked(
            et.vec_reset(12345 + a, b - a, 4, 3, 0, 100000, device=d),
            et.sampler_init(42 + a, b - a, device=d), 4500, 1500)
        _same(shards[i], want[0])
        assert torch.equal(srngs[i], want[1])
        total += want[2]
    assert episodes == total > 0


def test_make_mesh_counts_the_cards(dev):
    from eldorado_tpu_torch.parallel import mesh as M
    count = torch.cuda.device_count()
    assert M.make_mesh().size == count
    with pytest.raises(RuntimeError, match="CUDA devices"):
        M.make_mesh(count + 1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        M.make_mesh(devices=[f"cuda:{count}"])


def test_sharded_paths_cuda_equal_cpu(dev):
    """tests/test_parallel.py's shapes on 4 shards of the card and of the
    CPU: the kernel, exact and full-record feed paths (32 envs, 60 steps,
    chunk 10, 10-turn games), ShardedRunner's sample / step over 30
    rounds of 6-turn games, and sharded_rollout (16 envs over 8 shards,
    100 steps, 8-turn games)."""
    from eldorado_tpu_torch.parallel import mesh as M, runner as R
    res = []
    for d in (dev, torch.device("cpu")):
        m4 = M.make_mesh(devices=[d] * 4)
        args = (et.vec_reset(5, 32, 4, 2, 0, 10, device=d),
                et.sampler_init(11, 32, device=d), 60)
        out = [R.sharded_kernel_rollout(m4, *args, 10),
               R.sharded_kernel_rollout(m4, *args, 10, exact=True),
               R.sharded_stream_rollout(m4, *args, 10)]
        out.append(R.sharded_rollout(
            M.make_mesh(devices=[d] * 8),
            et.vec_reset(5, 16, 4, 2, 0, 8, device=d),
            et.sampler_init(11, 16, device=d), 100))
        runner = R.ShardedRunner(m4, 32)
        runner.reset(seed=9, n_pieces=2, max_steps=6)
        rounds = [(torch.cat(runner.sample()).cpu(),
                   torch.cat(runner.step_sync()).cpu()) for _ in range(30)]
        out.append((runner.states, runner.sampler_rngs, rounds))
        res.append(out)
    for a, b in zip(*res):
        _same(M.unshard_envs(a[0], "cpu"), M.unshard_envs(b[0]))
        assert torch.equal(M.unshard_envs(a[1], "cpu"), M.unshard_envs(b[1]))
    for i in (0, 1, 3):
        assert res[0][i][2:] == res[1][i][2:]
    assert res[0][2][2] == res[1][2][2] > 0
    for x, y in zip(res[0][2][3], res[1][2][3]):
        assert torch.equal(x.cpu(), y)
    for (a1, d1), (a2, d2) in zip(res[0][4][2], res[1][4][2]):
        assert torch.equal(a1, a2) and torch.equal(d1, d2)


def test_count_read_span_ends_after_its_kernel(dev, tmp_path):
    """The host's clock and the card's agree in the profiler's trace: over
    200 VecEnv rounds at 4096 envs (100-turn games, so queues reset), each
    ``ed.k1act.read`` span, the host waiting for K1-act's counts, ends no
    earlier than 2 us before the ``step_actions_kernel`` it waited on. A
    host read cannot finish before the kernel it reads; the margins'
    minimum and median are printed (``-s``)."""
    from torch.profiler import ProfilerActivity, profile
    env = et.VecEnv(4096, device=dev)
    env.reset(seed=12345, n_players=4, n_pieces=3, max_steps=100)
    for _ in range(50):
        env.step(env.sample())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            env.step(env.sample())
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    ends = {"read": [], "kernel": []}
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "user_annotation" and e["name"] == "ed.k1act.read":
            ends["read"].append(e["ts"] + e["dur"])
        elif e.get("cat") == "kernel" and "step_actions_kernel" in e["name"]:
            ends["kernel"].append(e["ts"] + e["dur"])
    reads, kernels = sorted(ends["read"]), sorted(ends["kernel"])
    assert len(reads) == len(kernels) == 200
    margins = [r - k for r, k in zip(reads, kernels)]
    print(f"ed.k1act.read end - step_actions_kernel end over 200 rounds: "
          f"min {min(margins):.3f} us, median "
          f"{statistics.median(margins):.3f} us")
    assert min(margins) >= -2.0


# (n, q_cap, share of envs done): more than q_cap done, none, all, the
# main path's queue
SELECT_CASES = [(160, 128, 0.9), (4096, 128, 0.03), (4096, 128, 0.0),
                (4096, 128, 1.0), (33, 33, 0.5), (20000, 625, 0.05)]


@pytest.mark.parametrize("n,q_cap,share", SELECT_CASES)
@pytest.mark.parametrize("deferred", [False, True])
def test_queue_select_equals_plain(dev, n, q_cap, share, deferred):
    """The select kernel (csrc/queue.cu) == its plain version: the queue,
    its count and the in-flight flags, bit for bit."""
    from eldorado_tpu_torch.ops import queue as Q
    g = np.random.default_rng(n + q_cap)
    done = torch.as_tensor(g.random(n) < share).to(torch.int32)
    inflight = torch.as_tensor(g.random(n) < 0.3) if deferred else None
    outs = []
    for d in (dev, torch.device("cpu")):
        fl = None if inflight is None else inflight.to(d, copy=True)
        idx = torch.full((q_cap,), -7, dtype=torch.int32, device=d)
        count = torch.full((1,), -7, dtype=torch.int32, device=d)
        Q.select(done.to(d), fl, idx, count)
        outs.append([t.cpu() for t in (idx, count)]
                    + ([] if fl is None else [fl.cpu()]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [0, 1, 77, 128])
def test_queue_k3_k2_settle_with_a_count_equal_plain(dev, k):
    """K3, K2 and settle on a 128-slot queue whose count lies in device
    memory (the chunk loop's boundary) == their plain versions: the maps,
    the carry, the flags, the tally and the in-flight flags."""
    from eldorado_tpu_torch import vec as V
    from eldorado_tpu_torch.ops import queue as Q
    n = 512
    outs = []
    for d in (dev, torch.device("cpu")):
        s = et.vec_reset(9, n, 4, 3, 0, 100, device=d)
        static, carry = V._split(s)
        carry, _, _ = K.fused_step(carry, et.sampler_init(4, n, device=d),
                                   *V._params(static), 60)
        idx = torch.arange(1, n, 3, dtype=torch.int32, device=d)[:128]
        count = torch.tensor([k], dtype=torch.int32, device=d)
        inflight = torch.zeros(n, dtype=torch.bool, device=d)
        inflight[idx.long()] = True
        tally = torch.zeros(3, dtype=torch.int64, device=d)
        maps = tuple(static[f] for f in V._MAP_FIELDS)
        pre = TE._prelude_out(128, d)
        k3 = (carry[V._OFF["rng"]], static["n_pieces"], static["difficulty"])
        if d.type == "cuda":   # the loop's checks, then its raw launches
            MG.check_launch(*k3, maps, idx, n_players=static["n_players"],
                            prelude=pre, count=count)
            K.check_fused_reset(carry, static["n_players"], *pre, idx, count)
            MG.launch_generate_map(*k3, maps, idx,
                                   n_players=static["n_players"],
                                   prelude=pre, count=count)
            K.launch_fused_reset(carry, carry, static["n_players"], *pre,
                                 idx, count)
        else:
            TE.reset_map_prelude_rows_plain(*k3, static["n_players"], idx,
                                            maps, count, pre)
            K.fused_reset_plain(carry, static["n_players"], *pre, idx, count)
        Q.settle(idx, count, static["map_ok"], static["map_overflow"],
                 inflight, tally)
        outs.append([carry, *maps, tally, inflight])
    for a, b in zip(*outs):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("k", [77, 128])
def test_k3_counts_and_settle_sums_equal_plain(dev, k):
    """K3 launched at a 128-slot queue's capacity with a device count, on
    a mixed batch (1-16 pieces, difficulties 0-2: lanes that retry, abort
    and overflow), writes each generated slot's trips and retries as the
    plain generator counts them, and nothing past the count; settle's sums
    of them (trips, count x most trips) are the host's."""
    from eldorado_tpu_torch.ops import queue as Q
    n = 512
    seeds, players, pieces, diff = MG.mixed_batch(n, seed=6)
    st = TE.make_state(torch.as_tensor(seeds, device=dev), players, pieces,
                       diff, 100)
    idx = torch.cat([torch.arange(509, 512), torch.arange(0, 500, 4)]).to(
        device=dev, dtype=torch.int32)   # 128 rows, the overflow lanes first
    count = torch.tensor([k], dtype=torch.int32, device=dev)
    maps = [t.clone() for t in (st.map_ids, st.min_xy, st.map_ok,
                                st.map_overflow)]
    pre = TE._prelude_out(128, dev)
    work = torch.full((128, 2), -7, dtype=torch.int32, device=dev)
    k3 = (st.rng, st.n_pieces, st.difficulty, maps, idx)
    MG.check_launch(*k3, n_players=st.n_players, prelude=pre, count=count,
                    work=work)
    MG.launch_generate_map(*k3, n_players=st.n_players, prelude=pre,
                           count=count, work=work)
    rows = idx[:k].long()
    gen = MG.generate_map_plain(st.rng[rows], st.n_pieces[rows],
                                st.difficulty[rows])
    want = torch.full((128, 2), -7, dtype=torch.int32, device=dev)
    want[:k] = torch.stack([gen.trips, gen.retries], 1)
    assert torch.equal(work, want)
    assert bool((gen.retries > 0).any()) and bool((~gen.ok).any())
    assert int(gen.trips.max()) > int(gen.trips.min())
    sums = []
    for d in (dev, torch.device("cpu")):
        ok, over = (maps[2].to(d, copy=True), maps[3].to(d, copy=True))
        tally = torch.zeros(3, dtype=torch.int64, device=d)
        counters = (work.to(d), torch.zeros(2, dtype=torch.int64, device=d))
        Q.settle(idx.to(d), count.to(d), ok, over, None, tally, counters)
        sums.append([t.cpu() for t in (counters[1], tally, ok, over)])
    for a, b in zip(*sums):
        assert torch.equal(a, b)
    trips = gen.trips.long()
    assert sums[0][0].tolist() == [int(trips.sum()), k * int(trips.max())]


QUEUE_RUNS = [("sync", False), ("sync", True), ("async", False),
              ("async", True)]


@pytest.mark.parametrize("mode,exact", QUEUE_RUNS)
def test_device_queue_rollout_equals_cpu(dev, mode, exact):
    """rollout_chunked with the device-resident queue == the plain path,
    bit for bit, at 160 envs of one-turn games in chunks of 8: the queue
    overflows at the first boundary (test_torch_queue_overflow.py's
    setting). Every field, srng, episodes and dead steps; no boundary
    reads the card."""
    from eldorado_tpu_torch import vec as V
    outs = []
    reads = V._ChunkLoop.boundary_reads
    for d in (dev, torch.device("cpu")):
        outs.append(et.rollout_chunked(
            et.vec_reset(5, 160, 2, 1, 0, 1, device=d),
            et.sampler_init(11, 160, device=d), 24, 8, exact=exact,
            reset_mode=mode))
    assert V._ChunkLoop.boundary_reads == reads
    (a, ra, *ca), (b, rb, *cb) = outs
    _same(b, a)
    assert torch.equal(ra.cpu(), rb) and ca == cb and ca[0] > 128


def test_device_queue_two_shards_equal_cpu(dev):
    """`parallel.runner.sharded_kernel_rollout` on two shards of the card
    (80 envs each, so each queue overflows) == the same on the CPU."""
    from eldorado_tpu_torch.parallel import mesh as M, runner as R
    outs = []
    for d in (dev, torch.device("cpu")):
        outs.append(R.sharded_kernel_rollout(
            M.make_mesh(devices=[d] * 2),
            et.vec_reset(5, 160, 2, 1, 0, 1, device=d),
            et.sampler_init(11, 160, device=d), 24, 8, exact=True))
    (a, ra, *ca), (b, rb, *cb) = outs
    for x, y in zip(a, b):
        _same(y, x)
    for x, y in zip(ra, rb):
        assert torch.equal(x.cpu(), y)
    assert ca == cb and ca[0] > 0


def test_boundary_runs_no_torch_op(dev, tmp_path):
    """Between a chunked call's start and end no torch op runs on the host
    (the profiler records none inside ``ed.rollout`` outside
    ``ed.rollout.end``): each boundary is select, K3, K2 and settle, each
    launched once, and no boundary reads the card."""
    from torch.profiler import ProfilerActivity, profile
    from eldorado_tpu_torch import vec as V
    from eldorado_tpu_torch.ops import queue as Q
    s = et.vec_reset(12345, 512, 4, 3, 0, 100, device=dev)
    r = et.sampler_init(42, 512, device=dev)
    s, r, _ = et.rollout_chunked(s, r, 160, 16)   # built and warm
    before = (Q.select.launches, MG.generate_map.launches,
              K.fused_reset.launches, Q.settle.launches,
              V._ChunkLoop.boundaries, V._ChunkLoop.boundary_reads)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, episodes = et.rollout_chunked(s, r, 320, 16)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    span = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation"
            and e["name"] in ("ed.rollout", "ed.rollout.end")}
    (a, b), (c, _) = span["ed.rollout"], span["ed.rollout.end"]
    ops = [e["name"] for e in events if e.get("cat") == "cpu_op"
           and a <= e["ts"] < c]
    assert ops == []
    after = (Q.select.launches, MG.generate_map.launches,
             K.fused_reset.launches, Q.settle.launches,
             V._ChunkLoop.boundaries, V._ChunkLoop.boundary_reads)
    delta = [x - y for x, y in zip(after, before)]
    assert delta[0] == delta[3] == delta[4] == 20 and delta[5] == 0
    assert delta[1] == delta[2] >= 20 and episodes > 0


def test_learner_queue_launch_counts(dev):
    """The learner's round takes its queue on the card: K1-act once a
    round; select, K3 and K2 once in each round that ended games, each
    such round counted in `VecEnv.card_queues`; no settle, and no burst
    over the queue at 256 envs."""
    from eldorado_tpu_torch.ops import queue as Q
    env = et.VecEnv(256, device=dev)
    env.reset(seed=21, n_players=2, n_pieces=1, max_steps=6)

    def counts():
        return (K.step_actions.launches, Q.select.launches,
                MG.generate_map.launches, K.fused_reset.launches,
                Q.settle.launches, et.VecEnv.card_queues,
                et.VecEnv.host_queues)
    before = counts()
    resets = sum(bool(env.step(env.sample()).any()) for _ in range(40))
    assert [x - y for x, y in zip(counts(), before)] == [
        40, resets, resets, resets, 0, resets, 0]
    assert resets > 0


# (case, envs): 100-turn games at the main path's batch, cog-4p-mixed-t100's
# levels, and a step that ends 1030 of 1100 games, over the queue's 1024
@pytest.mark.parametrize("case,n", [("t100", 4096), ("mixed", 4096),
                                    ("burst", 1100)])
def test_vecenv_card_queue_equals_host_path_cuda(dev, case, n):
    """tests/test_torch_vecenv.py's check on the card over 200 rounds: the
    queue chosen by select and reset by K3 and K2 equals the host path
    (`_reset_columns` on the ascending done rows) in every field, the done
    flags and the engines after every round; the burst alone falls back."""
    got = LQ.run(*LQ.batch(case, n, 200, dev), 200)
    assert got["ended"] >= 20, got
    assert got["bursts"] == (case == "burst"), got
    assert got["card_queues"] == got["ended"] - got["bursts"], got
    assert got["host_queues"] == got["bursts"], got


def test_vecenv_card_queue_equals_cpu_cuda(dev):
    """The queue on the card against a CPU VecEnv's (the plain select, K3
    and K2, which share no code with the kernels) over 200 rounds of
    cog-4p-mixed-t100's levels at 512 envs."""
    got = LQ.run(*LQ.batch("mixed", 512, 200, dev), 200, ref="cpu")
    assert got["ended"] >= 20 and got["bursts"] == 0, got
    assert got["card_queues"] == got["ended"] and not got["host_queues"]
