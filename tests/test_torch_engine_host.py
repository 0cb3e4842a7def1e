"""csrc/engine.cuh on the host, against the plain torch K1, tolerance zero.

K1's per-env work (``ed::run_steps``: ``ed::sample_step`` and the record
packer, on an env staged into its padded ``EnvSlot``) is built with g++
around tests/engine_host.cpp and run on the CPU, so every edit to the
engine's logic or to the slot layout is held to
`step_kernel.fused_step_plain` here, before the card sees it. 64 envs with
mixed players, pieces and difficulties, taken mid-game by 1500 host steps
(so that bought cards and their specials are in play), x 200 steps in
which half of them reach their turn limit, with the storage mask, the sel
mask, and gate_dead (every 7th env done at entry): the carry, srng, last
actions, dead steps and full records are equal word for word; the same
window with the trajectory record. K1-act's per-env work (``ed::step_given``
behind ``ed::actions_in_heads``) steps the same envs with sampled actions,
with random actions inside the heads that the masks forbid and with a few
outside them, against `step_actions_plain`; K1-sample's
(``ed::sample_action``) draws from random masks, live or not, against
`sample_plain`. The sampler's shortened chain: the 23-row SMALL_RANGE
table against the divisions it replaces (and its reciprocals against the
quotient's), the host branch of nth_set_bit against a bit scan in numpy
on seeded width-22 masks and every position. K1-act's block staging
plan, looped as its kernel loops it, at n = 1, 3, 31, 4096, 4097 and
4100 (a last block of 4 envs by 16-byte units):
every (field, env) staged exactly once; its block's constants in
engine.cuh against `step_kernel.ACT_ENVS` and kin. K2's per-env work
(``ed::reset_env`` through the lane shim's loop form, each slot holding
noise before it is staged) against `fused_reset_plain` on the mid-game
carry with the players of `mapgen.mixed_batch` and seeded ball rows of
every cell type, into a new carry and in place on an unsorted queue;
with every word outside its read set replaced by noise, the words it
writes equal the clean run's and no other word changes; its write set's
size, the bit table of it that its stores read and the start deck's slot
table; its staging plan; its block's constants against
`step_kernel.RESET_ENVS` and kin. Skips only where g++ is missing.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import eldorado_tpu_torch as et
from eldorado_tpu_torch import stream as S
from eldorado_tpu_torch.core import cells as C
from eldorado_tpu_torch.core import engine as E
from eldorado_tpu_torch.core import mapgen as MG
from eldorado_tpu_torch.ops import build
from eldorado_tpu_torch.ops import step_kernel as K

DRIVER = Path(__file__).with_name("engine_host.cpp")
N, T, WARM = 64, 200, 1500
_OFF = {f: off for f, _, _, off, _ in E.DYN_LAYOUT}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of engine.cuh needs it")
    so = tmp_path_factory.mktemp("engine_host") / "libengine_host.so"
    res = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
         f"-I{build.CSRC}", "-o", str(so), str(DRIVER)],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    lib = ctypes.CDLL(str(so))
    lib.ed_host_fused_step.argtypes = [ctypes.c_void_p] * 11 \
        + [ctypes.c_int] * 5
    lib.ed_host_fused_step.restype = ctypes.c_int
    lib.ed_host_step_actions.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int]
    lib.ed_host_sample.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
    lib.ed_host_small_range.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.ed_host_small_quotient.argtypes = [ctypes.c_int] \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.ed_host_nth_set_bit.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.ed_host_tile_cover.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.ed_host_reset_tile_cover.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.ed_host_fused_reset.argtypes = [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 2 + [ctypes.c_uint32]
    lib.ed_host_reset_sets.argtypes = [ctypes.c_void_p] * 2
    lib.ed_host_minstd_skip.argtypes = [ctypes.c_uint32, ctypes.c_void_p]
    lib.ed_host_start_slots.argtypes = [ctypes.c_void_p] * 2
    return lib


@pytest.fixture(scope="module")
def host_step(host_lib):
    return host_lib.ed_host_fused_step


@pytest.fixture(scope="module")
def start(host_step):
    """64 envs of mixed parameters, reset on the CPU and stepped WARM
    times on the host (a few games end there by a win and dead-step from
    then on); then every odd env's turn limit is set a few turns ahead,
    so that it ends inside the compared window."""
    i = np.arange(N)
    s = et.vec_reset_varied(1000 + i, 2 + i % 3, 1 + i % 3, i % 2, 100000,
                            device="cpu")
    static = (s.map_ids, s.min_xy, s.n_players, s.max_steps.clone())
    carry, _, _, _, _ = run_host(host_step, E.pack_dyn(E.split_state(s)[1]),
                                 et.sampler_init(7, N, device="cpu"), static,
                                 WARM, "storage", False, record_words=0)
    turns = carry[_OFF["turn_counter"]]
    static[3][1::2] = turns[1::2] + 2 + torch.arange(N // 2) % 5
    return carry, static


def run_host(host_step, carry, srng, static, n_steps, mask_src, gate_dead,
             record_words=S.RECORD_WORDS_FULL):
    n = carry.shape[1]
    out, srng_out = torch.empty_like(carry), torch.empty_like(srng)
    act = torch.zeros((n, 5), dtype=torch.int32)
    dead = torch.zeros(1, dtype=torch.int64)
    rec = torch.full((n_steps, n, record_words), -1, dtype=torch.int32)
    err = host_step(carry.data_ptr(), out.data_ptr(), srng.data_ptr(),
                    srng_out.data_ptr(), *(t.data_ptr() for t in static),
                    act.data_ptr(), dead.data_ptr(), rec.data_ptr(), n,
                    n_steps, mask_src == "sel", int(gate_dead),
                    record_words)
    assert err == 0
    return out, srng_out, act, dead, rec


@pytest.mark.parametrize("mask_src,gate_dead", [
    ("storage", False), ("sel", False), ("storage", True)])
def test_engine_host_equals_plain(host_step, start, mask_src, gate_dead):
    carry, static = start
    carry = carry.clone()
    if gate_dead:
        carry[_OFF["done"], ::7] = 1
    srng = et.sampler_init(42, N, device="cpu")
    got = run_host(host_step, carry, srng, static, T, mask_src, gate_dead)
    dead = torch.zeros(1, dtype=torch.int64)
    rec = torch.empty((T, N, S.RECORD_WORDS_FULL), dtype=torch.int32)
    c, r, a = K.fused_step_plain(carry, srng, *static, T, mask_src,
                                 gate_dead, dead, record="full", records=rec)
    for name, x, y in (("carry", got[0], c), ("srng", got[1], r),
                       ("actions", got[2], a), ("dead", got[3], dead),
                       ("records", got[4], rec)):
        assert torch.equal(x, y), name
    fields = dict(zip(E.DYN_FIELDS, E.unpack_dyn(c)))
    assert bool(fields["done"][1::7].any())   # envs ended inside the run
    if gate_dead:
        assert int(dead) >= len(range(0, N, 7)) * T


@pytest.mark.parametrize("mask_src", ["storage", "sel"])
def test_engine_host_traj_records_equal_plain(host_step, start, mask_src):
    """The trajectory record (vec.rollout's per-step fields) over the same
    window, in which games end: every word, and the carry and srng as
    without records."""
    carry, static = start
    srng = et.sampler_init(42, N, device="cpu")
    got = run_host(host_step, carry, srng, static, T, mask_src, False,
                   record_words=K.TRAJ_WORDS)
    rec = torch.empty((T, N, K.TRAJ_WORDS), dtype=torch.int32)
    c, r, _ = K.fused_step_plain(carry, srng, *static, T, mask_src,
                                 record="traj", records=rec)
    assert torch.equal(got[4], rec)
    assert torch.equal(got[0], c) and torch.equal(got[1], r)
    assert bool(K.unpack_traj(rec)[1].any())   # done records in the window


def host_step_actions(lib, carry, actions, static):
    out = torch.empty_like(carry)
    counts = torch.zeros(2, dtype=torch.int32)
    lib.ed_host_step_actions(carry.data_ptr(), out.data_ptr(),
                             actions.data_ptr(),
                             *(t.data_ptr() for t in static),
                             counts.data_ptr(), carry.shape[1])
    return out, counts


def test_engine_host_step_actions_equal_plain(host_lib, start):
    """K1-act's per-env code against `step_actions_plain` over 60 steps
    from the mid-game carry (every 5th env done at entry): odd steps take
    sampled actions, even steps random actions inside the heads (most of
    them forbidden by the masks: moves off the map, cards not in hand,
    empty shop slots); every tenth step gives every 9th env an action
    outside its head, which both leave unstepped and count."""
    carry, static = start
    carry = carry.clone()
    carry[_OFF["done"], ::5] = 1
    gen = np.random.default_rng(3)
    widths = np.asarray(K.HEAD_WIDTHS)
    srng = et.sampler_init(5, N, device="cpu")
    refused = 0
    for t in range(60):
        if t % 2:
            act, srng, _ = K.sample_plain(srng,
                                          K.mask_words(carry, "storage"))
        else:
            act = torch.as_tensor(gen.integers(0, 1 << 20, (N, 5)) % widths,
                                  dtype=torch.int32)
        if t % 10 == 0:
            act[::9, t // 10 % 5] = (-1, 22, 22, 7, 19)[t // 10 % 5]
        got = host_step_actions(host_lib, carry, act, static)
        want = K.step_actions_plain(carry, act, *static)
        assert torch.equal(got[0], want[0]), f"carry, step {t}"
        assert torch.equal(got[1], want[1]), f"counts, step {t}"
        refused += int(got[1][0])
        carry = got[0]
    assert refused == 6 * len(range(0, N, 9))
    assert int(got[1][1]) > len(range(0, N, 5))   # envs ended in the run


@pytest.mark.parametrize("live", [False, True])
def test_engine_host_sample_equal_plain(host_lib, live):
    """K1-sample's per-env code against `sample_plain` on 256 random
    packed masks (bits 92-95 clear; some heads empty) with and without
    the live flags (a third of the envs draw nothing)."""
    n = 256
    gen = np.random.default_rng(4)
    bits = gen.random((n, E.MASK_LEN)) < gen.random((n, 1))
    words = E.pack_mask(torch.as_tensor(bits))
    srng = et.sampler_init(9, n, device="cpu")
    flags = torch.as_tensor(gen.random(n) < 0.67) if live else None
    act = torch.empty((n, 5), dtype=torch.int32)
    srng_out = torch.empty_like(srng)
    tainted = torch.empty(n, dtype=torch.bool)
    host_lib.ed_host_sample(srng.data_ptr(), srng_out.data_ptr(),
                            words.data_ptr(),
                            None if flags is None else flags.data_ptr(),
                            act.data_ptr(), tainted.data_ptr(), n)
    want = K.sample_plain(srng, words, flags)
    for name, x, y in zip(("actions", "srng", "tainted"),
                          (act, srng_out, tainted), want):
        assert torch.equal(x, y), name
    if live:
        assert torch.equal(srng_out[~flags], srng[~flags])


URNG_RANGE = 2147483645   # libstdc++ minstd_rand0: max - min


def test_small_range_table_equals_division(host_lib):
    """Every row of rng.cuh's SMALL_RANGE: scaling and past as
    uniform_int_fast computes them (row 0 is row 1, the clamp), and the
    reciprocal's quotient equal to r // scaling on each multiple of
    scaling and its neighbours up to 2^31 and on 100,000 seeded r."""
    gen = np.random.default_rng(11)
    row = np.zeros(4, np.uint32)
    for n in range(23):
        m = max(n, 1)
        host_lib.ed_host_small_range(n, row.ctypes.data)
        scaling = URNG_RANGE // m
        assert (int(row[0]), int(row[1])) == (scaling, m * scaling), n
        mult = np.arange(0, (1 << 31) // scaling + 2, dtype=np.int64)
        r = np.concatenate([(mult[:, None] * scaling
                             + np.arange(-2, 3)).ravel(),
                            gen.integers(0, 1 << 31, 100_000),
                            [(1 << 31) - 1]])
        r = r[(r >= 0) & (r < 1 << 31)].astype(np.uint32)
        q = np.empty_like(r)
        host_lib.ed_host_small_quotient(n, r.ctypes.data, q.ctypes.data,
                                        len(r))
        assert np.array_equal(q, r // np.uint32(scaling)), n


def test_nth_set_bit_host_equals_scan(host_lib):
    """nth_set_bit's host branch (the scan __fns replaces on the card)
    against numpy's scan, on 4,096 seeded width-22 masks (full, single
    bits and random densities) at every position below the popcount."""
    gen = np.random.default_rng(12)
    masks = np.concatenate([
        [(1 << 22) - 1], 1 << np.arange(22),
        (gen.random((4096 - 23, 22)) < gen.random((4096 - 23, 1)))
        @ (1 << np.arange(22))]).astype(np.uint32)
    bits = (masks[:, None] >> np.arange(22)) & 1
    f, pos, want = [], [], []
    for m, b in zip(masks, bits):
        where = np.flatnonzero(b)
        f += [m] * len(where)
        pos += range(len(where))
        want += list(where)
    f = np.asarray(f, np.uint32)
    pos = np.asarray(pos, np.int32)
    got = np.empty(len(f), np.int32)
    host_lib.ed_host_nth_set_bit(f.ctypes.data, pos.ctypes.data,
                                 got.ctypes.data, len(f))
    assert np.array_equal(got, np.asarray(want, np.int32))


def test_act_block_constants_match_header():
    """engine.cuh's kActEnvs, kActWarps and kActUnits (K1-act's block) are
    step_kernel's ACT_ENVS, ACT_WARPS and ACT_UNITS, and one pass of the
    block's threads stages a full tile of 16-byte units."""
    text = (build.CSRC / "engine.cuh").read_text()
    got = [int(re.search(rf"constexpr int kAct{k} = (\d+);", text)[1])
           for k in ("Envs", "Warps", "Units")]
    assert got == [K.ACT_ENVS, K.ACT_WARPS, K.ACT_UNITS]
    units = E.CARRY_WORDS * K.ACT_ENVS // 4
    assert K.ACT_UNITS == -(-units // (32 * K.ACT_WARPS))


@pytest.mark.parametrize("n", [1, 3, 31, 4096, 4097, 4100])
def test_tile_plan_covers_every_word_once(host_lib, n):
    """K1-act's staging plan: the units of every block (16-byte ones where
    n % 4 == 0, words elsewhere) move each (field, env) of the carry
    exactly once; with unaligned carries (words throughout) likewise."""
    for vec_ok in (1, 0) if n % 4 == 0 else (1,):
        staged = np.zeros(E.CARRY_WORDS * n, np.int32)
        host_lib.ed_host_tile_cover(n, vec_ok, staged.ctypes.data)
        assert np.array_equal(staged, np.ones_like(staged)), vec_ok


# ------------------------------------------------------------------- K2
@pytest.fixture(scope="module")
def reset_inputs(start):
    """The 64 mid-game columns of `start` as the old carry, with the
    players (1-4) of `mapgen.mixed_batch(64)` (its pieces and
    difficulties do not enter the reset body), seeded add_players
    positions and ball rows of every cell type (seeded ids decoded to
    req / nr / end); an unsorted queue of 23 columns."""
    carry = start[0]
    _, players, _, _ = MG.mixed_batch(N)
    gen = np.random.default_rng(8)
    ids = torch.as_tensor(gen.integers(0, C.N_CELL_TYPES, (N, 4, E.N_BALL)),
                          dtype=torch.int32)
    xy = torch.as_tensor(gen.integers(-48, 48, (N, 4, 2)),
                         dtype=torch.int32)
    idx = torch.as_tensor(gen.permutation(N)[:23], dtype=torch.int32)
    return (carry, torch.as_tensor(players, dtype=torch.int32), xy,
            C.decode_cells(ids), idx)


def host_reset(lib, carry, n_players, xy, ball, idx=None, seed=1):
    """ed_host_fused_reset as `fused_reset` calls ed_fused_reset: a new
    carry, or (idx) the queue's columns of a copy of ``carry`` in place."""
    q = xy.shape[0]
    out = torch.empty_like(carry) if idx is None else carry.clone()
    lib.ed_host_fused_reset(carry.data_ptr() if idx is None
                            else out.data_ptr(), out.data_ptr(),
                            None if idx is None else idx.data_ptr(),
                            n_players.data_ptr(), xy.data_ptr(),
                            *(t.data_ptr() for t in ball), carry.shape[1],
                            q, seed)
    return out


def reset_sets(lib):
    """(reads (570,), writes (4, 570): row np - 1 for np players), bool."""
    reads = np.zeros(E.CARRY_WORDS, np.uint8)
    writes = np.zeros((4, E.CARRY_WORDS), np.uint8)
    lib.ed_host_reset_sets(reads.ctypes.data, writes.ctypes.data)
    return torch.as_tensor(reads > 0), torch.as_tensor(writes > 0)


@pytest.mark.parametrize("queue", [False, True])
def test_reset_host_equals_plain(host_lib, reset_inputs, queue):
    """K2's lane form equals `fused_reset_plain` on every word: into a new
    carry, and in place on the unsorted queue (every other column as it
    was); each env's slot held noise before it was staged."""
    carry, n_players, xy, ball, idx = reset_inputs
    if queue:
        rows = idx.long()
        q_xy, q_ball = xy[rows], tuple(b[rows] for b in ball)
        got = host_reset(host_lib, carry, n_players, q_xy, q_ball, idx)
        want = K.fused_reset_plain(carry.clone(), n_players, q_xy, *q_ball,
                                   idx=idx)
        keep = torch.ones(N, dtype=torch.bool)
        keep[rows] = False
        assert torch.equal(got[:, keep], carry[:, keep])
    else:
        got = host_reset(host_lib, carry, n_players, xy, ball)
        want = K.fused_reset_plain(carry, n_players, xy, *ball)
    assert torch.equal(got, want)
    assert set(n_players.tolist()) == {1, 2, 3, 4}


@pytest.mark.parametrize("queue", [False, True])
def test_reset_host_read_set_poison(host_lib, reset_inputs, queue):
    """The read set pinned: with every word outside RESET_READS replaced
    by noise, every word K2 writes equals the clean plain run's, and every
    word it does not write keeps its (noisy) value; the plain run changes
    no word outside the write set."""
    carry, n_players, xy, ball, idx = reset_inputs
    reads, writes = reset_sets(host_lib)
    gen = np.random.default_rng(9)
    noise = torch.as_tensor(gen.integers(-2 ** 31, 2 ** 31, carry.shape),
                            dtype=torch.int32)
    noisy = torch.where(reads[:, None], carry, noise)
    cols = idx.long() if queue else torch.arange(N)
    w = writes[n_players[cols].long() - 1].T     # (570, q) for the columns
    if queue:
        q_xy, q_ball = xy[cols], tuple(b[cols] for b in ball)
        got = host_reset(host_lib, noisy, n_players, q_xy, q_ball, idx,
                         seed=5)
        want = K.fused_reset_plain(carry.clone(), n_players, q_xy, *q_ball,
                                   idx=idx)
        keep = torch.ones(N, dtype=torch.bool)
        keep[cols] = False
        assert torch.equal(got[:, keep], noisy[:, keep])
    else:
        got = host_reset(host_lib, noisy, n_players, xy, ball, seed=5)
        want = K.fused_reset_plain(carry, n_players, xy, *ball)
    got, want, old = got[:, cols], want[:, cols], carry[:, cols]
    assert torch.equal(got[w], want[w])
    assert torch.equal(got[~w], noisy[:, cols][~w])
    assert torch.equal(want[~w], old[~w])
    assert bool((noisy[:, cols][~w] != old[~w]).any())


MINSTD_M, MINSTD_A = 2 ** 31 - 1, 16807


def test_minstd_skip_equals_pow(host_lib):
    """rng.cuh's jump-ahead (the deals' draws): minstd_skip(x, k) ==
    16807^k x mod 2^31 - 1 for k = 0-16 on the engine's extremes and 200
    seeded states."""
    gen = np.random.default_rng(10)
    out = np.zeros(17, np.uint32)
    for x in [1, 2, MINSTD_M - 1, *gen.integers(1, MINSTD_M, 200)]:
        host_lib.ed_host_minstd_skip(int(x), out.ctypes.data)
        assert out.tolist() == [pow(MINSTD_A, k, MINSTD_M) * int(x) % MINSTD_M
                                for k in range(17)], x


@pytest.mark.parametrize("queue", [False, True])
def test_reset_host_rejected_draws_equal_plain(host_lib, reset_inputs,
                                               queue):
    """A deal's draw whose first attempt is rejected (about 4 in 10^9
    draws): column c's engine is set so that its draw c % 16 (of the
    deals' 4 * n_players) rejects, which the lanes' jump-ahead cannot
    take; K2's lane form then runs the draws in sequence and equals
    `fused_reset_plain` on every word."""
    carry, n_players, xy, ball, idx = reset_inputs
    carry = carry.clone()
    inv = pow(MINSTD_A, MINSTD_M - 2, MINSTD_M)
    urng = MINSTD_M - 2                      # uniform_int's range
    forced = 0
    for c in range(N):
        j = c % (4 * int(n_players[c]))
        n = 8 - j % 4
        past = n * (urng // n)
        first = min(past + 1 + c % 2, MINSTD_M - 1)   # r = first - 1
        x = first * pow(inv, j + 1, MINSTD_M) % MINSTD_M
        carry[_OFF["rng"], c] = x - (1 << 32) if x >= 1 << 31 else x
        forced += 1
    if queue:
        rows = idx.long()
        q_xy, q_ball = xy[rows], tuple(b[rows] for b in ball)
        got = host_reset(host_lib, carry, n_players, q_xy, q_ball, idx)
        want = K.fused_reset_plain(carry.clone(), n_players, q_xy, *q_ball,
                                   idx=idx)
    else:
        got = host_reset(host_lib, carry, n_players, xy, ball)
        want = K.fused_reset_plain(carry, n_players, xy, *ball)
    assert forced == N and torch.equal(got, want)


def test_reset_sets(host_lib):
    """K2's sets: the nine words of RESET_READS; 57 words written in every
    env and 98 more for each player, none of them a played pile."""
    reads, writes = reset_sets(host_lib)
    want = {_OFF["rng"], _OFF["rng_tainted"], _OFF["n_in_market"],
            *range(_OFF["sel_mask"], _OFF["sel_mask"] + 3),
            *range(_OFF["resources"], _OFF["resources"] + 3)}
    assert set(np.flatnonzero(reads.numpy())) == want
    assert writes.sum(1).tolist() == [57 + 98 * p for p in range(1, 5)]
    played = E.PILE_PLAYED * E.N_CARDTYPES
    for p in range(4):
        base = _OFF["piles"] + p * 5 * E.N_CARDTYPES + played
        assert not bool(writes[:, base:base + E.N_CARDTYPES].any())


def test_start_slots_lay_out_the_start_deck(host_lib):
    """START_SLOTS (the deals' slots of each card) lays START_DISCARD's
    eight cards out in card order, a bit a slot, each slot once."""
    slots = np.zeros(E.N_CARDTYPES, np.uint32)
    start = np.zeros(E.N_CARDTYPES, np.int32)
    host_lib.ed_host_start_slots(slots.ctypes.data, start.ctypes.data)
    lo = np.concatenate([[0], np.cumsum(start)[:-1]])
    want = ((1 << start.astype(np.int64)) - 1) << lo
    assert slots.tolist() == want.tolist()
    assert start.sum() == 8 and int(np.bitwise_or.reduce(slots)) == 0xFF


def test_reset_write_table_equals_predicate(host_lib):
    """RESET_WRITES, the bit table K2's stores read, holds exactly the
    words reset_writes names, at every player count from -2 to 6."""
    assert host_lib.ed_host_write_table_mismatches() == 0


@pytest.mark.parametrize("n", [1, 3, 31, 4096, 4097])
def test_reset_tile_plan_covers_every_word_once(host_lib, n):
    """K2's new-carry staging plan moves each (field, env) exactly once."""
    staged = np.zeros(E.CARRY_WORDS * n, np.int32)
    host_lib.ed_host_reset_tile_cover(n, staged.ctypes.data)
    assert np.array_equal(staged, np.ones_like(staged))


def test_reset_block_constants_match_header():
    """engine.cuh's kResetEnvs and kResetUnits (K2's block) are
    step_kernel's RESET_ENVS and RESET_UNITS."""
    text = (build.CSRC / "engine.cuh").read_text()
    got = [int(re.search(rf"constexpr int kReset{k} = (\d+);", text)[1])
           for k in ("Envs", "Units")]
    assert got == [K.RESET_ENVS, K.RESET_UNITS]
