"""Drive the PyTorch / CUDA port's main path on one GPU and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the kernels from eldorado_tpu_torch/csrc, then runs these
phases, printing a line for each; any mismatch or exception exits non-zero
before the final line:

0. the device, the card's name and power limit (nvidia-smi), versions and
   the kernel build time, and every kernel's registers and stack frame;
1. K3 (map generation and its prelude, one warp per env) against the
   eight oracle goldens, and against its plain version (generate_map_plain
   and the plain prelude) on every lane and field: the 4096 main-path
   seeds, a mixed batch (1-4 players, 1-16 pieces, difficulties 0-2,
   aborted and MAX_PLACED-overflow lanes), the mixed batch again in every
   launch shape (1, 2 or 4 envs a block, the pair table through L1 or in
   shared memory) and, in its queue form, a 128-env reset queue of
   mid-game envs writing the batch's rows;
2. K2 (fused_reset) against its plain version: vec_reset at 4096 envs,
   then in place on the 128-env queue's columns of the batch carry; then
   at q = 1, 8, 31, 33, 128, 4096 and 4097 envs, in place on unsorted
   columns of a 4100-env mid-game batch and into a new carry from them;
3. K1 (fused_step) against its plain version: 1024 envs, 64 steps, with
   the storage mask, the sel mask, and gate_dead;
4. the slice, CUDA against CPU: rollout_chunked at 512 envs; then the
   card path against the 11 oracle trajectory goldens at full length
   (tests/traj_replay.py: one K1 launch per step, K3 and K2 at each
   game's end; traj_win_storage's 20,000 steps with two won games);
5. the main path at full size: vec_reset(12345, 4096, 4, 3, EASY,
   max_steps=100000) and rollout_chunked over 3 chunks of 1500 steps
   (and once with exact=True), timed, with K1's share and the reset
   queue's cost split into K3, K2 and the rest; the plain generator's
   trip loop must not run there; then K1 against its plain version
   on the 4096-env mid-game carry over a 200-step window in which games
   end by a win; kernel times beside their plain versions and bounds;
   K1's launch shape (threads, blocks, shared bytes per block, blocks
   resident per SM) and its ms per step at 8192 and 16384 envs; K3's
   launch shape and its ms per 128-env queue and at 4096 envs in every
   launch shape (both places of the pair table); K2 in place on queues of
   1, 8 and 128 envs of the mid-game carry and into a new carry at 4096
   envs, each beside an empty kernel on its grid (its launch floor); its
   bound on the bytes an in-place reset moves, and its ratio to the bound
   of each column in and out that earlier records used; the chunk loop's
   boundary at the main path's capacity (select against its plain
   version; K3 and K2 launched at the capacity with the queue's device
   count, K3 writing each slot's trips and retries, against their plain
   versions given it; settle with K3's counters against its plain version
   with a map failure and an overflow planted in the queue; select and
   settle (with its counters) timed beside an empty one-block kernel,
   each beside its bytes bound; K3 and K2 at the capacity with a count of 1, 8 and
   128 beside the launches sized to those envs);
6. K1's cost probes on the carry phase 5 leaves: K1-null, P1 (null
   copy), P2 (op chain,
   nine shapes, both ops, k=4096) and P3 (step prefix, cuts 0-3 over 8
   steps) against their plain versions, then the probe path: the
   measurements of the four eldorado_tpu_torch.tools modules at short step
   counts, printed as the tools print them; then P1 beside
   ``dst.copy_(carry)``, each timed twice in turns, with the L2 swept by a
   write (dirty) and by a read (clean) before each launch, and the latency of one dependent int32 op
   (P2's time over k, one warp), which sets P2's bound;
7. the learner feed (stream.py): (a) K1 with compact and with full
   records against the records of phase 3's and phase 5's plain runs,
   and K1's ms per step with and without records; (b) stream_rollout
   (full records, ring) CUDA against CPU at 128 envs with resets, and an
   ObsReconstructor driven by the CUDA feed against the CUDA final state;
   (c) the feed at full width, timed, with the launch counts zeroed just
   before it: from vec_reset(12345, 4096, 4, 3, EASY, 100000), 3 chunks
   of 1500 steps through the compact ring, device delivery, the
   compressed ring and exact mode, then one chunk of full records
   through a small ring;
8. the learner's surface (vec.py): (a) K1-act (vec_step's step with the
   learner's actions) and K1-sample (vec_sample's sampler) against their
   plain versions at 4096 envs from the main path's reset, sampled and
   random in-range actions, live flags or none; K1-act at 1, 4096, 4097
   and 16384 envs (the word and the 16-byte staging paths, printed);
   K1-sample reading its masks from the carry
   (VecEnv.sample's one launch) against mask_words + the plain sampler +
   the OR into rng_tainted, storage and sel masks, with and without live
   flags; K1 with the trajectory record against the plain record on
   phases 3 and 5's inputs; (b) an action outside its head raises, the
   batch untouched; then, with the counts zeroed just before: (c)
   VecEnv's sample / step loop at 512 envs for 200 steps in 20-turn
   games, CUDA against CPU on every field, srng and the episode count;
   (d) rollout in both auto-reset modes and with both mask sources, and
   kernel_rollout, CUDA against CPU; (e) VecEnv's sample-then-step rate
   at 4096 envs; the counts of K1-act, K1-sample (every launch from the
   carry), K1's trajectory record, K3 and K2 read just after, and one
   VecEnv.sample under the profiler, which must be one device operation;
   then K1-act on the learner's carry timed cold (the L2 written before
   each launch, as for P1), warm, and with every env done (its staging
   floor), K1-null beside it (the first design's staging floor), K1-act
   at one env (cog_env's width), K1-sample from the carry and from mask
   words beside an empty kernel launched the same way (the launch
   floor), and the trajectory record, each beside its bound;
9. the city_of_gold surface (compat): (a) cog_env on the card in
   lockstep with cog_env(backend="ref") (the numpy reference engine) over
   three parameter sets of 2000 storage-mask steps in short games, and
   seed 21 (4 players, 1 piece, EASY) played to its win; each with a
   full-parameter reset after a finished game; every observation, mask,
   reward and info field after every step and reset; single-env steps/s;
   (b) compat.vec's sample -> step loop with the observations and infos
   read every 10 steps, CUDA against CPU at 256 envs, then its rate at
   4096 envs with and without the reads; (c) the runner's rate. Each of
   cog_env (a), compat.vec (b) and the runner (c) has its own counts,
   zeroed just before it and read just after;
10. rollout_chunked(reset_mode="async"): (a) CUDA against CPU at 512 envs
   with exact off and on (phase 4's recipe); (b) the main path at full
   width, sync and async in alternating turns (sync, async, async, sync)
   from the same reset: each mode's env-steps/s, the counts zeroed just
   before each async run and read just after it; then one run of each
   mode under torch.profiler: its wall against the device's busy time,
   and K3 and K2's device time per reset queue;
11. the sharded path (eldorado_tpu_torch.parallel): (a) on a 1-device
   mesh, sharded_kernel_rollout at the main path's full width equal to
   rollout_chunked on every field, srng and the episode count, with exact
   off and on (dead steps too), with the counts zeroed just before the
   sharded run and read just after (K1, K3 and K2, as many as the
   unsharded run's); both rates in alternating turns and their ratio;
   (b) the main path as 4 shards on the one card (1024 envs each, a
   128-env queue each): every shard equal to the unsharded run of its own
   slice and seeds, its rate, its launches counted from 0 after its
   inputs were made (K1 once a shard a chunk); sharded_stream_rollout (compact and full
   records, the default device fold) equal, summed over the shards, to the
   folds of the four slices; (c) sharded_rollout at 4096 envs over 200
   steps from (a)'s mid-game state against rollout(auto_reset="step"), its
   stats against the per-step done sums; ShardedRunner (4 shards on the
   card) over 50 sample / step rounds of 6-turn games, its launches read
   before VecEnv replays its actions (K1-act and K1-sample once a shard a
   round), then against VecEnv, step() returning done after the reset; tests/test_parallel.py's shapes
   (32 envs over 4 shards, 60 steps, chunk 10, 10-turn games: the kernel,
   exact and full-record feed paths; 16 envs over 8 shards for
   sharded_rollout) CUDA against CPU on every field; (d) dryrun_multichip(4)
   and the card count torch sees (where it is above 1, (a)'s check over
   every card, shard by shard); (e) two processes on the card in a gloo
   group (NCCL refuses two ranks on one GPU), each building only its rows
   with vec_reset_distributed, then a short sharded_rollout, each checking
   its rows and the all-reduced stats against one process's run of the
   whole batch.

Every kernel's record carries its bound: the least time the card could
take for the same work, the larger of the bytes it must move over HBM's
3.35 TB/s and the time its instructions need on the units that execute
them, at 1.98 GHz (the clock of the data sheet's peak rates) on every SM:
integer instructions on the SM's 64 int32 lanes, loads and stores on its
32 load/store units, and all of them through its 4 x 32 issue slots,
whichever takes longest. The instructions of K1, K1-null, K2, K3 and P3 are
counted by kind by a profiling build run on the timed inputs
(eldorado_tpu_torch/tools/inst_count.py: PTX instructions per thread;
phase 5 sets K1's static SASS count beside its PTX count); K3's and K2's
are their work, the same per-env code run one thread per env
(count_k3_work, count_k2_work), not the copies of the scalar chain in the
other lanes of each warp, whose sums phase 5 prints beside them; K2's
bytes are those an in-place reset must move (the words it reads and
writes, and its inputs), and phase 5 prints beside its ratio the one to
each column in and out, the bytes its first design moved; P1 does no
arithmetic; P2's are its k ops per
element. P1 and K1-null are timed
with the L2 evicted before each launch, so that their bytes come from
HBM as their bound assumes. For P1 it also times one PyTorch call that
computes the same function (``dst.copy_(src)``), the same way; no single
call computes the others. P2's bound is the longer of its instructions'
time through the schedulers and its chain of k dependent ops at the
latency measured in phase 6.

The line before last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Nothing here imports jax.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_MAIN, CHUNK, N_CHUNKS = 4096, 1500, 3
WIN_WINDOW = 200   # phase 5: K1 against plain over this many main-path steps
FEED_N, FEED_STEPS, FEED_CHUNK = 128, 400, 100   # phase 7b
PREFIX_STEPS = 8   # phase 6: P3 against plain over this many steps
OP_K = 4096        # phase 6: P2's chain length
WIDE = (8192, 16384)   # phase 5: K1's ms per step at these env counts
Q = 128            # phases 1, 2 and 5: the reset queue's width
K2_WIDTHS = (1, 8, 31, 33, 128, 4096, 4097)   # phase 2: K2 against plain
K2_BATCH = 4100    # phase 2: the batch K2 resets those widths of in place
K2_TIMED = (1, 8, 128)   # phase 5: K2 in place at these queue widths
ACT_STEPS = 8      # phase 8a: K1-act and K1-sample against plain
ACT_WIDTHS = (1, 4096, 4097, 16384)   # phase 8a: K1-act's staging paths
VEC_N, VEC_STEPS, VEC_TURNS = 512, 200, 20   # phase 8c: VecEnv, CPU vs CUDA
ROLL_N, ROLL_STEPS, ROLL_TURNS = 256, 60, 10   # phase 8d: rollouts
RATE_STEPS = 200   # phase 8e: VecEnv's sample-then-step rate
MIXED_N = 512      # phase 1: the mixed batch
COMPAT_STEPS = 2000   # phase 9a: cog_env against the reference, per set
WIN_STEPS = 4600   # phase 9a: seed 21 played to its win (4438 steps)
CVEC_CHECK_N, CVEC_CHECK_STEPS = 256, 30   # phase 9b: CUDA against CPU
CVEC_STEPS = 100   # phase 9b: compat.vec's and the runner's rates
ASYNC_N, ASYNC_STEPS, ASYNC_CHUNK = 512, 400, 100   # phase 10a
SHARDS = 4         # phase 11b: shards of the main path on one card
SR_STEPS = 200     # phase 11c: sharded_rollout at the main path's width
RUNNER_ROUNDS, RUNNER_TURNS = 50, 6   # phase 11c: ShardedRunner, VecEnv
# phase 11c: tests/test_parallel.py's shapes (N envs over 4 shards, steps,
# chunk, max_steps; the lockstep rollout: N over 8 shards, steps)
SMALL = (32, 60, 10, 10)
SMALL_ROLL = (16, 100, 8)
GLOO_N, GLOO_STEPS, GLOO_TURNS = 4096, 50, 6   # phase 11e
# phases 1 and 5: K3's launch shapes (envs per block, pair table in
# shared memory)
K3_SHAPES = tuple((e, o) for o in (False, True) for e in (1, 2, 4))
K3_ROUNDS = 5      # phase 5: turns of timing every K3 shape
HOLD_CYCLES = 50_000_000   # cuda_ms(ahead=True): about 25 ms of spin
GOLDENS = (("mapgen_easy", 3, 0), ("mapgen_medium", 3, 1),
           ("mapgen_hard", 3, 2), ("mapgen_1p", 1, 0), ("mapgen_2p", 3, 0),
           ("mapgen_8p_medium", 8, 1), ("mapgen_10p_hard", 10, 2),
           ("mapgen_throw_easy4", 4, 0))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
CLOCK_HZ = 1.98e9             # the clock of the data sheet's peak rates
# instructions per SM per clock: int32 lanes, load/store units, and the
# issue slots of its 4 schedulers (every kind)
INT_PER_SM, MEM_PER_SM, ISSUE_PER_SM = 64, 32, 128


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def field_diff(a: dict, b: dict):
    """(max |a - b| over every field, names of the fields that differ)."""
    import torch
    worst, bad = 0.0, []
    for f in a:
        x = a[f].double().cpu()
        y = b[f].double().cpu()
        if not torch.equal(a[f].cpu(), b[f].cpu()):
            bad.append(f)
            worst = max(worst, float((x - y).abs().max()))
    return worst, bad


def carry_fields(carry):
    from eldorado_tpu_torch.core import engine as E
    return dict(zip(E.DYN_FIELDS, E.unpack_dyn(carry)))


def expect_equal(tag: str, a: dict, b: dict):
    err, bad = field_diff(a, b)
    if bad:
        fail(f"{tag}: fields differ: {bad} (max abs err {err})")
    return err


MAP_FIELDS = ("map_ids", "min_xy", "map_ok", "map_overflow")


def k3_check(tag: str, st, shapes=(None,)) -> float:
    """K3 with its prelude (one launch) against generate_map_plain and the
    plain prelude, on the engine words and parameters of the states
    ``st``: every lane, every field; in the default launch shape (None)
    and each of ``shapes``. Returns the max abs error (0)."""
    import torch
    from eldorado_tpu_torch.core import engine as E
    from eldorado_tpu_torch.core import mapgen as MG
    ins = (st.rng, st.n_pieces, st.difficulty, st.n_players)

    def fields(gen, xy, ball):
        return dict(ids=gen.ids, min_xy=gen.min_xy,
                    start_xy=gen.player_start_xy,
                    start_no=gen.player_start_no, ok=gen.ok,
                    overflow=gen.overflow, player_xy=xy, req=ball[0],
                    nr=ball[1], end=ball[2])
    want = fields(*E.reset_map_prelude_plain(*ins))
    err = 0.0
    for shape in shapes:
        if shape is None:
            got = fields(*E.reset_map_prelude(*ins))
        else:
            got = {k: torch.empty_like(v) for k, v in want.items()}
            MG.launch(*ins[:3], tuple(got[k] for k in ("ids", "min_xy", "ok",
                                                       "overflow")),
                      starts=(got["start_xy"], got["start_no"]),
                      n_players=ins[3], prelude=tuple(
                          got[k] for k in ("player_xy", "req", "nr", "end")),
                      shape=shape)
        err = max(err, expect_equal(f"{tag}, K3 shape {shape}", got, want))
    ok, over = want["ok"], want["overflow"]
    print(f"{tag.split(' (')[0]}: K3 == plain generator and prelude on "
          f"{tag.split('(')[1][:-1]}: {ok.numel()} envs, every field; "
          f"{int(ok.sum())} maps, {int((~ok & ~over).sum())} aborted, "
          f"{int(over.sum())} overflowed; launch shapes {list(shapes)}")
    return err


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bound(n_bytes: float, ops=None) -> tuple:
    """(the least ms the card could take for work that moves ``n_bytes``
    and executes the instructions ``ops`` counts by kind, "bytes" or
    "operations", whichever sets it)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    ops = ops or {"int": 0, "mem": 0, "other": 0}
    clocks = max(ops["int"] / INT_PER_SM, ops["mem"] / MEM_PER_SM,
                 sum(ops.values()) / ISSUE_PER_SM)
    t_ops = clocks / (sms * CLOCK_HZ) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def per_kind(ops: dict, units: float) -> str:
    """``ops`` (instructions by kind) per unit of work, for a line."""
    return ", ".join(f"{k} {v / units:.0f}" for k, v in ops.items())


def k1_bytes(n: int, steps: int, live: int, words: int = 0) -> int:
    """The bytes one K1 launch must move: each env's carry column in and
    out, srng in and out, its last actions out and its four per-env inputs
    in; the ball cells its live steps read, each map plane at most once;
    and the records out."""
    from eldorado_tpu_torch.core import engine as E
    ball = min(live * E.N_BALL * 4, n * E.GRIDSIZE * E.GRIDSIZE * 4)
    return n * (2 * E.CARRY_WORDS * 4 + 8 + 20 + 16) + ball \
        + steps * n * words * 4


def k2_moved_bytes(n_players, in_place: bool) -> int:
    """The bytes K2's design moves for envs with these player counts: in
    place, the nine words of RESET_READS in and the words the reset writes
    out (57 a column and 98 a live player: csrc/engine.cuh's
    reset_writes); into a new carry, the words it reads or keeps in (five
    of the nine are written) and the whole column out; and the inputs (the
    column index in place, n_players, player_xy and the three ball
    rows)."""
    from eldorado_tpu_torch.core import engine as E
    q = int(n_players.numel())
    written = 57 * q + 98 * int(n_players.sum())
    inputs = q * (4 + 8 * 4 + 3 * 4 * E.N_BALL * 4 + (4 if in_place else 0))
    if in_place:
        return 4 * (9 * q + written) + inputs
    return 4 * ((E.CARRY_WORDS + 5) * q - written + E.CARRY_WORDS * q) \
        + inputs


def k1_bound(c, srng, static, steps: int, dead: int, record=None) -> tuple:
    """K1's bound per step for ``steps`` steps from carry ``c`` (``dead``
    of them dead steps), and its PTX instructions per env-step, in all
    and by kind."""
    from eldorado_tpu_torch.ops import step_kernel as K
    from eldorado_tpu_torch.tools import inst_count as IC
    n = c.shape[1]
    words = 0 if record is None else K.RECORD_WORDS[record]
    ops = IC.count_k1(c, srng, static, steps, record=record)
    ms, by = bound(k1_bytes(n, steps, n * steps - dead, words), ops)
    return (ms / steps, by, sum(ops.values()) / (n * steps),
            per_kind(ops, n * steps))


def cuda_ms(fn, reps: int = 1, ahead: bool = False):
    """Milliseconds per call of the work ``fn`` enqueues, between CUDA
    events around ``reps`` calls. ``ahead``: the card first spins for
    HOLD_CYCLES, so that every call is enqueued before it starts them and
    the time is the device's alone, not the host's between short
    launches."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if ahead:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def main():
    if not (ROOT / "eldorado_tpu_torch").is_dir():
        fail("run from a checkout of the repository (eldorado_tpu_torch/ "
             "not found beside this script)")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the GPU")
    sys.path.insert(0, str(ROOT))
    import eldorado_tpu_torch as et
    from eldorado_tpu_torch.core import engine as E
    from eldorado_tpu_torch.core.cells import expand_obs
    from eldorado_tpu_torch.core import mapgen as MG
    from eldorado_tpu_torch.core.mapgen import generate_map
    from eldorado_tpu_torch.ops import build, rng as R
    from eldorado_tpu_torch.ops import queue as QK
    from eldorado_tpu_torch.ops import step_kernel as K
    from eldorado_tpu_torch import stream as S
    from eldorado_tpu_torch import vec
    from eldorado_tpu_torch.tools import _timing, inst_count as IC, step_cost
    if "jax" in sys.modules:
        fail("jax was imported")
    dev = torch.device("cuda", 0)
    record = {}

    # ---- phase 0: device ----------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"phase 0: device {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi)
    lib = build.load()
    print(f"phase 0: kernels built in {lib.seconds:.1f} s -> {lib.path.name}")
    t_ptx = time.perf_counter()
    IC.build_ptx()
    print(f"phase 0: the profiling build's PTX in "
          f"{time.perf_counter() - t_ptx:.1f} s")
    for line in lib.log.splitlines():
        if line.startswith("== ") or any(
                k in line for k in ("entry function", "registers",
                                    "stack frame")):
            print(f"  ptxas: {line.strip()}")

    # ---- phase 1: K3 against the goldens and its plain version ---------
    k3_before = MG.generate_map.launches
    for gname, n_pieces, diff in GOLDENS:
        d = np.load(ROOT / "tests" / "golden" / f"{gname}.npz")
        gen = generate_map(R.seed(d["seeds"].astype(np.int64), device=dev),
                           n_pieces, diff)
        ok = gen.ok.cpu().numpy().astype(np.uint8)
        good = d["ok"] > 0
        if not np.array_equal(ok, d["ok"]):
            fail(f"phase 1: {gname} ok flags differ")
        obs = expand_obs(gen.ids).cpu().numpy()
        if not np.array_equal(obs[good], d["obs"][good]):
            fail(f"phase 1: {gname} maps differ")
        print(f"phase 1: K3 {gname}: {len(good)} seeds, {int(good.sum())} "
              "maps equal to the golden")
    if MG.generate_map.launches - k3_before != len(GOLDENS):
        fail("phase 1: generate_map did not launch K3 on the card")
    s0 = E.make_state(torch.arange(12345, 12345 + N_MAIN, device=dev),
                      4, 3, 0, 100000)
    err_k3 = k3_check("phase 1 (4096 main-path seeds)", s0)
    seeds, players, pieces, diffs = MG.mixed_batch(MIXED_N)
    mixed = E.make_state(torch.as_tensor(seeds, device=dev), players,
                         pieces, diffs, 100)
    err_k3 = max(err_k3, k3_check("phase 1 (mixed batch)", mixed,
                                  (None,) + K3_SHAPES))
    # the 128-env reset queue: every 32nd env of the main path 200 steps
    # after its reset, K3 writing its rows of (copies of) the batch's maps
    states = et.vec_reset(12345, N_MAIN, 4, 3, 0, 100000, device=dev)
    srng = et.sampler_init(42, N_MAIN, device=dev)
    stepped, _, _ = K.fused_step(E.pack_dyn(E.split_state(states)[1]), srng,
                                 states.map_ids, states.min_xy,
                                 states.n_players, states.max_steps, 200)
    q_states = states
    idx = torch.arange(0, N_MAIN, N_MAIN // Q, device=dev, dtype=torch.int32)
    rows = idx.long()
    rng_row = [off for f, _, _, off, _ in E.DYN_LAYOUT if f == "rng"][0]
    q_in = (stepped[rng_row], states.n_pieces, states.difficulty,
            states.n_players, idx)
    outs = []
    for fn in (E.reset_map_prelude_rows, E.reset_map_prelude_rows_plain):
        maps = [getattr(states, f).clone() for f in MAP_FIELDS]
        xy, ball = fn(*q_in, maps)
        outs.append((maps, dict(zip(("player_xy", "req", "nr", "end"),
                                    (xy,) + ball))))
    (k3_maps, k3_pre), (plain_maps, plain_pre) = outs
    keep = torch.ones(N_MAIN, dtype=torch.bool, device=dev)
    keep[rows] = False
    for f, a, b in zip(MAP_FIELDS, k3_maps, plain_maps):
        if not torch.equal(a[keep], getattr(states, f)[keep]):
            fail(f"phase 1: K3 wrote {f} outside the queue's rows")
    err_k3 = max(err_k3, expect_equal(
        "phase 1 (128-env queue)",
        dict(k3_pre, **{f: m[rows] for f, m in zip(MAP_FIELDS, k3_maps)}),
        dict(plain_pre, **{f: m[rows] for f, m in zip(MAP_FIELDS,
                                                      plain_maps)})))
    print(f"phase 1: K3 == plain on a {Q}-env queue of mid-game envs: every "
          "field of its batch rows, no other row touched")
    qxy, qball = k3_pre["player_xy"], tuple(k3_pre[k] for k in
                                            ("req", "nr", "end"))

    # ---- phase 2: K2 against its plain version ------------------------
    carry0 = E.pack_dyn(E.split_state(s0)[1])
    gen, pxy, (req, nr, end) = E.reset_map_prelude(
        s0.rng, s0.n_pieces, s0.difficulty, s0.n_players)
    k2 = K.fused_reset(carry0, s0.n_players, pxy, req, nr, end)
    plain = K.fused_reset_plain(carry0, s0.n_players, pxy, req, nr, end)
    err_k2 = expect_equal("phase 2 (4096)", carry_fields(k2),
                          carry_fields(plain))
    expect_equal("phase 2 (vec_reset)", carry_fields(k2), {
        f: getattr(states, f) for f in E.DYN_FIELDS})
    print(f"phase 2: K2 == plain reset_body on all {len(E.DYN_FIELDS)} "
          f"fields at {N_MAIN} envs; vec_reset went through K2")
    # in place on the queue's columns of the mid-game batch carry
    q_args = (states.n_players, qxy, *qball)
    got = K.fused_reset(stepped.clone(), *q_args, idx=idx)
    want = K.fused_reset_plain(stepped.clone(), *q_args, idx=idx)
    err_k2 = max(err_k2, expect_equal("phase 2 (Q=128, in place)",
                                      carry_fields(got), carry_fields(want)))
    if not torch.equal(got[:, keep], stepped[:, keep]):
        fail("phase 2: K2 wrote columns outside the queue")
    print(f"phase 2: K2 in place == gather + plain reset_body + scatter on "
          f"a {Q}-env queue of the mid-game batch carry; no other column "
          "touched")
    # every width, in place (unsorted columns of a 4100-env mid-game batch)
    # and into a new carry (those columns)
    wide = torch.cat([stepped, stepped[:, :K2_BATCH - N_MAIN]], 1)
    w_static = {f: torch.cat([getattr(states, f),
                              getattr(states, f)[:K2_BATCH - N_MAIN]])
                for f in ("n_players", "n_pieces", "difficulty")}
    order = torch.randperm(K2_BATCH, generator=torch.Generator().manual_seed(
        13)).to(dev)
    for q in K2_WIDTHS:
        cols = order[:q]
        q_idx = cols.to(torch.int32)
        _, w_xy, w_ball = E.reset_map_prelude(
            wide[0][cols], *(w_static[f][cols] for f in
                             ("n_pieces", "difficulty", "n_players")))
        w_args = (w_static["n_players"], w_xy, *w_ball)
        got = K.fused_reset(wide.clone(), *w_args, idx=q_idx)
        want = K.fused_reset_plain(wide.clone(), *w_args, idx=q_idx)
        err_k2 = max(err_k2, expect_equal(f"phase 2 (q={q}, in place)",
                                          carry_fields(got),
                                          carry_fields(want)))
        out = torch.ones(K2_BATCH, dtype=torch.bool, device=dev)
        out[cols] = False
        if not torch.equal(got[:, out], wide[:, out]):
            fail(f"phase 2: K2 (q={q}) wrote columns outside the queue")
        new_args = (wide[:, cols].contiguous(), w_static["n_players"][cols],
                    w_xy, *w_ball)
        err_k2 = max(err_k2, expect_equal(
            f"phase 2 (q={q}, new carry)",
            carry_fields(K.fused_reset(*new_args)),
            carry_fields(K.fused_reset_plain(*new_args))))
    print(f"phase 2: K2 == plain at q = {list(K2_WIDTHS)}, in place on "
          f"unsorted columns of a {K2_BATCH}-env mid-game batch (no other "
          "column touched) and into a new carry from those columns")

    # ---- phase 3: K1 against its plain version ------------------------
    n3 = 1024
    st3 = {f: getattr(states, f)[:n3].contiguous()
           for f in ("map_ids", "min_xy", "n_players", "max_steps")}
    c3 = k2[:, :n3].contiguous()
    r3 = srng[:n3].contiguous()
    err_k1 = 0.0
    # phase 7a: (what, K1's inputs, K1's outputs, the plain full records)
    feed_checks = []
    for mask_src, gate in (("storage", False), ("sel", False),
                           ("storage", True)):
        c_in = c3.clone()
        if gate:   # a done env at entry dead-steps; every 7th one here
            done_row = [off for f, _, _, off, _ in E.DYN_LAYOUT
                        if f == "done"][0]
            c_in[done_row, ::7] = 1
        inputs = (c_in, r3, st3["map_ids"], st3["min_xy"],
                  st3["n_players"], st3["max_steps"], 64, mask_src, gate)
        plain_rec = torch.empty((64, n3, S.RECORD_WORDS_FULL),
                                dtype=torch.int32, device=dev)
        outs = []
        for fn, kw in ((K.fused_step, {}),
                       (K.fused_step_plain,
                        dict(record="full", records=plain_rec))):
            dead = torch.zeros(1, dtype=torch.int64, device=dev)
            c, r, a = fn(*inputs, dead, **kw)
            outs.append(dict(carry_fields(c), srng=r, actions=a, dead=dead))
        feed_checks.append((f"{n3} envs x 64 steps, mask {mask_src}, "
                            f"gate_dead={gate}", inputs, outs[0], plain_rec))
        err_k1 = max(err_k1, expect_equal(
            f"phase 3 ({mask_src}, gate_dead={gate})", outs[0], outs[1]))
        print(f"phase 3: K1 == plain step, {n3} envs x 64 steps, "
              f"mask {mask_src}, gate_dead={gate}: every field, srng, "
              f"actions, dead steps {int(outs[0]['dead'])}")

    # ---- phase 4: the slice, CUDA against CPU -------------------------
    res = {}
    for d in (dev, torch.device("cpu")):
        before = K.fused_reset.launches, MG.generate_map.launches
        s = et.vec_reset(7, 512, 4, 3, 0, 60, device=d)
        out = et.rollout_chunked(s, et.sampler_init(8, 512, device=d),
                                 400, 100)
        res[d.type] = (out, K.fused_reset.launches - before[0],
                       MG.generate_map.launches - before[1])
    (s_gpu, r_gpu, ep_gpu), k2_gpu, k3_gpu = res["cuda"]
    (s_cpu, r_cpu, ep_cpu), k2_cpu, k3_cpu = res["cpu"]
    expect_equal("phase 4", dict({f: getattr(s_gpu, f) for f in E.FIELDS},
                                 srng=r_gpu),
                 dict({f: getattr(s_cpu, f) for f in E.FIELDS}, srng=r_cpu))
    if ep_gpu != ep_cpu or ep_gpu <= 0:
        fail(f"phase 4: episodes {ep_gpu} (cuda) vs {ep_cpu} (cpu)")
    if k2_gpu <= 0 or k2_cpu != 0 or k3_gpu != k2_gpu or k3_cpu != 0:
        fail(f"phase 4: K2 / K3 launches {k2_gpu} / {k3_gpu} (cuda run), "
             f"{k2_cpu} / {k3_cpu} (cpu)")
    print(f"phase 4: rollout_chunked 512 envs x 400 steps, CUDA == CPU on "
          f"every field and srng; episodes {ep_gpu}; K2 and K3 launches "
          f"{k2_gpu}")
    # the card path against the oracle trajectory goldens, full length
    sys.path.insert(0, str(ROOT / "tests"))
    import traj_replay as TR
    before = (K.fused_step.launches, MG.generate_map.launches,
              K.fused_reset.launches)
    t_gold = time.perf_counter()
    resets = 0
    for mask_src in (0, 1):
        names = [n for n in TR.NAMES if TR.probe_params(n)[0] == mask_src]
        ds = {n: TR.load(n) for n in names}
        steps = max(TR.header(d)[-1] for d in ds.values())
        for gname, traj in zip(names, TR.replay(names, steps, dev)):
            try:
                TR.check(gname, ds[gname], traj, TR.header(ds[gname])[-1])
            except AssertionError as exc:
                fail(f"phase 4: {exc}")
            resets += len(traj.maps) - 1
    gold = [a - b for a, b in zip((K.fused_step.launches,
                                   MG.generate_map.launches,
                                   K.fused_reset.launches), before)]
    if min(gold) <= 0:
        fail(f"phase 4: the golden replay launched K1, K3, K2 {gold} times")
    print(f"phase 4: the card path == the {len(TR.NAMES)} oracle trajectory "
          f"goldens at full length (every compared field of every step, "
          f"{resets} reset maps; traj_win_storage's 20000 steps with two won "
          f"games), {time.perf_counter() - t_gold:.1f} s; launches K1, K3, "
          f"K2 {gold}")

    # ---- phase 5: the main path at full size --------------------------
    K.fused_step.launches = 0
    K.fused_reset.launches = 0
    MG.generate_map.launches = 0
    QK.select.launches = QK.settle.launches = 0
    MG.generate_map_plain.cuda_trips = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = et.vec_reset(12345, N_MAIN, 4, 3, 0, 100000, device=dev)
    srng = et.sampler_init(42, N_MAIN, device=dev)
    states, srng, ep_warm = et.rollout_chunked(states, srng, CHUNK, CHUNK)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    k3_t1 = MG.generate_map.launches
    states, srng, episodes = et.rollout_chunked(states, srng,
                                                CHUNK * N_CHUNKS, CHUNK)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"K1": K.fused_step.launches, "K2": K.fused_reset.launches,
                "K3": MG.generate_map.launches, "select": QK.select.launches,
                "settle": QK.settle.launches}
    queues = launches["K3"] - k3_t1   # reset queues in the timed run
    if min(launches.values()) <= 0:
        fail(f"phase 5: a kernel of the main path did not launch: {launches}")
    if MG.generate_map_plain.cuda_trips:
        fail(f"phase 5: the plain generator ran "
             f"{MG.generate_map_plain.cuda_trips} trips on the card")
    rate = N_MAIN * CHUNK * N_CHUNKS / (t2 - t1)
    for f in ("rewards", "resources", "info_returns"):
        if not bool(torch.isfinite(getattr(states, f)).all()):
            fail(f"phase 5: non-finite {f}")
    if bool(states.rng_tainted.any()):
        fail("phase 5: the fast RNG path deviated from the exact stream")
    print(f"phase 5: main path {N_MAIN} envs, {N_CHUNKS} x {CHUNK} steps: "
          f"{rate:.0f} env-steps/s ({t2 - t1:.3f} s; reset + warm-up chunk "
          f"{t1 - t0:.3f} s); episodes {episodes} (+{ep_warm} in warm-up); "
          f"launches K1 {launches['K1']}, K2 {launches['K2']}, K3 "
          f"{launches['K3']} ({queues} reset queues in the timed run); the "
          "plain generator ran no trip")
    t3 = time.perf_counter()
    _, _, ep_x, dead_x = et.rollout_chunked(states, srng, CHUNK * N_CHUNKS,
                                            CHUNK, exact=True)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    live = N_MAIN * CHUNK * N_CHUNKS - dead_x
    print(f"phase 5: exact=True: {live / (t4 - t3):.0f} live env-steps/s, "
          f"episodes {ep_x}, dead steps {dead_x}")

    # K1 against its plain version at the main path's shapes: the 4096-env
    # mid-game carry the timed run left, a window in which games end by a
    # win (the has_won / n_winners / rewards branch); then the kernel times
    c = E.pack_dyn(E.split_state(states)[1])
    args = (c, srng, states.map_ids, states.min_xy, states.n_players,
            states.max_steps)
    if bool(states.done.any()):
        fail("phase 5: the window starts with done envs")
    # the plain run also writes the window's full records (phase 7a), so
    # its time includes packing them
    win_rec = torch.empty((WIN_WINDOW, N_MAIN, S.RECORD_WORDS_FULL),
                          dtype=torch.int32, device=dev)
    outs = []
    for fn, kw in ((K.fused_step, {}),
                   (K.fused_step_plain, dict(record="full",
                                             records=win_rec))):
        dead = torch.zeros(1, dtype=torch.int64, device=dev)
        ms, (c_out, r_out, a_out) = cuda_ms(
            lambda: fn(*args, WIN_WINDOW, "storage", False, dead, **kw))
        outs.append((ms, dict(carry_fields(c_out), srng=r_out, actions=a_out,
                              dead=dead)))
    (_, k1_out), (ms_plain_window, plain_out) = outs
    feed_checks.append((f"{N_MAIN} envs x {WIN_WINDOW} steps from the main "
                        "path's carry", args + (WIN_WINDOW, "storage", False),
                        k1_out, win_rec))
    plain1 = ms_plain_window / WIN_WINDOW   # plain step, ms per step
    err_k1 = max(err_k1, expect_equal("phase 5 (K1, main-path window)",
                                      k1_out, plain_out))
    wins = int((k1_out["done"] & k1_out["has_won"].any(dim=1)).sum())
    if wins <= 0:
        fail(f"phase 5: no game ended by a win in the {WIN_WINDOW}-step "
             "window; the win branch went unchecked")
    print(f"phase 5: K1 == plain step, {N_MAIN} envs x {WIN_WINDOW} steps "
          f"from the main path's carry: every field, srng, actions, dead "
          f"steps {int(k1_out['dead'])}; {wins} games ended by a win")
    dead_t = torch.zeros(1, dtype=torch.int64, device=dev)
    ms_k1, _ = cuda_ms(lambda: K.fused_step(*args, CHUNK, "storage", False,
                                            dead_t))
    # the reset queue of phases 1-2: K3 into copies of the batch's maps,
    # K2 in place on a copy of the carry, each repeated on the same
    # inputs; their plain versions once; the whole queued reset
    # (vec._reset_columns) with a synchronize after it, as the learner's
    # round runs it (a chunk boundary runs select, K3, K2 and settle and
    # reads nothing)
    k3_maps = [getattr(q_states, f).clone() for f in MAP_FIELDS]
    q_carry = stepped.clone()
    ms_k3, _ = cuda_ms(lambda: E.reset_map_prelude_rows(*q_in, k3_maps),
                       reps=20, ahead=True)
    ms_plain3, _ = cuda_ms(lambda: E.reset_map_prelude_rows_plain(
        *q_in, k3_maps))
    ms_k2, _ = cuda_ms(lambda: K.fused_reset(q_carry, *q_args, idx=idx),
                       reps=20, ahead=True)
    # K2 in place at every timed width on the same mid-game carry, each
    # beside an empty kernel on its grid (its launch floor)
    k2_widths = {}
    for q in K2_TIMED:
        q_idx = torch.arange(0, N_MAIN, N_MAIN // q, device=dev,
                             dtype=torch.int32)
        rows_q = q_idx.long()
        _, t_xy, t_ball = E.reset_map_prelude(
            stepped[0][rows_q], q_states.n_pieces[rows_q],
            q_states.difficulty[rows_q], q_states.n_players[rows_q])
        t_carry = stepped.clone()
        ms_q, _ = cuda_ms(lambda: K.fused_reset(
            t_carry, q_states.n_players, t_xy, *t_ball, idx=q_idx), reps=20,
            ahead=True)
        K.launch_empty(32 * q, dev)   # loads it
        floor_q, _ = cuda_ms(lambda: K.launch_empty(32 * q, dev), reps=20,
                             ahead=True)
        k2_widths[q] = (ms_q, floor_q)
    ms_plain2, _ = cuda_ms(lambda: K.fused_reset_plain(q_carry, *q_args,
                                                       idx=idx), reps=2)
    # the chunk loop's queue kernels (csrc/queue.cu) at the main path's
    # capacity: select over a done row with 3% of the envs done (a
    # short-game boundary's ~107), against its plain version, timed beside
    # an empty one-block kernel; settle on the queue it took, below
    sel_done = (torch.rand(N_MAIN, generator=torch.Generator().manual_seed(
        5)) < 0.03).to(torch.int32)
    sel = [(torch.empty(Q, dtype=torch.int32, device=d),
            torch.empty(1, dtype=torch.int32, device=d))
           for d in (dev, torch.device("cpu"))]
    QK.select(sel_done.to(dev), None, *sel[0])
    QK.select(sel_done, None, *sel[1])
    if not all(torch.equal(a.cpu(), b) for a, b in zip(*sel)):
        fail("phase 5: select != its plain version")
    sel_done = sel_done.to(dev)
    ms_sel, _ = cuda_ms(lambda: QK.select(sel_done, None, *sel[0]), reps=20,
                        ahead=True)
    floor_block, _ = cuda_ms(lambda: K.launch_empty(1024, dev, 1024),
                             reps=20, ahead=True)
    sel_k = int(sel[1][1])
    # plain versions on card tensors, into buffers of their own
    sel_plain = tuple(torch.empty_like(t) for t in sel[0])
    ms_plain_sel, _ = cuda_ms(lambda: QK.select_plain(sel_done, None,
                                                      *sel_plain), reps=2)
    # the chunk loop's boundary on that queue, as `vec._ChunkLoop._reset`
    # runs it: K3 and K2 launched at the capacity with its device count, K3
    # writing each slot's trips and retries to a work buffer (the loop's
    # checks, then its raw launches), against their plain versions given
    # the count; then settle with K3's counters on the card against
    # settle_plain on CPU copies, with a map failure and an overflow
    # planted among the queued rows and envs in flight beside the queue, so
    # that the tally's failed and overflow bits set
    q_idx, q_count = sel[0]
    q_rows = q_idx[:sel_k].long()
    np_ = q_states.n_players
    outs = []
    for plain in (False, True):
        b_carry = stepped.clone()
        b_maps = [getattr(q_states, f).clone() for f in MAP_FIELDS]
        b_pre = E._prelude_out(Q, dev)
        # slots past the count keep the fill: neither writes them
        b_work = torch.full((Q, 2), -7, dtype=torch.int32, device=dev)
        k3 = (b_carry[rng_row], q_states.n_pieces, q_states.difficulty)
        if plain:
            E.reset_map_prelude_rows_plain(*k3, np_, q_idx, b_maps, q_count,
                                           b_pre, b_work)
            K.fused_reset_plain(b_carry, np_, *b_pre, q_idx, q_count)
        else:
            MG.check_launch(*k3, b_maps, q_idx, n_players=np_, prelude=b_pre,
                            count=q_count, work=b_work)
            K.check_fused_reset(b_carry, np_, *b_pre, q_idx, q_count)
            MG.launch_generate_map(*k3, b_maps, q_idx, n_players=np_,
                                   prelude=b_pre, count=q_count, work=b_work)
            K.launch_fused_reset(b_carry, b_carry, np_, *b_pre, q_idx,
                                 q_count)
        outs.append(dict(carry_fields(b_carry), **dict(zip(MAP_FIELDS,
                                                           b_maps)),
                         **{k: t[:sel_k] for k, t in zip(
                             ("player_xy", "req", "nr", "end"), b_pre)},
                         work=b_work))
    err_count = expect_equal("phase 5 (K3 and K2 with a device count)",
                             *outs)
    q_work = outs[0]["work"]
    if int((q_work[:sel_k] < 0).sum()) or int((q_work[sel_k:] != -7).sum()):
        fail("phase 5: K3's work buffer was not written at the counted "
             "slots alone")
    err_k3, err_k2 = max(err_k3, err_count), max(err_k2, err_count)
    s_ok, s_over = outs[0]["map_ok"].clone(), outs[0]["map_overflow"].clone()
    s_ok[q_rows[sel_k // 3]] = False
    s_over[q_rows[2 * sel_k // 3]] = True
    s_fl = torch.zeros(N_MAIN, dtype=torch.bool, device=dev)
    s_fl[::97] = True
    s_fl[q_rows] = True
    s_tally = torch.tensor([1000, 0, 0], dtype=torch.int64, device=dev)
    s_sums = torch.tensor([500, 900], dtype=torch.int64, device=dev)
    settled = [s_ok, s_over, s_fl, s_tally, s_sums]
    want = [t.to("cpu", copy=True) for t in settled]
    QK.settle(q_idx, q_count, *settled[:4], (q_work, s_sums))
    QK.settle_plain(q_idx.cpu(), q_count.cpu(), *want[:4],
                    (q_work.cpu(), want[4]))
    if not all(torch.equal(a.cpu(), b) for a, b in zip(settled, want)):
        fail("phase 5: settle != its plain version on the planted queue")
    if want[3].tolist() != [1000 + sel_k, 1, 1]:
        fail(f"phase 5: the planted failure and overflow gave the tally "
             f"{want[3].tolist()}")
    q_trips = q_work[:sel_k, 0].long().cpu()
    if want[4].tolist() != [500 + int(q_trips.sum()),
                            900 + sel_k * int(q_trips.max())]:
        fail(f"phase 5: settle's sums {want[4].tolist()} are not the "
             "queue's trips and count x most trips")
    # settle timed as the loop launches it, with K3's counters
    sel_flags = (q_states.map_ok.clone(), q_states.map_overflow.clone())
    sel_tally = torch.zeros(3, dtype=torch.int64, device=dev)
    sel_sums = torch.zeros(2, dtype=torch.int64, device=dev)
    ms_settle, _ = cuda_ms(lambda: QK.settle(
        q_idx, q_count, *sel_flags, None, sel_tally, (q_work, sel_sums)),
        reps=20, ahead=True)
    ms_plain_settle, _ = cuda_ms(lambda: QK.settle_plain(
        q_idx, q_count, *(t.clone() for t in sel_flags), None,
        sel_tally.clone(), (q_work, sel_sums.clone())), reps=2)
    print(f"phase 5: the chunk loop's boundary at {N_MAIN} envs, capacity "
          f"{Q}, {sel_k} envs queued: K3 and K2 with the device count == "
          "their plain versions given it (every carry field, the maps, the "
          "prelude); settle == plain with a map failure and an overflow "
          "planted (the flags, the in-flight mask, the tally "
          f"{want[3].tolist()}); K3's trips and retries == plain's, "
          f"settle's sums of them {want[4].tolist()} == plain's)")
    # a sparse boundary: K3 and K2 at the capacity with a device count of
    # k, beside the launches sized to the k envs (the old boundary's)
    sparse = {}
    for k in K2_TIMED:
        sp_idx = torch.full((Q,), N_MAIN, dtype=torch.int32, device=dev)
        sp_idx[:k] = torch.arange(0, N_MAIN, N_MAIN // k, device=dev,
                                  dtype=torch.int32)
        sp_count = torch.tensor([k], dtype=torch.int32, device=dev)
        sp_maps = [getattr(q_states, f).clone() for f in MAP_FIELDS]
        sp_carry = stepped.clone()
        k3 = (sp_carry[rng_row], q_states.n_pieces, q_states.difficulty,
              sp_maps)
        pre_k, pre_cap = E._prelude_out(k, dev), E._prelude_out(Q, dev)
        runs = {
            "k3": lambda: MG.launch_generate_map(
                *k3, sp_idx[:k], n_players=np_, prelude=pre_k),
            "k3_count": lambda: MG.launch_generate_map(
                *k3, sp_idx, n_players=np_, prelude=pre_cap, count=sp_count),
            "k2": lambda: K.launch_fused_reset(
                sp_carry, sp_carry, np_, *pre_k, sp_idx[:k]),
            "k2_count": lambda: K.launch_fused_reset(
                sp_carry, sp_carry, np_, *pre_cap, sp_idx, sp_count)}
        sparse[k] = {name: cuda_ms(fn, reps=20, ahead=True)[0]
                     for name, fn in runs.items()}
    for k, t in sparse.items():
        print(f"phase 5: a boundary of {k} envs: K3 {t['k3']:.4f} ms sized "
              f"to it, {t['k3_count']:.4f} ms at capacity {Q} with the "
              f"device count; K2 {t['k2']:.4f} / {t['k2_count']:.4f} ms")
    bound_sel, by_sel = bound(4 * N_MAIN + 4 * (Q + 1))
    # a queued env's index, flags and trips, the count, the tally and the
    # sums read and written
    bound_settle, by_settle = bound(12 * sel_k + 4 + 48 + 32)
    print(f"phase 5: the queue kernels at {N_MAIN} envs, capacity {Q}: "
          f"select {ms_sel:.4f} ms ({sel_k} envs taken; bound "
          f"{bound_sel:.6f} ms, {by_sel}), settle {ms_settle:.4f} ms (bound "
          f"{bound_settle:.6f} ms, {by_settle}); an empty one-block kernel "
          f"{floor_block:.4f} ms; their plain versions {ms_plain_sel:.4f} "
          f"and {ms_plain_settle:.4f} ms")
    queue_ms = []
    for _ in range(5):
        qc = stepped.clone()
        qs = {f: getattr(q_states, f).clone() for f in E.STATIC_FIELDS}
        torch.cuda.synchronize()
        tq = time.perf_counter()
        vec._reset_columns(qc, qs, idx)
        torch.cuda.synchronize()
        queue_ms.append((time.perf_counter() - tq) * 1e3)
    queue_ms = sorted(queue_ms)[len(queue_ms) // 2]
    print(f"phase 5: K1 {ms_k1 / CHUNK:.5f} ms/step ({ms_k1:.2f} ms per "
          f"{CHUNK}-step launch; recorded before: 0.00791); plain step "
          f"{plain1:.2f} ms/step, {N_MAIN} envs")
    print(f"phase 5: {Q}-env reset queue: K3 {ms_k3:.4f} ms (plain "
          f"generator + prelude {ms_plain3:.2f} ms); K2 in place "
          f"{ms_k2:.4f} ms (plain {ms_plain2:.2f} ms); the whole queued "
          f"reset {queue_ms:.4f} ms (median of 5), of which the rest "
          f"{queue_ms - ms_k3 - ms_k2:.4f} ms")
    k1_share = N_CHUNKS * ms_k1 / 1e3 / (t2 - t1)
    reset_s = (t2 - t1) - N_CHUNKS * ms_k1 / 1e3
    # the boundaries read nothing, so their host work overlaps K1: the
    # wall less K1's launches (timed alone, on another carry) is what the
    # queues add, and reads a little below 0 where that is within K1's
    # own spread
    print(f"phase 5: main path {rate:.0f} env-steps/s; K1 launches are "
          f"{100 * k1_share:.1f}% of it; the rest, {reset_s * 1e3:.2f} ms, "
          f"is what the chunk loop and its {queues} reset queues add "
          f"({reset_s * 1e3 / max(queues, 1):.3f} ms each)")
    # the bounds, on the timed launches' own inputs
    bound_k1, by_k1, ips, kinds = k1_bound(c, srng, args[2:], CHUNK,
                                           int(dead_t))
    print(f"phase 5: K1 bound {bound_k1:.6f} ms/step ({by_k1}; {ips:.0f} "
          f"PTX instructions per env-step: {kinds}; {int(dead_t)} dead "
          f"steps in the launch): K1 takes "
          f"{ms_k1 / CHUNK / bound_k1:.1f}x its bound")
    k1_entry = IC.K1_ENTRY.format(null=0, rec=0)
    sass = IC.sass_counts(k1_entry)
    ptx = IC.counter(IC.K1_SOURCE[0], k1_entry).static
    print("phase 5: K1's static instructions, SASS / PTX: all "
          f"{sum(sass.values())} / {sum(ptx.values())} = "
          f"{sum(sass.values()) / sum(ptx.values()):.3f}; " + ", ".join(
              f"{k} {sass[k]} / {ptx[k]}" for k in IC.KINDS))
    # K2 in place reads the nine words of each queued column it reads and
    # writes the words it writes, and reads its idx, n_players and K3's
    # queue outputs (k2_moved_bytes); K3 reads idx, the engine word and
    # three parameters per env and the pair table, and writes the map
    # row, min_xy, the two flags and the queue outputs
    queue_out = 8 * 4 + 3 * 4 * E.N_BALL * 4
    ops_k2 = IC.count_k2_work(stepped, *q_args, idx=idx)
    ops_k2_warp = IC.count_k2(stepped, *q_args, idx=idx)
    moved_k2 = k2_moved_bytes(q_states.n_players[idx.long()],
                              in_place=True)
    bound_k2, by_k2 = bound(moved_k2, ops_k2)
    # the bytes bound of PR 6-11's records: each column in and out
    columns_k2 = Q * (2 * E.CARRY_WORDS * 4 + 8 + queue_out)
    ops_k3 = IC.count_k3_work(*q_in)
    ops_k3_warp = IC.count_k3(*q_in)
    bound_k3, by_k3 = bound(
        Q * (5 * 4 + E.GRIDSIZE ** 2 * 4 + 8 + 2 + queue_out)
        + MG._K(dev).ovl.numel() * 4, ops_k3)
    print(f"phase 5: K2 bound {bound_k2:.6f} ms per {Q}-env queue "
          f"({by_k2}; its work {sum(ops_k2.values()) / Q:.0f} PTX "
          f"instructions per env, one thread per env: {per_kind(ops_k2, Q)};"
          f" K2's warps execute {sum(ops_k2_warp.values()) / Q:.0f} per env "
          f"over their 32 lanes: {per_kind(ops_k2_warp, Q)}; {moved_k2} "
          f"bytes): K2 takes {ms_k2 / bound_k2:.1f}x its bound; against "
          f"the bound of each column in and out, {columns_k2} bytes, "
          f"{bound(columns_k2, ops_k2)[0]:.6f} ms, as PRs 6-11 recorded "
          f"it: {ms_k2 / bound(columns_k2, ops_k2)[0]:.1f}x")
    for q, (ms_q, floor_q) in k2_widths.items():
        print(f"phase 5: K2 in place, {q}-env queue of the mid-game carry: "
              f"{ms_q:.4f} ms, launch floor (an empty kernel on its grid) "
              f"{floor_q:.4f} ms")
    # the same kernels at the reset's full width (vec_reset: 4096 envs)
    ms_k3_full, _ = cuda_ms(lambda: E.reset_map_prelude(
        s0.rng, s0.n_pieces, s0.difficulty, s0.n_players), reps=5,
        ahead=True)
    ms_k2_full, _ = cuda_ms(lambda: K.fused_reset(
        carry0, s0.n_players, pxy, req, nr, end), reps=20, ahead=True)
    floor_full, _ = cuda_ms(lambda: K.launch_empty(
        32 * N_MAIN, dev, 32 * K.RESET_ENVS), reps=20, ahead=True)
    print(f"phase 5: at {N_MAIN} envs (vec_reset): K3 {ms_k3_full:.4f} ms, "
          f"K2 into a new carry {ms_k2_full:.4f} ms per launch (launch floor "
          f"{floor_full:.4f} ms; the design moves "
          f"{k2_moved_bytes(s0.n_players, in_place=False)} bytes, each column "
          f"in and out {N_MAIN * 2 * E.CARRY_WORDS * 4})")
    print(f"phase 5: K3 bound {bound_k3:.6f} ms per {Q}-env queue "
          f"({by_k3}; its work {sum(ops_k3.values()) / Q:.0f} PTX "
          f"instructions per env, one thread per env: {per_kind(ops_k3, Q)};"
          f" K3's warps execute {sum(ops_k3_warp.values()) / Q:.0f} per env "
          f"over their 32 lanes: {per_kind(ops_k3_warp, Q)}): K3 takes "
          f"{ms_k3 / bound_k3:.1f}x its bound")
    # K3's launch shapes: the default's, then every shape's time on the
    # queue and at full width, the pair table through L1 and in shared
    # memory
    for n_envs in (Q, N_MAIN):
        shape = MG.launch_shape(n_envs)
        print(f"phase 5: K3 launch at {n_envs} envs: {shape['blocks']} "
              f"blocks of {shape['envs_per_block']} warps (one per env), "
              f"{shape['smem_bytes']} B of shared memory per block, "
              f"{shape['blocks_per_sm']} blocks resident per SM, pair table "
              f"in {'shared memory' if shape['ovl_shared'] else 'L1'}")
    q_out, full_out = E._prelude_out(Q, dev), E._prelude_out(N_MAIN, dev)
    k3_full_maps = [getattr(s0, f).clone() for f in MAP_FIELDS]
    shape_ms = {shape: ([], []) for shape in K3_SHAPES}
    for _ in range(K3_ROUNDS):   # the shapes in turn, K3_ROUNDS times
        for shape in K3_SHAPES:
            ms_q, _ = cuda_ms(lambda: MG.launch(
                q_in[0], *q_in[1:3], k3_maps, idx=idx, n_players=q_in[3],
                prelude=q_out, shape=shape), reps=20, ahead=True)
            ms_f, _ = cuda_ms(lambda: MG.launch(
                s0.rng, s0.n_pieces, s0.difficulty, k3_full_maps,
                n_players=s0.n_players, prelude=full_out, shape=shape),
                reps=5, ahead=True)
            shape_ms[shape][0].append(ms_q)
            shape_ms[shape][1].append(ms_f)
    for shape, runs in shape_ms.items():
        info = MG.launch_shape(Q, shape)
        q_ms, f_ms = (sorted(r) for r in runs)
        print(f"phase 5: K3 shape {shape[0]} envs per block, pair table in "
              f"{'shared memory' if shape[1] else 'L1'} "
              f"({info['smem_bytes']} B per block, {info['blocks_per_sm']} "
              f"blocks per SM), median (min-max) of {K3_ROUNDS} turns: "
              f"{q_ms[K3_ROUNDS // 2]:.4f} ({q_ms[0]:.4f}-{q_ms[-1]:.4f}) ms "
              f"per {Q}-env queue, {f_ms[K3_ROUNDS // 2]:.4f} "
              f"({f_ms[0]:.4f}-{f_ms[-1]:.4f}) ms at {N_MAIN} envs")
    for n_envs in (N_MAIN,) + WIDE:
        shape = K.fused_step_shape(n_envs)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"phase 5: K1 launch at {n_envs} envs: {shape['threads']} "
              f"threads x {shape['blocks']} blocks, {shape['smem_bytes']} "
              f"B of shared memory per block, {shape['blocks_per_sm']} "
              f"blocks resident per SM "
              f"({min(shape['blocks'], sms * shape['blocks_per_sm'])} of "
              f"{shape['blocks']} at once on {sms} SMs)")
    for n_envs in WIDE:   # on the tools' state, steps 50 to 200 of a game
        wc, ws, wst = _timing.inputs(n_envs, dev)
        row = step_cost.measure(wc, ws, wst, 50, 200, reps=2)["full"]
        print(f"phase 5: K1 at {n_envs} envs, the tools' state from "
              f"vec_reset(123), steps 50-200: {row.per:.4f} ms/step "
              f"({n_envs / row.per / 1e3:.0f}M env-steps/s inside K1)")
        del wc, ws, wst
    torch.cuda.empty_cache()
    record["kernels"] = [
        {"name": "fused_step (K1)", "route": "cuda",
         "source": "eldorado_tpu_torch/csrc/step_kernel.cu",
         "replaces": "eldorado_tpu/ops/step_kernel.py:556",
         "launches": launches["K1"], "max_abs_err": err_k1,
         "ms": ms_k1 / CHUNK, "plain_ms": plain1, "bound_ms": bound_k1,
         "bound_by": by_k1, "library_ms": None,
         "per": f"env-step batch of {N_MAIN}"},
        {"name": "fused_reset (K2)", "route": "cuda",
         "source": "eldorado_tpu_torch/csrc/reset_kernel.cu",
         "replaces": "eldorado_tpu/ops/step_kernel.py:420",
         "launches": launches["K2"], "max_abs_err": err_k2,
         "ms": ms_k2, "plain_ms": ms_plain2, "bound_ms": bound_k2,
         "bound_by": by_k2, "library_ms": None,
         "per": f"{Q}-env reset queue, in place",
         "ms_in_place": {q: t[0] for q, t in k2_widths.items()},
         "launch_floor_ms": {q: t[1] for q, t in k2_widths.items()},
         "ms_new_carry": ms_k2_full, "launch_floor_ms_new_carry": floor_full,
         "ms_capacity_count": {k: t["k2_count"] for k, t in sparse.items()}},
        {"name": "generate_map (K3)", "route": "cuda",
         "source": "eldorado_tpu_torch/csrc/mapgen.cu",
         "replaces": "eldorado_tpu/core/mapgen.py:416",
         "launches": launches["K3"], "max_abs_err": err_k3,
         "ms": ms_k3, "plain_ms": ms_plain3, "bound_ms": bound_k3,
         "bound_by": by_k3, "library_ms": None,
         "per": f"{Q}-env reset queue, with the prelude",
         "ms_sized": {k: t["k3"] for k, t in sparse.items()},
         "ms_capacity_count": {k: t["k3_count"] for k, t in sparse.items()}},
        {"name": "queue_select (select)", "route": "cuda",
         "source": "eldorado_tpu_torch/csrc/queue.cu", "replaces": None,
         "launches": launches["select"], "max_abs_err": 0.0,
         "ms": ms_sel, "plain_ms": ms_plain_sel, "bound_ms": bound_sel,
         "bound_by": by_sel, "library_ms": None,
         "launch_floor_ms": floor_block,
         "per": f"{Q}-env queue of {N_MAIN} envs"},
        {"name": "queue_settle (settle)", "route": "cuda",
         "source": "eldorado_tpu_torch/csrc/queue.cu", "replaces": None,
         "launches": launches["settle"], "max_abs_err": 0.0,
         "ms": ms_settle, "plain_ms": ms_plain_settle,
         "bound_ms": bound_settle,
         "bound_by": by_settle, "library_ms": None,
         "launch_floor_ms": floor_block,
         "per": f"{sel_k}-env queue, with K3's counters"},
    ]
    record["kernels"] += phase6(dev, c, srng, states)
    record["kernels"] += phase7(dev, feed_checks, args, ms_k1 / CHUNK, plain1)
    record["kernels"] += phase8(dev, feed_checks, plain1)
    rows = {r["name"].split(" (")[-1].rstrip(")"): r
            for r in record["kernels"]}
    for path, counts in phase9(dev).items():
        for key, n in counts.items():
            rows[key][f"launches_{path}"] = n
    for key, n in phase10(dev).items():
        rows[key]["launches_async"] = n
    for path, counts in phase11(dev).items():
        for key, n in counts.items():
            rows[key][f"launches_{path}"] = n
    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phase6(dev, c, srng, states):
    """K1's cost probes on the main path's 4096-env carry: each kernel
    against its plain version, then the probe path (the four tools'
    measurements, short) with the launch counts zeroed just before it.
    Returns the four kernels' records."""
    import torch
    from eldorado_tpu_torch.core import engine as E
    from eldorado_tpu_torch.ops import probes as P
    from eldorado_tpu_torch.ops import step_kernel as K
    from eldorado_tpu_torch.tools import _timing, inst_count as IC
    from eldorado_tpu_torch.tools import (null_kernel, op_cost,
                                          prefix_profile, step_cost)
    static = (states.map_ids, states.min_xy, states.n_players,
              states.max_steps)
    n = c.shape[1]
    fields_in = dict(carry_fields(c), srng=srng)

    # K1-null: the carry and srng through, zero actions, dead untouched
    outs = []
    for fn in (K.fused_step, K.fused_step_plain):
        dead = torch.full((1,), 7, dtype=torch.int64, device=dev)
        c_out, r_out, a_out = fn(c, srng, *static, WIN_WINDOW, "storage",
                                 False, dead, null_body=True)
        outs.append(dict(carry_fields(c_out), srng=r_out, actions=a_out,
                         dead=dead))
    err_null = expect_equal("phase 6 (K1-null)", outs[0], outs[1])
    expect_equal("phase 6 (K1-null is the identity)",
                 {f: outs[0][f] for f in fields_in}, fields_in)
    if bool(outs[0]["actions"].any()) or int(outs[0]["dead"]) != 7:
        fail("phase 6: K1-null wrote actions or dead steps")
    print(f"phase 6: K1-null == plain, {n} envs: every field and srng "
          "unchanged, actions zero, dead untouched")

    p1, p1_plain = P.null_copy(c), P.null_copy_plain(c)
    err_p1 = max_err(p1, p1_plain)
    if not (torch.equal(p1, p1_plain) and torch.equal(p1, c)):
        fail(f"phase 6: P1 null copy differs (max abs err {err_p1})")
    print(f"phase 6: P1 == plain: the ({c.shape[0]}, {c.shape[1]}) carry "
          "copied word for word")

    gen = np.random.default_rng(0)
    err_p2 = 0.0
    for shape in op_cost.SHAPES:
        x, y = (torch.as_tensor(gen.integers(-2 ** 31, 2 ** 31, shape),
                                dtype=torch.int32, device=dev)
                for _ in range(2))
        for op in P.OPS:
            a, b = P.op_chain(x, y, OP_K, op), P.op_chain_plain(x, y, OP_K, op)
            err_p2 = max(err_p2, max_err(a, b))
            if not torch.equal(a, b):
                fail(f"phase 6: P2 {op} at {shape} differs (max abs err "
                     f"{max_err(a, b)})")
    print(f"phase 6: P2 == plain at all {len(op_cost.SHAPES)} shapes, ops "
          f"{'/'.join(P.OPS)}, k={OP_K}, full int32 range")

    err_p3 = 0.0
    for cut in P.CUTS:
        a = P.step_prefix(c, srng, *static, PREFIX_STEPS, cut)
        b = P.step_prefix_plain(c, srng, *static, PREFIX_STEPS, cut)
        err_p3 = max(err_p3, max_err(a, b))
        if not torch.equal(a, b):
            fail(f"phase 6: P3 cut {cut} checksums differ in "
                 f"{int((a != b).sum())} envs")
    print(f"phase 6: P3 == plain at cuts {list(P.CUTS)}, {n} envs x "
          f"{PREFIX_STEPS} steps: equal checksums")

    # the probe path, with every count at 0 just before it
    K.fused_step.launches = K.fused_step.null_launches = 0
    for fn in (P.null_copy, P.op_chain, P.step_prefix):
        fn.launches = 0
    rows_k1 = step_cost.measure(c, srng, static, 50, 200, reps=2)
    row_p1 = null_kernel.measure(c, 20, 80, reps=2)
    rows_p2 = {(shape, op): op_cost.measure(shape, OP_K, op, 10, 40, reps=2)
               for op in P.OPS for shape in op_cost.SHAPES}
    rows_p3 = prefix_profile.measure(c, srng, static, 50, 200, reps=2)
    counts = {"K1-null": K.fused_step.null_launches,
              "P1": P.null_copy.launches, "P2": P.op_chain.launches,
              "P3": P.step_prefix.launches}
    if min(counts.values()) <= 0:
        fail(f"phase 6: a probe kernel did not launch on its path: {counts}")
    print(f"phase 6: probe path launches {counts} (and K1 "
          f"{K.fused_step.launches})")
    for line in step_cost.report(rows_k1, n):
        print(f"  step_cost: {line}")
    print(f"  null_kernel: {null_kernel.report(row_p1, c)}")
    for (shape, op), row in rows_p2.items():
        print(f"  op_cost {op}: {op_cost.report(shape, OP_K, row)}")
    for line in prefix_profile.report(rows_p3):
        print(f"  prefix_profile: {line}")
    k1_step = rows_k1["full"].per
    split = {name: rows_p3[cut].per - rows_p3[cut - 1].per
             for cut, name in ((1, "sampling"), (2, "ball read"),
                               (3, "step body"))}
    print("phase 6: K1 per step {:.2f} us; P3 split of its cut-3 time: "
          "{}".format(k1_step * 1e3, ", ".join(
              f"{k} {v * 1e3:.2f} us ({100 * v / rows_p3[3].per:.0f}%)"
              for k, v in split.items())))

    # plain times beside the kernels' for the record
    null_plain, _ = cuda_ms(lambda: K.fused_step_plain(
        c, srng, *static, 1, null_body=True), reps=10)
    p1_plain_ms = _timing.cold(lambda: P.null_copy_plain(c), 20, 80,
                               reps=2).per
    x32 = torch.ones((32, 512), dtype=torch.int32, device=dev)
    p2_plain_ms, _ = cuda_ms(lambda: P.op_chain_plain(x32, x32, OP_K, "add"))
    p3_plain_ms, _ = cuda_ms(lambda: P.step_prefix_plain(
        c, srng, *static, PREFIX_STEPS, 3))
    p2_row = rows_p2[((32, 512), "add")]
    # one PyTorch call that computes P1's function, on the same carry,
    # timed as P1 is, with the L2 swept by a write (dirty lines to write
    # back) and by a read (clean) before each launch; each twice, in the
    # order P1, copy_, copy_, P1, so that two readings of one function
    # show the method's spread beside the difference between the two
    dst = torch.empty_like(c)
    p1_ms = {}
    for dirty in (True, False):
        l2 = "dirty" if dirty else "clean"
        for turn, what in enumerate(("P1", "copy_", "copy_", "P1")):
            call = (lambda: P.null_copy(c)) if what == "P1" else (
                lambda: dst.copy_(c))
            p1_ms[f"{what} {turn // 2 + 1}, L2 {l2}"] = _timing.cold(
                call, 50, 250, reps=3, dirty=dirty).per
        print(f"phase 6: ms per copy of the carry, the L2 swept by a "
              f"{'write (dirty)' if dirty else 'read (clean)'} before each "
              "launch, in turns: " + ", ".join(
                  f"{k.split(',')[0]} {v:.5f}" for k, v in p1_ms.items()
                  if k.endswith(l2)))

    def p1_mean(what, l2):
        return sum(p1_ms[f"{what} {i}, L2 {l2}"] for i in (1, 2)) / 2
    p1_ms_dirty, p1_lib_ms = p1_mean("P1", "dirty"), p1_mean("copy_", "dirty")
    # the latency of one dependent int32 op: P2's time per call over k,
    # one warp
    lat = op_cost.latency(64, OP_K, "add", 10, 40, reps=2)
    print(f"phase 6: one dependent int32 add, one warp: {lat * 1e6:.3f} ns "
          f"({lat * 1e-3 * CLOCK_HZ:.2f} cycles at {CLOCK_HZ / 1e9:.2f} "
          "GHz; the slope of P2's time per call from k = 64 to 4096)")
    # the bounds: K1-null stages each env in and out; P1 copies the carry;
    # P2 is count x k int32 ops, two loads and a store, and each element's
    # chain of k dependent ops; P3's per-step work from its counted
    # instructions at two step counts
    carry_bytes = 2 * E.CARRY_WORDS * 4 * n
    b_null = bound(carry_bytes + n * (8 + 20),
                   IC.count_k1(c, srng, static, 1, null_body=True))
    b_p1 = bound(carry_bytes)
    b_p2 = max(bound(3 * 4 * 32 * 512,
                     {"int": 32 * 512 * OP_K, "mem": 3 * 32 * 512,
                      "other": 0}), (OP_K * lat, "operations"))
    p3_200, p3_50 = (IC.count_p3(c, srng, static, s, 3) for s in (200, 50))
    b_p3 = bound(n * E.N_BALL * 4,
                 {k: (p3_200[k] - p3_50[k]) / 150 for k in IC.KINDS})
    for name, ms, (b, by) in (("K1-null", rows_k1["null"].per, b_null),
                              ("P1", p1_ms_dirty, b_p1),
                              ("P2", p2_row["calls"][OP_K].per, b_p2),
                              ("P3 cut 3, per step", rows_p3[3].per, b_p3)):
        print(f"phase 6: {name} bound {b:.6f} ms ({by}): takes "
              f"{ms / b:.2f}x its bound")
    print(f"phase 6: P1's library call dst.copy_(carry) {p1_lib_ms:.5f} ms, "
          f"plain (clone) {p1_plain_ms:.5f} ms, P1 {p1_ms_dirty:.5f} ms, "
          "each with the L2 written before every launch (P1 and copy_: the "
          "mean of their two turns)")
    print(f"phase 6: P2's chain bound {OP_K} x {lat * 1e6:.3f} ns = "
          f"{OP_K * lat:.6f} ms")
    return [
        {"name": "fused_step null_body (K1-null)", "route": "cuda",
         "source": "eldorado_tpu_torch/csrc/step_kernel.cu",
         "replaces": "eldorado_tpu/ops/step_kernel.py:624",
         "launches": counts["K1-null"], "max_abs_err": err_null,
         "ms": rows_k1["null"].per, "plain_ms": null_plain,
         "bound_ms": b_null[0], "bound_by": b_null[1], "library_ms": None,
         "per": f"launch at {n} envs"},
        {"name": "null_copy (P1)", "route": "cuda",
         "source": "eldorado_tpu_torch/csrc/probes.cu",
         "replaces": "tools/tpu_null_kernel.py:105",
         "launches": counts["P1"], "max_abs_err": err_p1,
         "ms": p1_ms_dirty, "plain_ms": p1_plain_ms,
         "bound_ms": b_p1[0], "bound_by": b_p1[1], "library_ms": p1_lib_ms,
         "per": f"copy of the ({c.shape[0]}, {n}) carry",
         "ms_l2_clean": p1_mean("P1", "clean"),
         "library_ms_l2_clean": p1_mean("copy_", "clean"),
         "turns_ms": p1_ms},
        {"name": "op_chain (P2)", "route": "cuda",
         "source": "eldorado_tpu_torch/csrc/probes.cu",
         "replaces": "tools/tpu_op_cost.py:62",
         "launches": counts["P2"], "max_abs_err": err_p2,
         "ms": p2_row["calls"][OP_K].per, "plain_ms": p2_plain_ms,
         "bound_ms": b_p2[0], "bound_by": b_p2[1], "library_ms": None,
         "per": f"call of {OP_K} add ops on (32, 512)"},
        {"name": "step_prefix (P3)", "route": "cuda",
         "source": "eldorado_tpu_torch/csrc/probes.cu",
         "replaces": "tools/tpu_prefix_profile.py:178",
         "launches": counts["P3"], "max_abs_err": err_p3,
         "ms": rows_p3[3].per, "plain_ms": p3_plain_ms / PREFIX_STEPS,
         "bound_ms": b_p3[0], "bound_by": b_p3[1], "library_ms": None,
         "per": f"step at cut 3, {n} envs"},
    ]


def phase7(dev, feed_checks, args, k1_ms, plain_ms):
    """The learner feed: K1's record instantiations against the plain
    records (a), the feed CUDA against CPU (b), the feed at full width
    with the counts zeroed just before it (c). Returns the two record
    instantiations' kernel records."""
    import torch
    import eldorado_tpu_torch as et
    from eldorado_tpu_torch import stream as S
    from eldorado_tpu_torch.core import engine as E
    from eldorado_tpu_torch.core import mapgen as MG
    from eldorado_tpu_torch.native import TrajectoryRing
    from eldorado_tpu_torch.ops import step_kernel as K

    # ---- a: K1's records against the plain version's ----------------
    err = {r: 0.0 for r in S.RECORD_WIDTH}
    for what, inputs, k1_out, plain_rec in feed_checks:
        T, n = plain_rec.shape[:2]
        for record, words in S.RECORD_WIDTH.items():
            recs = torch.full((T, n, words), -1, dtype=torch.int32,
                              device=dev)
            dead = torch.zeros(1, dtype=torch.int64, device=dev)
            c, r, a = K.fused_step(*inputs, dead, record=record, records=recs)
            want = plain_rec[..., :words]
            err[record] = max(err[record], max_err(recs, want))
            if not torch.equal(recs, want):
                bad = (recs != want).any(-1).nonzero()[:5].tolist()
                fail(f"phase 7a: K1 {record} records differ from plain, "
                     f"{what}: (step, env) {bad}")
            expect_equal(f"phase 7a ({record}, {what}): K1 with records vs "
                         "without", dict(carry_fields(c), srng=r, actions=a,
                                         dead=dead), k1_out)
        done = int(((plain_rec[..., 0] >> 25) & 1).sum())
        print(f"phase 7a: K1 compact and full records == plain, {what}: "
              f"every word, {done} done records; carry, srng, actions and "
              "dead steps as without records")
    ms_rec, bound_rec = {}, {}
    for record, words in S.RECORD_WIDTH.items():
        buf = torch.empty((CHUNK, N_MAIN, words), dtype=torch.int32,
                          device=dev)
        dead = torch.zeros(1, dtype=torch.int64, device=dev)
        ms, _ = cuda_ms(lambda: K.fused_step(*args, CHUNK, "storage", False,
                                             dead, record=record,
                                             records=buf))
        ms_rec[record] = ms / CHUNK
        del buf
        bound_rec[record] = k1_bound(args[0], args[1], args[2:], CHUNK,
                                     int(dead), record)
        print(f"phase 7a: K1 {record} records: bound "
              f"{bound_rec[record][0]:.6f} ms/step ({bound_rec[record][1]}; "
              f"{bound_rec[record][2]:.0f} PTX instructions per env-step: "
              f"{bound_rec[record][3]}): takes "
              f"{ms_rec[record] / bound_rec[record][0]:.1f}x its bound")
    print(f"phase 7a: K1 ms per step at {N_MAIN} envs: no records "
          f"{k1_ms:.4f}, compact {ms_rec['compact']:.4f}, full "
          f"{ms_rec['full']:.4f} (one {CHUNK}-step launch each)")

    # ---- b: the feed, CUDA against CPU --------------------------------
    res = []
    for d in (dev, torch.device("cpu")):
        blocks = []
        s = et.vec_reset(7, FEED_N, 4, 3, 0, 60, device=d)
        out = S.stream_rollout(s, et.sampler_init(8, FEED_N, device=d),
                               FEED_STEPS, FEED_CHUNK, steps_per_push=50,
                               record="full",
                               consume=lambda b: blocks.append(b.copy()))
        res.append((s, out, np.concatenate(blocks)))
    (s0, (s_gpu, r_gpu, ep_gpu, c_gpu), rec_gpu), \
        (_, (s_cpu, r_cpu, ep_cpu, c_cpu), rec_cpu) = res
    if not np.array_equal(rec_gpu, rec_cpu):
        fail("phase 7b: the feed's records differ between CUDA and CPU")
    if ep_gpu != ep_cpu or ep_gpu <= 0 or not c_gpu.keyframes:
        fail(f"phase 7b: episodes {ep_gpu} (cuda) vs {ep_cpu} (cpu), "
             f"{len(c_gpu.keyframes)} keyframes")
    if [k for k, _ in c_gpu.keyframes] != [k for k, _ in c_cpu.keyframes] \
            or not all(np.array_equal(a, b) for (_, a), (_, b)
                       in zip(c_gpu.keyframes, c_cpu.keyframes)):
        fail("phase 7b: the keyframes differ between CUDA and CPU")
    expect_equal("phase 7b", dict({f: getattr(s_gpu, f) for f in E.FIELDS},
                                  srng=r_gpu),
                 dict({f: getattr(s_cpu, f) for f in E.FIELDS}, srng=r_cpu))
    recon = S.ObsReconstructor(s0, c_gpu.q_cap)
    kf = dict(c_gpu.keyframes)
    for t in range(FEED_STEPS):
        recon.apply_step(rec_gpu[t])
        if t % FEED_CHUNK == FEED_CHUNK - 1 and t // FEED_CHUNK in kf:
            recon.apply_reset(kf[t // FEED_CHUNK])
    for mine, theirs in (("piles", "piles"), ("shop", "shop_stock"),
                         ("storage", "storage_masks"), ("sel", "sel_mask"),
                         ("map_ids", "map_ids"), ("min_xy", "min_xy"),
                         ("agent", "agent"), ("phase", "phase"),
                         ("resources", "resources"), ("done", "done")):
        want = getattr(s_gpu, theirs).cpu().numpy()
        if not np.array_equal(getattr(recon, mine), want.astype(
                getattr(recon, mine).dtype)):
            fail(f"phase 7b: ObsReconstructor's {mine} differs from the "
                 "CUDA final state")
    print(f"phase 7b: stream_rollout(record='full') {FEED_N} envs x "
          f"{FEED_STEPS} steps, CUDA == CPU: every record word, "
          f"{len(c_gpu.keyframes)} keyframes, every field and srng; episodes "
          f"{ep_gpu}; the ObsReconstructor fed by the CUDA feed == the CUDA "
          "final state on all 10 mirrored fields")

    # ---- c: the feed at full width ------------------------------------
    states = et.vec_reset(12345, N_MAIN, 4, 3, 0, 100000, device=dev)
    srng = et.sampler_init(42, N_MAIN, device=dev)
    steps = CHUNK * N_CHUNKS
    K.fused_step.launches = K.fused_reset.launches = 0
    MG.generate_map.launches = 0
    K.fused_step.record_launches = dict.fromkeys(K.RECORD_WORDS, 0)
    rows = {}

    def timed(name, T, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = S.stream_rollout(states, srng, T, CHUNK, **kw)
        torch.cuda.synchronize()
        rows[name] = (time.perf_counter() - t0, out)
        return out

    ring_out = timed("compact ring", steps)
    dev_out = timed("device", steps, deliver="device")
    comp_out = timed("compressed ring", steps, compress=True)
    exact_out = timed("exact, compact ring", steps, exact=True)
    small = TrajectoryRing(100 * N_MAIN * S.RECORD_WORDS_FULL * 4, 8)
    full_out = timed("full records, small ring", CHUNK, record="full",
                     ring=small)
    counts = dict({r: K.fused_step.record_launches[r]
                   for r in S.RECORD_WIDTH}, K2=K.fused_reset.launches,
                  K3=MG.generate_map.launches)
    if min(counts.values()) <= 0:
        fail(f"phase 7c: a kernel of the feed did not launch: {counts}")
    want = {"compact ring": N_MAIN * steps, "compressed ring": N_MAIN * steps,
            "exact, compact ring": N_MAIN * steps,
            "full records, small ring": N_MAIN * CHUNK}
    for name, n_rec in want.items():
        got = rows[name][1][3].records
        if got != n_rec:
            fail(f"phase 7c: {name}: the consumer counted {got} records, "
                 f"not {n_rec}")
    if comp_out[3].checksum != ring_out[3].checksum:
        fail("phase 7c: the compressed ring delivered other records than "
             "the compact ring")
    d_steps, _, _, hist = dev_out[3]
    if int(d_steps) != N_MAIN * steps or int(hist.sum()) != 5 * N_MAIN * steps:
        fail(f"phase 7c: device delivery folded {int(d_steps)} env-steps")
    if ring_out[2] != dev_out[2] or ring_out[2] != comp_out[2]:
        fail(f"phase 7c: episodes differ between deliveries: "
             f"{ring_out[2]}, {dev_out[2]}, {comp_out[2]}")
    for name, (wall, out) in rows.items():
        T = CHUNK if name.startswith("full") else steps
        line = (f"phase 7c: {name}: {N_MAIN * T / wall:.0f} delivered "
                f"env-steps/s ({wall:.3f} s, {N_MAIN} envs x {T} steps), "
                f"episodes {out[2]}")
        if name != "device":
            line += f", consumer counted {out[3].records} records"
        if name.startswith("compressed"):
            line += (f", {out[3].tunnel_bytes / out[3].records:.3f} bytes "
                     f"per record crossed to the host (raw "
                     f"{4 * S.RECORD_WORDS})")
        if name.startswith("exact"):
            live = N_MAIN * T - out[4]
            line += (f", dead steps {out[4]}, {live / wall:.0f} live "
                     "env-steps/s")
        print(line)
    print(f"phase 7c: feed path launches K1 compact {counts['compact']}, "
          f"K1 full {counts['full']}, K2 {counts['K2']}, K3 {counts['K3']}")
    return [
        {"name": f"fused_step record={record} (K1 + feed)", "route": "cuda",
         "source": f"eldorado_tpu_torch/csrc/step_{record}.cu",
         "replaces": "eldorado_tpu/ops/step_kernel.py:556",
         "launches": counts[record], "max_abs_err": err[record],
         "ms": ms_rec[record], "plain_ms": plain_ms,
         "bound_ms": bound_rec[record][0], "bound_by": bound_rec[record][1],
         "library_ms": None,
         "per": f"env-step batch of {N_MAIN} with "
                f"{S.RECORD_WIDTH[record]}-word records"}
        for record in S.RECORD_WIDTH]


def phase8(dev, feed_checks, plain_step_ms):
    """The learner's surface: K1-act, K1-sample and K1's trajectory record
    against their plain versions (a), the refusal of actions outside their
    heads (b), then with every count zeroed just before, VecEnv (c) and
    the rollouts (d) CUDA against CPU and VecEnv's rate at full width (e),
    the counts read just after; then the three kernels' times and bounds.
    Returns their kernel records."""
    import torch
    import eldorado_tpu_torch as et
    from eldorado_tpu_torch import vec
    from eldorado_tpu_torch.core import engine as E
    from eldorado_tpu_torch.core import mapgen as MG
    from eldorado_tpu_torch.ops import step_kernel as K
    from eldorado_tpu_torch.tools import _timing, sample_cost
    from eldorado_tpu_torch.tools import inst_count as IC
    cpu = torch.device("cpu")
    done_row = [o for f, _, _, o, _ in E.DYN_LAYOUT if f == "done"][0]

    # ---- a: the kernels against their plain versions ----------------
    states = et.vec_reset(12345, N_MAIN, 4, 3, 0, 100000, device=dev)
    st = (states.map_ids, states.min_xy, states.n_players, states.max_steps)
    c = E.pack_dyn(E.split_state(states)[1])
    srng = et.sampler_init(42, N_MAIN, device=dev)
    gen = np.random.default_rng(8)
    widths = np.asarray(K.HEAD_WIDTHS)
    err_act = err_sample = 0.0
    for t in range(ACT_STEPS):
        words = K.mask_words(c, "storage")
        live = (torch.arange(N_MAIN, device=dev) % 3 != 0) if t % 2 else None
        got = K.sample(srng, words, live)
        want = K.sample_plain(srng, words, live)
        for name, a, b in zip(("actions", "srng", "tainted"), got, want):
            err_sample = max(err_sample, max_err(a, b))
            if not torch.equal(a, b):
                fail(f"phase 8a: K1-sample {name} differ at step {t}")
        acts = got[0] if t % 4 < 2 else torch.as_tensor(
            gen.integers(0, 1 << 20, (N_MAIN, 5)) % widths,
            dtype=torch.int32, device=dev)
        new, n_done = K.step_actions(c, acts, *st)
        plain, counts = K.step_actions_plain(c, acts, *st)
        err_act = max(err_act, expect_equal(
            f"phase 8a (K1-act, step {t})", carry_fields(new),
            carry_fields(plain)))
        if n_done != int(counts[1]) or int(counts[0]):
            fail(f"phase 8a: K1-act counts {n_done} vs {counts.tolist()}")
        c, srng = new, got[1]
    print(f"phase 8a: K1-sample == plain and K1-act == plain at {N_MAIN} "
          f"envs from the main path's reset, {ACT_STEPS} steps: sampled "
          "actions and random actions inside the heads (mostly forbidden "
          "by the masks), live flags on odd steps; every field, srng, "
          "actions, tainted flags and the done count")
    err_traj = 0.0
    for what, inputs, k1_out, _ in feed_checks:
        T, n = inputs[6], inputs[0].shape[1]
        plain = torch.empty((T, n, K.TRAJ_WORDS), dtype=torch.int32,
                            device=dev)
        K.fused_step_plain(*inputs, record="traj", records=plain)
        recs = torch.full_like(plain, -1)
        dead = torch.zeros(1, dtype=torch.int64, device=dev)
        out = K.fused_step(*inputs, dead, record="traj", records=recs)
        err_traj = max(err_traj, max_err(recs, plain))
        if not torch.equal(recs, plain):
            bad = (recs != plain).any(-1).nonzero()[:5].tolist()
            fail(f"phase 8a: K1 trajectory records differ from plain, "
                 f"{what}: (step, env) {bad}")
        expect_equal(f"phase 8a (traj, {what}): K1 with the trajectory "
                     "record vs without", dict(carry_fields(out[0]),
                                               srng=out[1], actions=out[2],
                                               dead=dead), k1_out)
        print(f"phase 8a: K1 trajectory records == plain, {what}: every "
              f"word, {int(K.unpack_traj(plain)[1].sum())} done records")

    # K1-act at the widths that take each staging path: n = 1 (cog_env) and a ragged 4097 by words, 4096
    # and 16384 by 16-byte units; from 60 K1 steps into 12-turn games, so
    # that envs end and dead-step in the window
    paths = {}
    for n_act in ACT_WIDTHS:
        s_a = et.vec_reset(123, n_act, 4, 3, 0, 12, device=dev)
        st_a = (s_a.map_ids, s_a.min_xy, s_a.n_players, s_a.max_steps)
        c_a, r_a, _ = K.fused_step(E.pack_dyn(E.split_state(s_a)[1]),
                                   et.sampler_init(77, n_act, device=dev),
                                   *st_a, 60)
        done_seen = 0
        for t in range(ACT_STEPS):
            if t % 2:
                acts, r_a, _ = K.sample(r_a, K.mask_words(c_a, "storage"))
            else:
                acts = torch.as_tensor(
                    gen.integers(0, 1 << 20, (n_act, 5)) % widths,
                    dtype=torch.int32, device=dev)
            new, n_done = K.step_actions(c_a, acts, *st_a)
            plain, counts = K.step_actions_plain(c_a, acts, *st_a)
            err_act = max(err_act, expect_equal(
                f"phase 8a (K1-act at {n_act} envs, step {t})",
                carry_fields(new), carry_fields(plain)))
            if n_done != int(counts[1]) or int(counts[0]):
                fail(f"phase 8a: K1-act counts {n_done} vs "
                     f"{counts.tolist()} at {n_act} envs")
            done_seen = max(done_seen, n_done)
            c_a = new
        paths[n_act] = (K.step_actions.last_path, done_seen)
    if [paths[n][0] for n in ACT_WIDTHS] != ["word", "16-byte", "word",
                                             "16-byte"]:
        fail(f"phase 8a: K1-act staged by {paths}")
    print(f"phase 8a: K1-act ({K.ACT_ENVS} envs and {K.ACT_WARPS} warps a "
          f"block, warp 0 stepping) == plain at {list(ACT_WIDTHS)} envs, {ACT_STEPS} steps each from "
          "60 K1 steps into 12-turn games, sampled and random in-head "
          "actions: every field and both counts; staging path and most "
          f"envs done after a step, by width: {paths}")
    # the carry-reading K1-sample: masks from the carry, the tainted
    # flags ORed into it in place, against mask_words + sample_plain + OR
    live_flags = torch.arange(N_MAIN, device=dev) % 3 != 0
    for mask_src in ("storage", "sel"):
        for live in (None, live_flags):
            cg, cp = c.clone(), c.clone()
            got = K.sample_carry(srng, cg, mask_src, live)
            want = K.sample_carry_plain(srng, cp, mask_src, live)
            for name, a, b in zip(("actions", "srng", "carry"),
                                  got + (cg,), want + (cp,)):
                err_sample = max(err_sample, max_err(a, b))
                if not torch.equal(a, b):
                    fail(f"phase 8a: K1-sample from the carry ({mask_src}, "
                         f"live {live is not None}): {name} differ")
    print(f"phase 8a: K1-sample from the carry == mask_words + plain + the "
          f"OR into rng_tainted at {N_MAIN} envs, storage and sel masks, "
          "with and without live flags: actions, srng and every carry word")

    # ---- b: actions outside their heads raise ------------------------
    env = et.VecEnv(64, device=dev)
    env.reset(seed=3, max_steps=VEC_TURNS)
    before = env.states
    for h, bad in enumerate((-1, 22, 22, 7, 19)):
        acts = env.sample()
        acts[5, h] = bad
        for call in (lambda: env.step(acts),
                     lambda: et.vec_step(before, acts)):
            try:
                call()
            except ValueError:
                continue
            fail(f"phase 8b: action {bad} in head {h} did not raise")
    expect_equal("phase 8b (the batch after the refusals)",
                 {f: getattr(env.states, f) for f in E.FIELDS},
                 {f: getattr(before, f) for f in E.FIELDS})
    print("phase 8b: an action outside its head raises ValueError in "
          "vec_step and VecEnv.step, each head, the batch untouched")

    # ---- c-e: the learner's path, counts zeroed just before ----------
    K.step_actions.launches = K.sample.launches = 0
    K.sample.carry_launches = 0
    K.fused_step.launches = K.fused_reset.launches = 0
    K.fused_step.record_launches = dict.fromkeys(K.RECORD_WORDS, 0)
    MG.generate_map.launches = 0
    res = []
    for d in (dev, cpu):
        env = et.VecEnv(VEC_N, device=d)
        env.reset(seed=7, max_steps=VEC_TURNS, sampler_seed=8)
        t0 = time.perf_counter()
        episodes = sum(int(env.step(env.sample()).sum())
                       for _ in range(VEC_STEPS))
        res.append((env, episodes, time.perf_counter() - t0))
    (e_gpu, ep_gpu, wall_gpu), (e_cpu, ep_cpu, wall_cpu) = res
    expect_equal("phase 8c", dict({f: getattr(e_gpu.states, f)
                                   for f in E.FIELDS},
                                  srng=e_gpu.sampler_rngs),
                 dict({f: getattr(e_cpu.states, f) for f in E.FIELDS},
                      srng=e_cpu.sampler_rngs))
    if ep_gpu != ep_cpu or ep_gpu <= 0:
        fail(f"phase 8c: episodes {ep_gpu} (cuda) vs {ep_cpu} (cpu)")
    print(f"phase 8c: VecEnv {VEC_N} envs x {VEC_STEPS} sample / step "
          f"rounds, {VEC_TURNS}-turn games: CUDA == CPU on every field and "
          f"srng; episodes {ep_gpu} ({wall_gpu:.2f} s on the card, "
          f"{wall_cpu:.2f} s on the CPU)")
    s = et.vec_reset(5, ROLL_N, 4, 3, 0, ROLL_TURNS, device=dev)
    r = et.sampler_init(11, ROLL_N, device=dev)
    runs = [(f"rollout({m}, {a})", lambda s, r, m=m, a=a: et.rollout(
        s, r, ROLL_STEPS, m, a)) for m in ("storage", "sel")
            for a in ("none", "step")]
    runs.append(("kernel_rollout", lambda s, r: et.kernel_rollout(
        s, r, ROLL_STEPS)))
    for name, run in runs:
        got = run(s, r)
        want = run(s.__class__(**{f: getattr(s, f).cpu()
                                  for f in E.FIELDS}), r.cpu())
        expect_equal(f"phase 8d ({name})",
                     dict({f: getattr(got[0], f) for f in E.FIELDS},
                          srng=got[1], **{f"traj{i}": x
                                          for i, x in enumerate(got[2])}),
                     dict({f: getattr(want[0], f) for f in E.FIELDS},
                          srng=want[1], **{f"traj{i}": x
                                           for i, x in enumerate(want[2])}))
        print(f"phase 8d: {name}, {ROLL_N} envs x {ROLL_STEPS} steps: CUDA "
              f"== CPU on every field, srng and all {len(got[2])} per-step "
              f"outputs; {int(got[2][1].sum())} done records")
    env = et.VecEnv(N_MAIN, device=dev)
    env.reset(seed=12345, max_steps=100000, sampler_seed=42)
    for _ in range(10):   # warm-up
        env.step(env.sample())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RATE_STEPS):
        env.step(env.sample())
    torch.cuda.synchronize()
    rate = N_MAIN * RATE_STEPS / (time.perf_counter() - t0)
    counts = {"K1-act": K.step_actions.launches,
              "K1-sample": K.sample.launches,
              "K1 traj": K.fused_step.record_launches["traj"],
              "K3": MG.generate_map.launches, "K2": K.fused_reset.launches}
    if min(counts.values()) <= 0:
        fail(f"phase 8: a kernel of the learner's path did not launch: "
             f"{counts}")
    if K.sample.carry_launches != counts["K1-sample"]:
        fail(f"phase 8: VecEnv.sample launched K1-sample from mask words "
             f"({counts['K1-sample'] - K.sample.carry_launches} times)")
    print(f"phase 8e: VecEnv {N_MAIN} envs, sample then step: {rate:.0f} "
          f"env-steps/s over {RATE_STEPS} rounds (recorded before the "
          "one-launch sampler: 14,095,175)")
    print(f"phase 8: learner path launches {counts}")
    # VecEnv.sample is one launch on the card: the device's operations in
    # one call, from the profiler
    prof_acts = [torch.profiler.ProfilerActivity.CPU,
                 torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=prof_acts) as prof:
        env.sample()
        torch.cuda.synchronize()
    device_ops = {ev.key: ev.count for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA}
    if sum(device_ops.values()) != 1 or not any(
            "sample_kernel" in k for k in device_ops):
        fail(f"phase 8: VecEnv.sample ran {device_ops} on the card")
    print(f"phase 8: VecEnv.sample on the card is one operation: "
          f"{device_ops}")

    # ---- the kernels' times and bounds -------------------------------
    c = env._carry
    st = tuple(env._static[f] for f in ("map_ids", "min_xy", "n_players",
                                        "max_steps"))
    words = K.mask_words(c, "storage")
    acts = K.sample(env.sampler_rngs, words)[0]
    cnt = torch.zeros(3, dtype=torch.int32, device=dev)

    def in_a_row(launch):
        def run(k):
            for _ in range(k):
                launch()
        return run
    # K1-act on the learner's 4096-env carry, timed cold (the L2 written
    # before each launch: its 19 MB would otherwise stay in the 50 MB L2,
    # and its bound counts HBM bytes, as for P1 and K1-null), warm (in a
    # row) and cold with every env done (each step a dead step: the
    # staging floor), in two turns; K1-null beside it on the same carry
    # (the first design's staging floor), timed the same way
    out_a = torch.empty_like(c)
    c_done = c.clone()
    c_done[done_row] = 1
    turns = {"cold": [], "warm": [], "done": [], "null": []}
    for _ in range(2):
        turns["cold"].append(_timing.cold(lambda: K.launch_step_actions(
            c, acts, *st, out_a, cnt), 50, 250, reps=3).per)
        turns["warm"].append(_timing.differenced(in_a_row(
            lambda: K.launch_step_actions(c, acts, *st, out_a, cnt)),
            20, 80, reps=2, graph=True).per)
        turns["done"].append(_timing.cold(lambda: K.launch_step_actions(
            c_done, acts, *st, out_a, cnt), 50, 250, reps=3).per)
        turns["null"].append(_timing.cold(lambda: K.fused_step(
            c, env.sampler_rngs, *st, 1, null_body=True), 50, 250,
            reps=3).per)
    ms_act, ms_act_warm, ms_act_floor, ms_null = (
        float(np.mean(turns[k])) for k in ("cold", "warm", "done", "null"))
    print(f"phase 8: K1-act {ms_act:.5f} ms cold, {ms_act_warm:.5f} ms warm, "
          f"{ms_act_floor:.5f} ms cold with every env done (its staging "
          f"floor), at {N_MAIN} envs (each the mean of two turns: "
          f"{turns}); recorded before the redesign: 0.02697 / 0.01725; "
          f"K1-null (the first design's staging floor) {ms_null:.5f} ms "
          f"cold on the same carry: K1-act takes {ms_act / ms_null:.2f}x it")
    # K1-act at n = 1, cog_env's width: launches in a row
    s1 = et.vec_reset(21, 1, 4, 1, 0, 100000, device=dev)
    st1 = (s1.map_ids, s1.min_xy, s1.n_players, s1.max_steps)
    c1 = E.pack_dyn(E.split_state(s1)[1])
    a1 = K.sample(et.sampler_init(6, 1, device=dev),
                  K.mask_words(c1, "storage"))[0]
    o1 = torch.empty_like(c1)
    ms_one = _timing.differenced(in_a_row(
        lambda: K.launch_step_actions(c1, a1, *st1, o1, cnt)), 20, 80,
        reps=2, graph=True).per
    print(f"phase 8: K1-act at 1 env (cog_env), launches in a row: "
          f"{ms_one:.5f} ms (recorded before the redesign: 0.01227)")
    # K1-sample from the carry (VecEnv.sample's launch), from mask words,
    # and an empty kernel launched the same way, in a row from a CUDA
    # graph, in two turns
    smp = sample_cost.measure(env.sampler_rngs, c)
    ms_smp, ms_smp_words, ms_empty = (smp[k] for k in ("carry", "words",
                                                       "empty"))
    ms_act_plain, _ = cuda_ms(lambda: K.step_actions_plain(c, acts, *st))
    ms_smp_plain, _ = cuda_ms(lambda: K.sample_carry_plain(
        env.sampler_rngs, c.clone()))
    live = int((c[done_row] == 0).sum())
    ops_act = IC.count_k1_act(c, acts, st)
    b_act = bound(N_MAIN * (2 * E.CARRY_WORDS * 4 + 20 + 16)
                  + live * E.N_BALL * 4 + 12, ops_act)
    # from the carry: the engine in and out, the agent and three mask
    # words in, the actions out (the tainted row is written only for a
    # tainted env: none here)
    ops_smp = IC.count_k1_sample_carry(env.sampler_rngs, c)
    b_smp = bound(N_MAIN * (4 + 4 + 4 + 12 + 20), ops_smp)
    ops_words = IC.count_k1_sample(env.sampler_rngs, words)
    b_words = bound(N_MAIN * (4 + 4 + 12 + 20 + 1), ops_words)
    for name, ms, how, plain_ms, (b, by), ops in (
            ("K1-act", ms_act, "the L2 written before each launch",
             ms_act_plain, b_act, ops_act),
            ("K1-sample from the carry", ms_smp,
             "launches in a row, its 0.2 MB in L2", ms_smp_plain, b_smp,
             ops_smp),
            ("K1-sample from mask words", ms_smp_words,
             "launches in a row", None, b_words, ops_words)):
        plain = "" if plain_ms is None else f", plain {plain_ms:.3f} ms"
        print(f"phase 8: {name} {ms:.5f} ms per launch at {N_MAIN} envs "
              f"({how}; CUDA graph){plain}; bound {b:.6f} ms ({by}; "
              f"{sum(ops.values()) / N_MAIN:.0f} PTX instructions per env: "
              f"{per_kind(ops, N_MAIN)}): takes {ms / b:.2f}x its bound")
    print(f"phase 8: {sample_cost.report(smp, N_MAIN)}; the empty kernel "
          f"is the launch floor under K1-sample (recorded before the "
          f"redesign: 0.00278 from mask words); turns {smp['turns']}")
    args = feed_checks[-1][1][:6]   # phase 5's main-path carry
    buf = torch.empty((CHUNK, N_MAIN, K.TRAJ_WORDS), dtype=torch.int32,
                      device=dev)
    dead = torch.zeros(1, dtype=torch.int64, device=dev)
    ms_traj, _ = cuda_ms(lambda: K.fused_step(*args, CHUNK, "storage", False,
                                              dead, record="traj",
                                              records=buf))
    ms_traj /= CHUNK
    del buf
    b_traj = k1_bound(args[0], args[1], args[2:], CHUNK, int(dead), "traj")
    print(f"phase 8: K1 trajectory record {ms_traj:.4f} ms/step at {N_MAIN} "
          f"envs (one {CHUNK}-step launch); bound {b_traj[0]:.6f} ms/step "
          f"({b_traj[1]}; {b_traj[2]:.0f} PTX instructions per env-step: "
          f"{b_traj[3]}): takes {ms_traj / b_traj[0]:.1f}x its bound")
    return [
        {"name": "step_actions (K1-act)", "route": "cuda",
         "source": "eldorado_tpu_torch/csrc/step_actions.cu",
         "replaces": "eldorado_tpu/vec.py:116",
         "launches": counts["K1-act"], "max_abs_err": err_act,
         "ms": ms_act, "plain_ms": ms_act_plain, "bound_ms": b_act[0],
         "bound_by": b_act[1], "library_ms": None,
         "per": f"step of {N_MAIN} envs with given actions, L2 written "
                f"before each launch",
         "ms_l2_warm": ms_act_warm, "ms_every_env_done": ms_act_floor,
         "k1_null_ms": ms_null, "ms_one_env": ms_one},
        {"name": "sample (K1-sample)", "route": "cuda",
         "source": "eldorado_tpu_torch/csrc/sample.cu",
         "replaces": "eldorado_tpu/vec.py:132",
         "launches": counts["K1-sample"], "max_abs_err": err_sample,
         "ms": ms_smp, "plain_ms": ms_smp_plain, "bound_ms": b_smp[0],
         "bound_by": b_smp[1], "library_ms": None,
         "per": f"sample of {N_MAIN} envs from the carry (VecEnv.sample)",
         "ms_words": ms_smp_words, "bound_ms_words": b_words[0],
         "empty_launch_ms": ms_empty},
        {"name": "fused_step record=traj (K1 + trajectory)",
         "route": "cuda", "source": "eldorado_tpu_torch/csrc/step_traj.cu",
         "replaces": "eldorado_tpu/ops/step_kernel.py:556",
         "launches": counts["K1 traj"], "max_abs_err": err_traj,
         "ms": ms_traj, "plain_ms": plain_step_ms, "bound_ms": b_traj[0],
         "bound_by": b_traj[1], "library_ms": None,
         "per": f"env-step batch of {N_MAIN} with {K.TRAJ_WORDS}-word "
                "trajectory records"},
    ]


def _compat_fields(env):
    """Everything a cog_env shows: observation, infos, selected mask,
    rewards, done and agent, as bytes."""
    return (env.observations.tobytes(), env.infos.tobytes(),
            env.selected_action_mask.tobytes(), env.rewards.tobytes(),
            env.get_done(), env.agent_selection)


def _compat_lockstep(dev, params, sampler_seed, n_steps, full_reset):
    """cog_env on the card against cog_env(backend="ref") (the numpy
    reference engine), storage-mask actions from RefSampler(sampler_seed),
    every field compared after every step and reset; a finished game
    resets with the same parameters, or the first finished game at or
    after ``full_reset[0]`` with the full parameters ``full_reset[1]``.
    Returns (resets, wins, seconds spent in the card env's steps)."""
    from eldorado_tpu_torch import compat
    from eldorado_tpu_torch.core.ref_engine import RefSampler
    envs = [compat.cog_env(*params, backend=b, device=dev)
            for b in ("device", "ref")]
    for e in envs:
        e.reset()
    sam = RefSampler(sampler_seed)
    resets = wins = 0
    t_dev = 0.0
    done_full = False
    for t in range(n_steps):
        ref = envs[1]._env
        a = sam.sample(ref.storage_masks[ref.agent])
        t0 = time.perf_counter()
        envs[0].step(a)
        t_dev += time.perf_counter() - t0
        envs[1].step(a)
        if _compat_fields(envs[0]) != _compat_fields(envs[1]):
            fail(f"phase 9a: cog_env {params} differs from the reference "
                 f"at step {t}")
        if envs[1].get_done():
            resets += 1
            wins += bool(ref.rewards.any())
            full = not done_full and t >= full_reset[0]
            done_full |= full
            for e in envs:
                if full:
                    e.reset(*full_reset[1])
                else:
                    e.reset()
            if _compat_fields(envs[0]) != _compat_fields(envs[1]):
                fail(f"phase 9a: cog_env {params} differs from the "
                     f"reference after the reset at step {t}")
    if not done_full:
        fail(f"phase 9a: {params}: no game ended after step {full_reset[0]}")
    return resets, wins, t_dev


def _compat_loop(dev, n, steps, read_every, seed=12345, max_steps=100000):
    """compat.vec's sample -> step loop (get_vec_env + get_vec_sampler),
    the observations and infos read every ``read_every`` steps (never
    with 0). Returns (the reads and the final getters as bytes, seconds)."""
    import torch
    from eldorado_tpu_torch.compat import vec as cvec
    venv = cvec.get_vec_env(n, device=dev)
    venv.reset(seed=seed, n_pieces=3, max_steps=max_steps)
    sampler = cvec.get_vec_sampler(n, device=dev)
    sampler.seed(42)
    reads = []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        a = sampler.sample(venv.get_selected_action_masks())
        done = venv.step(a)
        if read_every and (t + 1) % read_every == 0:
            reads.append(a.tobytes() + done.tobytes()
                         + venv.get_observations().tobytes()
                         + venv.get_infos().tobytes())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reads.append(venv.get_rewards().tobytes()
                 + venv.get_agent_selections().tobytes()
                 + venv.get_selected_action_masks().tobytes())
    return reads, wall


def _launch_counts(zero=False):
    """The launch counts of the kernels the compat and async paths run,
    by kernel; with ``zero`` set them to 0 first."""
    from eldorado_tpu_torch.core import mapgen as MG
    from eldorado_tpu_torch.ops import step_kernel as K
    counters = {"K1": K.fused_step, "K1-act": K.step_actions,
                "K1-sample": K.sample, "K3": MG.generate_map,
                "K2": K.fused_reset}
    if zero:
        for fn in counters.values():
            fn.launches = 0
    return {key: fn.launches for key, fn in counters.items()}


def _check_counts(tag, counts, need):
    """Fail unless every kernel in ``need`` launched and no other did."""
    if any(counts[k] <= 0 for k in need) or any(
            n for k, n in counts.items() if k not in need):
        fail(f"{tag}: launches {counts}, expected {sorted(need)} only")
    print(f"{tag}: launches {counts}")
    return {k: counts[k] for k in need}


def phase9(dev):
    """The city_of_gold surface (eldorado_tpu_torch.compat) on the card:
    cog_env in lockstep with the numpy reference engine, compat.vec's loop
    CUDA against CPU and its rates at full width, and the runner's rate.
    Each of the three has its own counts, zeroed just before it and read
    just after. Returns {path: launches by kernel}."""
    import torch
    from eldorado_tpu_torch.compat import vec as cvec
    launches = {}

    # ---- a: cog_env on the card == the reference engine ---------------
    _launch_counts(zero=True)
    steps_dev = secs_dev = 0
    for params, n_steps in (((77, 3, 2, 0, 6), COMPAT_STEPS),
                            ((5, 2, 3, 2, 4), COMPAT_STEPS),
                            ((123, 4, 2, 1, 10), COMPAT_STEPS)):
        resets, _, secs = _compat_lockstep(
            dev, params, params[0] + 1, n_steps,
            (n_steps // 2, (params[0] + 9, 4, 1, 0, 5)))
        steps_dev += n_steps
        secs_dev += secs
        print(f"phase 9a: cog_env{params} on the card == the reference "
              f"engine over {n_steps} steps: every observation, mask, "
              f"reward and info field; {resets} resets, one of them a "
              "full-parameter reset after a finished game")
    resets, wins, secs = _compat_lockstep(
        dev, (21, 4, 1, 0, 100000), 6, WIN_STEPS,
        (0, (31, 3, 2, 1, 100000)))
    steps_dev += WIN_STEPS
    secs_dev += secs
    if wins < 1:
        fail("phase 9a: the seed-21 game did not end by a win")
    print(f"phase 9a: cog_env(21, 4, 1, EASY) == the reference engine over "
          f"{WIN_STEPS} storage-mask steps (RefSampler(6)): {wins} won "
          f"game(s) ({resets} resets), then a "
          "full-parameter reset of the finished game (rewards and infos "
          "kept) and play on")
    print(f"phase 9a: single-env cog_env on the card: "
          f"{steps_dev / secs_dev:.0f} steps/s ({steps_dev} steps, K1-act "
          "and the one copy to the host each)")
    launches["cog_env"] = _check_counts(
        "phase 9a: cog_env", _launch_counts(), ("K1-act", "K3", "K2"))

    # ---- b: compat.vec, CUDA against CPU, then its rates -------------
    _launch_counts(zero=True)
    got, _ = _compat_loop(dev, CVEC_CHECK_N, CVEC_CHECK_STEPS, 10,
                          seed=21, max_steps=3)
    want, wall_cpu = _compat_loop(torch.device("cpu"), CVEC_CHECK_N,
                                  CVEC_CHECK_STEPS, 10, seed=21, max_steps=3)
    if got != want:
        fail("phase 9b: compat.vec differs between CUDA and CPU")
    print(f"phase 9b: compat.vec {CVEC_CHECK_N} envs x {CVEC_CHECK_STEPS} "
          f"steps of 3-turn games, observations and infos read every 10 "
          f"steps: CUDA == CPU on every read ({wall_cpu:.1f} s on the CPU)")
    _compat_loop(dev, N_MAIN, 10, 0)   # warm-up
    _, wall_bare = _compat_loop(dev, N_MAIN, CVEC_STEPS, 0)
    _, wall_read = _compat_loop(dev, N_MAIN, CVEC_STEPS, 10)
    print(f"phase 9b: compat.vec at {N_MAIN} envs, sample -> step: "
          f"{N_MAIN * CVEC_STEPS / wall_bare:.0f} env-steps/s without "
          f"observation reads, {N_MAIN * CVEC_STEPS / wall_read:.0f} with "
          f"get_observations() and get_infos() every 10 steps "
          f"({CVEC_STEPS} steps each)")
    launches["compat.vec"] = _check_counts(
        "phase 9b: compat.vec", _launch_counts(),
        ("K1-act", "K1-sample", "K3", "K2"))

    # ---- c: the runner -------------------------------------------------
    _launch_counts(zero=True)
    runner = cvec.get_runner(N_MAIN, device=dev)
    runner.reset(seed=12345, n_pieces=3)
    for _ in range(10):
        runner.sample()
        runner.step()
    runner.sync()
    t0 = time.perf_counter()
    for _ in range(CVEC_STEPS):
        runner.sample()
        runner.step()
    runner.sync()
    wall_run = time.perf_counter() - t0
    print(f"phase 9c: RunnerCompat at {N_MAIN} envs, sample + step: "
          f"{N_MAIN * CVEC_STEPS / wall_run:.0f} env-steps/s")
    launches["runner"] = _check_counts(
        "phase 9c: runner", _launch_counts(),
        ("K1-act", "K1-sample", "K3", "K2"))
    return launches


def phase10(dev):
    """rollout_chunked(reset_mode="async"): CUDA against CPU with exact off
    and on (phase 4's recipe), then the main path at full width, sync and
    async in alternating turns, the counts zeroed just before each async
    run and read just after it; then one profiled run of each mode. Returns
    the launches of one async run by kernel."""
    import torch
    import eldorado_tpu_torch as et
    from eldorado_tpu_torch.core import engine as E
    from eldorado_tpu_torch.reset_profile import _kernel_times
    for exact in (False, True):
        res = []
        for d in (dev, torch.device("cpu")):
            s = et.vec_reset(7, ASYNC_N, 4, 3, 0, 60, device=d)
            res.append(et.rollout_chunked(
                s, et.sampler_init(8, ASYNC_N, device=d), ASYNC_STEPS,
                ASYNC_CHUNK, exact=exact, reset_mode="async"))
        (a, ra, *ca), (b, rb, *cb) = res
        expect_equal(f"phase 10a (exact={exact})",
                     dict({f: getattr(a, f) for f in E.FIELDS}, srng=ra),
                     dict({f: getattr(b, f) for f in E.FIELDS}, srng=rb))
        if ca != cb or ca[0] <= 0:
            fail(f"phase 10a: episodes / dead steps {ca} (cuda) vs {cb}")
        print(f"phase 10a: async rollout_chunked {ASYNC_N} envs x "
              f"{ASYNC_STEPS} steps (chunk {ASYNC_CHUNK}), "
              f"exact={exact}: CUDA == CPU on every field and srng; "
              f"episodes{' and dead steps' if exact else ''} {ca}")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def run(mode, profile=False):
        """One main-path rollout from the same reset: (its output, its
        wall in s, its launches, the profiler or None). The reset is made
        before the counts are zeroed and the clock starts."""
        s = et.vec_reset(12345, N_MAIN, 4, 3, 0, 100000, device=dev)
        r = et.sampler_init(42, N_MAIN, device=dev)
        torch.cuda.synchronize()
        _launch_counts(zero=True)
        prof = torch.profiler.profile(activities=acts) if profile else None
        if prof:
            prof.__enter__()
        t0 = time.perf_counter()
        out = et.rollout_chunked(s, r, CHUNK * N_CHUNKS, CHUNK,
                                 reset_mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof:
            prof.__exit__(None, None, None)
        return out, wall, _launch_counts(), prof

    run("sync")
    run("async")   # warm-up, both modes
    walls = {"sync": [], "async": []}
    counts = []
    for mode in ("sync", "async", "async", "sync"):
        (st, _, eps), wall, launches, _ = run(mode)
        walls[mode].append(wall)
        for f in ("rewards", "resources", "info_returns"):
            if not bool(torch.isfinite(getattr(st, f)).all()):
                fail(f"phase 10b: non-finite {f} ({mode})")
        if eps <= 0:
            fail(f"phase 10b: the {mode} main path ended no game")
        if mode == "async":
            counts.append(_check_counts("phase 10b: async run", launches,
                                        ("K1", "K3", "K2")))
        print(f"phase 10b: main path {mode}: "
              f"{N_MAIN * CHUNK * N_CHUNKS / wall:.0f} env-steps/s "
              f"({wall:.4f} s), episodes {eps}, launches {launches}")
    if counts[0] != counts[1]:
        fail(f"phase 10b: the two async runs launched {counts}")
    rate = {m: [N_MAIN * CHUNK * N_CHUNKS / w for w in ws]
            for m, ws in walls.items()}
    print(f"phase 10b: sync {np.mean(rate['sync']):.0f} env-steps/s "
          f"(turns {[round(x) for x in rate['sync']]}), async "
          f"{np.mean(rate['async']):.0f} (turns "
          f"{[round(x) for x in rate['async']]}): async / sync "
          f"{np.mean(rate['async']) / np.mean(rate['sync']):.4f}")
    # where the difference goes: one run of each mode under the profiler,
    # its wall against the device's busy time (every kernel, summed), and
    # K3 + K2's device time per reset (each queue and the final sweep)
    for mode in ("sync", "async"):
        _, wall, launches, prof = run(mode, profile=True)
        busy, kern = _kernel_times(prof)
        wall *= 1e3
        print(f"phase 10b: profiled {mode} run: wall {wall:.2f} ms, device "
              f"busy {busy:.2f} ms ({100 * busy / wall:.1f}%), idle "
              f"{wall - busy:.2f} ms; K1 {kern['k1']:.2f} ms, K2 "
              f"{kern['k2']:.3f} ms, K3 {kern['k3']:.3f} ms; "
              f"{launches['K2']} resets, K3 + K2 "
              f"{(kern['k2'] + kern['k3']) / max(1, launches['K2']):.4f} ms "
              "per reset")
    return counts[0]


def _fields(states, srng):
    from eldorado_tpu_torch.core import engine as E
    return dict({f: getattr(states, f) for f in E.FIELDS}, srng=srng)


def _main_inputs(dev, n=N_MAIN, seed=12345, sampler_seed=42,
                 max_steps=100000):
    """The main path's reset (4 players, 3 pieces, EASY) of ``n`` envs."""
    import eldorado_tpu_torch as et
    return (et.vec_reset(seed, n, 4, 3, 0, max_steps, device=dev),
            et.sampler_init(sampler_seed, n, device=dev))


def _check_slices(tag, mesh, shards, srngs, steps, chunk, **kw):
    """Each shard against the unsharded run of its own rows and seeds (env
    i seeded 12345 + i, sampler i 42 + i); returns their episodes."""
    import eldorado_tpu_torch as et
    from eldorado_tpu_torch.parallel import mesh as M
    episodes = 0
    for i, (d, a, b) in enumerate(M.env_sharding(mesh, N_MAIN)):
        want = et.rollout_chunked(*_main_inputs(d, b - a, 12345 + a, 42 + a),
                                  steps, chunk, **kw)
        expect_equal(f"{tag} shard {i}", _fields(shards[i], srngs[i]),
                     _fields(*want[:2]))
        episodes += want[2]
    return episodes


GLOO_WORKER = r"""
import sys
import torch
import eldorado_tpu_torch as et
from eldorado_tpu_torch.core import engine as E
from eldorado_tpu_torch.parallel import bootstrap, mesh as M, runner as R

port, rank, dev, n, steps, turns = sys.argv[1:]
rank, n, steps, turns = int(rank), int(n), int(steps), int(turns)
bootstrap.initialize(f"localhost:{port}", 2, rank, backend="gloo")
try:
    mesh = M.make_mesh(devices=[dev])
    start, stop = bootstrap.local_env_range(mesh, n)
    shards, rngs = bootstrap.vec_reset_distributed(mesh, 12345, n, 4, 3, 0,
                                                   turns)
    shards, rngs, stats = R.sharded_rollout(mesh, shards, rngs, steps)
    whole, wrngs, traj = et.rollout(
        et.vec_reset(12345, n, 4, 3, 0, turns, device=dev),
        et.sampler_init(42, n, device=dev), steps, auto_reset="step")
    for f in E.FIELDS:
        rows = getattr(whole, f)[start:stop]
        if not torch.equal(getattr(shards[0], f), rows):
            sys.exit(f"rank {rank}: field {f} differs")
    if not torch.equal(rngs[0], wrngs[start:stop]):
        sys.exit(f"rank {rank}: srng differs")
    done, rewards = traj[1], traj[2]
    want = {"episodes": int(done.sum()),
            "return_sum": float(rewards[done].sum()), "steps": steps}
    if stats != want or want["episodes"] <= 0:
        sys.exit(f"rank {rank}: stats {stats}, want {want}")
    print(f"RANK_OK {rank} rows [{start}, {stop}) {stats}", flush=True)
finally:
    torch.distributed.destroy_process_group()
"""


def phase11(dev):
    """The sharded path (eldorado_tpu_torch.parallel): a 1-device mesh
    against the unsharded main path, with the rates in turns; four shards
    on the card against their slices, the sharded feed; sharded_rollout,
    ShardedRunner and tests/test_parallel.py's shapes, CUDA against CPU;
    the dry run and the card count; two processes in a gloo group.
    Returns {path: launches by kernel}: the sharded main path's on the
    1-device mesh (a) and over four shards (b), and ShardedRunner's
    sample / step rounds (c), each counted from 0 after its inputs were
    made, and read before anything else ran."""
    import socket
    import torch
    import eldorado_tpu_torch as et
    from eldorado_tpu_torch import stream as S
    from eldorado_tpu_torch.parallel import dryrun_multichip
    from eldorado_tpu_torch.parallel import mesh as M, runner as R
    launches = {}
    steps = CHUNK * N_CHUNKS
    cpu = torch.device("cpu")

    # ---- a: a 1-device mesh == the unsharded main path -----------------
    mesh1 = M.make_mesh(1)
    for exact in (False, True):
        s, r = _main_inputs(dev)
        torch.cuda.synchronize()
        _launch_counts(zero=True)
        want = et.rollout_chunked(s, r, steps, CHUNK, exact=exact)
        torch.cuda.synchronize()
        whole = _launch_counts()
        _launch_counts(zero=True)
        (shards, srngs, *got) = R.sharded_kernel_rollout(
            mesh1, s, r, steps, CHUNK, exact=exact)
        torch.cuda.synchronize()
        counts = _launch_counts()
        expect_equal(f"phase 11a (exact={exact})",
                     _fields(shards[0], srngs[0]), _fields(*want[:2]))
        if list(want[2:]) != got or got[0] <= 0:
            fail(f"phase 11a: episodes / dead steps {got} (sharded) vs "
                 f"{list(want[2:])}")
        sharded = _check_counts(f"phase 11a: sharded main path "
                                f"(exact={exact})", counts, ("K1", "K3", "K2"))
        if counts != whole:
            fail(f"phase 11a: launches {counts} (sharded) vs {whole}")
        if not exact:
            launches["sharded"] = sharded
        what = "episodes and dead steps" if exact else "episodes"
        print(f"phase 11a: 1-device mesh, {N_MAIN} envs x {steps} steps, "
              f"exact={exact}: sharded_kernel_rollout == rollout_chunked on "
              f"every field and srng; {what} {got}; launches as the "
              "unsharded run's")
    mid = want[:2]   # (c) starts from this mid-game state

    def run(fn):
        """``fn`` on fresh main-path inputs: (its result, its wall time,
        the launches it made, counted from 0 after the inputs were made)."""
        s, r = _main_inputs(dev)
        torch.cuda.synchronize()
        _launch_counts(zero=True)
        t0 = time.perf_counter()
        out = fn(s, r)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, _launch_counts()

    unsharded = lambda s, r: et.rollout_chunked(s, r, steps, CHUNK)
    one = lambda s, r: R.sharded_kernel_rollout(mesh1, s, r, steps, CHUNK)
    run(unsharded)
    run(one)   # warm-up
    walls = {"unsharded": [], "sharded": []}
    for name in ("unsharded", "sharded", "sharded", "unsharded") * 2:
        walls[name].append(run(unsharded if name == "unsharded" else one)[1])
    rate = {k: [N_MAIN * steps / w for w in ws] for k, ws in walls.items()}
    print(f"phase 11a: main path unsharded {np.mean(rate['unsharded']):.0f} "
          f"env-steps/s (turns {[round(x) for x in rate['unsharded']]}), "
          f"1-device mesh {np.mean(rate['sharded']):.0f} (turns "
          f"{[round(x) for x in rate['sharded']]}): sharded / unsharded "
          f"{np.mean(rate['sharded']) / np.mean(rate['unsharded']):.4f}")

    # ---- b: four shards on the one card ---------------------------------
    mesh4 = M.make_mesh(devices=[dev] * SHARDS)
    four = lambda s, r: R.sharded_kernel_rollout(mesh4, s, r, steps, CHUNK)
    run(four)   # warm-up
    (shards, srngs, episodes), wall, counts = run(four)
    launches["four_shards"] = _check_counts("phase 11b: 4 shards", counts,
                                            ("K1", "K3", "K2"))
    if counts["K1"] != SHARDS * N_CHUNKS:
        fail(f"phase 11b: K1 launched {counts['K1']} times, not "
             f"{SHARDS} shards x {N_CHUNKS} chunks")
    slices = _check_slices("phase 11b", mesh4, shards, srngs, steps, CHUNK)
    if episodes != slices or episodes <= 0:
        fail(f"phase 11b: episodes {episodes} vs the slices' {slices}")
    print(f"phase 11b: {SHARDS} shards of {N_MAIN // SHARDS} envs on one "
          f"card (queue {et.vec._q_cap(N_MAIN // SHARDS)} each): every shard "
          f"== the unsharded run of its slice on every field and srng; "
          f"episodes {episodes}; {N_MAIN * steps / wall:.0f} env-steps/s "
          f"(unsharded {np.mean(rate['unsharded']):.0f}: "
          f"{N_MAIN * steps / wall / np.mean(rate['unsharded']):.4f})")
    for record in ("compact", "full"):
        shards, srngs, episodes, rows = R.sharded_stream_rollout(
            mesh4, *_main_inputs(dev), steps, CHUNK, record=record)
        folds = []
        for d, a, b in M.env_sharding(mesh4, N_MAIN):
            folds.append(S.stream_rollout(
                *_main_inputs(d, b - a, 12345 + a, 42 + a), steps, CHUNK,
                deliver="device", record=record)[3])
        for k, row in enumerate(rows):
            want = sum(f[k].double() for f in folds)
            if not torch.equal(row.double().sum(0), want):
                fail(f"phase 11b: the {record} fold's carry {k} differs "
                     "from the slices' sum")
        print(f"phase 11b: sharded_stream_rollout ({record} records, the "
              f"default fold) over the {SHARDS} shards: the rows' sum == "
              f"the sum of the slices' folds; episodes {episodes}, "
              f"{int(rows[0].sum())} env-steps folded")

    # ---- c: sharded_rollout, ShardedRunner, the JAX tests' shapes -------
    _launch_counts(zero=True)
    shards, srngs, stats = R.sharded_rollout(mesh1, *mid, SR_STEPS)
    counts = _launch_counts()
    want = et.rollout(*mid, SR_STEPS, auto_reset="step")
    expect_equal("phase 11c (sharded_rollout)", _fields(shards[0], srngs[0]),
                 _fields(*want[:2]))
    done, rewards = want[2][1], want[2][2]
    need = {"episodes": int(done.sum()),
            "return_sum": float(rewards[done].sum()), "steps": SR_STEPS}
    if stats != need:
        fail(f"phase 11c: sharded_rollout's stats {stats}, want {need}")
    _check_counts("phase 11c: sharded_rollout", counts,
                  ("K1", "K3", "K2") if stats["episodes"] else ("K1",))
    print(f"phase 11c: sharded_rollout {N_MAIN} envs x {SR_STEPS} steps from "
          f"(a)'s state == rollout(auto_reset='step') on every field and "
          f"srng; stats {stats}")

    # the runner's rounds alone, counted; then VecEnv replays them
    runner = R.ShardedRunner(mesh4, N_MAIN)
    runner.reset(seed=12345, max_steps=RUNNER_TURNS)
    torch.cuda.synchronize()
    _launch_counts(zero=True)
    rounds = []
    for t in range(RUNNER_ROUNDS):
        acts = torch.cat(runner.sample())
        rounds.append((acts, torch.cat(runner.step_sync())))
    counts = _launch_counts()
    launches["sharded_runner"] = _check_counts(
        "phase 11c: ShardedRunner's rounds", counts,
        ("K1-act", "K1-sample", "K3", "K2"))
    if not counts["K1-act"] == counts["K1-sample"] == SHARDS * RUNNER_ROUNDS:
        fail(f"phase 11c: K1-act / K1-sample launched {counts}, not "
             f"{SHARDS} shards x {RUNNER_ROUNDS} rounds each")
    env = et.VecEnv(N_MAIN, device=dev)
    env.reset(seed=12345, max_steps=RUNNER_TURNS)
    finished = 0
    for t, (acts, done) in enumerate(rounds):
        if not torch.equal(acts, env.sample()):
            fail(f"phase 11c: ShardedRunner's actions differ at round {t}")
        finished += int(env.step(acts).sum())
        if not torch.equal(done, env.dones) or bool(done.any()):
            fail(f"phase 11c: ShardedRunner.step's done at round {t}")
    expect_equal("phase 11c (ShardedRunner)",
                 _fields(M.unshard_envs(runner.states),
                         M.unshard_envs(runner.sampler_rngs)),
                 _fields(env.states, env.sampler_rngs))
    if finished <= 0:
        fail("phase 11c: no game ended in the runner's rounds")
    print(f"phase 11c: ShardedRunner ({SHARDS} shards on the card) == VecEnv "
          f"over {RUNNER_ROUNDS} sample / step rounds of "
          f"{RUNNER_TURNS}-turn games ({finished} finished): actions, "
          "step()'s done after the reset, every field and srng")

    n, small_steps, chunk, turns = SMALL
    res = []   # the card's runs, then the CPU's
    for d in (dev, cpu):
        m4 = M.make_mesh(devices=[d] * 4)
        args = (et.vec_reset(5, n, 4, 2, 0, turns, device=d),
                et.sampler_init(11, n, device=d), small_steps)
        out = [R.sharded_kernel_rollout(m4, *args, chunk, exact=x)
               for x in (False, True)]
        out.append(R.sharded_stream_rollout(m4, *args, chunk))
        nr, rsteps, rturns = SMALL_ROLL
        out.append(R.sharded_rollout(
            M.make_mesh(devices=[d] * 8),
            et.vec_reset(5, nr, 4, 2, 0, rturns, device=d),
            et.sampler_init(11, nr, device=d), rsteps))
        res.append(out)
    for what, a, b in zip(("kernel", "exact", "feed", "sharded_rollout"),
                          *res):
        expect_equal(f"phase 11c ({what}, CUDA vs CPU)",
                     _fields(M.unshard_envs(a[0]), M.unshard_envs(a[1])),
                     _fields(M.unshard_envs(b[0], dev),
                             M.unshard_envs(b[1], dev)))
        extra_a, extra_b = a[2:], b[2:]
        if what == "feed":
            extra_a = (a[2], [t.cpu() for t in a[3]])
            extra_b = (b[2], list(b[3]))
            same = extra_a[0] == extra_b[0] and all(
                torch.equal(x, y) for x, y in zip(extra_a[1], extra_b[1]))
        else:
            same = extra_a == extra_b
        if not same:
            fail(f"phase 11c ({what}): {extra_a} (cuda) vs {extra_b}")
    print(f"phase 11c: tests/test_parallel.py's shapes ({n} envs over 4 "
          f"shards, {small_steps} steps, chunk {chunk}, {turns}-turn games; "
          f"sharded_rollout {SMALL_ROLL[0]} over 8): kernel, exact, feed and "
          "lockstep rollout CUDA == CPU on every field, srng, episode, dead "
          f"step and fold; episodes {res[0][0][2]}, dead steps "
          f"{res[0][1][3]}, stats {res[0][3][2]}")

    # ---- d: the dry run, the card count ---------------------------------
    t0 = time.perf_counter()
    dryrun_multichip(4)
    cards = torch.cuda.device_count()
    print(f"phase 11d: dryrun_multichip(4) passed "
          f"({time.perf_counter() - t0:.1f} s); torch sees {cards} CUDA "
          "device(s)")
    if cards > 1:
        mesh = M.make_mesh()
        shards, srngs, episodes = R.sharded_kernel_rollout(
            mesh, *_main_inputs(dev), steps, CHUNK)
        slices = _check_slices("phase 11d", mesh, shards, srngs, steps, CHUNK)
        if episodes != slices:
            fail(f"phase 11d: episodes {episodes} vs the slices' {slices}")
        print(f"phase 11d: the main path over all {cards} cards: every "
              "shard == the unsharded run of its slice")

    # ---- e: two processes on the card, gloo ----------------------------
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env_vars = {k: v for k, v in os.environ.items()
                if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    env_vars["PYTHONPATH"] = str(ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_WORKER, str(port), str(rank), str(dev),
         str(GLOO_N), str(GLOO_STEPS), str(GLOO_TURNS)], cwd=ROOT,
        env=env_vars, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for rank in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode != 0 or f"RANK_OK {rank}" not in out:
            fail(f"phase 11e: rank {rank} exited {proc.returncode}:\n{out}")
        line = [x for x in out.splitlines() if x.startswith("RANK_OK")][0]
        print(f"phase 11e: {line}")
    print(f"phase 11e: two processes on {torch.cuda.get_device_name(0)} in a "
          f"gloo group: each built only its {GLOO_N // 2} rows, ran "
          f"{GLOO_STEPS} steps of sharded_rollout and matched one process's "
          f"run of the whole batch, rows and all-reduced stats "
          f"({time.perf_counter() - t0:.1f} s)")
    return launches


if __name__ == "__main__":
    main()
