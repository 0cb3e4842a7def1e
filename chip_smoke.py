"""Drive the PyTorch / CUDA port's main path on one GPU and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the kernels from eldorado_tpu_torch/csrc, then runs these
phases, printing a line for each; any mismatch or exception exits non-zero
before the final line:

0. the device, the card's name and power limit (nvidia-smi), versions and
   the kernel build time;
1. map generation on the card against the oracle goldens;
2. K2 (fused_reset) against its plain version: vec_reset at 4096 envs,
   then one reset queue of 128 envs;
3. K1 (fused_step) against its plain version: 1024 envs, 64 steps, with
   the storage mask, the sel mask, and gate_dead;
4. the slice, CUDA against CPU: rollout_chunked at 512 envs;
5. the main path at full size: vec_reset(12345, 4096, 4, 3, EASY,
   max_steps=100000) and rollout_chunked over 3 chunks of 1500 steps
   (and once with exact=True), timed; then K1 against its plain version
   on the 4096-env mid-game carry over a 200-step window in which games
   end by a win; kernel times beside their plain versions and bounds;
   K1's launch shape (threads, blocks, shared bytes per block, blocks
   resident per SM) and its ms per step at 8192 and 16384 envs;
6. K1's cost probes on the carry phase 5 leaves: K1-null, P1 (null
   copy), P2 (op chain, nine shapes, both ops, k=4096) and P3 (step
   prefix, cuts 0-3 over 8 steps) against their plain versions, then the
   probe path: the measurements of the four eldorado_tpu_torch.tools
   modules at short step counts, printed as the tools print them;
7. the learner feed (stream.py): (a) K1 with compact and with full
   records against the records of phase 3's and phase 5's plain runs,
   and K1's ms per step with and without records; (b) stream_rollout
   (full records, ring) CUDA against CPU at 128 envs with resets, and an
   ObsReconstructor driven by the CUDA feed against the CUDA final state;
   (c) the feed at full width, timed, with the launch counts zeroed just
   before it: from vec_reset(12345, 4096, 4, 3, EASY, 100000), 3 chunks
   of 1500 steps through the compact ring, device delivery, the
   compressed ring and exact mode, then one chunk of full records
   through a small ring.

Every kernel's record carries its bound: the least time the card could
take for the same work, the larger of the bytes it must move over HBM's
3.35 TB/s and the time its instructions need on the units that execute
them, at 1.98 GHz (the clock of the data sheet's peak rates) on every SM:
integer instructions on the SM's 64 int32 lanes, loads and stores on its
32 load/store units, and all of them through its 4 x 32 issue slots,
whichever takes longest. The instructions of K1, K1-null, K2 and P3 are
counted by kind by a profiling build run on the timed inputs
(eldorado_tpu_torch/tools/inst_count.py: PTX instructions per thread;
phase 5 sets K1's static SASS count beside its PTX count); P1 does no
arithmetic; P2's are its k ops per element. P1 and K1-null are timed
with the L2 evicted before each launch, so that their bytes come from
HBM as their bound assumes. For P1 it also times one PyTorch call that
computes the same function (``dst.copy_(src)``), the same way; no single
call computes the others.

The line before last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Nothing here imports jax.
"""
from __future__ import annotations

import json
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


def k1_bound(c, srng, static, steps: int, dead: int, record=None) -> tuple:
    """K1's bound per step for ``steps`` steps from carry ``c`` (``dead``
    of them dead steps), and its PTX instructions per env-step, in all
    and by kind."""
    from eldorado_tpu_torch import stream as S
    from eldorado_tpu_torch.tools import inst_count as IC
    n = c.shape[1]
    words = 0 if record is None else S.RECORD_WIDTH[record]
    ops = IC.count_k1(c, srng, static, steps, record=record)
    ms, by = bound(k1_bytes(n, steps, n * steps - dead, words), ops)
    return (ms / steps, by, sum(ops.values()) / (n * steps),
            per_kind(ops, n * steps))


def cuda_ms(fn, reps: int = 1):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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
    from eldorado_tpu_torch.core.mapgen import generate_map
    from eldorado_tpu_torch.ops import build, rng as R
    from eldorado_tpu_torch.ops import step_kernel as K
    from eldorado_tpu_torch import stream as S
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

    # ---- phase 1: mapgen against the oracle goldens -------------------
    for gname, n_pieces, diff in (("mapgen_easy", 3, 0),
                                  ("mapgen_hard", 3, 2),
                                  ("mapgen_throw_easy4", 4, 0)):
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
        print(f"phase 1: {gname}: {len(good)} seeds, {int(good.sum())} maps "
              "equal to the golden")

    # ---- phase 2: K2 against its plain version ------------------------
    s0 = E.make_state(torch.arange(12345, 12345 + N_MAIN, device=dev),
                      4, 3, 0, 100000)
    carry0 = E.pack_dyn(E.split_state(s0)[1])
    gen, pxy, (req, nr, end) = E.reset_map_prelude(
        s0.rng, s0.n_pieces, s0.difficulty, s0.n_players)
    k2 = K.fused_reset(carry0, s0.n_players, pxy, req, nr, end)
    plain = K.fused_reset_plain(carry0, s0.n_players, pxy, req, nr, end)
    err_k2 = expect_equal("phase 2 (4096)", carry_fields(k2),
                          carry_fields(plain))
    states = et.vec_reset(12345, N_MAIN, 4, 3, 0, 100000, device=dev)
    expect_equal("phase 2 (vec_reset)", carry_fields(k2), {
        f: getattr(states, f) for f in E.DYN_FIELDS})
    print(f"phase 2: K2 == plain reset_body on all {len(E.DYN_FIELDS)} "
          f"fields at {N_MAIN} envs; vec_reset went through K2")
    # one reset queue of Q = 128 mid-game columns
    srng = et.sampler_init(42, N_MAIN, device=dev)
    stepped, _, _ = K.fused_step(k2, srng,
                                 states.map_ids, states.min_xy,
                                 states.n_players, states.max_steps, 200)
    idx = torch.arange(0, N_MAIN, N_MAIN // 128, device=dev)
    cols = stepped[:, idx].contiguous()
    qs = {f: getattr(states, f)[idx] for f in ("n_pieces", "difficulty",
                                               "n_players")}
    _, qxy, (qreq, qnr, qend) = E.reset_map_prelude(
        cols[0], qs["n_pieces"], qs["difficulty"], qs["n_players"])
    q_args = (cols, qs["n_players"], qxy, qreq, qnr, qend)
    err_k2 = max(err_k2, expect_equal(
        "phase 2 (Q=128)", carry_fields(K.fused_reset(*q_args)),
        carry_fields(K.fused_reset_plain(*q_args))))
    print("phase 2: K2 == plain reset_body on a reset queue of 128 "
          "mid-game envs")

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
        k2_before = K.fused_reset.launches
        s = et.vec_reset(7, 512, 4, 3, 0, 60, device=d)
        out = et.rollout_chunked(s, et.sampler_init(8, 512, device=d),
                                 400, 100)
        res[d.type] = (out, K.fused_reset.launches - k2_before)
    (s_gpu, r_gpu, ep_gpu), k2_gpu = res["cuda"]
    (s_cpu, r_cpu, ep_cpu), k2_cpu = res["cpu"]
    expect_equal("phase 4", dict({f: getattr(s_gpu, f) for f in E.FIELDS},
                                 srng=r_gpu),
                 dict({f: getattr(s_cpu, f) for f in E.FIELDS}, srng=r_cpu))
    if ep_gpu != ep_cpu or ep_gpu <= 0:
        fail(f"phase 4: episodes {ep_gpu} (cuda) vs {ep_cpu} (cpu)")
    if k2_gpu <= 0 or k2_cpu != 0:
        fail(f"phase 4: K2 launches {k2_gpu} (cuda run), {k2_cpu} (cpu)")
    print(f"phase 4: rollout_chunked 512 envs x 400 steps, CUDA == CPU on "
          f"every field and srng; episodes {ep_gpu}; K2 launches {k2_gpu}")

    # ---- phase 5: the main path at full size --------------------------
    K.fused_step.launches = 0
    K.fused_reset.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = et.vec_reset(12345, N_MAIN, 4, 3, 0, 100000, device=dev)
    srng = et.sampler_init(42, N_MAIN, device=dev)
    states, srng, ep_warm = et.rollout_chunked(states, srng, CHUNK, CHUNK)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    states, srng, episodes = et.rollout_chunked(states, srng,
                                                CHUNK * N_CHUNKS, CHUNK)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"K1": K.fused_step.launches, "K2": K.fused_reset.launches}
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        fail(f"phase 5: a kernel of the main path did not launch: {launches}")
    rate = N_MAIN * CHUNK * N_CHUNKS / (t2 - t1)
    for f in ("rewards", "resources", "info_returns"):
        if not bool(torch.isfinite(getattr(states, f)).all()):
            fail(f"phase 5: non-finite {f}")
    if bool(states.rng_tainted.any()):
        fail("phase 5: the fast RNG path deviated from the exact stream")
    print(f"phase 5: main path {N_MAIN} envs, {N_CHUNKS} x {CHUNK} steps: "
          f"{rate:.0f} env-steps/s ({t2 - t1:.3f} s; reset + warm-up chunk "
          f"{t1 - t0:.3f} s); episodes {episodes} (+{ep_warm} in warm-up); "
          f"launches K1 {launches['K1']}, K2 {launches['K2']}")
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
    ms_k2, _ = cuda_ms(lambda: K.fused_reset(*q_args), reps=20)
    ms_plain2, _ = cuda_ms(lambda: K.fused_reset_plain(*q_args), reps=2)
    print(f"phase 5: K1 {ms_k1 / CHUNK:.4f} ms/step ({ms_k1:.2f} ms per "
          f"{CHUNK}-step launch); plain step {plain1:.2f} ms/step, "
          f"{N_MAIN} envs")
    print(f"phase 5: K2 {ms_k2:.4f} ms per 128-env queue; plain "
          f"{ms_plain2:.2f} ms")
    k1_share = N_CHUNKS * ms_k1 / 1e3 / (t2 - t1)
    print(f"phase 5: K1 launches are {100 * k1_share:.1f}% of the timed "
          f"main path; the rest is the chunk-boundary resets (mapgen, "
          f"prelude, K2, queue)")
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
    q = q_args[0].shape[1]
    bound_k2, by_k2 = bound(
        q * (2 * E.CARRY_WORDS * 4 + 4 + 32 + 3 * 4 * E.N_BALL * 4),
        IC.count_k2(*q_args))
    print(f"phase 5: K2 bound {bound_k2:.6f} ms per {q}-env queue "
          f"({by_k2}): K2 takes {ms_k2 / bound_k2:.1f}x its bound")
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
         "per": "128-env reset queue"},
    ]
    record["kernels"] += phase6(dev, c, srng, states)
    record["kernels"] += phase7(dev, feed_checks, args, ms_k1 / CHUNK, plain1)
    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
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
    # timed as P1 is
    dst = torch.empty_like(c)
    p1_lib_ms = _timing.cold(lambda: dst.copy_(c), 20, 80, reps=2).per
    # the bounds: K1-null stages each env in and out; P1 copies the carry;
    # P2 is count x k int32 ops, two loads and a store; P3's per-step work
    # from its counted instructions at two step counts
    carry_bytes = 2 * E.CARRY_WORDS * 4 * n
    b_null = bound(carry_bytes + n * (8 + 20),
                   IC.count_k1(c, srng, static, 1, null_body=True))
    b_p1 = bound(carry_bytes)
    b_p2 = bound(3 * 4 * 32 * 512,
                 {"int": 32 * 512 * OP_K, "mem": 3 * 32 * 512, "other": 0})
    p3_200, p3_50 = (IC.count_p3(c, srng, static, s, 3) for s in (200, 50))
    b_p3 = bound(n * E.N_BALL * 4,
                 {k: (p3_200[k] - p3_50[k]) / 150 for k in IC.KINDS})
    for name, ms, (b, by) in (("K1-null", rows_k1["null"].per, b_null),
                              ("P1", row_p1.per, b_p1),
                              ("P2", p2_row["calls"][OP_K].per, b_p2),
                              ("P3 cut 3, per step", rows_p3[3].per, b_p3)):
        print(f"phase 6: {name} bound {b:.6f} ms ({by}): takes "
              f"{ms / b:.2f}x its bound")
    print(f"phase 6: P1's library call dst.copy_(carry) {p1_lib_ms:.5f} ms, "
          f"plain (clone) {p1_plain_ms:.5f} ms, P1 {row_p1.per:.5f} ms, "
          "each with the L2 evicted before every launch")
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
         "ms": row_p1.per, "plain_ms": p1_plain_ms,
         "bound_ms": b_p1[0], "bound_by": b_p1[1], "library_ms": p1_lib_ms,
         "per": f"copy of the ({c.shape[0]}, {n}) carry"},
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
    K.fused_step.record_launches = {r: 0 for r in S.RECORD_WIDTH}
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
    counts = dict(K.fused_step.record_launches, K2=K.fused_reset.launches)
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
          f"K1 full {counts['full']}, K2 {counts['K2']}")
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


if __name__ == "__main__":
    main()
