"""Where the main path's time goes on the GPU, and what a reset costs: a
profile of the queued rollout, then K3 and K2 at the reset's shapes, tree
against tree.

    python -m eldorado_tpu_torch.reset_profile [--trees DIR ...]

For each checkout of the repo named in ``--trees`` (default: this one),
in turns (the list, then the list reversed: A, B, B, A), a fresh process
imports ``eldorado_tpu_torch`` from that checkout (its own build
directory holds its kernels), so that two commits are compared on the
same card in one run. On the main path (vec_reset(12345, 4096, 4, 3,
EASY, 100000), sampler_init(42, 4096), one warm-up chunk of 1500 steps)
each process

1. times 3 more chunks of `vec.rollout_chunked` (the main path's rate,
   env-steps/s, between ``torch.cuda.synchronize()`` calls), then runs 2
   more under ``torch.profiler``
   and prints the profiled wall, the summed device time of every kernel
   (its share of the wall is the device's busy share), and K1's, K2's
   and K3's device time;
2. times K3 and K2 at the reset's four shapes: queues of q = 1, 8 and 128
   envs spread over the resulting mid-game batch (K3 writing the queue's
   map rows of a copy of the batch's maps, K2 in place on a copy of the
   carry), and both at 4096 envs into new state (vec_reset's launches:
   new maps, a new carry), each with CUDA events over 20 launches
   enqueued behind a spin of the card, so that the events time the
   device alone; beside K2 at each shape, an empty kernel launched on
   K2's grid (its launch floor); at q = 128 the whole queued reset
   (`vec._reset_columns`: K3, K2 and the queue's flags) between
   ``torch.cuda.synchronize()`` calls and, once, the plain generator and
   prelude on the same rows.

The last line is a JSON object of every number. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

N, CHUNK, CHUNKS = 4096, 1500, 2   # the main path; chunks profiled
TIMED = 3                          # chunks timed for the main path's rate
QUEUES = (1, 8, 128)               # in-place queue widths timed
REPS = 20                          # launches per timing
_KERNELS = {"k1": "fused_step_kernel", "k2": "fused_reset_kernel",
            "k3": "generate_map_kernel"}


def _kernel_times(prof):
    """(summed device time of every kernel, {k1, k2, k3: device time}), in
    ms."""
    import torch
    total, per = 0.0, dict.fromkeys(_KERNELS, 0.0)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        total += ms
        for k, name in _KERNELS.items():
            if name in ev.key:
                per[k] += ms
    return total, per


def _synced_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _event_ms(fn, reps=REPS):
    """Device milliseconds per call of ``fn``'s launches, after one call
    that loads its kernels: the card spins first (about 25 ms), so that
    all ``reps`` calls are enqueued before it starts them and the events
    time the device, not the host's Python between launches that are
    shorter than it."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _k2_floor(K, q, dev, in_place):
    """An empty kernel on K2's grid for q envs: a warp per env, a warp a
    block in place and RESET_ENVS into a new carry; in a checkout before
    that design, a thread per env and 32 a block."""
    if not hasattr(K, "RESET_ENVS"):
        return lambda: K.launch_empty(q, dev)
    envs = 1 if in_place else K.RESET_ENVS
    return lambda: K.launch_empty(32 * q, dev, 32 * envs)


def profile(root: str) -> dict:
    """One checkout's numbers (the module's docstring), in a process whose
    sys.path leads to ``root``."""
    sys.path[0] = root
    import torch
    from eldorado_tpu_torch import vec
    from eldorado_tpu_torch.core import engine as E
    from eldorado_tpu_torch.ops import step_kernel as K
    dev = torch.device("cuda", 0)
    states = vec.vec_reset(12345, N, 4, 3, 0, 100000, device=dev)
    srng = vec.sampler_init(42, N, device=dev)
    states, srng, _ = vec.rollout_chunked(states, srng, CHUNK, CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, srng, _ = vec.rollout_chunked(states, srng, CHUNK * TIMED, CHUNK)
    torch.cuda.synchronize()
    rate = N * CHUNK * TIMED / (time.perf_counter() - t0)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        states, srng, episodes = vec.rollout_chunked(
            states, srng, CHUNK * CHUNKS, CHUNK)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ms, kern = _kernel_times(prof)
    row = {"root": root, "envs": N, "chunk": CHUNK, "rate": rate,
           "chunks": CHUNKS,
           "wall_ms": wall, "device_ms": dev_ms, "busy": dev_ms / wall,
           **{f"{k}_ms": v for k, v in kern.items()}, "episodes": episodes}

    carry = E.pack_dyn(E.split_state(states)[1])
    static = {f: getattr(states, f) for f in E.STATIC_FIELDS}
    maps = [static[f].clone() for f in vec._MAP_FIELDS]
    cols = (carry[0], static["n_pieces"], static["difficulty"],
            static["n_players"])
    shapes = {}
    for q in QUEUES:
        idx = torch.arange(0, N, N // q, device=dev, dtype=torch.int32)
        xy, ball = E.reset_map_prelude_rows(*cols, idx, maps)
        c = carry.clone()
        k2 = (c, static["n_players"], xy, *ball)
        shapes[f"q{q}"] = {
            "k3": _event_ms(lambda: E.reset_map_prelude_rows(*cols, idx,
                                                              maps)),
            "k2": _event_ms(lambda: K.fused_reset(*k2, idx=idx)),
            "k2_floor": _event_ms(_k2_floor(K, q, dev, True))}
        if q == QUEUES[-1]:
            c, st = carry.clone(), {f: t.clone() for f, t in static.items()}
            shapes[f"q{q}"]["queue"] = _synced_ms(lambda: vec._reset_columns(
                c, st, idx, queue_flags=True))
            shapes[f"q{q}"]["plain_k3"] = _synced_ms(
                lambda: E.reset_map_prelude_rows_plain(*cols, idx, maps))
    # vec_reset's launches at full width: new maps, a new carry
    s0 = E.make_state(torch.arange(12345, 12345 + N, device=dev), 4, 3, 0,
                      100000)
    ins = (s0.rng, s0.n_pieces, s0.difficulty, s0.n_players)
    _, xy, ball = E.reset_map_prelude(*ins)
    k2 = (E.pack_dyn(E.split_state(s0)[1]), s0.n_players, xy, *ball)
    shapes[f"new{N}"] = {
        "k3": _event_ms(lambda: E.reset_map_prelude(*ins), reps=5),
        "k2": _event_ms(lambda: K.fused_reset(*k2)),
        "k2_floor": _event_ms(_k2_floor(K, N, dev, False))}
    row["shapes"] = shapes
    return row


def report(row: dict) -> list:
    lines = [f"{row['root']}: main path {row['rate']:.0f} env-steps/s "
             f"({TIMED} x {row['chunk']} steps); profiled {row['chunks']} x "
             f"{row['chunk']} "
             f"steps at {row['envs']} envs: wall {row['wall_ms']:.1f} ms, "
             f"summed device time {row['device_ms']:.1f} ms "
             f"({100 * row['busy']:.1f}% busy); K1 {row['k1_ms']:.1f} ms, "
             f"K2 {row['k2_ms']:.3f} ms, K3 {row['k3_ms']:.3f} ms; "
             f"{row['episodes']} episodes"]
    for name, t in row["shapes"].items():
        what = (f"{name[1:]}-env queue in place" if name.startswith("q")
                else f"{name[3:]} envs into new state")
        lines.append(f"  {what}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + " ms")
    return lines


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+",
                    default=[str(Path(__file__).resolve().parents[1])])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(profile(args.child)))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this profile measures the GPU")
    print(_card(), flush=True)
    trees = [str(Path(t).resolve()) for t in args.trees]
    rows = []
    for root in trees + trees[::-1]:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", root],
            capture_output=True, text=True, cwd=root, check=False)
        if out.returncode != 0:
            raise RuntimeError(f"reset_profile in {root} failed:\n"
                               f"{out.stderr[-4000:]}")
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        for line in report(rows[-1]):
            print(line, flush=True)
    print(json.dumps({"card": _card(), "turns": rows}))


if __name__ == "__main__":
    main()
