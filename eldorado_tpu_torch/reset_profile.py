"""Where the main path's time goes on the GPU: a profile of the queued
rollout and the cost of one reset queue, split into K3, K2 and the rest.

    python -m eldorado_tpu_torch.reset_profile

On the main path (vec_reset(12345, 4096, 4, 3, EASY, 100000),
sampler_init(42, 4096), one warm-up chunk of 1500 steps) it

1. runs 2 more chunks of `vec.rollout_chunked` under
   ``torch.profiler`` and prints the profiled wall, the summed device
   time of every kernel (its share of the wall is the device's busy
   share), and K1's, K2's and K3's device time;
2. takes 3 reset queues of 128 envs from the resulting mid-game carry
   and times, on copies of the batch, K3 (map generation and the
   prelude, writing the queue's map rows) and K2 (in place) with CUDA
   events over 20 launches each, enqueued behind a spin of the card so
   that the events time the device alone, and the whole queued reset
   (`vec._reset_columns`: K3, K2 and the queue's flags) between
   ``torch.cuda.synchronize()`` calls; beside them, once per queue, the
   plain generator and prelude on the same rows, the column K3 is
   compared with.

The last line is a JSON object of these numbers. Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from . import vec
from .core import engine as E
from .ops.step_kernel import fused_reset

N, CHUNK, CHUNKS = 4096, 1500, 2   # the main path; chunks profiled
QUEUES, Q = 3, 128                 # reset queues timed, and their width
_KERNELS = {"k1": "fused_step_kernel", "k2": "fused_reset_kernel",
            "k3": "generate_map_kernel"}


def _kernel_times(prof):
    """(summed device time of every kernel, {k1, k2, k3: device time}), in
    ms."""
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _event_ms(fn, reps=20):
    """Device milliseconds per call of ``fn``'s launches: the card spins
    first (about 25 ms), so that all ``reps`` calls are enqueued before it
    starts them and the events time the device, not the host's Python
    between launches that are shorter than it."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this profile measures the GPU")
    dev = torch.device("cuda", 0)
    states = vec.vec_reset(12345, N, 4, 3, 0, 100000, device=dev)
    srng = vec.sampler_init(42, N, device=dev)
    states, srng, _ = vec.rollout_chunked(states, srng, CHUNK, CHUNK)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        states, srng, episodes = vec.rollout_chunked(
            states, srng, CHUNK * CHUNKS, CHUNK)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ms, kern = _kernel_times(prof)
    print(f"profiled {CHUNKS} x {CHUNK} steps at {N} envs: wall "
          f"{wall:.1f} ms, summed device time {dev_ms:.1f} ms "
          f"({100 * dev_ms / wall:.1f}% busy); K1 {kern['k1']:.1f} ms "
          f"({100 * kern['k1'] / dev_ms:.1f}% of device time), K2 "
          f"{kern['k2']:.3f} ms, K3 {kern['k3']:.3f} ms; {episodes} episodes")

    carry = E.pack_dyn(E.split_state(states)[1])
    static = {f: getattr(states, f) for f in E.STATIC_FIELDS}
    maps = [static[f].clone() for f in vec._MAP_FIELDS]
    cols = (carry[0], static["n_pieces"], static["difficulty"],
            static["n_players"])
    rows = {k: [] for k in ("k3", "k2", "queue", "plain")}
    for i in range(QUEUES):
        idx = torch.arange(i, N, N // Q, device=dev, dtype=torch.int32)
        rows["k3"].append(_event_ms(
            lambda: E.reset_map_prelude_rows(*cols, idx, maps)))
        xy, ball = E.reset_map_prelude_rows(*cols, idx, maps)
        c = carry.clone()
        rows["k2"].append(_event_ms(lambda: fused_reset(
            c, static["n_players"], xy, *ball, idx=idx)))
        c, st = carry.clone(), {f: t.clone() for f, t in static.items()}
        rows["queue"].append(_synced_ms(lambda: vec._reset_columns(
            c, st, idx, queue_flags=True)))
        rows["plain"].append(_synced_ms(
            lambda: E.reset_map_prelude_rows_plain(*cols, idx, maps)))
    for k, what in (("k3", "K3"), ("k2", "K2 in place"),
                    ("queue", "the whole queued reset"),
                    ("plain", "plain generator + prelude")):
        print(f"{Q}-env reset queue, {what}: "
              f"{' / '.join(f'{x:.4f}' for x in rows[k])} ms")
    print(json.dumps({"envs": N, "chunk": CHUNK, "chunks": CHUNKS,
                      "wall_ms": wall, "device_ms": dev_ms,
                      "busy": dev_ms / wall,
                      **{f"{k}_ms": v for k, v in kern.items()},
                      "episodes": episodes, "q": Q,
                      **{f"queue_{k}_ms": v for k, v in rows.items()}}))


if __name__ == "__main__":
    main()
