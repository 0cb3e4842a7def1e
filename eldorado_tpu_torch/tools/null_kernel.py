"""The I/O floor of K1's state on the card: P1, the port's counterpart of
tools/tpu_null_kernel.py.

    python -m eldorado_tpu_torch.tools.null_kernel [--envs 4096]
        [--s1 100] [--s2 400] [--reps 3]

`ops.probes.null_copy` reads and writes every word of K1's (570, envs)
int32 carry once. Launches of it in a row (s1 and s2 of them, replayed
from a CUDA graph, the L2 evicted before each: `_timing.cold`) are
differenced into the time per launch, reported in microseconds and in
GB/s of bytes read plus written. At 4096 envs the carry is 9.3 MB and
would otherwise stay in the 50 MB L2 from one launch to the next. P1 and
the one PyTorch call that computes the same function, ``dst.copy_(carry)``,
are timed after a write of the L2 (dirty lines, written back by the
launch) and after a read of it (clean), each twice in the order P1,
copy_, copy_, P1, so that the two readings of one function show the
method's spread beside the difference between the two. The TPU kernel also read its hoisted
constants; the CUDA kernels keep their tables in __constant__ memory, so
nothing stands for them here. The last line is a JSON object of every
number printed. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import probes as P
from . import _timing


def measure(carry, s1: int, s2: int, reps: int = 3,
            dirty: bool = True) -> _timing.Slope:
    """Slope of null_copy per launch on ``carry``, the L2 cold: swept by a
    write (``dirty``) or by a read."""
    return _timing.cold(lambda: P.null_copy(carry), s1, s2, reps, dirty)


def report(row: _timing.Slope, carry, what: str = "null copy") -> str:
    nbytes = 2 * carry.numel() * carry.element_size()
    return (f"{what} of ({carry.shape[0]}, {carry.shape[1]}) int32: "
            f"{row.per * 1e3:8.2f} us per launch, "
            f"{nbytes / (row.per * 1e-3) / 1e9:7.1f} GB/s read + written "
            f"({nbytes / 1e6:.1f} MB per launch)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--s1", type=int, default=100)
    ap.add_argument("--s2", type=int, default=400)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = _timing.require_cuda("null_kernel")
    print(_timing.card(), flush=True)
    carry = _timing.inputs(args.envs, dev)[0]
    dst = torch.empty_like(carry)
    out = {}
    for dirty in (True, False):
        l2 = "dirty" if dirty else "clean"
        for turn, what in enumerate(("P1", "copy_", "copy_", "P1")):
            name = f"{what} {turn // 2 + 1}, L2 {l2}"
            if what == "P1":
                out[name] = measure(carry, args.s1, args.s2, args.reps, dirty)
            else:
                out[name] = _timing.cold(lambda: dst.copy_(carry), args.s1,
                                         args.s2, args.reps, dirty)
            print(report(out[name], carry, name), flush=True)
    print(json.dumps({"envs": args.envs, "card": _timing.card(),
                      "bytes": 2 * carry.numel() * carry.element_size(),
                      **{k: v._asdict() for k, v in out.items()}}))


if __name__ == "__main__":
    main()
