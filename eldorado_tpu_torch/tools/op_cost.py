"""The cost of one dependent int32 op on the card: P2, the port's
counterpart of tools/tpu_op_cost.py.

    python -m eldorado_tpu_torch.tools.op_cost [--k 4096] [--op add|sel]
        [--s1 100] [--s2 400] [--reps 3] [--shapes 512,8x64,...]

For each operand shape (the TPU tool's nine by default) it times
`ops.probes.op_chain` with 2 and with k dependent ops, per call by
differencing s1 and s2 launches in a row (replayed from a CUDA graph),
and the per-op cost by differencing the two: (call(k) - call(2)) / (k - 2).
One thread runs each element's chain, so the per-op cost is the latency of
one dependent op while the card has few warps, and falls as it fills. K1
is branchy scalar int32 code, one thread per env: the per-op figure is its
unit of cost. Inputs are fresh integers in [1, 1000) from numpy's seed 0.
The last line is a JSON object of every number printed. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import probes as P
from . import _timing

B = 512
SHAPES = ((B,), (1, B), (8, B // 8), (3, B), (21, B), (92, B), (4096,),
          (8, 512), (32, B))


def _calls(shape, ks, op: str, s1: int, s2: int, reps: int) -> dict:
    """{k: Slope of op_chain per call with k ops} on fresh inputs of
    ``shape``."""
    rng = np.random.default_rng(0)
    x, y = (torch.as_tensor(rng.integers(1, 1000, shape), dtype=torch.int32,
                            device="cuda") for _ in range(2))
    per = {}
    for kk in ks:
        def run(s, kk=kk):
            z = x
            for _ in range(s):
                z = P.op_chain(z, y, kk, op)
        per[kk] = _timing.differenced(run, s1, s2, reps, graph=True)
    return per


def measure(shape, k: int, op: str, s1: int, s2: int,
            reps: int = 3) -> dict:
    """{"calls": {2: Slope, k: Slope} of op_chain per call, "per_op": ms
    per op} on fresh inputs of ``shape``."""
    per = _calls(shape, (2, k), op, s1, s2, reps)
    return {"calls": per, "per_op": (per[k].per - per[2].per) / (k - 2)}


def latency(k1: int = 64, k2: int = 4096, op: str = "add", s1: int = 10,
            s2: int = 40, reps: int = 3) -> float:
    """ms per dependent op of a single warp's chain: the slope of
    op_chain's time per call over k, from k1 to k2 ops, on 32 elements
    (one warp, so nothing hides the latency of each op)."""
    per = _calls((32,), (k1, k2), op, s1, s2, reps)
    return (per[k2].per - per[k1].per) / (k2 - k1)


def report(shape, k: int, row: dict) -> str:
    n = int(np.prod(shape))
    call2, callk = row["calls"][2].per, row["calls"][k].per
    per_op = row["per_op"]
    return (f"shape {str(shape):12s} call(2op) {call2 * 1e3:7.2f} us  "
            f"call({k}op) {callk * 1e3:8.2f} us  per-op {per_op * 1e6:6.2f} "
            f"ns  ({n / per_op / 1e6:8.1f} G elem-ops/s, "
            f"{-(-n // 32)} warps)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=4096,
                    choices=[k for k in P.OP_CHAIN_K if k > 2])
    ap.add_argument("--op", default="add", choices=P.OPS)
    ap.add_argument("--s1", type=int, default=100)
    ap.add_argument("--s2", type=int, default=400)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shapes", default="")
    args = ap.parse_args(argv)
    _timing.require_cuda("op_cost")
    shapes = SHAPES
    if args.shapes:
        shapes = [tuple(int(d) for d in s.split("x"))
                  for s in args.shapes.split(",")]
    print(_timing.card(), flush=True)
    out = []
    for shape in shapes:
        row = measure(shape, args.k, args.op, args.s1, args.s2, args.reps)
        print(report(shape, args.k, row), flush=True)
        out.append({"shape": list(shape), "per_op_ms": row["per_op"],
                    **{f"call{kk}": r._asdict()
                       for kk, r in row["calls"].items()}})
    print(json.dumps({"k": args.k, "op": args.op, "card": _timing.card(),
                      "shapes": out}))


if __name__ == "__main__":
    main()
