"""K1-sample's time per launch on the card, beside the launch floor.

    python -m eldorado_tpu_torch.tools.sample_cost [--envs 4096]
        [--steps 200]

On the tools' state (`_timing.inputs`) taken ``--steps`` K1 steps into
its games, K1-sample (`ops.step_kernel.sample_carry`: the masks read from
the carry, VecEnv.sample's one launch; `ops.step_kernel.sample`: from
(n, 3) mask words) and an empty kernel launched as K1-sample is
(`ops.step_kernel.launch_empty`, the same grid) are each timed as
launches in a row replayed from a CUDA graph, differenced over two
counts (`_timing.differenced`), in two turns (carry, words, empty, then
the reverse), each reading the mean of its two. The last line is a JSON
object of every number printed. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..ops import step_kernel as K
from . import _timing


def measure(srng, carry) -> dict:
    """{"carry", "words", "empty": ms per launch (the mean of two turns),
    and each one's turns} for K1-sample on ``carry``'s storage masks (a
    copy: its rng_tainted row is written in place) and on the same masks
    as words, and the empty kernel at the same width."""
    c = carry.clone()
    words = K.mask_words(carry, "storage")
    n = srng.shape[0]
    launches = {"carry": lambda: K.sample_carry(srng, c),
                "words": lambda: K.sample(srng, words),
                "empty": lambda: K.launch_empty(n, carry.device)}

    def in_a_row(launch):
        def run(k):
            for _ in range(k):
                launch()
        return run
    turns = {name: [] for name in launches}
    for order in (list(launches), list(launches)[::-1]):
        for name in order:
            turns[name].append(_timing.differenced(
                in_a_row(launches[name]), 20, 80, reps=2, graph=True).per)
    out = {name: float(np.mean(t)) for name, t in turns.items()}
    out["turns"] = turns
    return out


def report(row: dict, n: int) -> str:
    return (f"K1-sample at {n} envs, launches in a row: from the carry "
            f"{row['carry']:.5f} ms, from mask words {row['words']:.5f} ms, "
            f"an empty kernel launched the same way {row['empty']:.5f} ms "
            "(each the mean of two turns)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    dev = _timing.require_cuda("sample_cost")
    print(_timing.card(), flush=True)
    carry, srng, static = _timing.inputs(args.envs, dev)
    carry, srng, _ = K.fused_step(carry, srng, *static, args.steps)
    row = measure(srng, carry)
    print(report(row, args.envs))
    print(json.dumps({"card": _timing.card(), "envs": args.envs, **row}))


if __name__ == "__main__":
    main()
