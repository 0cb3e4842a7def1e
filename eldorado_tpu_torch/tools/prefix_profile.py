"""Where K1's time goes, by cutting it short: P3 on the card, the port's
counterpart of tools/tpu_prefix_profile.py.

    python -m eldorado_tpu_torch.tools.prefix_profile [--envs 4096]
        [--s1 200] [--s2 800] [--reps 3]

The TPU tool timed the first K nodes of K1's jaxpr plan. The port has no
plan; `ops.probes.step_prefix` cuts K1 at the boundaries of
``ed::sample_step`` instead: cut 0 stages each env and writes a checksum,
1 also samples the five action heads every step, 2 also reads the agent's
19 ball ids, 3 runs the whole step. Each cut is timed per step by
differencing launches of s1 and s2 steps on the tools' state (see
`_timing.inputs`); the increments between cuts attribute K1's per-step
time to sampling, the ball read and the step body. Below cut 3 the state
does not advance, so every step at cut 2 reads the same cells, from cache:
the ball read's increment understates its cost in K1, where the position
moves. The last line is a JSON object of every number printed. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json

from ..ops import probes as P
from . import _timing


def measure(carry, srng, static, s1: int, s2: int, reps: int = 3,
            cuts=P.CUTS) -> dict:
    """{cut: Slope of step_prefix per step} on the given inputs."""
    return {cut: _timing.differenced(
                lambda s, cut=cut: P.step_prefix(carry, srng, *static, s, cut),
                s1, s2, reps)
            for cut in cuts}


def report(rows: dict) -> list:
    lines, prev = [], None
    for cut, r in rows.items():
        step = r.per * 1e3
        delta = "" if prev is None else f"  (+{step - prev:7.2f})"
        lines.append(f"cut {cut} {P.CUT_NAMES[cut]:6s} per-step {step:8.2f} us"
                     f"{delta}  fixed {r.fixed * 1e3:7.2f} us per launch")
        prev = step
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--s1", type=int, default=200)
    ap.add_argument("--s2", type=int, default=800)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = _timing.require_cuda("prefix_profile")
    print(_timing.card(), flush=True)
    rows = measure(*_timing.inputs(args.envs, dev), args.s1, args.s2,
                   args.reps)
    for line in report(rows):
        print(line, flush=True)
    print(json.dumps({"envs": args.envs, "card": _timing.card(),
                      **{f"cut{c}": r._asdict() for c, r in rows.items()}}))


if __name__ == "__main__":
    main()
