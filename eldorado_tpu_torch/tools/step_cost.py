"""Per-step cost of K1 and K1-null on the card: the port's counterpart of
tools/tpu_true_step_cost.py.

    python -m eldorado_tpu_torch.tools.step_cost [--envs 4096] [--s1 200]
        [--s2 800] [--reps 3]

From the main path's state, ``vec_reset(123, envs, 4, 3, EASY, 100000)``
and ``sampler_init(7, envs)``, it times

- ``full``: K1, launches of s1 and s2 steps. One launch runs a whole
  chunk, so the difference is the per-step cost and the intercept
  (``fixed``) is what one launch pays whatever its length: the launch and
  staging the carry in and out;
- ``null``: K1-null (``fused_step(null_body=True)``), which stages every
  env as K1 does and runs no step, so it is timed per launch, s1 and s2
  launches in a row, the L2 evicted before each (`_timing.cold`), as K1
  finds its carry: K1's launch and staging floor.

The TPU tool's ``nogather`` and ``null+gather`` variants timed the XLA
ball gather beside the kernel. In the port the gather happens inside K1,
so they become P3's cuts 1 (sample, no gather) and 2 (sample and gather),
whose rows this tool prints from `prefix_profile`. The last line is a JSON
object of every number printed. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json

from ..ops import step_kernel as K
from . import _timing, prefix_profile


def measure(carry, srng, static, s1: int, s2: int, reps: int = 3) -> dict:
    """{"full": K1 per step, "null": K1-null per launch}, as Slopes."""
    def full(s):
        return K.fused_step(carry, srng, *static, s)

    def null():
        K.fused_step(carry, srng, *static, 1, null_body=True)

    return {"full": _timing.differenced(full, s1, s2, reps),
            "null": _timing.cold(null, s1, s2, reps)}


def report(rows: dict, envs: int) -> list:
    full, null = rows["full"], rows["null"]
    return [
        f"full (K1)     t({full.s1})={full.t1:8.3f} ms  "
        f"t({full.s2})={full.t2:8.3f} ms  per-step {full.per * 1e3:8.2f} us"
        f"  -> {envs / full.per / 1e3:7.2f}M env-steps/s; fixed "
        f"{full.fixed * 1e3:7.2f} us per launch",
        f"null (K1-null) t({null.s1})={null.t1:8.3f} ms  "
        f"t({null.s2})={null.t2:8.3f} ms  per-launch "
        f"{null.per * 1e3:8.2f} us ({null.s1} vs {null.s2} launches in a "
        f"row)",
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--s1", type=int, default=200)
    ap.add_argument("--s2", type=int, default=800)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = _timing.require_cuda("step_cost")
    print(_timing.card(), flush=True)
    carry, srng, static = _timing.inputs(args.envs, dev)
    rows = measure(carry, srng, static, args.s1, args.s2, args.reps)
    for line in report(rows, args.envs):
        print(line, flush=True)
    cuts = prefix_profile.measure(carry, srng, static, args.s1, args.s2,
                                  args.reps, cuts=(1, 2))
    print("nogather -> P3 cut 1 (sample); null+gather -> P3 cut 2 "
          "(sample + ball read):")
    for line in prefix_profile.report(cuts):
        print(line, flush=True)
    print(json.dumps({"envs": args.envs, "card": _timing.card(),
                      **{k: v._asdict() for k, v in rows.items()},
                      **{f"cut{c}": v._asdict() for c, v in cuts.items()}}))


if __name__ == "__main__":
    main()
