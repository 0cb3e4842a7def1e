"""K3 alone on random engine words at chosen levels: how often a level's
map generation fails, and how often it retries.

    python -m eldorado_tpu_torch.tools.level_screen --level 3,0
        [--level 8,1 ...] [--words 200000000] [--batch 262144] [--seed 0]

For each level (``n_pieces,difficulty``), K3 (`core.mapgen`'s
`launch_generate_map`, with its per-env work buffer) generates maps from
engine words drawn uniformly from [1, 2**31 - 2] by a torch generator on
the card seeded with ``--seed``, ``--batch`` a launch, until at least
``--words`` words. It counts the resets that failed (five nested retries:
the reference's generate_map_failure) and those that overflowed
MAX_PLACED, the trips and retries, and the resets by their number of
retries (the last bin holds 7 and more), and lists the failing words.
``p`` = retries / (resets + retries) is the share of generation attempts
that fail; ``p ** 5`` the failure rate five independent failed attempts in
a row would give. The last line is a JSON object of every number. Needs a
CUDA device; `screen` on a CPU device runs the plain generator instead (a
few hundred words: the tool's own check).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..constants import GRIDSIZE
from ..core import mapgen as MG

_i32 = torch.int32
M = 2 ** 31 - 1
BINS = 8


def _generate(rng, pieces, diff, maps, work) -> None:
    """K3 on CUDA tensors, the plain generator on CPU ones, into ``maps``
    and ``work`` alike."""
    if rng.is_cuda:
        MG.launch_generate_map(rng, pieces, diff, maps, work=work)
        return
    out = MG.generate_map_plain(rng, pieces, diff)
    for t, v in zip(maps, (out.ids, out.min_xy, out.ok, out.overflow)):
        t.copy_(v)
    work.copy_(torch.stack([out.trips, out.retries], 1))


def screen(n_pieces: int, difficulty: int, words: int, batch: int,
           gen: torch.Generator, dev) -> dict:
    """One level's counts over at least ``words`` engine words."""
    def full(v, dtype=_i32):
        return torch.full((batch,), v, dtype=dtype, device=dev)
    maps = (torch.empty((batch, GRIDSIZE * GRIDSIZE), dtype=_i32,
                        device=dev),
            torch.empty((batch, 2), dtype=_i32, device=dev),
            full(False, torch.bool), full(False, torch.bool))
    pieces, diff = full(n_pieces), full(difficulty)
    work = torch.empty((batch, 2), dtype=_i32, device=dev)
    rng = torch.empty(batch, dtype=_i32, device=dev)
    if rng.is_cuda:
        MG.check_launch(rng, pieces, diff, maps, work=work)
    sums = torch.zeros(4, dtype=torch.int64, device=dev)   # trips, retries,
    hist = torch.zeros(BINS, dtype=torch.int64, device=dev)  # fail, over
    most = torch.zeros((), dtype=_i32, device=dev)
    failing = []
    launches = -(-words // batch)
    sync = torch.cuda.synchronize if rng.is_cuda else (lambda dev: None)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(launches):
        torch.randint(1, M, (batch,), generator=gen, device=dev, dtype=_i32,
                      out=rng)
        _generate(rng, pieces, diff, maps, work)
        _, _, ok, over = maps
        failed = ~ok & ~over
        sums += torch.stack([work[:, 0].sum(), work[:, 1].sum(),
                             failed.sum(), over.sum()])
        hist += torch.bincount(work[:, 1].clamp(max=BINS - 1),
                               minlength=BINS)
        torch.maximum(most, work[:, 0].max(), out=most)
        if len(failing) < 64:
            failing += rng[failed].tolist()
    sync(dev)
    seconds = time.perf_counter() - t0
    trips, retries, fails, overflows = sums.tolist()
    resets = launches * batch
    p = retries / (resets + retries)
    return {"n_pieces": n_pieces, "difficulty": difficulty,
            "resets": resets, "failures": fails, "overflows": overflows,
            "failure_rate": fails / resets, "trips": trips,
            "trips_per_reset": trips / resets, "most_trips": int(most),
            "retries": retries, "retries_per_reset": retries / resets,
            "p": p, "p5": p ** 5, "by_retries": hist.tolist(),
            "failing_words": failing[:64], "seconds": seconds}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--level", action="append", required=True,
                    help="n_pieces,difficulty (repeatable)")
    ap.add_argument("--words", type=int, default=200_000_000)
    ap.add_argument("--batch", type=int, default=262_144)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("level_screen: needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    out = {"device": torch.cuda.get_device_name(dev), "levels": []}
    for level in args.level:
        n_pieces, difficulty = (int(x) for x in level.split(","))
        res = screen(n_pieces, difficulty, args.words, args.batch, gen, dev)
        print(f"{n_pieces} pieces, difficulty {difficulty}: "
              f"{res['resets']} resets, {res['failures']} failed, "
              f"{res['retries_per_reset']:.3e} retries a reset, "
              f"p^5 {res['p5']:.3e}, {res['seconds']:.1f} s", flush=True)
        out["levels"].append(res)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
