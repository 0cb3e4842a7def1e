"""Shared timing for the probe tools: CUDA events, step-count differencing,
and the state the tools time the kernels on.

Every tool times the card's kernels as the TPU tools in ``tools/`` did: the
same work at two counts ``s1 < s2`` (steps inside one launch, or launches in
a row), per unit = (t(s2) - t(s1)) / (s2 - s1), which cancels the fixed
cost of each timed call. Launches in a row are captured once into a CUDA
graph and replayed, so the host's Python between launches is not timed;
where a launch's inputs would otherwise stay in the 50 MB L2 from one
launch to the next, `cold` evicts them before each launch. There is no
CPU mode: the tools measure the GPU or refuse to run.
"""
from __future__ import annotations

import subprocess
from typing import Callable, NamedTuple

import torch

from .. import vec
from ..core import engine as E


def inputs(envs: int, device):
    """(carry, srng, (map_ids, min_xy, n_players, max_steps)) of the TPU
    tools' state: vec_reset(123, envs, 4, 3, EASY, 100000) and
    sampler_init(7, envs)."""
    states = vec.vec_reset(123, envs, 4, 3, 0, 100000, device=device)
    carry = E.pack_dyn(E.split_state(states)[1])
    static = (states.map_ids, states.min_xy, states.n_players,
              states.max_steps)
    return carry, vec.sampler_init(7, envs, device=device), static


def require_cuda(tool: str) -> torch.device:
    """The first CUDA device, or a RuntimeError naming the tool."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool}: no CUDA device; this tool times the "
                           "CUDA kernels on the GPU and has no CPU mode")
    return torch.device("cuda", 0)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def event_ms(fn: Callable[[], object]) -> float:
    """Milliseconds of the work ``fn`` enqueues, between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def graphed(fn: Callable[[], object]) -> Callable[[], None]:
    """``fn``'s launches captured once into a CUDA graph; returns replay.
    One call of ``fn`` runs first, outside the capture (warm-up)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


class Slope(NamedTuple):
    """t1, t2: best ms of the s1- and s2-unit calls; per: ms per unit;
    fixed: t1 - s1 * per, the per-call cost the differencing removed."""
    s1: int
    s2: int
    t1: float
    t2: float
    per: float
    fixed: float


def differenced(run: Callable[[int], object], s1: int, s2: int,
                reps: int = 3, graph: bool = False) -> Slope:
    """Time ``run(s)`` (s units of work) at s1 and s2, best of ``reps``
    each after a warm-up, and difference. ``graph``: replay a CUDA graph
    of ``run(s)`` instead of calling it (for launches in a row)."""
    if not 0 < s1 < s2:
        raise ValueError(f"need 0 < s1 < s2, got {s1}, {s2}")
    calls = []
    for s in (s1, s2):
        call = graphed(lambda s=s: run(s)) if graph else (lambda s=s: run(s))
        call()
        calls.append(call)
    t1, t2 = (min(event_ms(call) for _ in range(reps)) for call in calls)
    per = (t2 - t1) / (s2 - s1)
    return Slope(s1, s2, t1, t2, per, t1 - s1 * per)


def cold(launch: Callable[[], object], s1: int, s2: int,
         reps: int = 3, dirty: bool = True) -> Slope:
    """Time per launch of ``launch`` as a caller finds it whose inputs are
    not in the L2 cache: before every launch a sweep of twice the L2's
    bytes evicts whatever the last launch left there. Launches in a row
    (s1 and s2 of them, each after its sweep, replayed from a CUDA graph)
    are differenced as in `differenced`, less the same sweeps alone. With
    ``dirty`` the sweep is a write, which leaves the L2 full of dirty
    lines, so a launch also pays to write back what it evicts; otherwise
    it is a read (a sum), which leaves the L2 clean, so a launch pays for
    its own bytes alone."""
    dev = torch.cuda.current_device()
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    flush = torch.empty(2 * l2 // 4, dtype=torch.int32, device=dev)
    flush.zero_()
    sweep = flush.zero_ if dirty else flush.sum

    def both(s):
        for _ in range(s):
            sweep()
            launch()

    def alone(s):
        for _ in range(s):
            sweep()

    a = differenced(both, s1, s2, reps, graph=True)
    b = differenced(alone, s1, s2, reps, graph=True)
    return Slope(s1, s2, a.t1 - b.t1, a.t2 - b.t2, a.per - b.per,
                 a.fixed - b.fixed)
