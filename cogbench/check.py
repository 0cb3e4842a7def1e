"""Whether what the timed path produced is correct, by the reference.

The drivers hand over three stages of the system's own outputs (each a
batch of per-env fields with the batch's sampler engines):

* ``reset``: the batch as the system's reset made it from the seeds;
* ``warm``: the batch after the set-up's warm-up, ``warm_steps`` steps
  later (at most that many, in exact self-play, where an ended env waits);
* ``segment``: a stretch of the window drawn from the seed, the batch
  before and after it, ``steps`` steps apart.

The reference (`reference/`) plays sampled envs: from their seeds through
the reset and the warm-up, and from the system's state at the start of the
segment through it (the segment lies millions of steps from the seed, out
of the reference's reach). The sample is drawn from the seed: envs whose
games ended inside the segment, so that the reset queue's choice and the
maps and reset state it made are judged, and envs at random. Every env's
sampler engine is checked too: over the segment it must have drawn what
its steps draw (five draws a step, and a rejected draw now and then), and
in exact self-play the steps the engines mark must add up to the live
steps the system counts. Every stage of a sampled env is also held to the
env's own game as the configuration gives it (`spec.env_params`: its
level, where the configuration has ``levels``).

The one number compared is ``mismatches``: the sampled envs that differ
from the reference at any stage, plus the envs whose engine is off its
steps, plus one if the live steps disagree. Its limit is 0.
"""
from __future__ import annotations

import os
import pickle
import queue
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from .reference import replay
from .reference.state import FIELDS

M, A = 2147483647, 16807
# a sampler draw is rejected about once in 10^8; five in one env within
# one checked stretch does not happen
REJECTS = 4
LIMIT = 0


def host_fields(states, idx) -> list:
    """The fields `reference.state.load` reads of envs ``idx`` of an
    `EnvState`, on the host, one dict per env."""
    import torch
    rows = torch.as_tensor(np.asarray(idx, np.int64),
                           device=states.rng.device)
    cols = {f: getattr(states, f).index_select(0, rows).cpu().numpy()
            for f in FIELDS}
    return [{f: cols[f][k] for f in FIELDS} for k in range(len(idx))]


def ended(before: dict, after: dict) -> np.ndarray:
    """Envs whose game ended between two host snapshots of ``turn_counter``
    and the end-of-game fields (an ended game writes its infos and
    rewards; the reset restarts the turn count)."""
    out = after["turn_counter"] < before["turn_counter"]
    for f in ("info_total", "info_returns", "rewards"):
        a, b = np.asarray(before[f]), np.asarray(after[f])
        out |= (a != b).reshape(a.shape[0], -1).any(1)
    return out


def pick(rng: np.random.Generator, n: int, favoured, k: int) -> list:
    """``k`` envs of ``n`` (all where n <= k): half drawn from
    ``favoured`` where it has them, the rest at random."""
    if n <= k:
        return list(range(n))
    fav = np.flatnonzero(favoured)
    take = list(rng.choice(fav, min(len(fav), k // 2), replace=False)) \
        if len(fav) else []
    rest = np.setdiff1d(np.arange(n), take)
    take += list(rng.choice(rest, k - len(take), replace=False))
    return sorted(int(i) for i in take)


def _pow(k: int) -> int:
    return pow(A, int(k), M)


def draws_between(s_in, s_out, most: int) -> np.ndarray:
    """For each env, the engine draws d in [0, most] with s_out =
    A^d s_in mod M (baby steps and giant steps over the batch), or -1
    where there is none."""
    s_in = np.asarray(s_in, np.int64) & 0xFFFFFFFF
    s_out = np.asarray(s_out, np.int64) & 0xFFFFFFFF
    m = int(np.sqrt(most + 1)) + 1
    inv = pow(A, M - 2, M)
    baby = np.empty((len(s_out), m), np.int64)   # s_out * A^-j
    cur = s_out.copy()
    for j in range(m):
        baby[:, j] = cur
        cur = cur * inv % M
    out = np.full(len(s_in), -1, np.int64)
    giant, cur = _pow(m), s_in.copy()
    for g in range(most // m + 1):
        hit = (baby == cur[:, None]) & (out[:, None] < 0)
        rows, js = np.nonzero(hit)
        d = g * m + js
        ok = d <= most
        out[rows[ok]] = d[ok]
        cur = cur * giant % M
    return out


def learner_streams_off(s_in, s_out, rounds: int) -> int:
    """Envs whose engine did not draw five a round, give or take the rare
    rejected draw, over ``rounds`` rounds."""
    s_in = np.asarray(s_in, np.int64) & 0xFFFFFFFF
    s_out = np.asarray(s_out, np.int64) & 0xFFFFFFFF
    base = s_in * _pow(5 * rounds) % M
    ok = np.zeros(len(s_in), bool)
    for r in range(REJECTS + 1):
        ok |= base == s_out
        base = base * A % M
    return int((~ok).sum())


def selfplay_streams(s_in, s_out, steps: int, live: int) -> tuple:
    """(envs whose engine is off the call's steps, the gap between the
    live steps the engines mark and ``live``, the system's count) for one
    exact self-play call of ``steps`` steps: each env drew five a live
    step, and nothing while it waited."""
    d = draws_between(s_in, s_out, 5 * steps + REJECTS)
    off = (d < 5) | (d // 5 > steps)
    marked = int((d[~off] // 5).sum())
    return int(off.sum()), abs(marked - int(live)) if not off.any() else 0


def run_jobs(jobs: list, workers: int) -> list:
    """`reference.replay.run` over ``jobs``: in ``workers`` worker processes
    (``python3 -m cogbench.check``), each fed one job at a time by a thread
    of this one so that long and short jobs balance; in this process when
    ``workers`` is 0. Every worker has ended, and been waited for, when
    this returns or raises."""
    if workers <= 0 or len(jobs) <= 1:
        return [replay.run(j) for j in jobs]
    root = Path(__file__).resolve().parents[1]
    todo = queue.SimpleQueue()
    for k in range(len(jobs)):
        todo.put(k)
    out = [None] * len(jobs)
    errors = []

    def feed(proc):
        try:
            while True:
                try:
                    k = todo.get_nowait()
                except queue.Empty:
                    return
                pickle.dump(jobs[k], proc.stdin)
                proc.stdin.flush()
                out[k] = pickle.load(proc.stdout)
        except Exception as exc:    # a worker that died: named below
            errors.append(repr(exc))

    procs, threads = [], []
    try:
        for _ in range(min(workers, len(jobs))):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cogbench.check"], cwd=root,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE))
        threads = [threading.Thread(target=feed, args=(p,)) for p in procs]
        for t in threads:
            t.start()
    finally:
        for t in threads:
            t.join()
        for p in procs:
            p.stdin.close()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p.stdout.close()
    missing = sum(r is None for r in out)
    if missing:
        raise RuntimeError(f"{missing} of {len(jobs)} reference jobs got no "
                           f"answer from the workers: {errors}")
    return out


def serve() -> None:
    """A worker's loop: a pickled job in on standard input, its pickled
    result out, until standard input ends. What the job prints goes to
    standard error."""
    inp = sys.stdin.buffer
    res = os.fdopen(os.dup(sys.stdout.fileno()), "wb")
    sys.stdout = sys.stderr
    while True:
        try:
            job = pickle.load(inp)
        except EOFError:
            break
        pickle.dump(replay.run(job), res)
        res.flush()
    res.close()


def default_workers() -> int:
    return max(1, min(8, (os.cpu_count() or 2) - 1))


if __name__ == "__main__":
    serve()
