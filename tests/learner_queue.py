"""VecEnv's reset queue on the device against the host path, round by
round. Imports no jax, so the card tests (tests/test_torch_cuda.py) use it
as well as tests/test_torch_vecenv.py.

Two VecEnvs adopt the same batch and sampler engines. Each round both
sample; one steps by `VecEnv.step` (done envs chosen by `ops.queue.select`
and reset by K3 and K2 on the queue's buffers, or a burst over the
capacity by the host path). The other, the reference, steps either by
`vec._step_columns` on the same device, the host path `vec_step` takes
(`vec._reset_columns` on the done rows in ascending order, `nonzero`'s),
or by `VecEnv.step` on the CPU, where select, K3 and K2 are their plain
versions. The actions, the done flags, the sampler engines and every
field must agree bit for bit after every round.

The games are 100-turn games (gym-eldorado src/tests/test_environment.cpp:
83-103) entered at turns spread over the batch, so that they end spread
over the rounds, as in a batch that has played for a while; a game lasts
~610 env-steps, ~6 a turn.
"""
from __future__ import annotations

import dataclasses

import torch

import eldorado_tpu_torch as et
from eldorado_tpu_torch import vec
from eldorado_tpu_torch.core import engine as E

TURNS = 100
# cogbench/configs/cog-4p-mixed-t100.json: env i plays LEVELS[i % 3]
# (n_pieces, difficulty), EASY/3, MEDIUM/8, HARD/3, 4 players
LEVELS = ((3, 0), (8, 1), (3, 2))


def batch(case: str, n: int, rounds: int, device):
    """A case's batch of ``n`` envs and its sampler engines: "t100" (4
    players, 3 pieces, EASY), "mixed" (`LEVELS`) or "burst" (the t100
    batch with every env but the last 70 done, so that the first step
    ends more games than a queue of 1024 holds). Each live env's game is
    entered at a turn at which it ends within about ``rounds`` rounds."""
    seeds = 5000 + torch.arange(n)
    if case == "mixed":
        pieces = [LEVELS[i % 3][0] for i in range(n)]
        diff = [LEVELS[i % 3][1] for i in range(n)]
    else:
        pieces, diff = 3, 0
    states = et.vec_reset_varied(seeds, 4, pieces, diff, TURNS,
                                 device=device)
    turns = max(1, rounds // 6)
    first = n - 70 if case == "burst" else 0   # the first live env
    i = torch.arange(n, device=device) - first
    tc = TURNS - turns + (i.clamp(min=0) * turns) // (n - first)
    states = dataclasses.replace(states, turn_counter=tc.to(torch.int32),
                                 done=i < 0)
    return states, et.sampler_init(77, n, device=device)


def run(states, srng, rounds: int, ref=None) -> dict:
    """``rounds`` rounds from ``(states, srng)`` of `VecEnv.step` and of
    the reference, held equal after each: with ``ref`` None the host path
    on the batch's device, else a VecEnv on the device ``ref``. Returns
    the rounds that ended games, those whose step ended more than
    min(n, 1024), and how `VecEnv.card_queues` and `.host_queues` moved in
    the first VecEnv's steps."""
    n = states.rng.shape[0]
    card = et.VecEnv(n, device=states.rng.device)
    card._attach(states, srng.clone())
    host = et.VecEnv(n, device=ref or states.rng.device)
    host._attach(states.__class__(**{f: getattr(states, f).to(host.device)
                                     for f in E.FIELDS}),
                 srng.clone().to(host.device))
    ended = bursts = card_queues = host_queues = 0
    for t in range(rounds):
        acts = card.sample()
        assert torch.equal(acts.cpu(), host.sample().cpu()), t
        before = (et.VecEnv.card_queues, et.VecEnv.host_queues)
        done = card.step(acts)
        card_queues += et.VecEnv.card_queues - before[0]
        host_queues += et.VecEnv.host_queues - before[1]
        if ref is None:
            host._carry, want = vec._step_columns(host._carry, host._static,
                                                  acts)
        else:
            want = host.step(acts.to(host.device))
        assert torch.equal(done.cpu(), want.cpu()), t
        assert torch.equal(card.sampler_rngs.cpu(),
                           host.sampler_rngs.cpu()), t
        got, exp = card.states, host.states
        for f in E.FIELDS:
            assert torch.equal(getattr(got, f).cpu(),
                               getattr(exp, f).cpu()), (t, f)
        k = int(done.sum())
        ended += k > 0
        bursts += k > min(n, 1024)
    return {"ended": ended, "bursts": bursts, "card_queues": card_queues,
            "host_queues": host_queues}
