"""The learner's loop: a policy's actions every step, ``VecEnv`` on the card.

The traffic mix names ``mask_src``, ``warmup_rounds``, ``traced_rounds``
and ``check_rounds``. The batch is ``VecEnv(n).reset(...)`` from the seeds;
a round is ``acts = env.sample(); env.step(acts)`` (the sampler stands in
for the policy; ``step`` reads the kernel's counts back, so a round ends
when the card has stepped, and an env that ended resets within it). The
set-up runs ``warmup_rounds`` rounds; the window runs rounds until
``--seconds`` have passed and the checked stretch of ``check_rounds``
rounds, which starts at a share of the window drawn from the seed, is
complete. The two copies of the batch around that stretch are taken with
the clock stopped.

With ``--trace 1`` the window is followed by ``traced_rounds`` rounds
under the profiler. The control ``modulo`` puts the reference in the
system's place for the checked envs, its sampler reducing each draw
modulo the head's width instead of libstdc++'s downscaling.
"""
from __future__ import annotations

import time

import numpy as np

from cogbench import check as C
from cogbench.trace import Profiled

CONTROLS = ("modulo",)


def run(ctx) -> dict:
    torch, et = ctx.torch, ctx.et
    cfg, mix = ctx.config, ctx.mix
    n = cfg["n_envs"]
    env = et.VecEnv(n, mask_src=mix["mask_src"], device=ctx.device)
    env.reset(seed=ctx.env_base, n_players=cfg["n_players"],
              n_pieces=cfg["n_pieces"], difficulty=cfg["difficulty"],
              max_steps=cfg["max_steps"], sampler_seed=ctx.sampler_base)
    reset = (env.states, env.sampler_rngs.clone())
    for _ in range(mix["warmup_rounds"]):
        env.step(env.sample())
    warm = (env.states, env.sampler_rngs.clone())
    ctx.sync()

    at = ctx.rng.uniform(0.1, 0.5) * ctx.seconds
    check_rounds = mix["check_rounds"]
    seg_in = seg_out = None
    seg_start = None
    times, t_sample, t_step = [], 0.0, 0.0
    paused = 0.0
    ctx.window_started()
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        acts = env.sample()
        b = time.perf_counter()
        env.step(acts)
        c = time.perf_counter()
        times.append(c - a)
        t_sample += b - a
        t_step += c - b
        if seg_in is None and c - t0 - paused >= at:
            seg_in = (env.states, env.sampler_rngs.clone())
            seg_start = len(times)
            paused += time.perf_counter() - c
        elif seg_start is not None and seg_out is None \
                and len(times) - seg_start == check_rounds:
            seg_out = (env.states, env.sampler_rngs.clone())
            paused += time.perf_counter() - c
        if seg_out is not None and \
                time.perf_counter() - t0 - paused >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0 - paused
    ctx.read_memory()

    traced, trace = {}, None
    if ctx.trace:
        ends = []
        with Profiled(torch, ctx.cuda) as prof:
            for _ in range(mix["traced_rounds"]):
                with torch.profiler.record_function("cogbench.sample"):
                    acts = env.sample()
                with torch.profiler.record_function("cogbench.step"):
                    ends.append(env.step(acts).sum())
        trace = prof.trace
        k = mix["traced_rounds"]
        traced = {"env_step": n * k, "live_step": n * k,
                  "env_reset": int(torch.stack(ends).sum())}

    rounds = len(times)
    out = {"window_s": window_s, "attempted": rounds, "trace": trace,
           "traced": traced,
           "e2e": {"learner_steps_per_s": n * rounds / window_s,
                   "learner_round_p95_ms":
                   1e3 * float(np.percentile(np.asarray(times), 95))},
           "counters": {"sample_us": 1e6 * t_sample / rounds,
                        "step_us": 1e6 * t_step / rounds}}

    keys = ("turn_counter", "info_total", "info_returns", "rewards")
    before = {f: getattr(seg_in[0], f).cpu().numpy() for f in keys}
    after = {f: getattr(seg_out[0], f).cpu().numpy() for f in keys}
    ended = C.ended(before, after)
    seg_idx = C.pick(ctx.rng, n, ended, ctx.sample)
    seed_idx = C.pick(ctx.rng, n, [], ctx.sample_from_seed)
    r_in, r_out = seg_in[1].cpu().numpy(), seg_out[1].cpu().numpy()
    off = C.learner_streams_off(r_in, r_out, check_rounds)
    stages = {
        "reset": (C.host_fields(reset[0], seed_idx),
                  reset[1].cpu().numpy()[seed_idx]),
        "warm": (C.host_fields(warm[0], seed_idx),
                 warm[1].cpu().numpy()[seed_idx]),
        "in": (C.host_fields(seg_in[0], seg_idx), r_in[seg_idx]),
        "out": (C.host_fields(seg_out[0], seg_idx), r_out[seg_idx]),
    }
    del env, reset, warm, seg_in, seg_out
    jobs = []
    for k, i in enumerate(seed_idx):
        start = ctx.from_seed(i)
        jobs.append({"kind": "reset", "env": i, **start,
                     "want": stages["reset"][0][k],
                     "want_sampler": int(stages["reset"][1][k])})
        jobs.append({"kind": "play", "env": i,
                     "params": start["params"], "start": start,
                     "steps": mix["warmup_rounds"], "exact_steps": True,
                     "want": stages["warm"][0][k],
                     "want_sampler": int(stages["warm"][1][k])})
    for k, i in enumerate(seg_idx):
        jobs.append({"kind": "play", "env": i, "params": ctx.params(i),
                     "start": {"fields": stages["in"][0][k],
                               "sampler": int(stages["in"][1][k])},
                     "steps": check_rounds, "exact_steps": True,
                     "want": stages["out"][0][k],
                     "want_sampler": int(stages["out"][1][k]),
                     "control": ctx.control})
    out["jobs"] = jobs
    out["stream_mismatches"] = off
    ends = np.cumsum(times)
    out["notes"] = {"segment_envs": len(seg_idx),
                    "segment_envs_ended": int(ended[seg_idx].sum()),
                    "streams_off": off,
                    "per_second": np.bincount(ends.astype(int)).tolist()}
    return out
