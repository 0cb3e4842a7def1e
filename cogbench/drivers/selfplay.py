"""Self-play: masked-random rollouts with on-card auto-reset.

The traffic mix names ``chunk`` (steps per K1 launch), ``steps_per_call``
(the steps of one ``rollout_chunked`` call), ``reset_mode``,
``warmup_calls`` and ``traced_calls``. The batch is
``vec_reset`` + ``sampler_init`` from the seeds; the set-up runs
``warmup_calls`` calls; the window runs calls back to back, exact mode,
until the first call that ends after ``--seconds``. The live env-steps
(every env's steps, less the dead steps of envs that ended and wait for
their reset) over the window's time are the cell's throughput.

With ``--trace 1`` the window is followed by ``traced_calls`` calls under
the profiler. The control ``inexact`` runs the window in the system's own
non-exact mode, in which a waiting env draws and dead-steps as if live: it
breaks the exact-mode guarantee the check holds the system to.
"""
from __future__ import annotations

import time

import numpy as np

from cogbench import check as C
from cogbench.trace import Profiled

CONTROLS = ("inexact",)


def run(ctx) -> dict:
    torch, et = ctx.torch, ctx.et
    cfg, mix = ctx.config, ctx.mix
    n, chunk = cfg["n_envs"], mix["chunk"]
    steps = (mix["steps_per_call"] // chunk) * chunk
    exact = ctx.control != "inexact"

    def call(states, srng):
        out = et.rollout_chunked(states, srng, steps, chunk, exact=exact,
                                 reset_mode=mix["reset_mode"])
        if exact:
            return out
        return out + (0,)

    states0 = et.vec_reset(ctx.env_base, n, cfg["n_players"],
                           cfg["n_pieces"], cfg["difficulty"],
                           cfg["max_steps"], device=ctx.device)
    srng0 = et.sampler_init(ctx.sampler_base, n, device=ctx.device)
    states, srng = states0, srng0
    for _ in range(mix["warmup_calls"]):
        states, srng, _, _ = call(states, srng)
    warm = (states, srng)
    ctx.sync()

    # the checked call: the first that starts past a share of the window
    # drawn from the seed
    at = ctx.rng.uniform(0.2, 0.8) * ctx.seconds
    checked = None
    calls = dead_total = 0
    call_ends = []
    ctx.window_started()
    t0 = time.perf_counter()
    while True:
        first = checked is None and time.perf_counter() - t0 >= at
        s_in, r_in = states, srng
        states, srng, eps, dead = call(states, srng)
        calls, dead_total = calls + 1, dead_total + int(dead)
        call_ends.append(time.perf_counter() - t0)
        if first:
            checked = (s_in, r_in, states, srng, int(dead))
        if time.perf_counter() - t0 >= ctx.seconds and checked is not None:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    ctx.read_memory()

    traced, trace = {}, None
    if ctx.trace:
        eps = dead = traced_calls = 0
        with Profiled(torch, ctx.cuda) as prof:
            for _ in range(mix["traced_calls"]):
                with torch.profiler.record_function("cogbench.call"):
                    states, srng, e, d = call(states, srng)
                eps, dead = eps + e, dead + int(d)
                traced_calls += 1
        trace = prof.trace
        traced = {"env_step": n * steps * traced_calls,
                  "live_step": n * steps * traced_calls - dead,
                  "env_reset": eps}

    all_steps = n * steps * calls
    out = {"window_s": window_s, "attempted": calls, "trace": trace,
           "traced": traced,
           "e2e": {"selfplay_live_steps_per_s":
                   (all_steps - dead_total) / window_s},
           "counters": {"dead_share": 100.0 * dead_total / all_steps}}

    # the check's inputs, on the host; then the system's state goes
    s_in, r_in, s_out, r_out, dead_c = checked
    keys = ("turn_counter", "info_total", "info_returns", "rewards")
    before = {f: getattr(s_in, f).cpu().numpy() for f in keys}
    after = {f: getattr(s_out, f).cpu().numpy() for f in keys}
    ended = C.ended(before, after)
    seg_idx = C.pick(ctx.rng, n, ended, ctx.sample)
    seed_idx = C.pick(ctx.rng, n, [], ctx.sample_from_seed)
    r_in_h, r_out_h = r_in.cpu().numpy(), r_out.cpu().numpy()
    off, gap = C.selfplay_streams(r_in_h, r_out_h, steps,
                                  n * steps - dead_c)
    stages = {
        "reset": (C.host_fields(states0, seed_idx),
                  srng0.cpu().numpy()[seed_idx]),
        "warm": (C.host_fields(warm[0], seed_idx),
                 warm[1].cpu().numpy()[seed_idx]),
        "in": (C.host_fields(s_in, seg_idx), r_in_h[seg_idx]),
        "out": (C.host_fields(s_out, seg_idx), r_out_h[seg_idx]),
    }
    del states0, srng0, warm, states, srng, checked, s_in, s_out
    jobs = []
    for k, i in enumerate(seed_idx):
        start = ctx.from_seed(i)
        jobs.append({"kind": "reset", "env": i, **start,
                     "want": stages["reset"][0][k],
                     "want_sampler": int(stages["reset"][1][k])})
        if mix["warmup_calls"]:
            jobs.append({"kind": "play", "env": i,
                         "params": start["params"], "start": start,
                         "steps": mix["warmup_calls"] * steps,
                         "exact_steps": False,
                         "want": stages["warm"][0][k],
                         "want_sampler": int(stages["warm"][1][k])})
    for k, i in enumerate(seg_idx):
        jobs.append({"kind": "play", "env": i, "params": ctx.params(i),
                     "start": {"fields": stages["in"][0][k],
                               "sampler": int(stages["in"][1][k])},
                     "steps": steps, "exact_steps": False,
                     "want": stages["out"][0][k],
                     "want_sampler": int(stages["out"][1][k])})
    out["jobs"] = jobs
    out["stream_mismatches"] = off + (1 if gap else 0)
    out["notes"] = {"segment_envs": len(seg_idx),
                    "segment_envs_ended": int(ended[seg_idx].sum()),
                    "streams_off": off, "live_steps_gap": gap,
                    "checked_call_dead": dead_c,
                    "per_second": np.bincount(
                        np.asarray(call_ends).astype(int)).tolist()}
    return out
