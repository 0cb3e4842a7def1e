"""The learner's loop on the card, tree against tree: VecEnv's rate and
where a round's host time goes.

    python -m eldorado_tpu_torch.tools.learner_rate [--trees DIR ...]
        [--envs 4096] [--rounds 1000] [--profiled 20] [--max-steps 100000]
        [--device cuda]

For each checkout of the repo named in ``--trees`` (default: this one),
in turns (the list, then the list reversed: A, B, B, A; ``CYCLES`` times
over, as one tree's turns spread widely on a shared host), a fresh
process imports ``eldorado_tpu_torch`` from that checkout, so that two
commits are compared on the same card in one run. Each process runs
``VecEnv(envs)``'s ``step(sample())`` loop from the main path's reset
(seed 12345, 4 players, 3 pieces, EASY, sampler seed 42) with games of
at most ``--max-steps`` turns (the default, 100000, ends few games in a
run; a few turns end games in most rounds, so that most rounds reset
envs, K3 then K2): 10 rounds to warm up, then ``--rounds`` rounds timed
whole (env-steps/s, and per block of 100 rounds) with each round's time
in ``sample()`` and in ``step()`` read apart on the host's clock
(``step`` reads the counts back, so it waits for the card), the reset
queues launched in them, the card's SM clock read by nvidia-smi before
and after, then ``--profiled`` rounds under ``torch.profiler``: each
operation's host time per round (its self time on the CPU, aten ops and
CUDA runtime calls), the card's busy time per round, and its split into
the learner's kernels (K1-act, K1-sample, K3, K2) and the rest, and the
envs that ended in those rounds. The checkout's own build directory
holds its kernels. Last, for each checkout, the median over its turns of
the rate, the round's, sample()'s and step()'s host time and the card's
busy time and split. The last line is a JSON object of every number
printed. Needs a CUDA device unless ``--device cpu`` (a dry run at a
small ``--envs``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


CYCLES = 3   # times the turns A, B, B, A run

# the learner's kernels, by a part of their names in the profiler's keys
SPLIT = {"K1-act": "step_actions_kernel", "K1-sample": "sample_kernel",
         "K3": "generate_map_kernel", "K2": "fused_reset_kernel"}


def _child(root: str, envs: int, rounds: int, profiled: int,
           max_steps: int, device: str) -> dict:
    """One checkout's numbers (see the module's docstring), in a process
    started on this file, whose own directory leads sys.path."""
    sys.path[0] = root
    import torch
    import eldorado_tpu_torch as et
    from eldorado_tpu_torch.ops import step_kernel as K
    env = et.VecEnv(envs, device=device)
    env.reset(seed=12345, max_steps=max_steps, sampler_seed=42)
    sync = torch.cuda.synchronize if device == "cuda" else lambda: None
    for _ in range(10):
        env.step(env.sample())
    sync()
    clocks = [_sm_clock()]
    resets = K.fused_reset.launches
    t_sample = t_step = 0.0
    t0 = time.perf_counter()
    blocks = []
    for i in range(rounds):
        a = time.perf_counter()
        acts = env.sample()
        b = time.perf_counter()
        env.step(acts)
        t_step += time.perf_counter() - b
        t_sample += b - a
        if i % 100 == 99:
            blocks.append(time.perf_counter())
    sync()
    wall = time.perf_counter() - t0
    resets = K.fused_reset.launches - resets
    clocks.append(_sm_clock())
    blocks = [envs * 100 / (t - s) for s, t in zip([t0] + blocks, blocks)]
    kinds = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        kinds.append(torch.profiler.ProfilerActivity.CUDA)
    dones = []
    with torch.profiler.profile(activities=kinds) as prof:
        for _ in range(profiled):
            with torch.profiler.record_function("round.sample"):
                acts = env.sample()
            with torch.profiler.record_function("round.step"):
                dones.append(env.step(acts))
        sync()
    host, card = {}, {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            card[ev.key] = getattr(ev, "self_device_time_total", None) \
                or getattr(ev, "self_cuda_time_total", 0.0)
            card[ev.key] /= profiled
        elif ev.key.startswith("round."):
            host[ev.key] = ev.cpu_time_total / profiled
        else:
            host[ev.key] = ev.self_cpu_time_total / profiled
    host = dict(sorted(host.items(), key=lambda kv: -kv[1]))
    busy = sum(v for k, v in card.items() if not k.startswith("round."))
    split = {name: sum(v for k, v in card.items() if part in k)
             for name, part in SPLIT.items()}
    split["rest"] = busy - sum(split.values())
    return {"root": root, "envs": envs, "rounds": rounds,
            "max_steps": max_steps, "reset_queues": resets,
            "rate": envs * rounds / wall,
            "round_us": 1e6 * wall / rounds,
            "sample_us": 1e6 * t_sample / rounds,
            "step_us": 1e6 * t_step / rounds,
            "rate_per_100_rounds": blocks, "sm_clock_before_after": clocks,
            "profiled_rounds": profiled,
            "host_us_per_round": host,
            "device_us_per_round": card,
            "device_busy_us_per_round": busy,
            "device_split_us_per_round": split,
            "ended_in_profiled_rounds": int(torch.stack(dones).sum())}


def median(rows: list) -> dict:
    """The median over one checkout's turns of the rate, the round's,
    sample()'s and step()'s host µs, the card's busy µs and its split."""
    def mid(values):
        v = sorted(values)
        return (v[(len(v) - 1) // 2] + v[len(v) // 2]) / 2
    keys = ("rate", "round_us", "sample_us", "step_us",
            "device_busy_us_per_round")
    out = {"turns": len(rows), **{k: mid([r[k] for r in rows]) for k in keys}}
    for name in rows[0]["device_split_us_per_round"]:
        out[f"{name}_us"] = mid([r["device_split_us_per_round"][name]
                                 for r in rows])
    return out


def report(row: dict) -> list:
    lines = [f"{row['root']}: {row['rate']:.0f} env-steps/s at "
             f"{row['envs']} envs, games of {row['max_steps']} turns at "
             f"most, {row['reset_queues']} reset queues in "
             f"{row['rounds']} rounds; a round {row['round_us']:.1f} us "
             f"(sample {row['sample_us']:.1f}, step {row['step_us']:.1f}, "
             f"unprofiled); per 100 rounds "
             f"{[round(r) for r in row['rate_per_100_rounds']]}; SM clock "
             f"before / after {row['sm_clock_before_after']}; under the "
             f"profiler, per round: card busy "
             f"{row['device_busy_us_per_round']:.1f} us ("
             + ", ".join(f"{k} {v:.2f}" for k, v in
                         row["device_split_us_per_round"].items())
             + f"); {row['ended_in_profiled_rounds']} envs ended in the "
             f"{row['profiled_rounds']} profiled rounds"]
    lines += [f"  host {k}: {v:.1f} us"
              for k, v in row["host_us_per_round"].items() if v >= 0.5]
    lines += [f"  device {k}: {v:.2f} us"
              for k, v in row["device_us_per_round"].items()]
    return lines


def _smi(query: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def _card() -> str:
    return _smi("name,power.limit")


def _sm_clock() -> str:
    return _smi("clocks.sm")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+",
                    default=[str(Path(__file__).resolve().parents[2])])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=1000)
    ap.add_argument("--profiled", type=int, default=20)
    ap.add_argument("--max-steps", type=int, default=100000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(_child(args.child, args.envs, args.rounds,
                                args.profiled, args.max_steps, args.device)))
        return
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("learner_rate: no CUDA device; pass --device cpu "
                           "for a dry run")
    print(_card(), flush=True)
    trees = [str(Path(t).resolve()) for t in args.trees]
    rows = []
    for root in (trees + trees[::-1]) * CYCLES:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", root,
             "--envs", str(args.envs), "--rounds", str(args.rounds),
             "--profiled", str(args.profiled), "--max-steps",
             str(args.max_steps), "--device", args.device],
            capture_output=True, text=True, cwd=root, check=False)
        if out.returncode != 0:
            raise RuntimeError(f"learner_rate in {root} failed:\n"
                               f"{out.stderr[-4000:]}")
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        for line in report(rows[-1]):
            print(line, flush=True)
    medians = {root: median([r for r in rows if r["root"] == root])
               for root in trees}
    for root, m in medians.items():
        print(f"{root}: median of {m['turns']} turns: " + ", ".join(
            f"{k} {v:.1f}" for k, v in m.items() if k != "turns"))
    print(json.dumps({"card": _card(), "turns": rows, "medians": medians}))


if __name__ == "__main__":
    main()
