"""Count the kernels' work once, at a configuration's inputs, and write
its frozen work files ``work/<kernel>/<config>.json`` that the roofline
metrics read (`roofline`).

    python3 -m cogbench.count_work --config NAME [--config NAME ...]
        [--out DIR]

Needs the card (the instructions are counted by the system's profiling
build, ``eldorado_tpu_torch.tools.inst_count``: PTX instructions by kind,
executed on the inputs given). It counts the configurations named, and
writes their files alone: no other configuration's file is opened. A
configuration is counted for the kernels its cells' mixes run: K1, K3 and
K2 where a cell runs a self-play mix, K1-act where one runs a learner mix.
The batch is reset from seed 12345 (sampler 42) with the configuration's
per-env game arguments (`spec.batch_params`). K1 runs on the carry after
one call of the self-play mix, for one chunk of that mix (exact mode);
K1-act on the learner mix's state after its warm-up rounds, with sampled
actions; K3 and K2 (their work: the per-env code one thread per env) on
128 envs of the self-play carry, spread over the batch (`queue_envs`):
for a configuration without levels every (n_envs / 128)-th env from env
0; with levels, each level's share of the 128 (128 / levels, the first
128 % levels levels one more), spread evenly over that level's envs, so
that each level is counted however its count divides the stride. The
bytes are the shapes': `roofline.k1_bytes` and `roofline.k2_moved_bytes`
(at the counted envs' own player counts), each input word read once and
each output word written once. The benchmark's runs never call this; it
is kept to show how the counts were made.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from cogbench import roofline, spec

QUEUE = 128
SEED, SAMPLER_SEED = 12345, 42
# the kernels a cell's mix runs, by the mix's driver
KERNELS = {"selfplay": ("k1", "k3", "k2"), "learner": ("k1act",)}


def _per(ops: dict, units: int) -> dict:
    return {k: v / units for k, v in ops.items()}


def queue_envs(cfg: dict) -> list:
    """The ``QUEUE`` envs whose resets K3's and K2's work is counted on,
    in order (see the module's docstring)."""
    n = cfg["n_envs"]
    levels = len(cfg.get("levels") or [])
    if not levels:
        return list(range(0, n, n // QUEUE))[:QUEUE]
    out = []
    for lv in range(levels):
        envs = range(lv, n, levels)
        share = QUEUE // levels + (lv < QUEUE % levels)
        out += [envs[k * len(envs) // share] for k in range(share)]
    return sorted(out)


def k2_bytes_per_unit(cfg: dict, envs: list) -> float:
    """K2's bytes an env reset: `roofline.k2_moved_bytes` at the player
    counts of the counted ``envs``, over their number (a whole number
    where it divides)."""
    b = roofline.k2_moved_bytes(
        [spec.env_params(cfg, i)["n_players"] for i in envs], in_place=True)
    return b // len(envs) if b % len(envs) == 0 else b / len(envs)


def _how(card: str, n: int) -> str:
    return (f"tools/inst_count.py on {card}: PTX instructions by kind, "
            f"executed; the batch from seed {SEED} (sampler {SAMPLER_SEED}),"
            f" {n} envs")


def _selfplay(cfg: dict, mix: dict, card: str) -> dict:
    import torch
    import eldorado_tpu_torch as et
    from eldorado_tpu_torch import vec
    from eldorado_tpu_torch.core import engine as E
    from eldorado_tpu_torch.core import mapgen as MG
    from eldorado_tpu_torch.tools import inst_count as IC
    n, game = cfg["n_envs"], spec.batch_params(cfg)
    chunk = mix["chunk"]
    steps = (mix["steps_per_call"] // chunk) * chunk
    s = et.vec_reset(SEED, n, *(game[k] for k in spec.GAME))
    r = et.sampler_init(SAMPLER_SEED, n)
    s, r, _, _ = et.rollout_chunked(s, r, steps, chunk, exact=True)
    static, carry = vec._split(s)
    ops_k1 = IC.count_k1(carry, r, vec._params(static), chunk,
                         gate_dead=True)

    envs = queue_envs(cfg)
    idx = torch.tensor(envs, device=carry.device, dtype=torch.int32)
    rng_row = vec._OFF["rng"]
    maps = tuple(static[f].clone() for f in vec._MAP_FIELDS)
    pxy, ball = E.reset_map_prelude_rows(
        carry[rng_row], static["n_pieces"], static["difficulty"],
        static["n_players"], idx, maps)
    ops_k3 = IC.count_k3_work(carry[rng_row], static["n_pieces"],
                              static["difficulty"], static["n_players"], idx)
    ops_k2 = IC.count_k2_work(carry, static["n_players"], pxy, *ball,
                              idx=idx)
    ovl_bytes = MG._K(carry.device).ovl.numel() * 4
    queue_out = 8 * 4 + 3 * 4 * 19 * 4
    how = (f"{_how(card, n)}, after one {steps}-step exact call at chunk "
           f"{chunk}")
    return {
        "k1": {"kernel": "K1", "trace_name": "fused_step_kernel",
               "unit": "env_step",
               "ops_per_unit": _per(ops_k1, n * chunk),
               "bytes": {"per_env_launch": roofline.k1_bytes(1, 0, 0),
                         "per_live_unit": 19 * 4,
                         "live_cap_per_env": 2304 * 4},
               "counted": f"{how}; one {chunk}-step launch, exact mode"},
        "k3": {"kernel": "K3", "trace_name": "generate_map_kernel",
               "unit": "env_reset",
               "ops_per_unit": _per(ops_k3, QUEUE),
               "bytes": {"per_launch": ovl_bytes,
                         "per_unit": 5 * 4 + 2304 * 4 + 8 + 2 + queue_out},
               "counted": f"{how}; its work (one thread per env, "
                          f"mapgen_work.cu) on {QUEUE} envs spread over "
                          "the batch"},
        "k2": {"kernel": "K2", "trace_name": "fused_reset_kernel",
               "unit": "env_reset",
               "ops_per_unit": _per(ops_k2, QUEUE),
               "bytes": {"per_unit": k2_bytes_per_unit(cfg, envs)},
               "counted": f"{how}; its work in place (one thread per env, "
                          f"reset_work.cu) on {QUEUE} envs spread over the "
                          "batch"},
    }


def _learner(cfg: dict, mix: dict, card: str) -> dict:
    import eldorado_tpu_torch as et
    from eldorado_tpu_torch import vec
    from eldorado_tpu_torch.tools import inst_count as IC
    n = cfg["n_envs"]
    env = et.VecEnv(n)
    env.reset(seed=SEED, **spec.batch_params(cfg),
              sampler_seed=SAMPLER_SEED)
    for _ in range(mix["warmup_rounds"]):
        env.step(env.sample())
    acts = env.sample()
    static, carry = vec._split(env.states)
    ops_act = IC.count_k1_act(carry, acts, vec._params(static))
    return {
        "k1act": {"kernel": "K1-act", "trace_name": "step_actions_kernel",
                  "unit": "env_step",
                  "ops_per_unit": _per(ops_act, n),
                  "bytes": {"per_launch": 12,
                            "per_env_launch": 2 * 570 * 4 + 20 + 16,
                            "per_live_unit": 19 * 4,
                            "live_cap_per_env": 2304 * 4},
                  "counted": f"{_how(card, n)}; VecEnv after "
                             f"{mix['warmup_rounds']} rounds, one step "
                             "of sampled actions"},
    }


def count(cfg: dict, mixes: dict) -> dict:
    """{kernel: its work file's body} for the kernels that ``mixes`` (one
    mix a driver) run, counted on the card."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("count_work: needs a CUDA device")
    card = torch.cuda.get_device_name(0)
    out = {}
    if "selfplay" in mixes:
        out.update(_selfplay(cfg, mixes["selfplay"], card))
    if "learner" in mixes:
        out.update(_learner(cfg, mixes["learner"], card))
    return out


def main(argv=None, root: Path = spec.ROOT):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", action="append", required=True,
                    help="a configuration to count (repeatable)")
    ap.add_argument("--out", default=str(root / "cogbench" / "work"))
    args = ap.parse_args(argv)
    bench = spec.load_benchmark(root)
    for name in args.config:
        cfg = spec.config(bench, name, root)
        mixes = {}
        for w in bench["workloads"]:
            if w["config"] == name:
                m = spec.mix(w["traffic"], root / "cogbench")
                mixes[m["driver"]] = m
        mixes = {d: m for d, m in mixes.items() if d in KERNELS}
        if not mixes:
            raise SystemExit(f"count_work: no cell runs {name!r} under a "
                             f"mix of {sorted(KERNELS)}")
        for kernel, body in count(cfg, mixes).items():
            path = Path(args.out) / kernel / f"{name}.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(body, indent=2) + "\n")
            print(path, json.dumps(body["ops_per_unit"]), flush=True)


if __name__ == "__main__":
    main()
