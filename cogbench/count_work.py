"""Count the kernels' work once, at each configuration's inputs, and write
the frozen work files ``work/<kernel>/<config>.json`` that the roofline
metrics read (`roofline`).

    python3 -m cogbench.count_work [--out DIR]

Needs the card (the instructions are counted by the system's profiling
build, ``eldorado_tpu_torch.tools.inst_count``: PTX instructions by kind,
executed on the inputs given). For each configuration of BENCHMARK.json:
the batch from seed 12345 (sampler 42) after one call of its self-play
mix; K1 on that carry for one chunk of that mix (exact mode); K1-act on
the learner mix's state after its warm-up rounds, with sampled actions;
K3 and K2 (their work: the per-env code one thread per env) on 128 envs of
the self-play carry, spread over the batch. The bytes are the shapes':
`roofline.k1_bytes` and `roofline.k2_moved_bytes`, each input word read
once and each output word written once. The benchmark's runs never call
this; it is kept to show how the counts were made.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from cogbench import roofline, spec

QUEUE = 128


def _per(ops: dict, units: int) -> dict:
    return {k: v / units for k, v in ops.items()}


def count(config_name: str, cfg: dict, selfplay: dict, learner: dict,
          card: str) -> dict:
    import torch
    import eldorado_tpu_torch as et
    from eldorado_tpu_torch import vec
    from eldorado_tpu_torch.core import engine as E
    from eldorado_tpu_torch.core import mapgen as MG
    from eldorado_tpu_torch.tools import inst_count as IC
    n = cfg["n_envs"]
    args = (cfg["n_players"], cfg["n_pieces"], cfg["difficulty"],
            cfg["max_steps"])
    chunk = selfplay["chunk"]
    steps = (selfplay["steps_per_call"] // chunk) * chunk
    s = et.vec_reset(12345, n, *args)
    r = et.sampler_init(42, n)
    s, r, _, _ = et.rollout_chunked(s, r, steps, chunk, exact=True)
    static, carry = vec._split(s)
    params = vec._params(static)
    ops_k1 = IC.count_k1(carry, r, params, chunk, gate_dead=True)

    env = et.VecEnv(n)
    env.reset(seed=12345, n_players=cfg["n_players"],
              n_pieces=cfg["n_pieces"], difficulty=cfg["difficulty"],
              max_steps=cfg["max_steps"], sampler_seed=42)
    for _ in range(learner["warmup_rounds"]):
        env.step(env.sample())
    acts = env.sample()
    lstatic, lcarry = vec._split(env.states)
    ops_act = IC.count_k1_act(lcarry, acts, vec._params(lstatic))

    idx = torch.arange(0, n, n // QUEUE, device=carry.device,
                       dtype=torch.int32)[:QUEUE]
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
    how = (f"tools/inst_count.py on {card}: PTX instructions by kind, "
           f"executed; the batch from seed 12345 (sampler 42), {n} envs, "
           f"after one {steps}-step exact call at chunk {chunk}")
    return {
        "k1": {"kernel": "K1", "trace_name": "fused_step_kernel",
               "unit": "env_step",
               "ops_per_unit": _per(ops_k1, n * chunk),
               "bytes": {"per_env_launch": roofline.k1_bytes(1, 0, 0),
                         "per_live_unit": 19 * 4,
                         "live_cap_per_env": 2304 * 4},
               "counted": f"{how}; one {chunk}-step launch, exact mode"},
        "k1act": {"kernel": "K1-act", "trace_name": "step_actions_kernel",
                  "unit": "env_step",
                  "ops_per_unit": _per(ops_act, n),
                  "bytes": {"per_launch": 12,
                            "per_env_launch": 2 * 570 * 4 + 20 + 16,
                            "per_live_unit": 19 * 4,
                            "live_cap_per_env": 2304 * 4},
                  "counted": f"{how}; VecEnv after "
                             f"{learner['warmup_rounds']} rounds, one step "
                             "of sampled actions"},
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
               "bytes": {"per_unit": roofline.k2_moved_bytes(
                   [cfg["n_players"]], in_place=True)},
               "counted": f"{how}; its work in place (one thread per env, "
                          f"reset_work.cu) on {QUEUE} envs spread over the "
                          "batch"},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(spec.HERE / "work"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("count_work: needs a CUDA device")
    card = torch.cuda.get_device_name(0)
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        cells = [w for w in bench["workloads"] if w["config"] == c["name"]]
        mixes = {spec.mix(w["traffic"])["driver"]: spec.mix(w["traffic"])
                 for w in cells}
        if "selfplay" not in mixes or "learner" not in mixes:
            continue
        for kernel, body in count(c["name"], cfg, mixes["selfplay"],
                                  mixes["learner"], card).items():
            path = Path(args.out) / kernel / f"{c['name']}.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(body, indent=2) + "\n")
            print(path, json.dumps(body["ops_per_unit"]), flush=True)


if __name__ == "__main__":
    main()
