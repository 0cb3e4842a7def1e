"""Run one cell of the benchmark once and print its result.

    python3 -m cogbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell (an entry of ``workloads`` in
BENCHMARK.json) names a configuration and a traffic mix; the mix names the
driver in ``drivers/`` that runs it on the system under test,
``eldorado_tpu_torch``. ``--seed`` makes every input: env i is seeded with
seed + i and its sampler with seed + 0x9E3779B9 + i (each modulo 2**32),
and plays its game from the configuration (`spec.env_params`: a
configuration with ``levels`` gives each env its own); the system receives
nothing else. A run: set-up (import, library load and
kernel build, the reset at the cell's shapes, the mix's warm-up), the
window of ``--seconds``, with ``--trace 1`` a profiled stretch of the same
work after it, then the check of the window's outputs by the reference
(`check`). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``, the
number compared and its limit, which also close standard error.

Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 2. ``--control <name>`` runs the cell's control in
the system's place (see the drivers) and is for measuring the check; the
control ``level0``, for a configuration with ``levels``, resets the whole
batch at the first level while the check holds each env to its own.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

_T_IMPORT = time.perf_counter()
FORBIDDEN = ("jax", "jaxlib", "flax", "eldorado_tpu")
SEED_GAP = 0x9E3779B9
# controls of every driver's cells (a driver names its own in CONTROLS)
CONTROLS = ("level0",)


def process_age() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) \
            - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Context:
    """What a driver gets: the system, the cell's data, the seeds and the
    clock of set-up. ``config``'s four game keys are the batch's arguments
    (`spec.batch_params`), which the drivers hand to the system's resets
    as they are; `params` is env i's own game, which the check holds it
    to."""

    def __init__(self, torch, et, config, mix, seed, seconds, trace, device,
                 control):
        import numpy as np
        from cogbench import spec
        self.torch, self.et = torch, et
        self.game = config
        if control == "level0":
            config = {**config, "levels": config["levels"][:1]}
        self.config = {**config, **spec.batch_params(config)}
        self.mix = mix
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.control = device, control
        self.cuda = device.startswith("cuda")
        self.env_base = seed & 0xFFFFFFFF
        self.sampler_base = (seed + SEED_GAP) & 0xFFFFFFFF
        self.rng = np.random.default_rng(seed)
        # envs the reference replays: through the checked stretch of the
        # window, and from their seeds through the reset and warm-up
        self.sample = mix["check_envs"]
        self.sample_from_seed = mix["check_envs_from_seed"]
        self.setup_s = None
        self.memory_peak_bytes = 0

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def window_started(self):
        # the set-up's objects leave the collector's generations, so that
        # the window's collections scan only what the window makes
        gc.collect()
        gc.freeze()
        self.setup_s = process_age()

    def read_memory(self):
        if self.cuda:
            self.memory_peak_bytes = int(
                self.torch.cuda.max_memory_allocated())

    def params(self, i: int) -> dict:
        """Env ``i``'s game, as the configuration gives it."""
        from cogbench import spec
        return spec.env_params(self.game, i)

    def from_seed(self, i: int) -> dict:
        """The reference's start for env ``i``: its seeds and parameters."""
        return {"seed": (self.env_base + int(i)) & 0xFFFFFFFF,
                "sampler_seed": (self.sampler_base + int(i)) & 0xFFFFFFFF,
                "params": self.params(i)}


class Run:
    """What a per-layer metric's ``read`` gets."""

    def __init__(self, out: dict, config_name: str, n_envs: int, sms: int,
                 here):
        self.trace = out["trace"]
        self.traced = out["traced"]
        self.counters = out["counters"]
        self.n_envs, self.sms = n_envs, sms
        self.config_name, self.here = config_name, here

    def work(self, kernel: str) -> dict:
        """``kernel``'s frozen work at this cell's configuration."""
        from cogbench import spec
        return spec.work(kernel, self.config_name, self.here)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control=None, overrides=None,
             workers=None, root=None) -> dict:
    """One run of ``workload``; returns the result line's object. The
    command line gives ``device="cuda"`` after finding the card;
    ``overrides`` ({"config": {...}, "mix": {...}}) and ``device="cpu"``
    are for the tests, at sizes a CPU holds."""
    from cogbench import check as C
    from cogbench import spec
    root = root or spec.ROOT
    here = root / "cogbench"
    bench = spec.load_benchmark(root)
    w = spec.cell(bench, workload)
    config = spec.config(bench, w["config"], root)
    mix = spec.mix(w["traffic"], here)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    mix = {**mix, **overrides.get("mix", {})}
    drv = spec.driver(mix["driver"], here)
    if control is not None and control not in drv.CONTROLS + CONTROLS:
        raise SystemExit(f"control {control!r} is not one of "
                         f"{drv.CONTROLS + CONTROLS} for this cell")
    if control == "level0" and not config.get("levels"):
        raise SystemExit("the control level0 needs a configuration with "
                         "levels")

    import torch
    torch.set_num_threads(1)
    import eldorado_tpu_torch as et
    ctx = Context(torch, et, config, mix, seed, seconds, trace, device,
                  control)
    out = drv.run(ctx)

    sms = (torch.cuda.get_device_properties(0).multi_processor_count
           if ctx.cuda else 0)
    e2e, layer = spec.metrics_for(bench, workload)
    metrics = {}
    if trace:
        r = Run(out, w["config"], config["n_envs"], sms, here)
        for m in layer:
            v = spec.metric_reader(m["name"], here)(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {**out["e2e"], "setup_s": ctx.setup_s}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    results = C.run_jobs(out["jobs"], C.default_workers()
                         if workers is None else workers)
    differ = [(j, r) for j, r in zip(out["jobs"], results) if not r["ok"]]
    mismatches = len(differ) + out["stream_mismatches"]
    device_info = {"platform": "gpu" if ctx.cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if ctx.cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": ctx.memory_peak_bytes}
    result = {"correct": mismatches <= C.LIMIT,
              "attempted": out["attempted"], "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace and out["trace"] is not None:
        tr = out["trace"]
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["check"] = {"mismatches": {"value": mismatches,
                                      "limit": C.LIMIT}}
    result["_detail"] = {
        "jobs": len(results), "jobs_differ": len(differ),
        "why": [(j["kind"], j["env"], r["why"]) for j, r in differ][:8],
        **out.get("notes", {}), "window_s": out["window_s"]}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)

    from cogbench import spec
    bench = spec.load_benchmark()
    chips = spec.cell(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cogbench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", args.control)
    found = forbidden_modules()
    if found:
        print(f"cogbench: these modules were loaded: {found}; the benchmark "
              "runs the PyTorch port only: no result", file=sys.stderr)
        return 3
    detail = result.pop("_detail")
    print(json.dumps({"detail": detail}, default=str), file=sys.stderr)
    check = result["check"]
    for name, c in check.items():
        print(f"check: {name} {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
