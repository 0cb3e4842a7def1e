"""The benchmark's data, found by name.

`BENCHMARK.json` at the root of the checkout names the cells, their
configurations, traffic mixes and metrics; everything that belongs to one
of them sits in a file of its own under this folder:

* a configuration: ``configs/<config>.json`` (`BENCHMARK.json` gives its
  path as ``file``). Its ``n_players``, ``n_pieces``, ``difficulty`` and
  ``max_steps`` are every env's game, unless it has ``levels``: a list of
  objects, each setting some of those four keys, env ``i`` playing
  ``levels[i % len(levels)]`` and a key a level leaves out taking the
  top-level value (`env_params`, `batch_params`);
* a traffic mix: ``traffic/<mix>.json``, whose ``driver`` names the module
  ``drivers/<driver>.py`` that runs it;
* a per-layer metric: ``metrics/<metric>.py``, whose ``read(run)`` returns
  the metric's value from a traced run, or None where it finds nothing;
* a kernel's frozen work at a configuration's inputs:
  ``work/<kernel>/<config>.json``.

Adding any of them is adding files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# a game's parameters, as a configuration and each of its levels name them
GAME = ("n_players", "n_pieces", "difficulty", "max_steps")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    """The entry of ``workloads`` called ``name``."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are "
                     f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def _levels(cfg: dict) -> list:
    levels = cfg.get("levels") or []
    for lv in levels:
        if not set(lv) <= set(GAME):
            raise SystemExit(f"config {cfg.get('name')!r}: a level sets "
                             f"{sorted(set(lv) - set(GAME))}; a level may "
                             f"set only {list(GAME)}")
    return levels


def _game(cfg: dict, level: dict) -> dict:
    return {k: int(level.get(k, cfg[k])) for k in GAME}


def env_params(cfg: dict, i: int) -> dict:
    """Env ``i``'s game: its four integers of `GAME`."""
    levels = _levels(cfg)
    return _game(cfg, levels[int(i) % len(levels)] if levels else {})


def batch_params(cfg: dict) -> dict:
    """The batch's four game arguments, as the system's resets take them:
    the configuration's value where no level sets the key, else a list of
    every env's (``n_envs`` ints)."""
    levels = _levels(cfg)
    games = [_game(cfg, lv) for lv in levels]
    return {k: [games[i % len(games)][k] for i in range(cfg["n_envs"])]
            if any(k in lv for lv in levels) else cfg[k] for k in GAME}


def mix(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, here: Path = HERE):
    return _module(here / "drivers" / f"{name}.py", f"cogbench_driver_{name}")


def metric_reader(name: str, here: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _module(here / "metrics" / f"{name}.py",
                   f"cogbench_metric_{name}").read


def work(kernel: str, config_name: str, here: Path = HERE) -> dict:
    return json.loads((here / "work" / kernel / f"{config_name}.json")
                      .read_text())


def _reported(metric: dict, cell_name: str, e2e_here: set) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_here


def metrics_for(bench: dict, cell_name: str) -> tuple:
    """(the end-to-end metrics the cell reports, its per-layer metrics):
    a metric with a ``workloads`` list is reported in those cells; an
    end-to-end metric without one in every cell; a per-layer metric
    without one wherever the metric it moves is reported."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reported(m, cell_name, names)]
    return e2e, layer
