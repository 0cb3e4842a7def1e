"""The harness: BENCHMARK.json against the contract, every cell's files
found by name, the result line's keys, what the run path imports, and the
refusal to run without a card.

The runs here are on the CPU at a few envs (``run_cell`` with
``device="cpu"``: the kernels' plain versions); the command line itself
refuses to run without a card. The test marked ``cuda`` runs a cell on
the card and skips where there is none, deciding inside the test.
"""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cogbench import spec
from cogbench.run import FORBIDDEN, run_cell

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SMALL = {
    "selfplay": {"config": {"n_envs": 12},
                 "mix": {"chunk": 8, "steps_per_call": 32, "traced_calls": 1,
                         "check_envs": 6, "check_envs_from_seed": 3}},
    "learner": {"config": {"n_envs": 12},
                "mix": {"warmup_rounds": 8, "traced_rounds": 4,
                        "check_rounds": 20, "check_envs": 6,
                        "check_envs_from_seed": 3}},
}


def small(cell):
    bench = spec.load_benchmark()
    return SMALL[spec.mix(spec.cell(bench, cell)["traffic"])["driver"]]


def test_benchmark_json_keys_and_names():
    b = spec.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert len(b["command"]) <= 32
    names = [c["name"] for c in b["configs"]] \
        + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_cell_resolves_by_name(cell):
    b = spec.load_benchmark()
    w = spec.cell(b, cell)
    cfg = spec.config(b, w["config"])
    assert cfg["name"] == w["config"]
    drv = spec.driver(spec.mix(w["traffic"])["driver"])
    assert callable(drv.run)
    e2e, layer = spec.metrics_for(b, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    for m in layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in {x["name"] for x in e2e}


# a curriculum batch: env i plays LEVELS[i % 3], each key a level leaves
# out taken from the configuration's top level (levels whose maps never
# failed in millions of generations; HARD with 4 or more pieces fails about
# once a million, in the reference too)
LEVELS = [{}, {"n_pieces": 8, "difficulty": 1},
          {"n_players": 2, "n_pieces": 3, "difficulty": 2}]
ADDED = {"uniform": {"n_players": 2, "n_pieces": 1},
         "levels": {"n_players": 4, "n_pieces": 3, "difficulty": 0,
                    "levels": LEVELS}}


@pytest.mark.parametrize("game", sorted(ADDED))
def test_added_cell_is_found_without_edits(tmp_path, monkeypatch, game):
    """A configuration, a traffic mix, a cell, a per-layer metric and the
    kernels' work counts, added as files and entries in a copy of the
    benchmark, are found and run by the harness; no other file changes.
    The system's reset gets the configuration's values as they are where
    it has no levels, and each env's own where it has; the reference gets
    every checked env's own game, and holds the system to it."""
    import eldorado_tpu_torch as et
    from cogbench import check as C
    shutil.copytree(ROOT / "cogbench", tmp_path / "cogbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "cogbench"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    b = spec.load_benchmark()
    cfg = json.loads((ROOT / "cogbench/configs/cog-4p3pc-easy-t100.json")
                     .read_text())
    cfg.update(name="cog-added-t100", **ADDED[game])
    (here / "configs" / "cog-added-t100.json").write_text(json.dumps(cfg))
    (here / "traffic" / "learner-short-check.json").write_text(json.dumps(
        {**spec.mix("learner-sample-step"), "check_rounds": 30}))
    for k in ("k1act", "k2", "k3"):
        shutil.copy(here / "work" / k / "cog-4p3pc-easy-t100.json",
                    here / "work" / k / "cog-added-t100.json")
    (here / "metrics" / "extra.attempted.py").write_text(
        "def read(run):\n    return 7.0\n")
    b["configs"].append({"name": "cog-added-t100", "source": "a test",
                         "file": "cogbench/configs/cog-added-t100.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "learner.added",
                           "config": "cog-added-t100",
                           "traffic": "learner-short-check", "chips": 1,
                           "why": "a test"})
    for m in b["per_layer"] + b["end_to_end"]:
        if "learner.short-games" in m.get("workloads", []):
            m["workloads"].append("learner.added")
    b["per_layer"].append({"name": "extra.attempted", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "learner surface: vec.VecEnv",
                           "moves": "learner_steps_per_s",
                           "workloads": ["learner.added"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    resets, jobs = [], []
    real_reset, real_jobs = et.VecEnv.reset, C.run_jobs

    def reset(self, **kw):
        resets.append(kw)
        return real_reset(self, **kw)

    def run_jobs(js, workers):
        jobs.extend(js)
        return real_jobs(js, workers)

    monkeypatch.setattr(et.VecEnv, "reset", reset)
    monkeypatch.setattr(C, "run_jobs", run_jobs)
    ov = small("learner.short-games")
    r = run_cell("learner.added", 2**31 + 9, 0.3, True, "cpu",
                 overrides=ov, workers=0, root=tmp_path)
    assert r["correct"]
    assert r["metrics"]["extra.attempted"]["value"] == 7.0
    assert "learner.step_us" in r["metrics"]
    assert all(p.read_bytes() == v for p, v in before.items())

    n = ov["config"]["n_envs"]
    game_of = [spec.env_params(cfg, i) for i in range(n)]
    by_level = {k for lv in cfg.get("levels", []) for k in lv}
    assert len(resets) == 1
    assert {k: resets[0][k] for k in spec.GAME} == {
        k: [g[k] for g in game_of] if k in by_level else cfg[k]
        for k in spec.GAME}
    if game == "levels":
        assert resets[0]["n_pieces"][:4] == [3, 8, 3, 3]
        assert resets[0]["max_steps"] == 100
        assert len({j["env"] % 3 for j in jobs}) == 3
    assert jobs
    for j in jobs:
        assert j["params"] == game_of[j["env"]]
        if "fields" in j.get("start", {}):
            assert int(j["start"]["fields"]["n_pieces"]) \
                == game_of[j["env"]]["n_pieces"]


@pytest.mark.parametrize("cell,trace", [("learner.short-games", True),
                                        ("selfplay.short-games", False)])
def test_result_line_keys(cell, trace):
    r = run_cell(cell, 2**31 + 77, 0.5, trace, "cpu", overrides=small(cell),
                 workers=0)
    r.pop("_detail")
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "check"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "check"}
    assert r["correct"] is True and r["failed"] == 0
    assert r["check"] == {"mismatches": {"value": 0, "limit": 0}}
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    b = spec.load_benchmark()
    e2e, layer = spec.metrics_for(b, cell)
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["metrics"]) <= {m["name"] for m in layer}
    else:
        assert set(r["metrics"]) == {m["name"] for m in e2e}
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"}


def _python(code, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def test_run_path_imports_no_jax():
    """A whole run (on the CPU, a few envs) loads no module whose
    top-level name is jax, jaxlib, flax or eldorado_tpu."""
    code = (
        "import json, sys\n"
        "from cogbench.run import run_cell, forbidden_modules\n"
        "if __name__ == '__main__':\n"
        f"    run_cell('learner.long-games', 5, 0.3, True, 'cpu',\n"
        f"             overrides={small('learner.long-games')!r},\n"
        "             workers=0)\n"
        "    print(json.dumps(forbidden_modules()))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "eldorado_tpu"}


def _children_left_code(body):
    return (
        "import json, os\n"
        "from cogbench.run import run_cell\n"
        "from cogbench import check as C\n"
        "def children():\n"
        "    me, out = str(os.getpid()), []\n"
        "    for d in os.listdir('/proc'):\n"
        "        try:\n"
        "            with open(f'/proc/{d}/stat') as fh:\n"
        "                if fh.read().rsplit(')', 1)[1].split()[1] == me:\n"
        "                    out.append(int(d))\n"
        "        except (OSError, IndexError, ValueError):\n"
        "            pass\n"
        "    return out\n"
        + body)


@pytest.mark.skipif(not os.path.isdir("/proc"), reason="reads /proc")
def test_reference_workers_all_end():
    """The check's worker processes give the in-process answers, and none
    of them, nor any other child, is left once the run returns; a job that
    breaks a worker raises, and leaves none either."""
    body = (
        f"ov = {small('learner.short-games')!r}\n"
        "r = run_cell('learner.short-games', 2**31 + 41, 0.3, False, 'cpu',\n"
        "             overrides=ov, workers=3)\n"
        "left = children()\n"
        "try:\n"
        "    C.run_jobs([{'kind': 'none'}] * 4, 2)\n"
        "    raised = False\n"
        "except Exception:\n"
        "    raised = True\n"
        "print(json.dumps([r['correct'], r['check'], left, raised,\n"
        "                  children()]))\n")
    out = _python(_children_left_code(body))
    assert out.returncode == 0, out.stderr[-2000:]
    correct, check, left, raised, left_after = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert correct is True
    assert check == {"mismatches": {"value": 0, "limit": 0}}
    assert left == [] and left_after == []
    assert raised


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for machines "
                    "without one")
    b = spec.load_benchmark()
    out = subprocess.run(
        [sys.executable, *b["command"][1:], "--workload",
         b["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_command_fails_with_only_the_benchmark(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, the run exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cogbench", tmp_path / "cogbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.load_benchmark()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, *b["command"][1:], "--workload",
         b["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run only on the GPU")
    r = run_cell("learner.long-games", 2**31 + 5, 2.0, False, "cuda")
    assert r["correct"] and r["device"]["platform"] == "gpu"
