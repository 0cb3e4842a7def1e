"""The roofline arithmetic, the frozen work counts and how they are made.

The copied arithmetic reproduces the figures the port's chip checks
published at 4096 envs on 132 SMs: K1's bound of 0.000281 ms a step at
1791 PTX instructions an env-step (1148 integer), and K2's 356,352 bytes
a 128-env in-place queue. Every kernel a cell's roofline metric reads has
a work file for the cell's configuration, with its trace name, unit,
counts and bytes. `count_work` writes the files of the configurations it
is told to count, and no other; the envs it counts K3 and K2 on reach
every level of a configuration with levels.
"""
import json
import shutil
from pathlib import Path

import pytest

from cogbench import count_work as CW
from cogbench import roofline as R
from cogbench import spec
from test_cogbench_harness import LEVELS


def test_k1_bound_reproduces_published_figure():
    n, steps = 4096, 1500
    # PTX instructions an env-step on the main path's carry: 1791 in all,
    # 1148 integer (the memory / other split as counted on the card)
    per = {"int": 1148, "mem": 420, "other": 223}
    assert sum(per.values()) == 1791
    ops = {k: v * n * steps for k, v in per.items()}
    b = R.k1_bytes(n, steps, live=n * steps)
    t, by = R.bound_s(b, ops, sms=132)
    assert by == "operations"
    assert round(t / steps * 1e3, 6) == 0.000281


def test_k2_bytes_reproduce_published_figure():
    assert R.k2_moved_bytes([4] * 128, in_place=True) == 356_352
    # each column in and out, the bound of K2's first design
    assert R.k2_moved_bytes([4] * 4096, in_place=False) > 4096 * 570 * 4


def test_launch_bytes_cap():
    work = {"bytes": {"per_env_launch": 4604, "per_live_unit": 76,
                      "live_cap_per_env": 9216}}
    # a long launch reads each map plane once
    assert R.launch_bytes(work, 1, 4096 * 1500, 4096 * 1500, 4096) \
        == R.k1_bytes(4096, 1500, 4096 * 1500)
    assert R.launch_bytes(work, 1, 4096 * 16, 4096 * 16, 4096) \
        == R.k1_bytes(4096, 16, 4096 * 16)


KERNEL_OF = {"k1.roofline_share": "k1", "k1act.roofline_share": "k1act",
             "k3.roofline_share.selfplay": "k3",
             "k3.roofline_share.learner": "k3",
             "k2.roofline_share.selfplay": "k2",
             "k2.roofline_share.learner": "k2"}


def _needed():
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        if m["name"] not in KERNEL_OF:
            continue
        for w in m["workloads"]:
            yield KERNEL_OF[m["name"]], spec.cell(bench, w)["config"]


@pytest.mark.parametrize("kernel,config", sorted(set(_needed())))
def test_work_file(kernel, config):
    w = spec.work(kernel, config)
    assert w["unit"] in ("env_step", "env_reset")
    assert w["trace_name"] and set(w["ops_per_unit"]) == {"int", "mem",
                                                          "other"}
    assert all(v > 0 for v in w["ops_per_unit"].values())
    assert w["bytes"] and all(v >= 0 for v in w["bytes"].values())
    json.dumps(w)



@pytest.mark.parametrize("levels", [0, 1, 2, 3, 5])
def test_queue_envs_give_each_level_its_share(levels):
    cfg = {"n_envs": 4096, "n_players": 4, "n_pieces": 3, "difficulty": 0,
           "max_steps": 100,
           "levels": [{"n_pieces": 1 + k} for k in range(levels)]}
    envs = CW.queue_envs(cfg)
    assert len(envs) == len(set(envs)) == CW.QUEUE
    assert envs == sorted(envs) and 0 <= envs[0] and envs[-1] < 4096
    if levels == 0:     # the stride of 32 from env 0
        assert envs == list(range(0, 4096, 32))
    else:
        share = [sum(i % levels == lv for i in envs) for lv in range(levels)]
        assert max(share) - min(share) <= 1


def test_k2_bytes_follow_the_counted_envs_players():
    uniform = {"n_envs": 4096, "n_players": 4, "n_pieces": 3,
               "difficulty": 0, "max_steps": 100}
    envs = CW.queue_envs(uniform)
    # the frozen files' figure, a whole number
    assert CW.k2_bytes_per_unit(uniform, envs) == 2784
    mixed = {**uniform, "levels": LEVELS}
    envs = CW.queue_envs(mixed)
    players = [4 if i % 3 < 2 else 2 for i in envs]
    assert CW.k2_bytes_per_unit(mixed, envs) == pytest.approx(
        R.k2_moved_bytes(players) / len(envs))
    assert CW.k2_bytes_per_unit(mixed, envs) < 2784


def test_count_work_writes_the_named_config_alone(tmp_path, monkeypatch):
    """``--config X`` counts X alone, for the kernels its cells' mixes run
    (a self-play cell alone: K1, K3 and K2), and leaves every other work
    file as it was, in the output and in the benchmark."""
    root = tmp_path / "root"
    shutil.copytree(spec.HERE, root / "cogbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.load_benchmark()
    cfg = {**spec.config(b, "cog-4p3pc-easy-t100"), "name": "cog-levels",
           "levels": LEVELS}
    (root / "cogbench/configs/cog-levels.json").write_text(json.dumps(cfg))
    b["configs"].append({"name": "cog-levels", "source": "a test",
                         "file": "cogbench/configs/cog-levels.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "selfplay.levels", "config": "cog-levels",
                           "traffic": "selfplay-c16", "chips": 1,
                           "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    out = tmp_path / "out"
    shutil.copytree(spec.HERE / "work", out)
    def files(d):
        return {p.relative_to(d): p.read_bytes() for p in d.rglob("*.json")}

    before, ours = files(out), files(spec.HERE / "work")
    calls = []

    def stub(cfg, mixes):
        calls.append((cfg["name"], sorted(mixes)))
        return {k: {"ops_per_unit": {"int": 1.0}, "config": cfg["name"]}
                for d in mixes for k in CW.KERNELS[d]}

    monkeypatch.setattr(CW, "count", stub)
    CW.main(["--config", "cog-levels", "--out", str(out)], root=root)
    assert calls == [("cog-levels", ["selfplay"])]
    after = files(out)
    assert set(after) - set(before) == {
        Path(k) / "cog-levels.json" for k in ("k1", "k3", "k2")}
    assert all(after[p] == v for p, v in before.items())
    assert files(spec.HERE / "work") == ours
    assert files(root / "cogbench" / "work") == ours
