"""The roofline arithmetic and the frozen work counts.

The copied arithmetic reproduces the figures the port's chip checks
published at 4096 envs on 132 SMs: K1's bound of 0.000281 ms a step at
1791 PTX instructions an env-step (1148 integer), and K2's 356,352 bytes
a 128-env in-place queue. Every kernel a cell's roofline metric reads has
a work file for the cell's configuration, with its trace name, unit,
counts and bytes.
"""
import json

import pytest

from cogbench import roofline as R
from cogbench import spec


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
