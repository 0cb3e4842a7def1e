"""The readers of the program's spans (``cogbench/spans.py`` and the six
``program_span`` metrics) on hand-built traces, whose values are worked out
by hand in the comments; None where the program has no spans; and a traced
run on the CPU that reports them."""
import pytest

from cogbench import spec
from cogbench.run import Run, run_cell
from cogbench.trace import WINDOW, Trace
from test_cogbench_harness import small

K1 = "void ed::fused_step_kernel<false, 0>(int const*)"


def span(name, a, b):
    return {"name": name, "cat": "user_annotation", "ph": "X", "ts": a,
            "dur": b - a}


def op(name, a, b):
    cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
    return {"name": name, "cat": cat, "ph": "X", "ts": a, "dur": b - a}


def run_of(events):
    tr = Trace([span(WINDOW, 0, 1000)] + events)
    return Run({"trace": tr, "traced": {}, "counters": {}}, "cog-4p3pc-easy",
               64, 132, spec.HERE)


# two rollout_chunked calls. Call 1: its start (idle 20), K1 A, a count
# read that waits 18 us on A and the count's copy then 7 us idle, a queue
# (idle 30 - 5 - 3 = 22), K1 B (A to B: 60, inside the call), a count read
# (5 busy, idle 10) with an empty queue, its end (idle 160 - 10 = 150, with
# the sweep's reset, which the queue metric leaves out). Call 2: its start
# (idle 20 - 5 = 15), K1 C (B to C: 230, across two calls, not a chunk
# gap), a count read (idle 5), its end (idle 30).
SELFPLAY = [
    span("ed.rollout.begin", 10, 30),
    span("ed.rollout", 30, 400),
    op(K1, 40, 100),
    span("ed.queue.count_read", 95, 120),
    op("Memcpy DtoH (Device -> Pageable)", 100, 113),
    span("ed.reset", 120, 150),
    op("generate_map_kernel", 135, 140),
    op("fused_reset_kernel", 145, 148),
    op(K1, 160, 220),
    span("ed.queue.count_read", 215, 230),
    span("ed.rollout.end", 240, 400),
    span("ed.reset", 250, 260),
    op("Memcpy DtoD (Device -> Device)", 300, 310),
    span("ed.rollout.begin", 420, 440),
    op("Memcpy DtoD (Device -> Device)", 425, 430),
    span("ed.rollout", 440, 900),
    op(K1, 450, 500),
    span("ed.queue.count_read", 490, 505),
    span("ed.rollout.end", 510, 540),
]
# three VecEnv rounds: steps of 100, 200 and 60 us (mean 120); reads of 20,
# 30 and 10 (mean 20); one reset of 100 in round 2 (100 / 3 a round); the
# rest 80, 70 and 50 (200 / 3). A reset and a read outside every step (the
# batch's reset, a bare step_actions) count for none.
LEARNER = [
    span("ed.step", 10, 110),
    span("ed.k1act.read", 60, 80),
    op("step_actions_kernel", 20, 75),
    span("ed.step", 200, 400),
    span("ed.k1act.read", 240, 270),
    span("ed.reset", 280, 380),
    span("ed.step", 500, 560),
    span("ed.k1act.read", 520, 530),
    span("ed.reset", 600, 650),
    span("ed.k1act.read", 700, 705),
]
CASES = [
    ("queue.chunk_gap_us", SELFPLAY, 60.0),
    ("queue.call_edge_us", SELFPLAY, (20 + 150 + 15 + 30) / 2),
    ("queue.reset_idle_us", SELFPLAY, 22.0),
    ("learner.count_read_us", LEARNER, 20.0),
    ("learner.reset_host_us", LEARNER, 100 / 3),
    ("learner.step_self_us", LEARNER, 200 / 3),
]
SPAN_METRICS = sorted({m for m, _, _ in CASES})


@pytest.mark.parametrize("metric,events,want", CASES)
def test_reader_values(metric, events, want):
    assert spec.metric_reader(metric)(run_of(events)) == pytest.approx(want)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_reader_none_without_spans(metric):
    """The parent's program has no spans: a trace of K1 launches and copies
    alone, or no trace, reads None."""
    bare = [e for e in SELFPLAY + LEARNER if e["cat"] != "user_annotation"]
    read = spec.metric_reader(metric)
    assert read(run_of(bare)) is None
    r = run_of(bare)
    r.trace = None
    assert read(r) is None


def test_learner_metrics_sum_to_the_step():
    r = run_of(LEARNER)
    parts = sum(spec.metric_reader(m)(r) for m in (
        "learner.count_read_us", "learner.reset_host_us",
        "learner.step_self_us"))
    assert parts == pytest.approx((100 + 200 + 60) / 3)


def test_metrics_entries_name_their_readers():
    b = spec.load_benchmark()
    entries = {m["name"]: m for m in b["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "us"
        assert m["better"] == "lower"
        want = "selfplay" if name.startswith("queue.") else "learner"
        assert all(w.startswith(want) for w in m["workloads"])


@pytest.mark.parametrize("cell", ["selfplay.short-games",
                                  "learner.short-games"])
def test_traced_cpu_run_reports_the_spans(cell):
    """A traced run of the program on the CPU (no device operations, so
    every span is idle time) reports the span metrics its spans feed."""
    r = run_cell(cell, 2**31 + 5, 0.3, True, "cpu", overrides=small(cell),
                 workers=0)
    assert r["correct"]
    want = (["queue.call_edge_us"]
            if cell.startswith("selfplay") else
            ["learner.count_read_us", "learner.reset_host_us",
             "learner.step_self_us"])
    for name in want:
        assert r["metrics"][name]["value"] >= 0
