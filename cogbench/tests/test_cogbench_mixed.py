"""The curriculum configuration ``cog-4p-mixed-t100`` and its cell
``selfplay.mixed``: the configuration's levels as the harness hands them
to the system, the cell's metrics, and the two readers of K3's work counts
(``k3.trip_idle_share``, ``k3.trips_per_reset``), silent over a system
without the counts and right over one with them.
"""
import pytest

from cogbench import spec
from cogbench.run import run_cell

CONFIG, CELL = "cog-4p-mixed-t100", "selfplay.mixed"
READERS = ("k3.trip_idle_share", "k3.trips_per_reset")


def test_config_levels_interleave():
    b = spec.load_benchmark()
    cfg = spec.config(b, CONFIG)
    entry = next(c for c in b["configs"] if c["name"] == CONFIG)
    assert cfg["source"] == entry["source"] and len(entry["source"]) <= 200
    assert entry["reduced"] == []
    games = [spec.env_params(cfg, i) for i in range(6)]
    assert [g["n_pieces"] for g in games] == [3, 8, 3] * 2
    assert [g["difficulty"] for g in games] == [0, 1, 2] * 2
    assert {(g["n_players"], g["max_steps"]) for g in games} == {(4, 100)}
    batch = spec.batch_params(cfg)
    assert batch["n_pieces"][:6] == [3, 8, 3, 3, 8, 3]
    assert batch["difficulty"][:6] == [0, 1, 2, 0, 1, 2]
    assert len(batch["n_pieces"]) == cfg["n_envs"] == 4096
    assert batch["n_players"] == 4 and batch["max_steps"] == 100


def test_cell_reports_what_short_games_report_and_the_counts():
    b = spec.load_benchmark()
    w = spec.cell(b, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG,
                                                       "selfplay-c16", 1)
    e2e, layer = spec.metrics_for(b, CELL)
    short_e2e, short_layer = spec.metrics_for(b, "selfplay.short-games")
    assert {m["name"] for m in e2e} == {m["name"] for m in short_e2e} == {
        "selfplay_live_steps_per_s", "setup_s"}
    names = {m["name"] for m in layer}
    assert names == {m["name"] for m in short_layer}
    assert set(READERS) <= names
    for m in layer:
        if m["name"] in READERS:
            assert m["layer"] == "K3: csrc/mapgen.cu"
            assert m["source"] == "program_counter"
            assert m["moves"] == "selfplay_live_steps_per_s"


@pytest.mark.parametrize("name", READERS)
def test_readers_silent_without_the_counts(monkeypatch, name):
    from eldorado_tpu_torch import vec
    monkeypatch.delattr(vec, "queue_work")
    assert spec.metric_reader(name)(None) is None
    monkeypatch.setattr(vec, "queue_work", lambda: dict.fromkeys(
        ("resets", "trips", "slowest_lane_trips"), 0),
        raising=False)
    assert spec.metric_reader(name)(None) is None


@pytest.mark.parametrize("name,want", [("k3.trip_idle_share", 25.0),
                                       ("k3.trips_per_reset", 9.0)])
def test_readers_on_faked_counts(monkeypatch, name, want):
    from eldorado_tpu_torch import vec
    monkeypatch.setattr(vec, "queue_work", lambda: {
        "resets": 100, "trips": 900, "slowest_lane_trips": 1200})
    assert spec.metric_reader(name)(None) == pytest.approx(want)


def test_traced_cpu_run_reads_the_counts():
    """The cell on the CPU at 12 envs and three-turn games: both readers
    find the counts the run's chunked resets left."""
    ov = {"config": {"n_envs": 12, "max_steps": 3},
          "mix": {"chunk": 8, "steps_per_call": 32, "traced_calls": 1,
                  "check_envs": 6, "check_envs_from_seed": 3}}
    r = run_cell(CELL, 2**31 + 19, 0.3, True, "cpu", overrides=ov,
                 workers=0)
    assert r["correct"]
    idle = r["metrics"]["k3.trip_idle_share"]["value"]
    per_reset = r["metrics"]["k3.trips_per_reset"]["value"]
    assert 0.0 <= idle < 100.0 and per_reset >= 7.0
