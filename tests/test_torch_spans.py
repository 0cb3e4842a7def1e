"""The port's spans (`eldorado_tpu_torch.spans`) on CPU tensors: with no
profiler recording none of them reaches ``record_function``; under a
profiler each learner round and each chunked rollout gives the spans the
benchmark's metrics read, nested as they read them. Small batches of
1-turn games, so that resets happen in some rounds and at every boundary.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import eldorado_tpu_torch as et
from eldorado_tpu_torch import spans
from eldorado_tpu_torch import vec as V
from eldorado_tpu_torch.parallel import mesh as M
from eldorado_tpu_torch.parallel import runner as R

CPU = dict(device="cpu")
N, ROUNDS, STEPS, CHUNK = 6, 12, 40, 8


def learner_rounds():
    env = et.VecEnv(N, **CPU)
    env.reset(seed=21, n_players=2, n_pieces=1, max_steps=1)
    return [bool(env.step(env.sample()).any()) for _ in range(ROUNDS)]


def batch():
    return (et.vec_reset(5, N, 2, 1, 0, 1, **CPU),
            et.sampler_init(11, N, **CPU))


def chunked(shards):
    states, rngs = batch()
    if shards == 1:
        return et.rollout_chunked(states, rngs, STEPS, CHUNK, exact=True)
    mesh = M.make_mesh(devices=["cpu"] * shards)
    return R.sharded_kernel_rollout(mesh, states, rngs, STEPS, CHUNK,
                                    exact=True)


def annotations(prof, tmp_path):
    """The profile's spans, from its Chrome trace (``prof.events()`` takes
    tens of seconds over the plain kernels' ops)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def recorded(events, name):
    """(start, end) of each ``name`` span, in start order."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e["name"] == name)


def inside(spans_, outer):
    return [s for s in spans_ if outer[0] <= s[0] and s[1] <= outer[1]]


@pytest.mark.parametrize("path", ["learner", "chunked"])
def test_no_span_without_a_profiler(monkeypatch, path):
    def refuse(name):
        raise AssertionError(f"span {name!r} recorded with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert spans.span("ed.step") is spans.span("ed.reset")
    if path == "learner":
        assert any(learner_rounds())
    else:
        assert chunked(1)[2] > 0


def test_learner_round_spans(tmp_path):
    """Each round one ``ed.step`` holding one ``ed.k1act.read``, and one
    ``ed.reset`` inside it in the rounds that reset envs."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reset = learner_rounds()
    events = annotations(prof, tmp_path)
    steps = recorded(events, "ed.step")
    reads = recorded(events, "ed.k1act.read")
    resets = recorded(events, "ed.reset")
    assert len(steps) == len(reads) == ROUNDS
    assert any(reset) and not all(reset)
    # the batch's reset in VecEnv.reset is the one outside every step
    assert len(resets) == 1 + sum(reset)
    for step, did_reset in zip(steps, reset):
        assert len(inside(reads, step)) == 1
        assert len(inside(resets, step)) == int(did_reset)


@pytest.mark.parametrize("shards", [1, 2])
def test_chunked_rollout_spans(monkeypatch, tmp_path, shards):
    """One ``rollout_chunked(exact=True)`` call (or a sharded one over
    `vec._ChunkLoop`): an ``ed.rollout.begin`` per shard before one
    ``ed.rollout``, which holds one ``ed.reset`` per chunk boundary and
    shard (the queue's K3, K2 and settle, enqueued whether or not the
    queue is empty, whose size the host never reads: no
    ``ed.queue.count_read``), and one ``ed.rollout.end`` after the last
    boundary."""
    queues = []
    take = V._ChunkLoop._reset

    def spy(self, ci, queue):
        queues.append(ci)
        return take(self, ci, queue)

    monkeypatch.setattr(V._ChunkLoop, "_reset", spy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chunked(shards)
    events = annotations(prof, tmp_path)
    begins = recorded(events, "ed.rollout.begin")
    [call] = recorded(events, "ed.rollout")
    [end] = recorded(events, "ed.rollout.end")
    resets = recorded(events, "ed.reset")
    assert len(begins) == shards
    assert all(b[1] <= call[0] for b in begins)
    assert recorded(events, "ed.queue.count_read") == []
    assert inside([end], call) == [end]
    boundary = [r for r in inside(resets, call) if not inside([r], end)]
    assert all(r[1] <= end[0] for r in boundary)
    assert len(queues) == len(boundary) == shards * STEPS // CHUNK
