"""The check must fail what is wrong: the controls, and the timed path
broken underneath.

Each cell's control (``inexact`` self-play: the system's own non-exact
mode, whose waiting envs draw; ``modulo`` learner: the reference in the
system's place with a modulo sampler) comes out not correct. So does a run
whose timed path is broken, once for each fault a one-chip cell can have:
a step that returns its state unchanged; half of the batch left out; an
answer altered where it is produced. (The exchange between chips does not
exist on one chip.) Everything runs on the CPU at a few envs, through
``run_cell``, which skips only the command line's look for a card.
"""
import pytest
import torch

import eldorado_tpu_torch as et
from cogbench.run import run_cell
from test_cogbench_harness import LEVELS

SELFPLAY = {"config": {"n_envs": 12},
            "mix": {"chunk": 16, "steps_per_call": 320, "check_envs": 6,
                    "check_envs_from_seed": 2}}
LEARNER = {"config": {"n_envs": 12},
           "mix": {"warmup_rounds": 10, "check_rounds": 200,
                   "check_envs": 6, "check_envs_from_seed": 2}}


def mismatches(cell, overrides, control=None, seed=2**31 + 101):
    r = run_cell(cell, seed, 0.3, False, "cpu", control, overrides,
                 workers=0)
    assert r["correct"] == (r["check"]["mismatches"]["value"] == 0)
    return r["check"]["mismatches"]["value"]


def test_sound_runs_pass():
    assert mismatches("selfplay.short-games", SELFPLAY) == 0
    assert mismatches("learner.short-games", LEARNER) == 0


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_controls_fail(seed):
    assert mismatches("selfplay.short-games", SELFPLAY, "inexact",
                      seed) > 0
    assert mismatches("learner.short-games", LEARNER, "modulo", seed) > 0


def _half(states, srng, fresh, fresh_r):
    """``fresh`` with its second half of envs put back to ``states``."""
    n = srng.shape[0]
    keep = torch.arange(n) >= n // 2
    out = {}
    for f in vars(fresh):
        a, b = getattr(fresh, f), getattr(states, f)
        m = keep.reshape((n,) + (1,) * (a.dim() - 1))
        out[f] = torch.where(m, b, a)
    return type(fresh)(**out), torch.where(keep, srng, fresh_r)


SELFPLAY_FAULTS = {
    "unchanged": lambda real: lambda s, r, *a, **k: (s, r, 0, 0),
    "half": lambda real: lambda s, r, *a, **k: (
        *_half(s, r, *real(s, r, *a, **k)[:2]), 0, 0),
    "altered": lambda real: lambda s, r, *a, **k: _alter(real(s, r, *a,
                                                              **k)),
}


def _alter(out):
    states = out[0]
    states.resources = states.resources + 1.0
    return out


@pytest.mark.parametrize("fault", sorted(SELFPLAY_FAULTS))
def test_selfplay_faults_fail(monkeypatch, fault):
    real = et.rollout_chunked
    monkeypatch.setattr(et, "rollout_chunked", SELFPLAY_FAULTS[fault](real))
    assert mismatches("selfplay.short-games", SELFPLAY) > 0


def _step_fault(fault, real):
    def step(self, actions):
        if fault == "unchanged":
            return torch.zeros(self.n_envs, dtype=torch.bool)
        before = self._carry.clone()
        done = real(self, actions)
        if fault == "half":
            self._carry[:, self.n_envs // 2:] = before[:, self.n_envs // 2:]
        else:
            self._carry[0] ^= 1     # every env's engine word
        return done
    return step


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_learner_faults_fail(monkeypatch, fault):
    monkeypatch.setattr(et.VecEnv, "step",
                        _step_fault(fault, et.VecEnv.step))
    assert mismatches("learner.short-games", LEARNER) > 0


SHORTER = {"selfplay.short-games": {"steps_per_call": 96}}


@pytest.mark.parametrize("cell,small", [("selfplay.short-games", SELFPLAY),
                                        ("learner.short-games", LEARNER)])
def test_level0_control_fails_by_the_level(cell, small):
    """A batch with levels is correct; the control ``level0``, the system
    reset at the first level everywhere, is not. Replayed from the
    system's own fields, its envs agree with the reference in everything
    but their game: the envs of the other levels fail by the ``level``
    comparison alone. No env is replayed from its seed, so that every job
    starts from the system's own fields."""
    ov = {"config": {**small["config"], "levels": LEVELS},
          "mix": {**small["mix"], **SHORTER.get(cell, {}),
                  "check_envs_from_seed": 0}}
    assert mismatches(cell, ov) == 0
    r = run_cell(cell, 2**31 + 101, 0.3, False, "cpu", "level0", ov,
                 workers=0)
    assert r["correct"] is False and r["check"]["mismatches"]["value"] > 0
    why = r["_detail"]["why"]
    assert why and all(w == ["level"] and env % 3 for _, env, w in why)
