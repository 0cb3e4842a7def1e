"""The reference's side of the check: one env replayed and compared.

Each job is a plain dict, so that a pool of worker processes can take it
(they import this module and numpy, nothing else). An env plays masked
uniform self-play on its acting player's action mask, and an env that
ends resets at once with the same parameters, its engine stream going on
(include/vec_environment.h:53-61). The system's exact mode leaves an
ended env frozen, drawing nothing, until its reset; so its trajectory
without those dead steps is this one, and its sampler engine marks how
far it went.

* ``{"kind": "reset", "env", "seed", "sampler_seed", "params",
  "want"}``: the reference's reset from the seed against the system's
  state ``want``.
* ``{"kind": "play", "env", "params", "start", "steps", "exact_steps",
  "want", "want_sampler"}``: from ``start`` (``{"seed", "sampler_seed",
  "params"}``: a reset from the seed; or ``{"fields", "sampler"}``: an
  env of the system), play until the sampler engine reads
  ``want_sampler``, at least one step and at most ``steps``; with
  ``exact_steps``, exactly ``steps``. Then compare with ``want``. With
  ``"control": "modulo"`` (and ``exact_steps``) the outputs compared are
  not ``want`` but the control's: the reference put in the system's place
  from the same start, its sampler reducing each draw modulo the head's
  width (`ModuloSampler`) instead of libstdc++'s downscaling.

``env`` is the env's index in the batch and ``params`` its own game as
the configuration gives it (its ``n_players``, ``n_pieces``,
``difficulty`` and ``max_steps``). Every stage of the system's that a job
reads, ``want`` and a start's ``fields``, must hold that game: a replay
from the system's own fields would carry a wrong game along unseen, so a
stage that differs fails the job as ``"level"``.

`run` returns ``{"ok", "steps", "why"}``: ``why`` names what differed.
"""
from __future__ import annotations

import numpy as np

from . import state as S
from .engine import (MOVE, PLAY, REMOVE, SHOP, SPECIAL, GenerateMapFailure,
                     RefEnv, RefSampler)


class ModuloSampler(RefSampler):
    """The control's sampler: one draw a head, reduced modulo the number
    of valid slots. It breaks the stated guarantee that actions follow
    libstdc++'s ``uniform_int_distribution`` on minstd_rand0."""

    def sample(self, mask):
        out = np.zeros(5, np.uint8)
        for h, sl in enumerate((PLAY, SPECIAL, REMOVE, MOVE, SHOP)):
            valid = np.nonzero(mask[sl])[0]
            if len(valid):
                out[h] = valid[(self.rng() - 1) % len(valid)]
        return out


def _from_seed(seed, sampler_seed, params):
    env = RefEnv(seed=seed, **params)
    env.reset()
    return env, RefSampler(sampler_seed)


def _step(env, sampler):
    env.step(sampler.sample(env.storage_masks[env.agent]))
    if env.done:
        env.reset()


def _holds(params: dict, *stages) -> bool:
    """Whether each of the system's ``stages`` (one env's fields) holds
    the game ``params``."""
    return all(int(np.asarray(f[k])) == int(v)
               for f in stages for k, v in params.items())


def run(job: dict) -> dict:
    try:
        return _run(job)
    except GenerateMapFailure:
        return {"ok": False, "steps": 0,
                "why": ["the reference's map generation failed"]}


def _run(job: dict) -> dict:
    start = job.get("start", {})
    level = [] if _holds(job["params"], job["want"],
                         *([start["fields"]] if "fields" in start else [])) \
        else ["level"]
    if job["kind"] == "reset":
        env, sampler = _from_seed(job["seed"], job["sampler_seed"],
                                  job["params"])
        bad = level + S.differ(S.extract(env), S.system_view(job["want"]))
        if int(job["want_sampler"]) & 0xFFFFFFFF != sampler.rng.state:
            bad.append("sampler")
        return {"ok": not bad, "steps": 0, "why": bad}
    if "fields" in start:
        env, sampler = S.load(start["fields"], start["sampler"])
    else:
        env, sampler = _from_seed(start["seed"], start["sampler_seed"],
                                  start["params"])
    want = S.system_view(job["want"])
    target = int(job["want_sampler"]) & 0xFFFFFFFF
    if job.get("control") == "modulo":
        c_env, c_sampler = S.load(start["fields"], start["sampler"])
        c_sampler.__class__ = ModuloSampler
        for _ in range(job["steps"]):
            _step(c_env, c_sampler)
        want, target = S.extract(c_env), c_sampler.rng.state
    steps = 0
    if job["exact_steps"]:
        for _ in range(job["steps"]):
            _step(env, sampler)
        steps = job["steps"]
        reached = sampler.rng.state == target
    else:
        reached = False
        while steps < job["steps"]:
            _step(env, sampler)
            steps += 1
            if sampler.rng.state == target:
                reached = True
                break
    if not reached:
        return {"ok": False, "steps": steps,
                "why": level + ["sampler stream not reached"]}
    bad = level + S.differ(S.extract(env), want)
    return {"ok": not bad, "steps": steps, "why": bad}
