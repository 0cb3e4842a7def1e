"""The oracle's trajectory probe loop on the port, and its check against
the trajectory goldens (tests/golden/traj_*.npz). Imports no jax, so the
card tests (tests/test_torch_cuda.py) and chip_smoke.py use it as well as
tests/test_torch_traj_golden.py.

The probe loop (the loop of tests/test_jax_parity.py::parity_rollout and
tests/test_ref_traj.py::replay) plays one env by masked-random self-play,
sampling the sel mask (mask source 0) or the acting player's storage mask
(1), and resets the env right after the step that ends its game. A golden
holds the env's state after its first reset, then after every step (and
its reset): the action, done, agent, phase, rewards, resources, shop
stock, the 20 piles, both mask surfaces and the Info block; and the map of
every reset after a game's end.

A trajectory here is the env's (570,) carry column (engine.DYN_LAYOUT)
after the first reset and after every step and its reset, every step's
action and done flag (the step's own, before the reset clears it), and
the env's maps by the step whose reset made them (-1: the first reset's).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from eldorado_tpu_torch import vec
from eldorado_tpu_torch.core import engine as E
from eldorado_tpu_torch.core.cells import expand_obs
from eldorado_tpu_torch.ops import rng as R
from eldorado_tpu_torch.ops.step_kernel import fused_step

GOLDEN = Path(__file__).resolve().parent / "golden"
NAMES = ("traj_2p_easy", "traj_4p_easy", "traj_4p_medium", "traj_3p_hard",
         "traj_win_2p", "traj_win_4p", "traj_trunc", "traj_2p_easy_storage",
         "traj_4p_easy_storage", "traj_trunc_storage", "traj_win_storage")
# the per-step fields compared (those of test_jax_parity.py:108-111)
STEP_FIELDS = ("actions", "done", "agent", "phase", "rewards", "resources",
               "shop", "piles", "sel_mask", "storage_masks", "info_total",
               "info_steps", "info_returns", "info_travelled", "info_added",
               "info_removed", "info_card_uses")
_OFF = {f: off for f, _, _, off, _ in E.DYN_LAYOUT}


def probe_params(name: str) -> tuple:
    """(mask source, max_steps) of a golden's probe loop, as
    tests/test_ref_traj.py replays it: the storage mask (1) for the
    `_storage` goldens, else the sel mask (0); 100 turns for the
    truncation goldens, else 100000."""
    return (int(name.endswith("_storage")),
            100 if name.startswith("traj_trunc") else 100000)


def load(name: str) -> dict:
    with np.load(GOLDEN / f"{name}.npz") as d:
        return {k: d[k] for k in d.files}


def header(d: dict) -> tuple:
    """(env seed, sampler seed, n_players, n_pieces, difficulty, steps)."""
    return tuple(int(v) for v in d["header"])


@dataclasses.dataclass
class Trajectory:
    states: torch.Tensor   # (T + 1, 570) int32 carry columns
    actions: torch.Tensor  # (T, 5) int32
    done: torch.Tensor     # (T,) bool
    maps: dict             # step -> (2304,) int32 map ids


def _fields(states: torch.Tensor) -> dict:
    """The golden's fields from (T + 1, 570) carry columns, as numpy."""
    f = dict(zip(E.DYN_FIELDS, E.unpack_dyn(states.t().contiguous())))
    out = {k: f[k] for k in ("agent", "phase", "rewards", "resources",
                             "piles", "info_total", "info_steps",
                             "info_returns", "info_travelled", "info_added",
                             "info_removed", "info_card_uses",
                             "rng_tainted")}
    out["shop"] = f["shop_stock"]
    out["sel_mask"] = E.unpack_mask(f["sel_mask"])
    out["storage_masks"] = E.unpack_mask(f["storage_masks"])
    return {k: v.numpy() for k, v in out.items()}


def _diverges(got, want) -> np.ndarray:
    """Rows (leading axis) where got differs from want; integers compared
    as int64, floats as float64, so no value wraps or rounds."""
    kind = np.float64 if want.dtype.kind == "f" else np.int64
    g = np.asarray(got).astype(kind).reshape(len(want), -1)
    w = np.asarray(want).astype(kind).reshape(len(want), -1)
    return np.nonzero(~np.all(g == w, axis=1))[0]


def check(name: str, d: dict, traj: Trajectory, steps: int) -> None:
    """Hold ``traj`` to golden ``d`` over its first ``steps`` steps: the
    state after the first reset (map, agent, both masks, piles), every
    compared field of every step, and the map of every reset in the
    window. Raises AssertionError naming the first diverging field and
    step."""
    f = _fields(traj.states[:steps + 1])
    first = {"map0": expand_obs(traj.maps[-1]).numpy()[None],
             "agent0": f["agent"][:1], "sel0": f["sel_mask"][:1],
             "storage0": f["storage_masks"][:1], "piles0": f["piles"][:1]}
    for key, got in first.items():
        if len(_diverges(got, d[key][None] if key != "agent0" else d[key])):
            raise AssertionError(f"{name}: {key} (the state after the first "
                                 "reset) differs")
    own = {"actions": traj.actions[:steps].numpy(),
           "done": traj.done[:steps].numpy()}
    first = {}
    for key in STEP_FIELDS:
        bad = _diverges(own[key] if key in own else f[key][1:],
                        d[key][:steps])
        if len(bad):
            first[key] = int(bad[0])
    if first:
        step = min(first.values())
        keys = [k for k, t in first.items() if t == step]
        raise AssertionError(f"{name}: first divergence at step {step}, "
                             f"field {', '.join(keys)}")
    if f["rng_tainted"].any():
        raise AssertionError(f"{name}: the fast sampler path deviated from "
                             "the exact stream at step "
                             f"{np.nonzero(f['rng_tainted'])[0][0] - 1}")
    for k, t in enumerate(d["reset_steps"]):
        if t >= steps:
            continue
        if t not in traj.maps or len(_diverges(
                expand_obs(traj.maps[t]).numpy()[None],
                d["reset_maps"][k][None])):
            raise AssertionError(f"{name}: the map of the reset at step {t} "
                                 "differs")


def replay(names, steps: int, device) -> list:
    """The probe loop on the port's main path, one env for each golden of
    ``names`` (all of one mask source), over ``steps`` steps: every step
    is one launch of the fused sample + step (`fused_step`), then the envs
    whose game ended are reset in place as the reset queue resets them
    (`vec._reset_columns`: map generation and its prelude, then the reset
    body, on those columns). On CUDA tensors that is K1, then K3 and K2;
    on CPU tensors their plain versions. Returns a `Trajectory` per env."""
    ds = [load(n) for n in names]
    es, ss, n_players, n_pieces, diff, _ = zip(*(header(d) for d in ds))
    params = [probe_params(n) for n in names]
    if len({m for m, _ in params}) != 1:
        raise ValueError("the goldens replayed together share a mask source")
    mask_src = "storage" if params[0][0] else "sel"
    states = vec.vec_reset_varied(list(es), list(n_players), list(n_pieces),
                                  list(diff), [s for _, s in params],
                                  device=device)
    static = {f: getattr(states, f).clone() for f in E.STATIC_FIELDS}
    carry = E.pack_dyn(E.split_state(states)[1])
    srng = R.seed(torch.as_tensor(ss, dtype=torch.int64), device=device)
    n = len(names)
    rows = torch.empty((steps + 1,) + carry.shape, dtype=torch.int32,
                       device=carry.device)
    acts = torch.empty((steps, n, 5), dtype=torch.int32, device=carry.device)
    dones = torch.empty((steps, n), dtype=torch.bool, device=carry.device)
    rows[0] = carry
    maps = [{-1: static["map_ids"][j].clone()} for j in range(n)]
    for t in range(steps):
        carry, srng, acts[t] = fused_step(
            carry, srng, static["map_ids"], static["min_xy"],
            static["n_players"], static["max_steps"], 1, mask_src)
        dones[t] = carry[_OFF["done"]] != 0
        done = torch.nonzero(dones[t]).flatten()
        if done.numel():
            vec._reset_columns(carry, static, done.to(torch.int32))
            for j in done.tolist():
                maps[j][t] = static["map_ids"][j].clone()
        rows[t + 1] = carry
    rows, acts, dones = rows.cpu(), acts.cpu(), dones.cpu()
    return [Trajectory(rows[:, :, j], acts[:, j], dones[:, j],
                       {t: m.cpu() for t, m in maps[j].items()})
            for j in range(n)]
