"""`city_of_gold`-compatible API surface.

Port of ``eldorado_tpu/compat/__init__.py``. Mirrors the reference pybind11
module layout (reference: src/pybind/common.cpp, src/pybind/single_env.cpp,
src/pybind/vectorized.cpp) so a user of the C++ wheel can switch imports
and keep their script shape:

    from eldorado_tpu_torch import compat as city_of_gold
    env = city_of_gold.cog_env(seed, n_players, n_pieces,
                               city_of_gold.Difficulty.EASY, max_steps, False)
    sampler = city_of_gold.action_sampler(42)
    venv = city_of_gold.vec.get_vec_env(1024)   # no 256-env cap here

Observations are numpy *structured arrays* with the reference's field
layout (include/api.h:67-161): copies of the device state, not zero-copy
views; training code should consume the batched tensors of
`eldorado_tpu_torch.vec` directly and keep everything on the card.

The reference's signatures have no device; every entry point here that
makes tensors (`cog_env` with ``backend="device"``, `vec.get_vec_env`,
`vec.get_vec_sampler`, `vec.get_runner`) takes ``device="cuda"`` as a
keyword and raises a RuntimeError where there is no card; pass
``device="cpu"`` for the kernels' plain versions on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import vec as V
from ..constants import Difficulty, MAX_N_PLAYERS, N_CARDTYPES
from ..core import engine as E
from ..core.cells import expand_obs_np
from ..core.ref_engine import GenerateMapFailure, MinstdRng, RefEnv, RefSampler
from ..devices import resolve
from ..errors import MapCapacityError

__all__ = [
    "Difficulty", "cog_env", "action_sampler", "max_envs",
    "deck_dtype", "action_mask_dtype", "player_dtype", "shared_dtype",
    "obs_dtype", "action_dtype", "agent_info_dtype", "info_dtype",
    "GenerateMapFailure", "vec",
]

# unlimited in practice; the reference caps at 256 (src/pybind/common.cpp:23)
max_envs = 1 << 20

# -- structured dtypes (include/api.h:67-161) ------------------------------
deck_dtype = np.dtype([
    ("draw", np.uint8, (N_CARDTYPES,)), ("hand", np.uint8, (N_CARDTYPES,)),
    ("active", np.uint8, (N_CARDTYPES,)), ("played", np.uint8, (N_CARDTYPES,)),
    ("discard", np.uint8, (N_CARDTYPES,)),
])
action_mask_dtype = np.dtype([
    ("play", np.bool_, (22,)), ("play_special", np.bool_, (22,)),
    ("remove", np.bool_, (22,)), ("move", np.bool_, (7,)),
    ("get_from_shop", np.bool_, (19,)),
])
player_dtype = np.dtype([
    ("obs", deck_dtype), ("action_mask", action_mask_dtype),
])
shared_dtype = np.dtype([
    ("map", np.uint8, (48, 48, 7)), ("phase", np.uint8),
    ("current_resources", np.float32, (3,)), ("shop", np.uint8, (18,)),
])
obs_dtype = np.dtype([
    ("shared", shared_dtype), ("player_data", player_dtype, (MAX_N_PLAYERS,)),
])
action_dtype = np.dtype([
    ("play", np.uint8), ("play_special", np.uint8), ("remove", np.uint8),
    ("move", np.uint8), ("get_from_shop", np.uint8),
])
agent_info_dtype = np.dtype([
    ("steps_taken", np.uint8), ("returns", np.float32),
    ("travelled_hexes", np.uint32), ("cards_added", np.uint8),
    ("cards_removed", np.uint8), ("n_machete_uses", np.uint32),
    ("n_paddle_uses", np.uint32), ("n_coin_uses", np.uint32),
    ("n_card_uses", np.uint32),
])
info_dtype = np.dtype([
    ("total_length", np.uint32),
    ("agent_infos", agent_info_dtype, (MAX_N_PLAYERS,)),
])

_HEADS = ("play", "play_special", "remove", "move", "get_from_shop")
_HEAD_SLICES = ((0, 22), (22, 44), (44, 66), (66, 73), (73, 92))
_OFF = {f: (off, size, shape, dt) for f, shape, dt, off, size in E.DYN_LAYOUT}


def _mask_to_struct(flat92):
    out = np.zeros((), action_mask_dtype)
    for name, (a, b) in zip(_HEADS, _HEAD_SLICES):
        out[name] = flat92[a:b]
    return out


def _action_to_vec(action):
    if isinstance(action, np.void) or (
            hasattr(action, "dtype") and action.dtype == action_dtype):
        return np.array([action[k] for k in _HEADS], np.uint8)
    return np.asarray(action, np.uint8).reshape(5)


def unpack_mask_np(words):
    """(..., 3) int32 mask words -> (..., 92) bool (`engine.unpack_mask`
    on the host)."""
    w = np.asarray(words).astype(np.uint32)
    bits = (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(w.shape[:-1] + (32 * E.MASK_WORDS,))[
        ..., :E.MASK_LEN] != 0


def _field_rows(carry, names):
    """The carry rows of the DYN fields ``names``, stacked in that order."""
    return torch.cat([carry[_OFF[name][0]:_OFF[name][0] + _OFF[name][1]]
                      for name in names])


def _rows_to_fields(rows, names):
    """Host rows of `_field_rows` (numpy, (words, n)) -> the fields as
    env-major numpy arrays: f32 fields from their bits, bools as bool."""
    n = rows.shape[1]
    out, at = {}, 0
    for name in names:
        _, size, shape, dt = _OFF[name]
        x = np.ascontiguousarray(rows[at:at + size].T)
        at += size
        if dt == torch.float32:
            x = x.view(np.float32)
        elif dt == torch.bool:
            x = x != 0
        out[name] = x.reshape((n,) + tuple(shape))
    return out


def host_fields(carry, names):
    """The DYN fields ``names`` of a (W, n) carry on any device, as
    env-major numpy arrays, read to the host in one copy."""
    return _rows_to_fields(_field_rows(carry, names).cpu().numpy(), names)


class _DeviceMapView:
    """Board view for the device backend (render/get_map surface:
    .obs / .player_xy / .min_xy, matching ref_engine.RefMap's fields)."""

    def __init__(self, obs, player_xy, min_xy):
        self.obs = obs
        self.player_xy = player_xy
        self.min_xy = min_xy


_SNAP_FIELDS = ("agent", "done", "phase", "resources", "shop_stock", "piles",
                "sel_mask", "storage_masks", "rewards", "info_total",
                "info_steps", "info_returns", "info_travelled", "info_added",
                "info_removed", "info_card_uses", "player_xy")
_SNAP_WORDS = sum(_OFF[f][1] for f in _SNAP_FIELDS)
_PARAMS = ("n_players", "n_pieces", "difficulty", "max_steps")


class _DeviceEnv:
    """RefEnv-shaped adapter over one env on ``device``, in K1's carry
    layout: a (CARRY_WORDS, 1) carry plus its static fields, as
    `vec.VecEnv` keeps a batch. The device analogue of the reference's
    native-backed cog_env (src/pybind/single_env.cpp:12-86 binds the C++
    engine directly), equal to RefEnv field for field.

    * ``step(action)``: K1-act on the one column, no auto-reset (a done
      env's step is a dead step, as ``engine.step_env``'s). Unlike the JAX
      package, an action outside its head (`ops.step_kernel.HEAD_WIDTHS`)
      raises ValueError and leaves the env as it was.
    * ``reset()``: K3 then K2 on column 0 (`vec._reset_columns`); the
      engine stream continues (src/environment.cpp:42-64).
    * ``reset(seed, n_players, n_pieces, difficulty, max_steps)``: the new
      seed's engine word and the parameters are written into the existing
      state, then the same reset (src/environment.cpp:66-77); rewards,
      infos, the played pile, the shop's n_in_market and the move and shop
      mask heads persist, as in the reference.

    One device-to-host copy per reset or step; attribute reads are free
    after that. The map is expanded on the host only after a reset (the
    step never writes it)."""

    def __init__(self, seed=0, n_players=4, n_pieces=3, difficulty=0,
                 max_steps=100000, device="cuda"):
        dev = resolve(device)
        self.seed_ = int(seed)
        states = E.make_state(V._seeds(seed, 1, dev), int(n_players),
                              int(n_pieces), int(difficulty), int(max_steps),
                              device=dev)
        self._static, self._carry = V._split(states)
        self._idx = torch.zeros(1, dtype=torch.int32, device=dev)
        self._pull(after_reset=True)

    def _pull(self, after_reset: bool):
        """The env's state to the host in one copy: the carry column, and
        after a reset the map row, min_xy, the two map flags and the
        parameters."""
        st = self._static
        parts = [_field_rows(self._carry, _SNAP_FIELDS)[:, 0]]
        if after_reset:
            parts += [st["map_ids"][0], st["min_xy"][0],
                      st["map_ok"].to(torch.int32),
                      st["map_overflow"].to(torch.int32)]
            parts += [st[f] for f in _PARAMS]
        host = torch.cat(parts).cpu().numpy()
        w = _SNAP_WORDS
        f = {k: v[0] for k, v in
             _rows_to_fields(host[:w, None], _SNAP_FIELDS).items()}
        if after_reset:
            rest = host[w:]
            cells = E.GRIDSIZE * E.GRIDSIZE
            self._map_obs = expand_obs_np(rest[:cells][None])[0]
            self._min_xy = rest[cells:cells + 2].copy()
            self._map_ok, self._map_overflow = (bool(x) for x in
                                                rest[cells + 2:cells + 4])
            (self.n_players, self.n_pieces, self.difficulty,
             self.max_steps) = (int(x) for x in rest[cells + 4:])
        self.map = _DeviceMapView(self._map_obs, f["player_xy"],
                                  self._min_xy)
        self.agent = int(f["agent"])
        self.done = bool(f["done"])
        self.phase = np.uint8(f["phase"])
        self.resources = f["resources"].astype(np.float32)
        self.shop_stock = f["shop_stock"].astype(np.uint8)
        self.piles = f["piles"].astype(np.uint8)
        self.sel_mask = unpack_mask_np(f["sel_mask"])
        self.storage_masks = unpack_mask_np(f["storage_masks"])
        self.rewards = f["rewards"].astype(np.float32)
        self.info_total = np.uint32(f["info_total"])
        self.info_steps = f["info_steps"].astype(np.uint8)
        self.info_returns = f["info_returns"].astype(np.float32)
        self.info_travelled = f["info_travelled"].astype(np.uint32)
        self.info_added = f["info_added"].astype(np.uint8)
        self.info_removed = f["info_removed"].astype(np.uint8)
        self.info_mpc = np.zeros((MAX_N_PLAYERS, 3), np.uint32)  # dead stats
        self.info_card_uses = f["info_card_uses"].astype(np.uint32)

    def _check_map(self):
        if self._map_overflow:
            raise MapCapacityError("map generation overflowed MAX_PLACED")
        if not self._map_ok:
            raise GenerateMapFailure(
                "map generation failed more than MAX_FAILURES times")

    def reset(self, seed=None, n_players=None, n_pieces=None,
              difficulty=None, max_steps=None):
        st, carry = self._static, self._carry
        if seed is not None:
            # cog_env::reset(seed, ...): into the existing state
            dev = carry.device
            self.seed_ = int(seed)
            carry[_OFF["rng"][0], 0] = V.R.seed(V._seeds(seed, 1, dev),
                                                device=dev)[0]
            for name, v in zip(_PARAMS, (n_players, n_pieces, difficulty,
                                         max_steps)):
                st[name][0] = int(v)
        V._reset_columns(carry, st, self._idx)
        self._pull(after_reset=True)
        self._check_map()

    def step(self, action):
        acts = torch.as_tensor(np.asarray(action, np.int32).reshape(1, 5),
                               device=self._carry.device)
        st = self._static
        self._carry, _ = V.step_actions(
            self._carry, acts, st["map_ids"], st["min_xy"], st["n_players"],
            st["max_steps"])
        self._pull(after_reset=False)


class cog_env:
    """Single environment (reference: src/pybind/single_env.cpp:12-86).
    Buffers are owned internally; the reference's init(obs, info, rewards,
    mask) wiring is implicit.

    ``backend="device"`` (default) runs the port's kernels on ``device``
    (K1-act for the step, K3 and K2 for the reset; their plain versions on
    CPU tensors), the analogue of the reference binding the native C++
    engine; ``backend="ref"`` keeps the host-numpy oracle (RefEnv), and
    ignores ``device``."""

    def __init__(self, seed=None, n_players=MAX_N_PLAYERS, n_pieces=3,
                 difficulty=Difficulty.EASY, max_steps=100000, render=False,
                 backend="device", device="cuda"):
        if backend not in ("device", "ref"):
            raise ValueError(f"backend must be 'device' or 'ref', not "
                             f"{backend!r}")
        if seed is None:
            seed = np.random.SeedSequence().entropy % (2 ** 32)
        kw = dict(seed=int(seed), n_players=int(n_players),
                  n_pieces=int(n_pieces), difficulty=int(difficulty),
                  max_steps=int(max_steps))
        self._env = (_DeviceEnv(**kw, device=device) if backend == "device"
                     else RefEnv(**kw))
        self._render = bool(render)
        self._bufs = None

    def init(self, observations, info, rewards, selected_action_masks):
        """Wire caller-owned numpy buffers (reference:
        src/pybind/single_env.cpp:19-21, environment.cpp:25-40). The
        reference env writes through pointers; here the buffers are synced
        after every reset/step."""
        observations = np.asarray(observations).reshape(())
        info = np.asarray(info).reshape(())
        rewards = np.asarray(rewards, np.float32).reshape(MAX_N_PLAYERS)
        selected_action_masks = np.asarray(
            selected_action_masks).reshape(())
        if (observations.dtype != obs_dtype or info.dtype != info_dtype
                or selected_action_masks.dtype != action_mask_dtype):
            raise TypeError("init() expects obs_dtype / info_dtype / "
                            "float32[4] / action_mask_dtype buffers")
        self._bufs = (observations, info, rewards, selected_action_masks)
        self._sync()

    def _sync(self):
        if self._bufs is None:
            return
        obs, info, rewards, mask = self._bufs
        obs[()] = self.observations
        info[()] = self.infos
        rewards[:] = self._env.rewards
        mask[()] = self.selected_action_mask

    def reset(self, seed=None, n_players=None, n_pieces=None,
              difficulty=None, max_steps=None, render=None):
        if render is not None:
            self._render = bool(render)
        if seed is None:
            self._env.reset()
        else:
            self._env.reset(int(seed), int(n_players), int(n_pieces),
                            int(difficulty), int(max_steps))
        self._sync()

    def step(self, action):
        self._env.step(_action_to_vec(action))
        self._sync()

    def get_map(self):
        """Reference parity: cog_env::get_map (include/environment.h:61)
        returns the board object (the C++ binding declares it but never
        registers Map with pybind; here the host-side map twin is returned
        and actually usable)."""
        return self._env.map

    @property
    def agent_selection(self):
        """src/pybind/single_env.cpp:18."""
        return int(self._env.agent)

    def render(self):
        if not self._render:
            print("You are calling render method without specifying any "
                  "render mode.")
            return
        from ..render import render_env
        print(render_env(self._env))

    # -- accessors (reference getter surface) -----------------------------
    def get_done(self):
        return bool(self._env.done)

    def get_agent_selection(self):
        return int(self._env.agent)

    def get_seed(self):
        return int(self._env.seed_)

    def get_n_players(self):
        return int(self._env.n_players)

    def get_n_pieces(self):
        return int(self._env.n_pieces)

    def get_difficulty(self):
        return Difficulty(self._env.difficulty)

    def get_max_steps(self):
        return int(self._env.max_steps)

    def get_render(self):
        return self._render

    @property
    def observations(self):
        e = self._env
        out = np.zeros((), obs_dtype)
        out["shared"]["map"] = e.map.obs
        out["shared"]["phase"] = e.phase
        out["shared"]["current_resources"] = e.resources
        out["shared"]["shop"] = e.shop_stock
        for p in range(MAX_N_PLAYERS):
            pd = out["player_data"][p]
            for i, name in enumerate(("draw", "hand", "active", "played",
                                      "discard")):
                pd["obs"][name] = e.piles[p, i]
            out["player_data"][p]["action_mask"] = _mask_to_struct(
                e.storage_masks[p])
        return out

    @property
    def selected_action_mask(self):
        return _mask_to_struct(self._env.sel_mask)

    @property
    def rewards(self):
        return self._env.rewards.copy()

    @property
    def infos(self):
        e = self._env
        out = np.zeros((), info_dtype)
        out["total_length"] = e.info_total
        ai = out["agent_infos"]
        ai["steps_taken"] = e.info_steps
        ai["returns"] = e.info_returns
        ai["travelled_hexes"] = e.info_travelled
        ai["cards_added"] = e.info_added
        ai["cards_removed"] = e.info_removed
        ai["n_machete_uses"] = e.info_mpc[:, 0]
        ai["n_paddle_uses"] = e.info_mpc[:, 1]
        ai["n_coin_uses"] = e.info_mpc[:, 2]
        ai["n_card_uses"] = e.info_card_uses
        return out


class action_sampler:
    """Masked uniform sampler (include/sampler.h:7-80), on the host."""

    def __init__(self, seed=42):
        self._s = RefSampler(int(seed))

    def set_seed(self, seed):
        self._s.rng.seed(int(seed))

    def sample(self, mask):
        if isinstance(mask, np.void) or (
                hasattr(mask, "dtype") and mask.dtype == action_mask_dtype):
            flat = np.concatenate([mask[k] for k in _HEADS]).astype(bool)
        else:
            flat = np.asarray(mask, bool).reshape(92)
        a = self._s.sample(flat)
        out = np.zeros((), action_dtype)
        for i, name in enumerate(_HEADS):
            out[name] = a[i]
        return out


from . import vec  # noqa: E402  (submodule mirror of city_of_gold.vec)
