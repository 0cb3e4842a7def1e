"""`city_of_gold.vec` mirror: vectorised env / sampler / runner factories.

Port of ``eldorado_tpu/compat/vec.py``. Reference surface:
src/pybind/vectorized.cpp:8-21 exposes get_vec_env(N) / get_vec_sampler(N)
/ get_runner(N) with N drawn from a compile-time instantiation list capped
at 256. Here N is any positive int; the returned objects wrap the lockstep
batch of `eldorado_tpu_torch.vec` on ``device`` (the card unless the
caller passes ``device="cpu"``) and materialise numpy structured views on
access: each getter copies the fields it needs to the host once.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..constants import Difficulty, MAX_N_PLAYERS
from ..core.cells import expand_obs_np
from ..devices import resolve
from ..vec import VecEnv, sampler_init, vec_sample
from . import (_HEAD_SLICES, _HEADS, action_dtype, action_mask_dtype,
               host_fields, info_dtype, obs_dtype, unpack_mask_np)

_PILES = ("draw", "hand", "active", "played", "discard")
_OBS_FIELDS = ("phase", "resources", "shop_stock", "piles", "storage_masks")
_INFO_FIELDS = ("info_total", "info_steps", "info_returns", "info_travelled",
                "info_added", "info_removed", "info_card_uses")


def _flat_masks_to_struct(flat):
    out = np.zeros(flat.shape[0], action_mask_dtype)
    for name, (a, b) in zip(_HEADS, _HEAD_SLICES):
        out[name] = flat[:, a:b]
    return out


def _struct_to_flat(m):
    """(n,) action_mask_dtype or (n, 92) -> (n, 92) bool."""
    m = np.asarray(m)
    if m.dtype == action_mask_dtype:
        m = np.concatenate([m[k] for k in _HEADS], axis=-1)
    return m.astype(bool)


def pack_obs_plain(map_u8, f):
    """The numpy packing of the observations into obs_dtype records: the
    plain version of `native.pack_obs`, which the tests hold it to.
    ``map_u8`` (n, 48, 48, 7), ``f`` the fields of `_OBS_FIELDS`."""
    n = map_u8.shape[0]
    out = np.zeros(n, obs_dtype)
    out["shared"]["map"] = map_u8
    out["shared"]["phase"] = f["phase"].astype(np.uint8)
    out["shared"]["current_resources"] = f["resources"]
    out["shared"]["shop"] = f["shop_stock"]
    storage = unpack_mask_np(f["storage_masks"])
    for p in range(MAX_N_PLAYERS):
        pd = out["player_data"][:, p]
        for i, name in enumerate(_PILES):
            pd["obs"][name] = f["piles"][:, p, i]
        for name, (a, b) in zip(_HEADS, _HEAD_SLICES):
            pd["action_mask"][name] = storage[:, p, a:b]
    return out


class VecEnvCompat:
    """vec_cog_env<N> equivalent (include/vec_environment.h:10-81) with
    per-step auto-reset semantics: `vec.VecEnv(n, mask_src="sel")`, whose
    step is K1-act, then K3 and K2 on the done envs."""

    def __init__(self, n_envs: int, device="cuda"):
        self.n_envs = n_envs
        self._v = VecEnv(n_envs, mask_src="sel", device=device)
        self._last_done = np.zeros(n_envs, bool)

    def reset(self, seed=0, n_players=MAX_N_PLAYERS, n_pieces=3,
              difficulty=Difficulty.EASY, max_steps=100000, render=False):
        self._v.reset(seed=int(seed), n_players=int(n_players),
                      n_pieces=int(n_pieces), difficulty=int(difficulty),
                      max_steps=int(max_steps))

    def step(self, actions):
        a = np.asarray(actions)
        if a.dtype == action_dtype:
            a = np.stack([a[k].astype(np.int32) for k in _HEADS], axis=-1)
        done = self._v.step(torch.as_tensor(a.astype(np.int32)))
        self._last_done = done.cpu().numpy()
        return self._last_done

    def _fields(self, names):
        """DYN fields of the batch on the host, in one copy."""
        return host_fields(self._v._carry, names)

    def get_num_envs(self):
        return self.n_envs

    def get_num_players(self):
        return int(self._v._static["n_players"][0])

    def get_agent_selections(self):
        return self._fields(("agent",))["agent"].astype(np.uint8)

    def get_dones(self):
        return self._last_done

    def get_rewards(self):
        return self._fields(("rewards",))["rewards"]

    def get_selected_action_masks(self):
        return _flat_masks_to_struct(unpack_mask_np(
            self._fields(("sel_mask",))["sel_mask"]))

    def get_observations(self):
        f = self._fields(_OBS_FIELDS)
        map_u8 = expand_obs_np(self._v._static["map_ids"].cpu().numpy())
        # one-pass native packing into the reference ObsData layout
        packed = native.pack_obs(
            map_u8, f["phase"], f["resources"], f["shop_stock"], f["piles"],
            unpack_mask_np(f["storage_masks"]).astype(np.uint8))
        return packed.reshape(-1).view(obs_dtype)

    def get_infos(self):
        f = self._fields(_INFO_FIELDS)
        out = np.zeros(self.n_envs, info_dtype)
        out["total_length"] = f["info_total"].astype(np.uint32)
        ai = out["agent_infos"]
        ai["steps_taken"] = f["info_steps"]
        ai["returns"] = f["info_returns"]
        ai["travelled_hexes"] = f["info_travelled"].astype(np.uint32)
        ai["cards_added"] = f["info_added"]
        ai["cards_removed"] = f["info_removed"]
        ai["n_card_uses"] = f["info_card_uses"].astype(np.uint32)
        return out

    def get_info(self, i):
        return self.get_infos()[i]

    # device-native accessors (the fast path a learner should use)
    @property
    def states(self):
        return self._v.states


class VecSamplerCompat:
    """vec_action_sampler<N> equivalent (include/vec_sampler.h:7-28):
    `vec.vec_sample` (K1-sample) on engines seeded seed + i, on
    ``device``."""

    def __init__(self, n_envs: int, device="cuda"):
        self.n_envs = n_envs
        self.device = resolve(device)
        self._rngs = sampler_init(42, n_envs, device=self.device)
        self._actions = np.zeros((n_envs, 5), np.uint8)

    def seed(self, seed):
        self._rngs = sampler_init(int(seed), self.n_envs, device=self.device)

    def sample(self, masks):
        m = torch.as_tensor(_struct_to_flat(masks), device=self.device)
        actions, self._rngs, _ = vec_sample(self._rngs, m)
        self._actions = actions.cpu().numpy().astype(np.uint8)
        out = np.zeros(self.n_envs, action_dtype)
        for i, name in enumerate(_HEADS):
            out[name] = self._actions[:, i]
        return out

    def get_actions(self):
        return self._actions


class RunnerCompat:
    """ThreadedRunner<N> equivalent (include/runner.h:93-100): sample and
    step enqueue their kernels (K1-sample, K1-act, and K3 and K2 on the
    done envs) on the device's stream, in place of the reference's SPSC
    queues; sync() waits for them."""

    def __init__(self, n_envs: int, n_threads: int = 0, device="cuda"):
        # n_threads accepted for signature parity; the card has no pool
        self.n_envs = n_envs
        self._v = VecEnv(n_envs, mask_src="sel", device=device)
        self._actions = None

    def reset(self, seed=0, n_players=MAX_N_PLAYERS, n_pieces=3,
              difficulty=Difficulty.EASY, max_steps=100000, render=False):
        self._v.reset(seed=int(seed), n_players=int(n_players),
                      n_pieces=int(n_pieces), difficulty=int(difficulty),
                      max_steps=int(max_steps))

    def sample(self):
        self._actions = self._v.sample()

    def step(self):
        if self._actions is None:
            self.sample()
        self._v.step(self._actions)

    def step_sync(self):
        self.step()
        self.sync()

    def sync(self):
        if self._v.device.type == "cuda":
            torch.cuda.synchronize(self._v.device)

    @property
    def env(self):
        return self._v


def get_vec_env(n: int, device="cuda") -> VecEnvCompat:
    return VecEnvCompat(n, device=device)


def get_vec_sampler(n: int, device="cuda") -> VecSamplerCompat:
    return VecSamplerCompat(n, device=device)


def get_runner(n: int, n_threads: int = 0, device="cuda") -> RunnerCompat:
    return RunnerCompat(n, n_threads, device=device)
