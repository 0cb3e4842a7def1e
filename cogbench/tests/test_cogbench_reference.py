"""The benchmark's frozen reference engine against the oracle goldens.

Replays the oracle's trajectory dumps in tests/golden/ (read only) through
``cogbench.reference.engine``: masked-random self-play with the built-in
sampler and same-step auto-reset, every dumped field compared every step,
and the maps after each reset. The four cases are the fast ones (a
truncation on each mask surface, a hard and a medium map); the card table
and the piece library are held to the oracle's table dump. Then the
state bridge: an env of the system under test, loaded into the reference
and read back, compares equal, and a field changed in it does not.
"""
import pathlib
import re

import numpy as np
import pytest

from cogbench.reference import state as S
from cogbench.reference import tables as T
from cogbench.reference.engine import RefEnv, RefSampler

GOLDEN = pathlib.Path(__file__).resolve().parents[2] / "tests" / "golden"

FIELDS = ("done", "agent", "phase", "rewards", "resources", "shop", "piles",
          "sel_mask", "storage_masks", "info_total", "info_steps",
          "info_returns", "info_travelled", "info_added", "info_removed",
          "info_mpc", "info_card_uses")


@pytest.mark.parametrize("name,mask_src,max_steps", [
    ("traj_trunc", 0, 100), ("traj_trunc_storage", 1, 100),
    ("traj_3p_hard", 0, 100000), ("traj_4p_medium", 0, 100000)])
def test_trajectory_matches_oracle(name, mask_src, max_steps):
    d = np.load(GOLDEN / f"{name}.npz")
    es, ss, n_players, n_pieces, diff, steps = (int(v) for v in d["header"])
    env = RefEnv(seed=es, n_players=n_players, n_pieces=n_pieces,
                 difficulty=diff, max_steps=max_steps)
    sampler = RefSampler(ss)
    env.reset()
    assert np.array_equal(env.map.obs, d["map0"])
    assert np.array_equal(env.piles, d["piles0"])
    assert np.array_equal(env.storage_masks.astype(np.uint8), d["storage0"])
    for t in range(steps):
        src = env.storage_masks[env.agent] if mask_src else env.sel_mask
        act = sampler.sample(src)
        env.step(act)
        done = env.done
        if done:
            env.reset()
        assert np.array_equal(act, d["actions"][t]), f"step {t}: actions"
        got = {
            "done": np.uint8(done), "agent": np.uint8(env.agent),
            "phase": env.phase, "rewards": env.rewards,
            "resources": env.resources, "shop": env.shop_stock,
            "piles": env.piles, "sel_mask": env.sel_mask.astype(np.uint8),
            "storage_masks": env.storage_masks.astype(np.uint8),
            "info_total": np.uint32(env.info_total),
            "info_steps": env.info_steps, "info_returns": env.info_returns,
            "info_travelled": env.info_travelled,
            "info_added": env.info_added, "info_removed": env.info_removed,
            "info_mpc": env.info_mpc, "info_card_uses": env.info_card_uses}
        for f in FIELDS:
            assert np.array_equal(np.asarray(got[f]), np.asarray(d[f][t])), \
                f"step {t}: {f}"
        if done:
            k = np.nonzero(d["reset_steps"] == t)[0]
            if len(k):
                assert np.array_equal(env.map.obs, d["reset_maps"][k[0]])


def test_tables_match_oracle_dump():
    cards, pieces = [], []
    for line in (GOLDEN / "tables.txt").read_text().splitlines():
        m = re.match(r"card (\d+) type=(\d+) cost=(\d+) mkt=(\d+) su=(\d+) "
                     r"res=(\d+),(\d+),(\d+) special=(\d+)", line)
        if m:
            cards.append([int(g) for g in m.groups()])
        m = re.match(r"piece (\w+) (\d+) diff=(\d+) type=(\d+) size=(\d+) "
                     r"n=(\d+)", line)
        if m:
            pieces.append([int(g) for g in m.groups()[1:]])
    assert len(cards) == len(T.CARD_COST) and pieces
    for c in cards:
        i = c[0]
        assert (T.CARD_COST[i], T.CARD_IN_MARKET[i], T.CARD_SINGLE_USE[i]) \
            == (c[2], bool(c[3]), bool(c[4]))
        assert list(T.CARD_RES[i]) == c[5:8]
    assert sorted(p[4] for p in pieces) == sorted(T.PIECE_N_HEX.tolist())


def _system_fields(seed, n_players=4, n_pieces=3, max_steps=100):
    import torch  # noqa: F401
    import eldorado_tpu_torch as et
    s = et.vec_reset(seed, 2, n_players, n_pieces, 0, max_steps,
                     device="cpu")
    return {f: getattr(s, f)[1].numpy() for f in S.FIELDS}


def test_state_bridge_round_trip():
    fields = _system_fields(4000000000)
    env, sampler = S.load(fields, 12345)
    assert sampler.rng.state == 12345
    assert S.differ(S.extract(env), S.system_view(fields)) == []
    # the reference's own reset of env 1 from its seed agrees
    ref = RefEnv(seed=(4000000000 + 1) & 0xFFFFFFFF, n_players=4,
                 n_pieces=3, difficulty=0, max_steps=100)
    ref.reset()
    assert S.differ(S.extract(ref), S.system_view(fields)) == []
    for f, change in (("resources", lambda x: x + 1),
                      ("sel_mask", lambda x: x ^ 1),
                      ("map_ids", lambda x: np.roll(x, 1)),
                      ("rng_tainted", lambda x: ~x)):
        bad = dict(fields, **{f: change(fields[f])})
        assert S.differ(S.extract(env), S.system_view(bad)), f
