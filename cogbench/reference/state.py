"""One env's state as the system under test returns it, and the reference
engine's state in the same terms.

The system hands back a batch as named per-env fields (its ``EnvState``:
numpy copies of one env's rows, keyed by field name). `load` builds the
reference engine (`engine.RefEnv`) and its sampler in exactly that state;
`extract` reads a reference engine back into the same fields; `differ`
names the fields in which two such dicts disagree, bit for bit. The
layouts read here are the system's public field formats: masks as three
little-endian 32-bit words of the 92-slot mask, f32 fields as floats, the
map as one cell-type id per grid cell (the ids index `CELL_TRIPLES`).
"""
from __future__ import annotations

import numpy as np

from . import tables as T
from .constants import GRIDSIZE, MAX_N_PLAYERS
from .engine import MASK_LEN, MinstdRng, RefEnv, RefMap, RefSampler

# every (requirement, n_required, is_end) triple a map cell can hold, the
# empty cell first: a cell-type id is an index into this list
CELL_TRIPLES = np.asarray(
    [(5, 0, 0)] + sorted({tuple(int(x) for x in h[:3])
                          for h in T.PIECE_HEX[T.PIECE_HEX_VALID]}
                         - {(5, 0, 0)}), np.int64)
MASK_WORDS = 3

# fields compared as they are, and the reference engine's name for each
_SAME = {
    "rng": None, "n_players": "n_players", "n_pieces": "n_pieces",
    "difficulty": "difficulty", "max_steps": "max_steps",
    "piles": "piles", "n_in_hand": "n_in_hand", "n_active": "n_active",
    "n_in_draw": "n_in_draw", "idx_last": "idx_last_activated",
    "has_won": "has_won", "mip": "movement_in_progress",
    "next_card_free": "next_card_free", "next_move_free": "next_move_free",
    "n_removes": "n_removes", "steps_taken": "steps_taken",
    "n_movements": "n_movements", "n_added": "n_added_cards",
    "shop_stock": "shop_stock", "in_market": "in_market",
    "n_in_market": "n_in_market", "phase": "phase", "agent": "agent",
    "resources": "resources", "turn_counter": "turn_counter",
    "done": "done", "rewards": "rewards", "info_total": "info_total",
    "info_steps": "info_steps", "info_returns": "info_returns",
    "info_travelled": "info_travelled", "info_added": "info_added",
    "info_removed": "info_removed", "info_card_uses": "info_card_uses",
}
_FLOATS = ("resources", "rewards", "info_returns")
_BOOLS = ("has_won", "mip", "next_card_free", "next_move_free",
          "in_market", "done")
# every field `differ` compares: the ones above, the map and the masks,
# and the two flags the reference cannot raise (a failed map generation
# raises in the reference; a tainted sampler draw is the system's own
# deviation from the exact stream)
COMPARED = tuple(_SAME) + ("map", "min_xy", "player_xy", "sel_mask",
                           "storage_masks", "map_ok", "map_overflow",
                           "rng_tainted")
# the system's fields `load` reads
FIELDS = tuple(f for f in _SAME) + ("map_ids", "min_xy", "player_xy",
                                    "sel_mask", "storage_masks", "map_ok",
                                    "map_overflow", "rng_tainted")


def expand_map(ids) -> np.ndarray:
    """(2304,) cell-type ids -> the (48, 48, 7) uint8 map observation:
    channel req + 1 holds n_required where a requirement is set, channel 6
    is_end."""
    trip = CELL_TRIPLES[np.asarray(ids, np.int64).reshape(-1)]
    out = np.zeros((trip.shape[0], 7), np.uint8)
    filled = trip[:, 0] < 5
    rows = np.nonzero(filled)[0]
    out[rows, trip[rows, 0] + 1] = trip[rows, 1]
    out[:, 6] = trip[:, 2]
    return out.reshape(GRIDSIZE, GRIDSIZE, 7)


def unpack_mask(words) -> np.ndarray:
    """(..., 3) 32-bit words -> (..., 92) bool, bit k of word w is slot
    32 w + k."""
    w = np.asarray(words, np.int64).astype(np.uint32)
    bits = (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(w.shape[:-1] + (32 * MASK_WORDS,))[..., :MASK_LEN] \
        != 0


def pack_mask(bits) -> np.ndarray:
    """(..., 92) bool -> (..., 3) int64 words (the inverse of
    `unpack_mask`)."""
    b = np.asarray(bits, bool)
    pad = np.zeros(b.shape[:-1] + (32 * MASK_WORDS - MASK_LEN,), bool)
    b = np.concatenate([b, pad], -1).reshape(b.shape[:-1] + (MASK_WORDS, 32))
    return (b.astype(np.int64) << np.arange(32)).sum(-1)


def _canon(name, x):
    """A field's value in one form for comparing: floats as their bits,
    bools as bools, integers as int64 modulo 2**32."""
    x = np.asarray(x)
    if name in _FLOATS:
        return np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    if name in _BOOLS or x.dtype == bool:
        return x.astype(bool)
    return x.astype(np.int64) & 0xFFFFFFFF


def system_view(fields: dict) -> dict:
    """The system's fields of one env in the form `differ` compares."""
    out = {f: _canon(f, fields[f]) for f in _SAME}
    out["map"] = expand_map(fields["map_ids"])
    out["min_xy"] = _canon("min_xy", fields["min_xy"])
    out["player_xy"] = _canon("player_xy", fields["player_xy"])
    out["sel_mask"] = unpack_mask(fields["sel_mask"])
    out["storage_masks"] = unpack_mask(fields["storage_masks"])
    for f in ("map_ok", "map_overflow", "rng_tainted"):
        out[f] = np.asarray(fields[f]).astype(bool)
    return out


def extract(env: RefEnv) -> dict:
    """A reference engine's state in the form `differ` compares."""
    out = {}
    for f, attr in _SAME.items():
        out[f] = _canon(f, env.rng.state if attr is None
                        else getattr(env, attr))
    out["map"] = env.map.obs.copy()
    out["min_xy"] = _canon("min_xy", env.map.min_xy)
    out["player_xy"] = _canon("player_xy", env.map.player_xy)
    out["sel_mask"] = env.sel_mask.astype(bool).copy()
    out["storage_masks"] = env.storage_masks.astype(bool).copy()
    out["map_ok"] = np.asarray(True)
    out["map_overflow"] = np.asarray(False)
    out["rng_tainted"] = np.asarray(False)
    return out


def differ(a: dict, b: dict) -> list:
    """The names of the compared fields in which ``a`` and ``b`` differ."""
    return [f for f in COMPARED
            if np.asarray(a[f]).shape != np.asarray(b[f]).shape
            or not np.array_equal(a[f], b[f])]


def load(fields: dict, sampler_state: int):
    """A reference engine and sampler in the state of one env of the
    system (``fields``, as `FIELDS` names them) and its sampler engine."""
    g = {f: np.asarray(v) for f, v in fields.items()}
    env = RefEnv(seed=1, n_players=int(g["n_players"]),
                 n_pieces=int(g["n_pieces"]),
                 difficulty=int(g["difficulty"]),
                 max_steps=int(g["max_steps"]))
    env.rng.state = int(g["rng"])
    m = RefMap()
    m.obs[:] = expand_map(g["map_ids"])
    m.min_xy = g["min_xy"].astype(np.int64).copy()
    m.player_xy = g["player_xy"].astype(np.int64).reshape(
        MAX_N_PLAYERS, 2).copy()
    m.n_players = env.n_players
    env.map = m
    u8 = np.uint8
    env.piles = g["piles"].astype(u8).copy()
    for f in ("n_in_hand", "n_active", "n_in_draw", "n_removes",
              "steps_taken", "info_steps", "info_added", "info_removed"):
        setattr(env, _SAME[f], g[f].astype(u8).copy())
    env.idx_last_activated = g["idx_last"].astype(u8).copy()
    env.n_added_cards = g["n_added"].astype(u8).copy()
    for f in ("has_won", "mip", "next_card_free", "next_move_free"):
        setattr(env, _SAME[f], g[f].astype(bool).copy())
    env.n_movements = g["n_movements"].astype(np.uint32).copy()
    env.shop_stock = g["shop_stock"].astype(u8).copy()
    env.in_market = g["in_market"].astype(bool).copy()
    env.n_in_market = u8(int(g["n_in_market"]))
    env.phase = u8(int(g["phase"]))
    env.agent = int(g["agent"])
    env.resources = g["resources"].astype(np.float32).copy()
    env.turn_counter = int(g["turn_counter"])
    env.done = bool(g["done"])
    env.sel_mask = unpack_mask(g["sel_mask"]).copy()
    env.storage_masks = unpack_mask(g["storage_masks"]).copy()
    env.rewards = g["rewards"].astype(np.float32).copy()
    env.info_total = np.uint32(int(g["info_total"]) & 0xFFFFFFFF)
    env.info_returns = g["info_returns"].astype(np.float32).copy()
    env.info_travelled = g["info_travelled"].astype(np.uint32).copy()
    env.info_card_uses = g["info_card_uses"].astype(np.uint32).copy()
    sampler = RefSampler(1)
    sampler.rng = MinstdRng.__new__(MinstdRng)
    sampler.rng.state = int(sampler_state)
    return env, sampler
