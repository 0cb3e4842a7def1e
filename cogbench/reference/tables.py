"""Static game data as numpy constant arrays (computed once at import).

The benchmark's frozen copy, so that its reference engine imports nothing
of the system it judges; cogbench/tests/test_cogbench_reference.py pins it
to the oracle's dump in tests/golden/tables.txt.

This is the array-native equivalent of the reference's pointer-based static
data: the 21-card table (reference: src/cards.cpp:40-78), the shop slot map
(src/cards.cpp:72-78), the 20-piece map library (src/map.cpp:446-695), and the
piece connection tables (src/map.cpp:203-263). Everything lives in *doubled*
integer axial coordinates (X = 2x, Y = 2y) so all geometry — rotation,
translation, overlap, grid rasterisation — is exact integer arithmetic (the
reference's float coordinates are dyadic rationals whose float ops all round
exactly; verified against tools/parity_probe/tables_probe.cpp dumps).

Hex-grid rotation by 60° in these axial coordinates is the integer linear map
(x, y) -> (-y, x + y); ROT[k] below is its k-th power.
"""
from __future__ import annotations

import numpy as np

from .constants import (
    CardType,
    Difficulty,
    N_BUYABLETYPES,
    N_CARDTYPES,
    Requirement,
)

# --------------------------------------------------------------------------
# Card table. Columns: cost, starts_in_market, single_use, res_machete,
# res_paddle, res_coin, special_id. Special ids: 0 none, 1 transmit,
# 2 draw2, 3 draw3, 4 draw1+remove1, 5 draw2+remove2, 6 native.
# (reference: src/cards.cpp:40-71)
# --------------------------------------------------------------------------
SPECIAL_NONE = 0
SPECIAL_TRANSMIT = 1
SPECIAL_DRAW2 = 2
SPECIAL_DRAW3 = 3
SPECIAL_DRAW1_REMOVE1 = 4
SPECIAL_DRAW2_REMOVE2 = 5
SPECIAL_NATIVE = 6
# Pseudo-special used by the step function for the "shop stays disabled while
# removes remain" continuation (reference: src/environment.cpp:156-159).
SPECIAL_SHOP_DISABLE = 7

_CARDS = {
    CardType.EXPLORER: (1, 0, 0, (1, 0, 0), SPECIAL_NONE),
    CardType.SCOUT: (1, 1, 0, (2, 0, 0), SPECIAL_NONE),
    CardType.TRAILBLAZER: (3, 1, 0, (3, 0, 0), SPECIAL_NONE),
    CardType.PIONEER: (5, 0, 0, (5, 0, 0), SPECIAL_NONE),
    CardType.GIANT_MACHETE: (3, 0, 1, (6, 0, 0), SPECIAL_NONE),
    CardType.SAILOR: (1, 0, 0, (0, 1, 0), SPECIAL_NONE),
    CardType.CAPTAIN: (2, 0, 0, (0, 3, 0), SPECIAL_NONE),
    CardType.TRAVELER: (1, 0, 0, (0, 0, 1), SPECIAL_NONE),
    CardType.PHOTOGRAPHER: (2, 1, 0, (0, 0, 2), SPECIAL_NONE),
    CardType.JOURNALIST: (3, 0, 0, (0, 0, 3), SPECIAL_NONE),
    CardType.TREASURE_CHEST: (3, 1, 0, (0, 0, 4), SPECIAL_NONE),
    CardType.MILLIONAIRE: (5, 0, 0, (0, 0, 4), SPECIAL_NONE),
    CardType.JACK_OF_ALL_TRADES: (2, 1, 0, (1, 1, 1), SPECIAL_NONE),
    CardType.ADVENTURER: (4, 0, 0, (2, 2, 2), SPECIAL_NONE),
    CardType.PROP_PLANE: (4, 0, 1, (4, 4, 4), SPECIAL_NONE),
    CardType.TRANSMITTER: (4, 1, 1, (0, 0, 0), SPECIAL_TRANSMIT),
    CardType.CARTOGRAPHER: (4, 0, 0, (0, 0, 0), SPECIAL_DRAW2),
    CardType.COMPASS: (2, 0, 1, (0, 0, 0), SPECIAL_DRAW3),
    CardType.SCIENTIST: (4, 0, 0, (0, 0, 0), SPECIAL_DRAW1_REMOVE1),
    CardType.TRAVEL_LOG: (3, 0, 1, (0, 0, 0), SPECIAL_DRAW2_REMOVE2),
    CardType.NATIVE: (5, 0, 0, (0, 0, 0), SPECIAL_NATIVE),
}

CARD_COST = np.array([_CARDS[CardType(i)][0] for i in range(N_CARDTYPES)], np.uint8)
CARD_IN_MARKET = np.array([_CARDS[CardType(i)][1] for i in range(N_CARDTYPES)], bool)
CARD_SINGLE_USE = np.array([_CARDS[CardType(i)][2] for i in range(N_CARDTYPES)], bool)
CARD_RES = np.array([_CARDS[CardType(i)][3] for i in range(N_CARDTYPES)], np.uint8)
CARD_SPECIAL = np.array([_CARDS[CardType(i)][4] for i in range(N_CARDTYPES)], np.int32)
CARD_IS_SPECIAL = CARD_SPECIAL > 0

# Shop slots hold every type except the three starters EXPLORER/SAILOR/TRAVELER
# (reference: src/cards.cpp:72-78).
SHOP_CARD_TYPE = np.array(
    [t for t in range(N_CARDTYPES)
     if t not in (CardType.EXPLORER, CardType.SAILOR, CardType.TRAVELER)],
    np.int32,
)
assert SHOP_CARD_TYPE.shape == (N_BUYABLETYPES,)
SHOP_COST = CARD_COST[SHOP_CARD_TYPE]
SHOP_STARTS_IN_MARKET = CARD_IN_MARKET[SHOP_CARD_TYPE]

# --------------------------------------------------------------------------
# Piece geometry in doubled axial coordinates.
# --------------------------------------------------------------------------
PIECE_LARGE, PIECE_SMALL, PIECE_TRIPLE = 0, 1, 2
TYPE_START, TYPE_TRAVEL, TYPE_END = 0, 1, 2

# 60-degree rotation powers: (x, y) -> (-y, x + y) applied k times.
ROT = np.empty((6, 2, 2), np.int64)
_r1 = np.array([[0, -1], [1, 1]], np.int64)  # row-vector convention: v' = R @ v
ROT[0] = np.eye(2, dtype=np.int64)
for _k in range(1, 6):
    ROT[_k] = _r1 @ ROT[_k - 1]


def rotate_xy(xy: np.ndarray, times: int) -> np.ndarray:
    """Rotate doubled-int coords by times*60 degrees (any integer times)."""
    return xy @ ROT[times % 6].T


def _hexrow(y: float, xs) -> list[tuple[int, int]]:
    return [(int(round(2 * x)), int(round(2 * y))) for x in xs]


# Large piece: centered hexagon of 37 cells, rows y=-3..3
# (reference coordinate list: src/map.cpp:446-454).
LARGE_XY = np.array(
    _hexrow(-3, range(0, 4))
    + _hexrow(-2, range(-1, 4))
    + _hexrow(-1, range(-2, 4))
    + _hexrow(0, range(-3, 4))
    + _hexrow(1, range(-3, 3))
    + _hexrow(2, range(-3, 2))
    + _hexrow(3, range(-3, 1)),
    np.int64,
)
assert LARGE_XY.shape == (37, 2)

# Small piece: 16 cells, half-integer x (src/map.cpp:456-460).
SMALL_XY = np.array(
    _hexrow(-1, [x + 0.5 for x in range(-2, 3)])
    + _hexrow(0, [x + 0.5 for x in range(-3, 3)])
    + _hexrow(1, [x + 0.5 for x in range(-3, 2)]),
    np.int64,
)
assert SMALL_XY.shape == (16, 2)

# End piece: 3 cells (src/map.cpp:462).
END_XY = np.array([(0, 0), (2, 0), (-2, 2)], np.int64)

# --------------------------------------------------------------------------
# Terrain legend: j=jungle(machete) w=water(paddle) d=desert(coin)
# r=rubble(discard) b=basecamp(remove) M=mountain S#=player start E=end hex.
# The digit is n_required. Transcribed from src/map.cpp:464-695 and verified
# against tables_probe dumps.
# --------------------------------------------------------------------------
_REQ_OF = {
    "j": Requirement.MACHETE,
    "w": Requirement.PADDLE,
    "d": Requirement.COIN,
    "r": Requirement.DISCARD,
    "b": Requirement.REMOVE,
}


def _parse(spec: str) -> np.ndarray:
    """-> [n, 4] uint8 rows of (requirement, n_required, is_end, player_start)."""
    out = []
    for tok in spec.split():
        if tok == "M":
            out.append((Requirement.NULL, 0, 0, 0))
        elif tok[0] == "S":
            out.append((Requirement.NULL, 0, 0, int(tok[1])))
        elif tok[0] == "E":
            req = Requirement.PADDLE if tok[1] == "w" else Requirement.MACHETE
            out.append((req, 1, 1, 0))
        else:
            out.append((_REQ_OF[tok[0]], int(tok[1]), 0, 0))
    return np.array(out, np.uint8)


_E = Difficulty.EASY
_M = Difficulty.MEDIUM
_H = Difficulty.HARD

# (terrain spec, difficulty, type, size)
_PIECES: list[tuple[str, int, int, int]] = [
    # -- start pieces (src/map.cpp:464-524)
    ("S1 S2 S3 S4 j1 j1 j1 j1 j1 j1 j1 d1 j1 w1 j1 j1 d1 j1 w1 j1 d1 j1 j1 M "
     "d1 j1 j1 j1 w1 M j1 j1 d1 j1 b1 j1 j1", _E, TYPE_START, PIECE_LARGE),
    ("S4 S3 S2 S1 j1 j1 j1 j1 j1 j1 j1 w1 j1 j1 j1 w1 j1 d1 j1 d1 j1 j1 j1 d1 "
     "j1 j1 j1 j1 j1 j1 d1 M j1 j1 w1 b1 w1", _E, TYPE_START, PIECE_LARGE),
    # -- travel pieces C..R (src/map.cpp:526-686)
    ("j1 j1 w1 w1 d1 r1 j1 d1 w1 d1 r1 w1 w1 d1 d1 w1 d1 r1 M w1 r1 r1 w1 w1 "
     "d1 d1 r1 w1 j1 d1 r1 w1 w1 j1 j1 r1 r1", _E, TYPE_TRAVEL, PIECE_LARGE),
    ("j2 j1 j1 j1 j1 w1 w1 w1 j1 j1 w1 w2 w1 w1 j1 j2 j1 j1 M w2 w1 j2 j1 d3 "
     "M j1 w1 j1 M d1 d3 j1 j1 w3 M j1 j2", _M, TYPE_TRAVEL, PIECE_LARGE),
    ("j1 j1 j1 r1 r1 w2 M j2 j1 r1 j2 r1 j1 w1 d1 M M r3 w1 w1 M d1 r1 r1 j3 "
     "M j1 d1 j1 j2 j1 j2 d1 j1 r1 j1 b1", _H, TYPE_TRAVEL, PIECE_LARGE),
    ("r1 r1 j1 b1 r1 d1 d1 j3 j2 j2 j1 d2 r2 j1 r1 j1 j1 w2 M j1 w2 b2 M M w3 "
     "j2 j1 w2 M w1 w1 j1 r1 w1 w1 r1 r1", _E, TYPE_TRAVEL, PIECE_LARGE),
    ("j1 j1 j1 r1 r1 w1 M j2 j1 r1 j1 r1 j1 w1 d1 M M r3 w1 w1 M d1 r1 r1 j3 "
     "M j1 d1 j1 j2 j1 j2 d1 j1 r1 j1 b1", _H, TYPE_TRAVEL, PIECE_LARGE),
    ("j2 j2 j2 j1 j2 j1 j1 j1 w2 j2 j1 d1 d1 w1 w2 j1 j1 d1 d2 d1 w1 w2 d1 d2 "
     "d2 d1 w1 w2 d2 M d2 w1 w2 d3 d2 d1 w1", _M, TYPE_TRAVEL, PIECE_LARGE),
    ("j2 j2 j2 j1 j2 j1 j1 j1 w2 j2 j1 d1 d1 w1 w2 j1 j1 d1 d2 d1 w1 w2 d1 d2 "
     "d2 d1 w1 w2 d2 M d2 w1 w2 d3 d2 d1 w1", _M, TYPE_TRAVEL, PIECE_LARGE),
    ("d1 d1 d1 r2 d1 d2 d2 M r1 d1 d2 j1 j1 r2 r1 d1 d1 j3 b1 j1 r2 r1 w1 w2 "
     "j1 j2 r2 r1 w1 M w2 w1 r2 w1 w1 w1 w1", _E, TYPE_TRAVEL, PIECE_LARGE),
    ("j2 j2 j2 j1 j1 j1 j1 j1 j2 j1 j2 j3 j3 w3 j2 b1 j1 j1 j1 j1 j1 b1 j2 d4 "
     "j3 j3 j2 j1 j2 j1 j1 j1 j1 j1 j2 j2 j2", _M, TYPE_TRAVEL, PIECE_LARGE),
    ("j2 j2 j1 j3 j1 j1 j1 j3 b1 j1 j2 M j3 w1 b1 M j1 j1 j1 j1 w1 w1 j1 d2 "
     "j2 M j1 j1 j2 b1 j2 j1 j2 j2 d2 j1 j2", _M, TYPE_TRAVEL, PIECE_LARGE),
    ("b1 j1 j1 j1 w4 M M d4 j1 M w1 j1 j1 d2 j1 M j1 j1 r2 j1 j1 M j1 r2 M M "
     "M M j1 r2 j1 j1 j1 j1 j1 w1 w1", _H, TYPE_TRAVEL, PIECE_LARGE),
    ("d1 w1 w1 j1 d1 d2 w1 j1 j1 j1 d2 d3 w1 j2 j1 j1 j1 j1 d4 j1 j1 j1 j1 j2 "
     "w1 d3 d2 d1 j1 j1 w1 w1 d1 j1 j1 w1 w1", _M, TYPE_TRAVEL, PIECE_LARGE),
    ("d2 j2 d1 d1 d2 d1 M M w4 M d1 d1 j1 j2 j1 d1", _H, TYPE_TRAVEL, PIECE_SMALL),
    ("w3 w2 w1 w2 w3 j1 w1 w1 w1 w1 r1 w1 r2 w3 j2 w1", _M, TYPE_TRAVEL, PIECE_SMALL),
    ("j1 r3 j1 j1 w2 j2 r1 j2 d3 w1 j2 r1 d1 d1 w1 j3", _M, TYPE_TRAVEL, PIECE_SMALL),
    ("j1 j1 M d1 d1 j1 j3 M d1 b1 d1 j1 j1 M d1 d1", _M, TYPE_TRAVEL, PIECE_SMALL),
    # -- end pieces (src/map.cpp:688-695)
    ("Ew Ew Ew", _E, TYPE_END, PIECE_TRIPLE),
    ("Em Em Em", _E, TYPE_END, PIECE_TRIPLE),
]

N_PIECES_TOTAL = len(_PIECES)  # 20
N_START_PIECES = 2
N_TRAVEL_PIECES = 16
N_END_PIECES = 2
START_PIECE_0 = 0
TRAVEL_PIECE_0 = N_START_PIECES  # global piece id of travel piece 0
END_PIECE_0 = N_START_PIECES + N_TRAVEL_PIECES
MAX_HEXES_PER_PIECE = 37

_SIZE_XY = {PIECE_LARGE: LARGE_XY, PIECE_SMALL: SMALL_XY, PIECE_TRIPLE: END_XY}

PIECE_N_HEX = np.zeros(N_PIECES_TOTAL, np.int32)
PIECE_SIZE = np.zeros(N_PIECES_TOTAL, np.int32)
PIECE_TYPE = np.zeros(N_PIECES_TOTAL, np.int32)
PIECE_DIFFICULTY = np.zeros(N_PIECES_TOTAL, np.int32)
PIECE_XY = np.zeros((N_PIECES_TOTAL, MAX_HEXES_PER_PIECE, 2), np.int32)
# per-hex (requirement, n_required, is_end, player_start); padding rows are
# (NULL, 0, 0, 0) with PIECE_HEX_VALID false.
PIECE_HEX = np.zeros((N_PIECES_TOTAL, MAX_HEXES_PER_PIECE, 4), np.uint8)
PIECE_HEX[:, :, 0] = Requirement.NULL
PIECE_HEX_VALID = np.zeros((N_PIECES_TOTAL, MAX_HEXES_PER_PIECE), bool)

for _i, (_spec, _diff, _typ, _size) in enumerate(_PIECES):
    _hexes = _parse(_spec)
    _xy = _SIZE_XY[_size]
    assert len(_hexes) == len(_xy), f"piece {_i}: {len(_hexes)} vs {len(_xy)}"
    _n = len(_hexes)
    PIECE_N_HEX[_i] = _n
    PIECE_SIZE[_i] = _size
    PIECE_TYPE[_i] = _typ
    PIECE_DIFFICULTY[_i] = _diff
    PIECE_XY[_i, :_n] = _xy
    PIECE_HEX[_i, :_n] = _hexes
    PIECE_HEX_VALID[_i, :_n] = True

# --------------------------------------------------------------------------
# Connection tables: CONN[placed_size, placed_type, new_size] -> entry list.
# Replicates the reference construction (src/map.cpp:203-263) including its
# self-referential "rotate the entry appended 2i steps ago" growth loop.
# --------------------------------------------------------------------------
MAX_CONN = 21


def _ref_connection_entries(size: int, typ: int, new_size: int):
    """-> list of ((X, Y) doubled coord, [rotation options])."""
    rotations: list[list[int]] = []
    coords: list[tuple[int, int]] = []
    can_rotate = False
    if size == PIECE_LARGE:
        if new_size == PIECE_LARGE:
            can_rotate = True
            rotations = [[-2, -1, 0, 1, 2, 3]] * 2
            coords = [(8, 6), (6, 8)]
        elif new_size == PIECE_SMALL:
            can_rotate = True
            rotations = [[-1, 2]] * 3
            coords = [(3, 7), (5, 5), (7, 3)]
        elif new_size == PIECE_TRIPLE and typ != TYPE_START:
            can_rotate = True
            rotations = [[-3]]
            coords = [(0, 8)]
    elif size == PIECE_SMALL and new_size == PIECE_LARGE:
        rotations = [[-2, -1, 0, 1, 2, 3]] * 6
        coords = [(-7, 10), (-5, 10), (-3, 10), (7, -10), (5, -10), (3, -10)]
    coords = [np.array(c, np.int64) for c in coords]
    rotations = [list(r) for r in rotations]
    n0 = len(coords)
    if can_rotate:
        for i in range(6):
            for j in range(n0):
                k = i * n0 + j
                rotations.append([d + 1 for d in rotations[k]])
                coords.append(rotate_xy(coords[k], 1))
    return list(zip(coords, rotations))


# Dense arrays indexed [placed_size, placed_type, new_size].
CONN_N = np.zeros((3, 3, 3), np.int32)
CONN_COORD = np.zeros((3, 3, 3, MAX_CONN, 2), np.int32)
CONN_NROT = np.ones((3, 3, 3, MAX_CONN), np.int32)
CONN_ROT = np.zeros((3, 3, 3, MAX_CONN, 6), np.int32)

for _ps in range(3):
    for _pt in range(3):
        for _ns in range(3):
            _entries = _ref_connection_entries(_ps, _pt, _ns)
            CONN_N[_ps, _pt, _ns] = len(_entries)
            for _k, (_c, _rots) in enumerate(_entries):
                CONN_COORD[_ps, _pt, _ns, _k] = _c
                CONN_NROT[_ps, _pt, _ns, _k] = len(_rots)
                CONN_ROT[_ps, _pt, _ns, _k, : len(_rots)] = _rots
