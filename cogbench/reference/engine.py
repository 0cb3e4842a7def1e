"""Scalar numpy reference engine — the executable specification.

The benchmark's frozen copy, on its own ``constants`` and ``tables``: it
imports nothing of the system it judges, and
cogbench/tests/test_cogbench_reference.py replays the oracle goldens in
tests/golden/ through it. Quirks below are kept as they are.

A from-scratch, bit-exact reimplementation of the reference C++ environment
semantics (reference: src/environment.cpp, src/map.cpp, src/player.cpp,
src/cards.cpp, include/sampler.h) against the *UB-patched oracle* (see
tools/parity_probe/make_oracle.py).  It is itself tested bit-exactly
against the oracle dumps in tests/golden/.

It deliberately replicates every behavioural quirk of the reference,
because trajectory parity is a headline metric (BASELINE.json):

* ``Map::generate`` receives the engine **by value** (src/environment.cpp:48 →
  src/map.cpp:697): map generation consumes a *copy* of the env RNG stream, so
  the deck draws that follow during reset restart from the same engine state.
* Recursive generation retries (src/map.cpp:716-740): a mid-loop placement
  failure recurses into a full regeneration **without resetting the map**, and
  the outer loop continues afterwards; an end-piece failure resets and retries.
  ``failures >= max_failures`` raises (GenerateMapFailure).
* All pile counts / counters are uint8 with wraparound (phantom card plays
  through stale masks underflow 0 → 255; observed throughout the golden
  trajectories).
* The live ("selected") action mask and the per-player observation masks alias
  differently per head: deck ops + enable/disable_playing write the *selected*
  mask (src/environment.cpp:34-39 wires Player::player_actionmask to the
  selected mask and am_storage to the per-player obs mask), while
  ``update_observation`` and card special-actions write the *per-player
  storage* mask (src/environment.cpp:252-279, src/cards.cpp:8-36).
* ``ActionMask::reset`` clears only the play/play_special/remove heads; the
  move/get_from_shop heads keep their previous contents apart from index 0
  (include/api.h:104-118).
* ``DeckObs::reset`` does not clear the ``played`` pile (include/api.h:75-81),
  so cards leak across auto-resets that interrupt a turn.
* ``Shop::reset`` does not reset ``n_in_market`` (src/cards.cpp:94-100).
* Rewards / Info buffers are only written on episode end and persist across
  resets (src/environment.cpp:187-207).
* Strict inequalities: shop affordability is ``coins > cost``
  (src/cards.cpp:114,118); DISCARD/REMOVE hexes need ``n_active > n_required``
  while resource hexes need ``>=`` (src/map.cpp:379-383).
* Floor/truncation of half-integer hex coordinates when rasterising and when
  indexing the hex grid (src/map.cpp:335-339,273-275): this engine works in
  exact doubled-integer axial coordinates and reproduces the float
  ``static_cast<size_t>`` semantics exactly.

Geometry is in doubled axial integer coordinates (X = 2x, Y = 2y) — see
tables.py.
"""
from __future__ import annotations

import numpy as np

from .constants import (
    GRIDSIZE,
    HAND_SIZE,
    MAX_FAILURES,
    MAX_N_PLAYERS,
    MKT_BOARD_SLOTS,
    N_BUYABLETYPES,
    N_CARDTYPES,
    CardType,
    Requirement,
    TurnPhase,
)
from . import tables as T

# ---------------------------------------------------------------------------
# libstdc++ RNG (scalar ints)
# ---------------------------------------------------------------------------
_M = 2147483647
_A = 16807
_URANGE = 2147483645


class MinstdRng:
    """libstdc++ std::default_random_engine = minstd_rand0."""

    __slots__ = ("state",)

    def __init__(self, seed: int = 1):
        self.seed(seed)

    def seed(self, s: int) -> None:
        s = int(s) % _M
        self.state = 1 if s == 0 else s

    def copy(self) -> "MinstdRng":
        r = MinstdRng.__new__(MinstdRng)
        r.state = self.state
        return r

    def __call__(self) -> int:
        self.state = (_A * self.state) % _M
        return self.state

    def uniform_int(self, n: int) -> int:
        """std::uniform_int_distribution<size_t>(0, n-1) — downscaling branch.

        Valid for n <= 2147483645, which covers every draw the engine makes.
        """
        assert 1 <= n <= _URANGE
        scaling = _URANGE // n
        past = n * scaling
        while True:
            r = self() - 1
            if r < past:
                return r // scaling


class GenerateMapFailure(RuntimeError):
    """Map generation failed MAX_FAILURES times (reference parity:
    generate_map_failure, src/map.cpp:736-740)."""


# ---------------------------------------------------------------------------
# Map generation (doubled-int geometry)
# ---------------------------------------------------------------------------

_DIR_DBL = np.array([(0, 0), (2, 0), (0, 2), (-2, 2), (-2, 0), (0, -2), (2, -2)],
                    np.int64)


def _rot_xy(xy: np.ndarray, times: int) -> np.ndarray:
    return xy @ T.ROT[times % 6].T


class RefMap:
    """Board state + procedural generation (reference: src/map.cpp:265-752)."""

    def __init__(self):
        self.obs = np.zeros((GRIDSIZE, GRIDSIZE, 7), np.uint8)
        self.reset()
        # piece-object mutable transforms survive across resets
        # (global MapPiece objects in the reference); start pieces are always
        # placed untransformed so identity is the correct initial value.
        self.piece_rot = np.zeros(T.N_PIECES_TOTAL, np.int64)
        self.piece_center = np.zeros((T.N_PIECES_TOTAL, 2), np.int64)
        self.player_xy = np.zeros((MAX_N_PLAYERS, 2), np.int64)
        self.n_players = 0

    def reset(self):
        self.entries: list[int] = []        # placed piece ids, in order
        self.xy: list[tuple[int, int]] = [] # doubled coords, placement order
        self.hexinfo: list[np.ndarray] = [] # rows (req, n_req, is_end, pstart)
        self.occ: set[tuple[int, int]] = set()
        self.min_xy = np.zeros(2, np.int64)
        self.max_xy = np.zeros(2, np.int64)

    # -- placement ---------------------------------------------------------
    def _add_piece(self, pid: int, coord: np.ndarray, rot: int):
        """reference: src/map.cpp:309-341 (hex_array rebuild is implicit)."""
        rot6 = rot % 6
        n = int(T.PIECE_N_HEX[pid])
        pxy = _rot_xy(T.PIECE_XY[pid, :n].astype(np.int64), rot6) + coord
        self.piece_rot[pid] = rot6
        self.piece_center[pid] = coord
        self.entries.append(pid)
        for k in range(n):
            p = (int(pxy[k, 0]), int(pxy[k, 1]))
            self.xy.append(p)
            self.hexinfo.append(T.PIECE_HEX[pid, k])
            self.occ.add(p)
        self.max_xy = np.maximum(self.max_xy, pxy.max(axis=0))
        self.min_xy = np.minimum(self.min_xy, pxy.min(axis=0))

    def _candidates(self, new_pid: int):
        """All attachment candidates in reference enumeration order
        (src/map.cpp:277-295): per placed piece, per connection-table entry."""
        nsize = int(T.PIECE_SIZE[new_pid])
        out = []  # (coordXY, [rot options])
        for pid in self.entries:
            psize = int(T.PIECE_SIZE[pid])
            ptype = int(T.PIECE_TYPE[pid])
            prot = int(self.piece_rot[pid])
            pc = self.piece_center[pid]
            nconn = int(T.CONN_N[psize, ptype, nsize])
            for k in range(nconn):
                c = T.CONN_COORD[psize, ptype, nsize, k].astype(np.int64)
                c = _rot_xy(c, prot) + pc
                nr = int(T.CONN_NROT[psize, ptype, nsize, k])
                rots = [int(r) + prot for r in T.CONN_ROT[psize, ptype, nsize, k, :nr]]
                out.append((c, rots))
        return out

    def _add_random_piece(self, pid: int, rng: MinstdRng) -> bool:
        """reference: src/map.cpp:277-307. Overlap test uses the first
        rotation option of each candidate; the final rotation is sampled from
        all options of the chosen candidate."""
        cands = self._candidates(pid)
        n = int(T.PIECE_N_HEX[pid])
        base = T.PIECE_XY[pid, :n].astype(np.int64)
        valid = []
        for c, rots in cands:
            fp = _rot_xy(base, rots[0]) + c
            if not any((int(x), int(y)) in self.occ for x, y in fp):
                valid.append((c, rots))
        if not valid:
            return False
        idx = rng.uniform_int(len(valid))
        c, rots = valid[idx]
        rot = rots[rng.uniform_int(len(rots))]
        self._add_piece(pid, c, rot)
        return True

    # -- generation --------------------------------------------------------
    def generate(self, n_pieces: int, difficulty: int, failures: int,
                 max_failures: int, rng: MinstdRng):
        """reference: src/map.cpp:697-742 with the oracle's erase-by-position
        patch (tools/parity_probe/make_oracle.py). ``rng`` is consumed by this
        call tree only (by-value semantics at the call site)."""
        if failures >= max_failures:
            raise GenerateMapFailure("map generation failed")
        start = rng.uniform_int(T.N_START_PIECES)
        self._add_piece(T.START_PIECE_0 + start, np.zeros(2, np.int64), 0)
        valid = [i for i in range(T.N_TRAVEL_PIECES)
                 if T.PIECE_DIFFICULTY[T.TRAVEL_PIECE_0 + i] <= difficulty]
        for _ in range(n_pieces):
            if valid:
                pos = rng.uniform_int(len(valid))
                idx = valid[pos]
                success = self._add_random_piece(T.TRAVEL_PIECE_0 + idx, rng)
            else:
                success = False
            if success:
                valid.pop(pos)
            else:
                # mid-loop retry: full regeneration on top of the current map,
                # with a copy of the current engine; outer loop then continues.
                self.generate(n_pieces, difficulty, failures + 1, max_failures,
                              rng.copy())
        e = rng.uniform_int(T.N_END_PIECES)
        if not self._add_random_piece(T.END_PIECE_0 + e, rng):
            self.reset()
            self.generate(n_pieces, difficulty, failures + 1, max_failures,
                          rng.copy())
        self.finalize()

    # -- rasterisation / queries ------------------------------------------
    @staticmethod
    def _grid_idx(d: int) -> int:
        """size_t(float(d/2)) + 1 for doubled offset d >= -2: truncation toward
        zero, with the d == -2 case wrapping to 0 (src/map.cpp:273-275)."""
        if d >= 0:
            return (d >> 1) + 1
        if d == -1:
            return 1
        return 0

    def finalize(self):
        """Rasterise into the 48x48x7 observation (src/map.cpp:389-405).
        Later entries overwrite earlier ones at colliding cells; the player
        channel (feature 0) is never written."""
        self.obs[:] = 0
        for (x, y), info in zip(self.xy, self.hexinfo):
            ix = ((x - int(self.min_xy[0])) >> 1) + 1
            iy = ((y - int(self.min_xy[1])) >> 1) + 1
            if 0 <= ix < GRIDSIZE and 0 <= iy < GRIDSIZE:
                cell = np.zeros(7, np.uint8)
                req, n_req, is_end, _ = (int(v) for v in info)
                if req != Requirement.NULL:
                    cell[req + 1] = n_req
                cell[6] = is_end
                self.obs[ix, iy] = cell

    def entry_xy(self, k: int) -> np.ndarray:
        """Doubled coords of placed entry k under the piece *object's current*
        transform (mirrors MapPiece::get_xy(): duplicated objects report their
        latest placement)."""
        pid = self.entries[k]
        n = int(T.PIECE_N_HEX[pid])
        return (_rot_xy(T.PIECE_XY[pid, :n].astype(np.int64),
                        int(self.piece_rot[pid])) + self.piece_center[pid])

    def add_players(self, n_players: int):
        """reference: src/map.cpp:343-354 with the oracle's bounds patch:
        player_locations[i] is only written when hex i's start number is in
        range AND i < n_players; others stay at the origin."""
        self.n_players = n_players
        self.player_xy[:] = 0
        pid = self.entries[0]
        n = int(T.PIECE_N_HEX[pid])
        for i in range(n):
            start = int(T.PIECE_HEX[pid, i, 3])
            if 0 < start < n_players + 1 and i < n_players:
                self.player_xy[i] = self.xy[i]

    def cell(self, xy: np.ndarray) -> np.ndarray:
        """Hex features at doubled coord (requirement, n_required, is_end);
        cells off the board read as impassable (req=NULL)."""
        ix = self._grid_idx(int(xy[0] - self.min_xy[0]))
        iy = self._grid_idx(int(xy[1] - self.min_xy[1]))
        if 0 <= ix < GRIDSIZE and 0 <= iy < GRIDSIZE:
            c = self.obs[ix, iy]
        else:  # beyond the 48-grid: mountain sentinel ring
            c = np.zeros(7, np.uint8)
        nz = np.nonzero(c[1:6])[0]
        if len(nz):
            return np.array([nz[0], c[1 + nz[0]], c[6]], np.int64)
        return np.array([Requirement.NULL, 0, c[6]], np.int64)

    def move_in_direction(self, player: int, direction: int) -> np.ndarray:
        """reference: src/map.cpp:356-367."""
        self.player_xy[player] = self.player_xy[player] + _DIR_DBL[direction]
        return self.cell(self.player_xy[player])

    def set_movement_mask(self, mask: np.ndarray, player: int,
                          resources: np.ndarray, n_active: int):
        """Writes move head indices 1..6 (src/map.cpp:369-387)."""
        for d in range(1, 7):
            req, n_req, _ = self.cell(self.player_xy[player] + _DIR_DBL[d])
            if req >= Requirement.DISCARD:
                filled = n_active > n_req
            elif req == Requirement.NULL:
                filled = False
            else:
                filled = resources[req] >= n_req
            mask[d] = (req != Requirement.NULL) and filled

    def player_done(self, player: int) -> bool:
        return bool(self.cell(self.player_xy[player])[2])


# ---------------------------------------------------------------------------
# Mask layout (flat 92-bool vector, matching the probe dump order)
# ---------------------------------------------------------------------------
PLAY = slice(0, 22)
SPECIAL = slice(22, 44)
REMOVE = slice(44, 66)
MOVE = slice(66, 73)
SHOP = slice(73, 92)
MASK_LEN = 92

PILE_DRAW, PILE_HAND, PILE_ACTIVE, PILE_PLAYED, PILE_DISCARD = range(5)

_u8 = np.uint8


def _w8(x):
    """uint8 with C wraparound semantics (numpy 2.x rejects OOB casts)."""
    return np.uint8(int(x) & 0xFF)


def _mask_reset(m: np.ndarray):
    """ActionMask::reset (include/api.h:104-118): play/special/remove heads
    cleared; move/get_from_shop keep indices 1.. untouched."""
    m[PLAY] = False
    m[SPECIAL] = False
    m[REMOVE] = False
    m[0] = m[22] = m[44] = True
    m[66] = True
    m[73] = True


class RefEnv:
    """Scalar single-env engine (reference: src/environment.cpp)."""

    def __init__(self, seed=0, n_players=4, n_pieces=3, difficulty=0,
                 max_steps=100000):
        self.seed_ = seed
        self.n_players = n_players
        self.n_pieces = n_pieces
        self.difficulty = difficulty
        self.max_steps = max_steps
        self.rng = MinstdRng(seed)
        self.map = RefMap()

        # observation / persistent buffers (zero at init, like the probe)
        self.phase = np.uint8(0)
        self.resources = np.zeros(3, np.float32)
        self.shop_stock = np.full(N_BUYABLETYPES, 0, _u8)
        self.piles = np.zeros((MAX_N_PLAYERS, 5, N_CARDTYPES), _u8)
        # ActionMask() runs reset() at construction (include/api.h:101-103),
        # so every mask buffer starts with the index-0 bits set — including
        # players beyond n_players, which are never touched again.
        self.sel_mask = np.zeros(MASK_LEN, bool)
        _mask_reset(self.sel_mask)
        self.storage_masks = np.zeros((MAX_N_PLAYERS, MASK_LEN), bool)
        for _p in range(MAX_N_PLAYERS):
            _mask_reset(self.storage_masks[_p])
        self.rewards = np.zeros(MAX_N_PLAYERS, np.float32)
        # Info buffers (persist across resets)
        self.info_total = np.uint32(0)
        self.info_steps = np.zeros(MAX_N_PLAYERS, _u8)
        self.info_returns = np.zeros(MAX_N_PLAYERS, np.float32)
        self.info_travelled = np.zeros(MAX_N_PLAYERS, np.uint32)
        self.info_added = np.zeros(MAX_N_PLAYERS, _u8)
        self.info_removed = np.zeros(MAX_N_PLAYERS, _u8)
        self.info_mpc = np.zeros((MAX_N_PLAYERS, 3), np.uint32)
        self.info_card_uses = np.zeros(MAX_N_PLAYERS, np.uint32)

        # shop state: Shop() constructor (src/cards.cpp:85-92);
        # init() fills stock (src/cards.cpp:80-83)
        self.in_market = T.SHOP_STARTS_IN_MARKET.copy()
        self.n_in_market = _u8(MKT_BOARD_SLOTS)
        self.shop_stock[:] = 3

        # per-player engine state
        self.has_won = np.zeros(MAX_N_PLAYERS, bool)
        self.movement_in_progress = np.zeros(MAX_N_PLAYERS, bool)
        self.next_card_free = np.zeros(MAX_N_PLAYERS, bool)
        self.next_move_free = np.zeros(MAX_N_PLAYERS, bool)
        self.n_removes = np.zeros(MAX_N_PLAYERS, _u8)
        self.steps_taken = np.zeros(MAX_N_PLAYERS, _u8)
        self.n_movements = np.zeros(MAX_N_PLAYERS, np.uint32)
        self.n_added_cards = np.zeros(MAX_N_PLAYERS, _u8)
        # deck counters
        self.n_in_hand = np.zeros(MAX_N_PLAYERS, _u8)
        self.n_active = np.zeros(MAX_N_PLAYERS, _u8)
        self.n_in_draw = np.zeros(MAX_N_PLAYERS, _u8)
        self.idx_last_activated = np.zeros(MAX_N_PLAYERS, _u8)

        self.agent = 0
        self.turn_counter = 0
        self.done = False

    # ------------------------------------------------------------------ deck
    def _draw(self, p: int, n: int):
        """Deck::draw (src/cards.cpp:183-211): recycle at most once before the
        loop, clamp, then n uniform draws scanning the count vector."""
        piles = self.piles[p]
        if self.n_in_draw[p] < n:
            # move_discard_to_draw (src/cards.cpp:234-240)
            for i in range(N_CARDTYPES):
                piles[PILE_DRAW, i] = _w8(int(piles[PILE_DRAW, i])
                                          + int(piles[PILE_DISCARD, i]))
                self.n_in_draw[p] = _w8(int(self.n_in_draw[p])
                                        + int(piles[PILE_DISCARD, i]))
                piles[PILE_DISCARD, i] = 0
        n = min(int(n), int(self.n_in_draw[p]))
        for _ in range(n):
            target = self.rng.uniform_int(int(self.n_in_draw[p]))
            ct = 0
            while target >= piles[PILE_DRAW, ct]:
                target -= int(piles[PILE_DRAW, ct])
                ct += 1
            piles[PILE_DRAW, ct] = _w8(int(piles[PILE_DRAW, ct]) - 1)
            self.n_in_draw[p] = _w8(int(self.n_in_draw[p]) - 1)
            piles[PILE_HAND, ct] = _w8(int(piles[PILE_HAND, ct]) + 1)
            self.sel_mask[1 + ct] = True
            self.sel_mask[22 + 1 + ct] = bool(T.CARD_IS_SPECIAL[ct])
        self.n_in_hand[p] = _w8(int(self.n_in_hand[p]) + n)

    def _activate(self, p: int, idx: int):
        """Deck::activate (src/cards.cpp:242-253), uint8 wrap on phantom."""
        piles = self.piles[p]
        self.n_in_hand[p] = _w8(int(self.n_in_hand[p]) - 1)
        self.n_active[p] = _w8(int(self.n_active[p]) + 1)
        self.idx_last_activated[p] = idx
        prev = int(piles[PILE_HAND, idx])
        piles[PILE_HAND, idx] = _w8(prev - 1)
        piles[PILE_ACTIVE, idx] = _w8(int(piles[PILE_ACTIVE, idx]) + 1)
        self.sel_mask[1 + idx] = prev > 1
        self.sel_mask[22 + 1 + idx] = (prev > 1) and bool(T.CARD_IS_SPECIAL[idx])

    def _play_last_activated(self, p: int):
        """src/cards.cpp:255-261."""
        idx = int(self.idx_last_activated[p])
        piles = self.piles[p]
        self.n_active[p] = _w8(int(self.n_active[p]) - 1)
        piles[PILE_ACTIVE, idx] = _w8(int(piles[PILE_ACTIVE, idx]) - 1)
        if not T.CARD_SINGLE_USE[idx]:
            piles[PILE_PLAYED, idx] = _w8(int(piles[PILE_PLAYED, idx]) + 1)

    def _play_immediate(self, p: int, idx: int):
        """src/cards.cpp:263-273."""
        piles = self.piles[p]
        self.n_in_hand[p] = _w8(int(self.n_in_hand[p]) - 1)
        prev = int(piles[PILE_HAND, idx])
        piles[PILE_HAND, idx] = _w8(prev - 1)
        piles[PILE_PLAYED, idx] = _w8(int(piles[PILE_PLAYED, idx]) + 1)
        self.sel_mask[1 + idx] = prev > 1
        self.sel_mask[22 + 1 + idx] = (prev > 1) and bool(T.CARD_IS_SPECIAL[idx])

    def _remove_immediate(self, p: int, idx: int):
        """src/cards.cpp:281-290."""
        piles = self.piles[p]
        self.n_in_hand[p] = _w8(int(self.n_in_hand[p]) - 1)
        prev = int(piles[PILE_HAND, idx])
        piles[PILE_HAND, idx] = _w8(prev - 1)
        self.sel_mask[44 + 1 + idx] = bool(self.sel_mask[44 + 1 + idx]) and prev > 1
        self.sel_mask[1 + idx] = bool(self.sel_mask[1 + idx]) and prev > 1
        self.sel_mask[22 + 1 + idx] = (bool(self.sel_mask[1 + idx])
                                       and bool(T.CARD_IS_SPECIAL[idx]))

    def _active_scan(self, p: int, target: int) -> int:
        """Scan the active counts for the target'th card (src/player.cpp:95-98).
        In-bounds by the mod-256 consistency of n_active vs the pile sum."""
        piles = self.piles[p]
        ct = 0
        while target >= piles[PILE_ACTIVE, ct]:
            target -= int(piles[PILE_ACTIVE, ct])
            ct += 1
        return ct

    def _discard_cards(self, p: int, n: int):
        """Player::discard_cards (src/player.cpp:85-104)."""
        n_discardable = int(self.n_active[p])
        for i in range(n):
            target = self.rng.uniform_int(n_discardable - i)
            ct = self._active_scan(p, target)
            self.n_active[p] = _w8(int(self.n_active[p]) - 1)
            self.piles[p, PILE_ACTIVE, ct] = _w8(int(self.piles[p, PILE_ACTIVE, ct]) - 1)
            self.piles[p, PILE_DISCARD, ct] = _w8(int(self.piles[p, PILE_DISCARD, ct]) + 1)

    def _remove_cards(self, p: int, n: int):
        """Player::remove_cards (src/player.cpp:106-131), clamped to n_active."""
        n_removable = int(self.n_active[p])
        n = min(n, n_removable)
        for i in range(n):
            target = self.rng.uniform_int(n_removable - i)
            ct = self._active_scan(p, target)
            self.n_active[p] = _w8(int(self.n_active[p]) - 1)
            self.piles[p, PILE_ACTIVE, ct] = _w8(int(self.piles[p, PILE_ACTIVE, ct]) - 1)

    # ------------------------------------------------------------- masks etc
    def _disable_playing(self):
        """Player::disable_playing on the selected mask (src/player.cpp:191-196)."""
        self.sel_mask[PLAY] = False
        self.sel_mask[SPECIAL] = False
        self.sel_mask[0] = self.sel_mask[22] = True

    def _enable_playing(self, p: int):
        """Player::enable_playing on the selected mask (src/player.cpp:198-206)."""
        self.sel_mask[REMOVE] = False
        self.sel_mask[44] = True
        hand = self.piles[p, PILE_HAND]
        for i in range(N_CARDTYPES):
            self.sel_mask[1 + i] = hand[i] > 0
            self.sel_mask[22 + 1 + i] = bool(self.sel_mask[1 + i]) and bool(
                T.CARD_IS_SPECIAL[i])

    def _shop_available_mask(self, coins: float, mask: np.ndarray):
        """Shop::set_available_mask on a 19-slot head (src/cards.cpp:109-121)."""
        if int(self.n_in_market) < MKT_BOARD_SLOTS:
            for i in range(N_BUYABLETYPES):
                mask[1 + i] = (self.shop_stock[i] > 0) and (coins > T.SHOP_COST[i])
        else:
            for i in range(N_BUYABLETYPES):
                mask[1 + i] = bool(self.in_market[i]) and (coins > T.SHOP_COST[i])

    def _shop_transmit_mask(self, mask: np.ndarray):
        for i in range(N_BUYABLETYPES):
            mask[1 + i] = self.shop_stock[i] > 0

    def _shop_get(self, i: int) -> int:
        """Shop::get (src/cards.cpp:136-142) -> global card type."""
        self.shop_stock[i] = _w8(int(self.shop_stock[i]) - 1)
        if self.shop_stock[i] == 0 and self.in_market[i]:
            self.in_market[i] = False
            self.n_in_market = _w8(int(self.n_in_market) - 1)
        return int(T.SHOP_CARD_TYPE[i])

    def _update_observation(self, agent: int):
        """cog_env::update_observation — writes the per-player storage mask
        (src/environment.cpp:252-279)."""
        m = self.storage_masks[agent]
        m[MOVE] = False
        m[66] = True
        m[SHOP] = False
        m[73] = True
        if self.phase == TurnPhase.MOVEMENT:
            self.map.set_movement_mask(m[MOVE], agent, self.resources,
                                       int(self.n_active[agent]))
        elif self.phase == TurnPhase.BUYING:
            self._shop_available_mask(float(self.resources[2]), m[SHOP])

    # ------------------------------------------------------------------ reset
    def reset(self, seed=None, n_players=None, n_pieces=None, difficulty=None,
              max_steps=None):
        if seed is not None:
            self.seed_ = seed
            self.n_players = n_players
            self.n_pieces = n_pieces
            self.difficulty = difficulty
            self.max_steps = max_steps
            self.rng.seed(seed)
        self.agent = 0
        self.phase = np.uint8(TurnPhase.INACTIVE)
        self.map.reset()
        # by-value rng: generation consumes a copy (src/environment.cpp:48)
        self.map.generate(self.n_pieces, self.difficulty, 0, MAX_FAILURES,
                          self.rng.copy())
        for p in range(self.n_players):
            self._player_reset(p)
        self.map.add_players(self.n_players)
        # Shop::reset (src/cards.cpp:94-100): stock + market flags only
        self.shop_stock[:] = 3
        self.in_market = T.SHOP_STARTS_IN_MARKET.copy()
        self.done = False
        self.turn_counter = 0
        for p in range(self.n_players):
            self._update_observation(p)
        self.sel_mask[:] = self.storage_masks[self.agent]

    def _player_reset(self, p: int):
        """Player::reset (src/player.cpp:29-43)."""
        self.has_won[p] = False
        self.movement_in_progress[p] = False
        self.next_card_free[p] = False
        self.next_move_free[p] = False
        self.n_removes[p] = 0
        self.steps_taken[p] = 0
        self.n_movements[p] = 0
        self.n_added_cards[p] = 0
        # DeckObs::reset — played survives (include/api.h:75-81)
        self.piles[p, PILE_DRAW] = 0
        self.piles[p, PILE_HAND] = 0
        self.piles[p, PILE_ACTIVE] = 0
        self.piles[p, PILE_DISCARD] = 0
        _mask_reset(self.sel_mask)
        # Deck::reset (src/cards.cpp:163-171)
        self.piles[p, PILE_DISCARD, CardType.EXPLORER] = 3
        self.piles[p, PILE_DISCARD, CardType.TRAVELER] = 4
        self.piles[p, PILE_DISCARD, CardType.SAILOR] = 1
        self.n_in_draw[p] = 0
        self.n_in_hand[p] = 0
        self.n_active[p] = 0
        self._draw(p, HAND_SIZE)
        # save_actionmask
        self.storage_masks[p] = self.sel_mask

    # ------------------------------------------------------------------- step
    def _cycle_phase(self):
        self.phase = np.uint8((int(self.phase) + 1) % 3)

    def _end_turn(self, p: int):
        """Player::end_turn (src/player.cpp:170-180)."""
        piles = self.piles[p]
        # discard_all_active / discard_all_played
        self.n_active[p] = 0
        for i in range(N_CARDTYPES):
            piles[PILE_DISCARD, i] = _w8(int(piles[PILE_DISCARD, i])
                                         + int(piles[PILE_ACTIVE, i]))
            piles[PILE_ACTIVE, i] = 0
            piles[PILE_DISCARD, i] = _w8(int(piles[PILE_DISCARD, i])
                                         + int(piles[PILE_PLAYED, i]))
            piles[PILE_PLAYED, i] = 0
        n_draw = HAND_SIZE - int(self.n_in_hand[p])  # int arithmetic
        if n_draw > 0:
            self._draw(p, n_draw)
        self.resources[:] = 0
        self.storage_masks[p] = self.sel_mask  # save_actionmask

    def _next_agent(self):
        """cog_env::next_agent (src/environment.cpp:79-89)."""
        self._end_turn(self.agent)
        self.agent += 1
        if self.agent >= self.n_players:
            self.agent = 0
        self.sel_mask[:] = self.storage_masks[self.agent]  # load_actionmask
        self.resources[:] = 0
        self.turn_counter += 1

    def step(self, action):
        """cog_env::step (src/environment.cpp:91-224). ``action`` is the
        5-tuple (play, play_special, remove, move, get_from_shop)."""
        if self.done:
            return
        a_play, a_special, a_remove, a_move, a_shop = (int(v) for v in action)
        self.info_steps[self.agent] = _w8(int(self.info_steps[self.agent]) + 1)
        if self.phase == TurnPhase.INACTIVE:
            self._cycle_phase()
        p = self.agent
        self.steps_taken[p] = _w8(int(self.steps_taken[p]) + 1)
        special = 0  # pending special-action id for this step

        if a_play:
            idx = a_play - 1
            # Player::play_card (src/player.cpp:47-69)
            if self.phase == TurnPhase.MOVEMENT:
                self.resources[:] = T.CARD_RES[idx]
            elif self.phase == TurnPhase.BUYING:
                coin = int(T.CARD_RES[idx, 2])
                self.resources[2] += coin if coin > 0 else np.float32(0.5)
            self._activate(p, idx)
        elif a_special:
            idx = a_special - 1
            # Player::play_special (src/player.cpp:71-79)
            if T.CARD_SINGLE_USE[idx]:
                self._remove_immediate(p, idx)
            else:
                self._play_immediate(p, idx)
            special = int(T.CARD_SPECIAL[idx])
        elif a_move:
            req, n_req, is_end = self.map.move_in_direction(p, a_move)
            if not self.next_move_free[p]:
                # Player::handle_requirement (src/player.cpp:141-162)
                if req < 3:
                    left = np.float32(self.resources[req] - np.float32(n_req))
                    self.resources[:] = 0
                    self.resources[req] = left
                    if not self.movement_in_progress[p]:
                        self._play_last_activated(p)
                        self.movement_in_progress[p] = True
                elif req == Requirement.REMOVE:
                    self._remove_cards(p, int(n_req))
                    self.resources[:] = 0
                    self.movement_in_progress[p] = False
                elif req == Requirement.DISCARD:
                    self._discard_cards(p, int(n_req))
                    self.resources[:] = 0
                    self.movement_in_progress[p] = False
            else:
                self.next_move_free[p] = False
                self._enable_playing(p)
            self.n_movements[p] += 1
            self.has_won[p] = bool(is_end)
        else:
            self.next_move_free[p] = False
            if a_shop:
                i = a_shop - 1
                if self.next_card_free[p]:
                    card = self._shop_get(i)  # Shop::transmit
                else:
                    # Shop::buy (src/cards.cpp:102-106): reopen the market
                    # slot *before* get() decrements stock.
                    self.n_in_market = _w8(int(self.n_in_market)
                                           + (1 - int(self.in_market[i])))
                    self.in_market[i] = True
                    card = self._shop_get(i)
                    self.resources[2] -= np.float32(T.CARD_COST[card])
                    self._cycle_phase()
                self.piles[p, PILE_DISCARD, card] = _w8(
                    int(self.piles[p, PILE_DISCARD, card]) + 1)
                self.n_added_cards[p] = _w8(int(self.n_added_cards[p]) + 1)
            elif a_remove:
                self._remove_immediate(p, a_remove - 1)
                self.n_removes[p] = _w8(int(self.n_removes[p]) - 1)
                if int(self.n_removes[p]) == 0:
                    self._enable_playing(p)
                else:
                    special = T.SPECIAL_SHOP_DISABLE
            else:
                self._cycle_phase()
                if int(self.n_removes[p]) > 0:
                    self.n_removes[p] = 0
                    self._enable_playing(p)
            if self.next_card_free[p]:
                self.next_card_free[p] = False
                self._enable_playing(p)

        if self.movement_in_progress[p] and not a_move:
            self.movement_in_progress[p] = False
            self.resources[:] = 0

        # maybe_end_turn
        if self.has_won[p] or self.phase == TurnPhase.INACTIVE:
            self._next_agent()
        self._update_observation(self.agent)

        if special:
            self._run_special(special, self.agent)
        elif self.map.player_done(self.agent) or self.turn_counter >= self.max_steps:
            self.done = True
            self.info_total = np.uint32(self.turn_counter)
            n_winners = float(self.has_won[:].sum())
            for a in range(self.n_players):
                self.info_steps[a] = self.steps_taken[a]
                r = np.float32(self.n_players * float(self.has_won[a]) - n_winners)
                self.info_returns[a] = r
                self.rewards[a] = r
                self.info_travelled[a] = self.n_movements[a]
                self.info_added[a] = self.n_added_cards[a]
                self.info_mpc[a] = 0
                self.info_card_uses[a] = np.uint32(self.n_added_cards[a])
                self.info_removed[a] = self.n_added_cards[a]

    def _run_special(self, special: int, agent: int):
        """Card special actions (src/cards.cpp:8-36) + the shop-disable
        continuation (src/environment.cpp:156-159). ``mask`` here is the
        current agent's storage mask; disable_playing acts on the selected
        mask."""
        m = self.storage_masks[agent]
        if special == T.SPECIAL_TRANSMIT:
            m[MOVE] = False
            m[66] = True
            self._disable_playing()
            self._shop_transmit_mask(m[SHOP])
            self.next_card_free[agent] = True
        elif special == T.SPECIAL_DRAW2:
            self._draw(agent, 2)
        elif special == T.SPECIAL_DRAW3:
            self._draw(agent, 3)
        elif special in (T.SPECIAL_DRAW1_REMOVE1, T.SPECIAL_DRAW2_REMOVE2):
            n = 1 if special == T.SPECIAL_DRAW1_REMOVE1 else 2
            self._draw(agent, n)
            self.n_removes[agent] = _w8(n)
            m[REMOVE] = m[PLAY]
            self._disable_playing()
            self._shop_available_mask(0.0, m[SHOP])
        elif special == T.SPECIAL_NATIVE:
            self.map.set_movement_mask(m[MOVE], agent,
                                       np.array([100.0, 100.0, 100.0], np.float32),
                                       100)
            self.next_move_free[agent] = True
            self._disable_playing()
            self._shop_available_mask(0.0, m[SHOP])
        elif special == T.SPECIAL_SHOP_DISABLE:
            self._shop_available_mask(0.0, m[SHOP])


class RefSampler:
    """Masked uniform sampler (include/sampler.h:14-79): per head, uniform
    over the valid indices; index 0 of every head is always valid so exactly
    five engine draws are consumed per call."""

    def __init__(self, seed=42):
        self.rng = MinstdRng(seed)

    def sample(self, mask: np.ndarray) -> np.ndarray:
        out = np.zeros(5, np.uint8)
        for h, sl in enumerate((PLAY, SPECIAL, REMOVE, MOVE, SHOP)):
            valid = np.nonzero(mask[sl])[0]
            if len(valid):
                out[h] = valid[self.rng.uniform_int(len(valid))]
        return out
