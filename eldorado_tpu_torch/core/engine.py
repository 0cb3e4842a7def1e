"""Single-env engine in plain torch: state, reset body, sampler and step.

Port of ``eldorado_tpu/core/engine.py``. Every single-env function here is
a one-to-one transliteration of its JAX counterpart (same one-hot,
scatter-free formulation, same uint8 wrap sites) and is batched with
``torch.func.vmap``; `vstep`, `vstep_actions`, `vsample` and
`vreset_body` are the batched entries.
These are the plain versions of the CUDA kernels of the step, the sampler
and the reset body (K1, K1-act, K1-sample, K2; ``csrc/engine.cuh``): the
CPU path runs them, and chip_smoke.py holds the kernels to them.

Dtypes at the public surface follow the JAX package: bool, int32 (which also
holds the reference's u_char fields, wrapped with `_wrap8` at the same sites)
and float32. The kernels' carry is the field-major, env-minor int32 layout
of `pack_dyn`/`unpack_dyn`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..constants import (GRIDSIZE, HAND_SIZE, MAX_N_PLAYERS, MKT_BOARD_SLOTS,
                         N_BUYABLETYPES, N_CARDTYPES, CardType, TurnPhase)
from ..ops import rng as R
from . import cells as C
from . import tables as T

_i32 = torch.int32
_f32 = torch.float32


def _wrap8(x):
    return x & 0xFF


# mask head offsets in the flat 92-bool mask (probe dump order)
PLAY0, SPECIAL0, REMOVE0, MOVE0, SHOP0 = 0, 22, 44, 66, 73
MASK_LEN = 92
MASK_WORDS = (MASK_LEN + 31) // 32
PILE_DRAW, PILE_HAND, PILE_ACTIVE, PILE_PLAYED, PILE_DISCARD = range(5)

_DIRS = ((0, 0), (2, 0), (0, 2), (-2, 2), (-2, 0), (0, -2), (2, -2))
_DIR_DBL = np.asarray(_DIRS, np.int32)
# 2-hop hex neighbourhood ("ball") in doubled coords, unit directions first
_BALL_LIST = []
for _a in _DIRS:
    for _b in _DIRS:
        _o = (_a[0] + _b[0], _a[1] + _b[1])
        if _o not in _BALL_LIST:
            _BALL_LIST.append(_o)
N_BALL = len(_BALL_LIST)  # 19
_BALL = np.asarray(_BALL_LIST, np.int32)
_PAIR = np.asarray([[_BALL_LIST.index((a[0] + b[0], a[1] + b[1]))
                     for b in _DIRS] for a in _DIRS], np.int32)   # (7,7)

_END_L = C._END_L
cell_type_ids = C.cell_type_ids
_decode_cells = C.decode_cells


def _np_pack_mask(bits):
    x = np.zeros(32 * MASK_WORDS, np.int64)
    x[:MASK_LEN] = np.asarray(bits, np.int64)
    w = (x.reshape(MASK_WORDS, 32) << np.arange(32)).sum(-1)
    return (w & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _np_head_mask_w(off, width):
    m = np.zeros(MASK_LEN, bool)
    m[off:off + width] = True
    return _np_pack_mask(m)


_NULL_MASK = np.zeros(MASK_LEN, bool)
_NULL_MASK[[PLAY0, SPECIAL0, REMOVE0, MOVE0, SHOP0]] = True
_HEAD_DEFS = ((PLAY0, 22), (SPECIAL0, 22), (REMOVE0, 22),
              (MOVE0, 7), (SHOP0, 19))


class _Consts:
    """Device copies of the static tables (one instance per device)."""

    def __init__(self, device):
        def t(x, dt=None):
            return torch.as_tensor(np.asarray(x), device=device, dtype=dt)
        self.iota3 = t(np.arange(3), _i32)
        self.iota4 = t(np.arange(4), _i32)
        self.iota7 = t(np.arange(7), _i32)
        self.iota18 = t(np.arange(N_BUYABLETYPES), _i32)
        self.iota19 = t(np.arange(N_BALL), _i32)
        self.iota21 = t(np.arange(N_CARDTYPES), _i32)
        self.iota32 = t(np.arange(32), _i32)
        self.iota_w = t(np.arange(MASK_WORDS), _i32)
        self.card_res = t(T.CARD_RES, _f32)
        self.card_single = t(T.CARD_SINGLE_USE)
        self.card_single_i = t(T.CARD_SINGLE_USE, _i32)
        self.card_is_special = t(T.CARD_IS_SPECIAL)
        self.card_special = t(T.CARD_SPECIAL, _i32)
        self.shop_type = t(T.SHOP_CARD_TYPE, _i32)
        self.shop_cost = t(T.SHOP_COST, _f32)
        self.shop_mkt0 = t(T.SHOP_STARTS_IN_MARKET)
        self.dir_dbl = t(_DIR_DBL, _i32)
        self.ball = t(_BALL, _i32)
        self.pair = t(_PAIR, _i32)
        self.null_mask = t(_NULL_MASK)
        self.null_w = t(_np_pack_mask(_NULL_MASK), _i32)
        self.start_discard = t(np.bincount(
            [CardType.EXPLORER] * 3 + [CardType.TRAVELER] * 4
            + [CardType.SAILOR], minlength=N_CARDTYPES), _i32)
        self.i0 = t(0, _i32)
        self.i1 = t(1, _i32)
        self.f0 = t(0.0, _f32)
        self.t_ = t(True)
        self.f_ = t(False)
        self._hw = {}
        self._hp = {}

    def head_w(self, off, width):
        """Packed (3,) words with bits [off, off+width) set."""
        key = (off, width)
        if key not in self._hw:
            self._hw[key] = torch.as_tensor(_np_head_mask_w(off, width),
                                            device=self.i0.device)
        return self._hw[key]

    def head_pos(self, off, k):
        """(word index, shift) of head bits [off, off+k)."""
        key = (off, k)
        if key not in self._hp:
            pos = off + np.arange(k)
            self._hp[key] = (
                torch.as_tensor(pos >> 5, dtype=_i32, device=self.i0.device),
                torch.as_tensor(pos & 31, dtype=_i32, device=self.i0.device))
        return self._hp[key]


@functools.lru_cache(maxsize=None)
def _K(device) -> _Consts:
    return _Consts(device)


def _k(x) -> _Consts:
    return _K(x.device)


def _oh(i, iota):
    return iota == i


def _get1(arr, i, iota):
    """arr[i] via a one-hot masked max (the JAX formulation, kept as is)."""
    if arr.dtype == torch.bool:
        return torch.where(_oh(i, iota), arr.to(_i32), 0).amax() > 0
    return torch.where(_oh(i, iota), arr, torch.zeros_like(arr)).amax()


def _wrow(arr2d, p):
    """Row p of a (4, k) i32 array, sign-safe (sum over the one-hot)."""
    k = _k(arr2d)
    return torch.where(_oh(p, k.iota4[:, None]), arr2d,
                       torch.zeros_like(arr2d)).sum(0, dtype=_i32)


def _u8row(arr, p):
    k = _k(arr)
    oh = _oh(p, k.iota4.reshape((MAX_N_PLAYERS,) + (1,) * (arr.ndim - 1)))
    return torch.where(oh, arr, torch.zeros_like(arr)).amax(0)


def _put_row(arr2d, p, row):
    k = _k(arr2d)
    return torch.where(_oh(p, k.iota4[:, None]), row[None, :], arr2d)


def _shr(x, n: int):
    """Logical right shift of int32 by a static n."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (32 - n)) - 1)


def _csum_incl(x):
    """Inclusive integer prefix sum along the last axis (the JAX engine's
    f32 triangular matmul, exact for these values)."""
    return torch.cumsum(x, -1).to(_i32)


def _any1(x):
    return x.to(_i32).sum() > 0


# ------------------------------------------------------------------ state
@dataclasses.dataclass
class EnvState:
    """The engine state, env-major: every field has a leading env axis
    (inside vmap, a single env's slice). Field names, shapes and dtypes are
    those of eldorado_tpu.core.engine.EnvState."""
    rng: torch.Tensor             # i32 engine state
    n_players: torch.Tensor       # i32
    n_pieces: torch.Tensor        # i32
    difficulty: torch.Tensor      # i32
    max_steps: torch.Tensor       # i32
    map_ids: torch.Tensor         # (2304,) i32 cell-type ids
    min_xy: torch.Tensor          # (2,) i32 doubled
    player_xy: torch.Tensor       # (4,2) i32 doubled
    map_ok: torch.Tensor          # bool
    map_overflow: torch.Tensor    # bool
    piles: torch.Tensor           # (4,5,21) u8 in i32
    n_in_hand: torch.Tensor       # (4,) u8
    n_active: torch.Tensor        # (4,) u8
    n_in_draw: torch.Tensor       # (4,) u8
    idx_last: torch.Tensor        # (4,) u8
    has_won: torch.Tensor         # (4,) bool
    mip: torch.Tensor             # (4,) bool
    next_card_free: torch.Tensor  # (4,) bool
    next_move_free: torch.Tensor  # (4,) bool
    n_removes: torch.Tensor       # (4,) u8
    steps_taken: torch.Tensor     # (4,) u8
    n_movements: torch.Tensor     # (4,) i32
    n_added: torch.Tensor         # (4,) u8
    shop_stock: torch.Tensor      # (18,) u8
    in_market: torch.Tensor       # (18,) bool
    n_in_market: torch.Tensor     # u8
    phase: torch.Tensor           # i32
    agent: torch.Tensor           # i32
    resources: torch.Tensor       # (3,) f32
    turn_counter: torch.Tensor    # i32
    done: torch.Tensor            # bool
    sel_mask: torch.Tensor        # (3,) i32 packed words
    storage_masks: torch.Tensor   # (4,3) i32 packed words
    w3_cache: torch.Tensor        # (4,) i32 packed one-hop words
    rewards: torch.Tensor         # (4,) f32
    info_total: torch.Tensor      # i32
    info_steps: torch.Tensor      # (4,) u8
    info_returns: torch.Tensor    # (4,) f32
    info_travelled: torch.Tensor  # (4,) i32
    info_added: torch.Tensor      # (4,) u8
    info_removed: torch.Tensor    # (4,) u8
    info_card_uses: torch.Tensor  # (4,) i32
    rng_tainted: torch.Tensor     # bool

    def _replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(EnvState))
# per-env shape and dtype of every field (engine.py:199-261)
FIELD_SPECS = {
    "map_ids": ((GRIDSIZE * GRIDSIZE,), _i32), "min_xy": ((2,), _i32),
    "player_xy": ((4, 2), _i32), "piles": ((4, 5, N_CARDTYPES), _i32),
    "shop_stock": ((N_BUYABLETYPES,), _i32),
    "in_market": ((N_BUYABLETYPES,), torch.bool),
    "resources": ((3,), _f32), "sel_mask": ((MASK_WORDS,), _i32),
    "storage_masks": ((4, MASK_WORDS), _i32),
}
for _f in ("n_in_hand", "n_active", "n_in_draw", "idx_last", "n_removes",
           "steps_taken", "n_movements", "n_added", "w3_cache", "info_steps",
           "info_travelled", "info_added", "info_removed", "info_card_uses"):
    FIELD_SPECS[_f] = ((4,), _i32)
for _f in ("has_won", "mip", "next_card_free", "next_move_free"):
    FIELD_SPECS[_f] = ((4,), torch.bool)
for _f in ("rewards", "info_returns"):
    FIELD_SPECS[_f] = ((4,), _f32)
for _f in ("map_ok", "map_overflow", "done", "rng_tainted"):
    FIELD_SPECS[_f] = ((), torch.bool)
for _f in FIELDS:
    FIELD_SPECS.setdefault(_f, ((), _i32))
FIELD_SPECS = {f: FIELD_SPECS[f] for f in FIELDS}

# Fields the step never writes (only reset touches them).
STATIC_FIELDS = ("map_ids", "min_xy", "map_ok", "map_overflow",
                 "n_players", "n_pieces", "difficulty", "max_steps")
DYN_FIELDS = tuple(f for f in FIELDS if f not in STATIC_FIELDS)


def split_state(states):
    return (tuple(getattr(states, f) for f in STATIC_FIELDS),
            tuple(getattr(states, f) for f in DYN_FIELDS))


def merge_state(static, dyn):
    parts = dict(zip(STATIC_FIELDS, static))
    parts.update(zip(DYN_FIELDS, dyn))
    return EnvState(**parts)


def _select(pred, a, b):
    """Field-wise where(pred, a, b); fields untouched by the taken branch
    are the same tensor on both sides and skip the select."""
    names = a._fields if isinstance(a, tuple) else FIELDS
    out = {}
    for f in names:
        x, y = getattr(a, f), getattr(b, f)
        out[f] = x if x is y else torch.where(pred, x, y)
    return type(a)(**out)


def _merge(base, *branches):
    """Flat N-way merge of (pred, tree) branches with exclusive preds."""
    names = base._fields if isinstance(base, tuple) else FIELDS
    out = {}
    for f in names:
        lb = getattr(base, f)
        val = lb
        for pred, tree in branches:
            lv = getattr(tree, f)
            if lv is not lb:
                val = torch.where(pred, lv, val)
        out[f] = val
    return type(base)(**out)


# ----------------------------------------------------- packed mask words
def pack_mask(bits):
    """(..., 92) bool -> (..., 3) i32 little-endian bit words."""
    k = _k(bits)
    x = bits.to(_i32)
    pad = torch.zeros(x.shape[:-1] + (32 * MASK_WORDS - MASK_LEN,),
                      dtype=_i32, device=bits.device)
    x = torch.cat([x, pad], -1).reshape(x.shape[:-1] + (MASK_WORDS, 32))
    return (x << k.iota32).sum(-1, dtype=_i32)


def unpack_mask(words):
    """(..., 3) i32 -> (..., 92) bool."""
    k = _k(words)
    u = (words[..., None] >> k.iota32) & 1
    u = u.reshape(words.shape[:-1] + (32 * MASK_WORDS,))
    return u[..., :MASK_LEN] != 0


def _mask_reset_w(m):
    k = _k(m)
    return (m & ~k.head_w(PLAY0, 66)) | k.null_w


def _bit_mask_w(pos):
    """(3,) i32 with (traced) bit ``pos`` set in its word."""
    k = _k(pos)
    return torch.where(k.iota_w == (pos >> 5), k.i1 << (pos & 31), k.i0)


def _bit_get_w(w, pos):
    return torch.where((w & _bit_mask_w(pos)) != 0, 1, 0).sum() > 0


def _bit_put_w(w, pos, bit):
    m = _bit_mask_w(pos)
    return (w & ~m) | torch.where(bit, m, _k(w).i0)


def _pack_head_w(bits, off):
    """(k,) bool/int head -> (3,) words with the head at static ``off``."""
    k = _k(bits)
    jk, sk = k.head_pos(off, bits.shape[-1])
    sh = bits.to(_i32) << sk
    return torch.stack([torch.where(jk == j, sh, k.i0).sum(dtype=_i32)
                        for j in range(MASK_WORDS)])


def _set_head_w(w, bits, off):
    k = _k(w)
    return (w & ~k.head_w(off, int(bits.shape[-1]))) | _pack_head_w(bits, off)


def _head_field_w(w, off, width):
    """Head bits [off, off+width) (width <= 22) as one scalar."""
    j0, sh = off >> 5, off & 31
    f = _shr(w[j0], sh)
    if sh + width > 32:
        f = f | (w[j0 + 1] << (32 - sh))
    return f & ((1 << width) - 1)


def _sel_card_bits(sel_w, idx, play_bit, special_bit, remove_bit=None):
    out = _bit_put_w(sel_w, PLAY0 + 1 + idx, play_bit)
    out = _bit_put_w(out, SPECIAL0 + 1 + idx, special_bit)
    if remove_bit is not None:
        out = _bit_put_w(out, REMOVE0 + 1 + idx, remove_bit)
    return out


def make_state(seeds, n_players=4, n_pieces=3, difficulty=0,
               max_steps=100000, device="cuda") -> EnvState:
    """Freshly constructed envs on ``device`` (batched over ``seeds``; each
    parameter is a scalar or a per-env sequence): zeroed buffers,
    ActionMask constructors, engine i seeded with seeds[i]."""
    rng = R.seed(seeds, device=device)
    n = rng.shape[0]
    device = rng.device
    k = _K(device)

    def par(v):
        return torch.as_tensor(v, device=device).to(_i32).expand(n).clone()

    out = {}
    for f, (shape, dt) in FIELD_SPECS.items():
        out[f] = torch.zeros((n,) + shape, dtype=dt, device=device)
    init_w = pack_mask(k.null_mask)
    out.update(
        rng=rng, n_players=par(n_players), n_pieces=par(n_pieces),
        difficulty=par(difficulty), max_steps=par(max_steps),
        map_ok=torch.ones(n, dtype=torch.bool, device=device),
        shop_stock=torch.full((n, N_BUYABLETYPES), 3, dtype=_i32,
                              device=device),
        in_market=k.shop_mkt0.expand(n, N_BUYABLETYPES).clone(),
        n_in_market=torch.full((n,), MKT_BOARD_SLOTS, dtype=_i32,
                               device=device),
        sel_mask=init_w.expand(n, MASK_WORDS).clone(),
        storage_masks=init_w.expand(n, 4, MASK_WORDS).clone())
    return EnvState(**out)


# ----------------------------------------------------------- player view
class PView(NamedTuple):
    """The current player's projected slice plus the shared step mutables
    (engine.PView)."""
    draw: torch.Tensor
    hand: torch.Tensor
    active: torch.Tensor
    played: torch.Tensor
    discard: torch.Tensor
    n_in_hand: torch.Tensor
    n_active: torch.Tensor
    n_in_draw: torch.Tensor
    idx_last: torch.Tensor
    xy: torch.Tensor
    storage: torch.Tensor
    has_won: torch.Tensor
    mip: torch.Tensor
    next_card_free: torch.Tensor
    next_move_free: torch.Tensor
    n_removes: torch.Tensor
    n_movements: torch.Tensor
    n_added: torch.Tensor
    sel: torch.Tensor
    resources: torch.Tensor
    phase: torch.Tensor
    shop_stock: torch.Tensor
    in_market: torch.Tensor
    n_in_market: torch.Tensor
    rng: torch.Tensor
    tainted: torch.Tensor


def _pview(s: EnvState, p) -> PView:
    k = _k(s.rng)
    piles_p = _u8row(s.piles, p)                       # (5,21)
    xy = torch.where(_oh(p, k.iota4[:, None]), s.player_xy,
                     torch.full_like(s.player_xy, -(1 << 20))).amax(0)

    def g(arr):
        return _get1(arr, p, k.iota4)
    return PView(
        draw=piles_p[PILE_DRAW], hand=piles_p[PILE_HAND],
        active=piles_p[PILE_ACTIVE], played=piles_p[PILE_PLAYED],
        discard=piles_p[PILE_DISCARD],
        n_in_hand=g(s.n_in_hand), n_active=g(s.n_active),
        n_in_draw=g(s.n_in_draw), idx_last=g(s.idx_last),
        xy=xy, storage=_wrow(s.storage_masks, p),
        has_won=g(s.has_won), mip=g(s.mip),
        next_card_free=g(s.next_card_free),
        next_move_free=g(s.next_move_free),
        n_removes=g(s.n_removes), n_movements=g(s.n_movements),
        n_added=g(s.n_added),
        sel=s.sel_mask, resources=s.resources, phase=s.phase,
        shop_stock=s.shop_stock, in_market=s.in_market,
        n_in_market=s.n_in_market, rng=s.rng, tainted=s.rng_tainted)


def _pview_embed(s: EnvState, p, v: PView) -> EnvState:
    k = _k(s.rng)
    oh_p = _oh(p, k.iota4)
    new_p = torch.stack([v.draw, v.hand, v.active, v.played, v.discard])

    def sput(arr, val):
        return torch.where(oh_p, val, arr)

    def bput(arr, val):
        return (arr & ~oh_p) | (oh_p & val)
    return s._replace(
        piles=torch.where(_oh(p, k.iota4[:, None, None]), new_p[None],
                          s.piles),
        n_in_hand=sput(s.n_in_hand, v.n_in_hand),
        n_active=sput(s.n_active, v.n_active),
        n_in_draw=sput(s.n_in_draw, v.n_in_draw),
        idx_last=sput(s.idx_last, v.idx_last),
        player_xy=torch.where(_oh(p, k.iota4[:, None]), v.xy[None],
                              s.player_xy),
        storage_masks=_put_row(s.storage_masks, p, v.storage),
        has_won=bput(s.has_won, v.has_won),
        mip=bput(s.mip, v.mip),
        next_card_free=bput(s.next_card_free, v.next_card_free),
        next_move_free=bput(s.next_move_free, v.next_move_free),
        n_removes=sput(s.n_removes, v.n_removes),
        n_movements=sput(s.n_movements, v.n_movements),
        n_added=sput(s.n_added, v.n_added),
        sel_mask=v.sel, resources=v.resources, phase=v.phase,
        shop_stock=v.shop_stock, in_market=v.in_market,
        n_in_market=v.n_in_market, rng=v.rng, rng_tainted=v.tainted)


# ------------------------------------------------------------------ deck
def _deck_draw_p(v: PView, n) -> PView:
    """Deck::draw (src/cards.cpp:183-211): recycle at most once, clamp,
    then up to four uniform picks scanning the draw-pile counts."""
    k = _k(v.rng)
    nid0 = v.n_in_draw
    need = nid0 < n
    rec_nid = _wrap8(nid0 + v.discard.sum(dtype=_i32))
    draw = torch.where(need, _wrap8(v.draw + v.discard), v.draw)
    discard = torch.where(need, torch.zeros_like(v.discard), v.discard)
    nid = torch.where(need, rec_nid, nid0)
    hand = v.hand
    if not torch.is_tensor(n):
        n = torch.tensor(n, dtype=_i32, device=nid.device)
    n_eff = torch.minimum(n, nid)
    sel, rng, taint = v.sel, v.rng, v.tainted
    cum = _csum_incl(draw)
    for j in range(HAND_SIZE):
        live = j < n_eff
        t, rng, tt = R.uniform_int_fast_maybe(rng, nid, live)
        taint = taint | tt
        ct = (cum <= t).sum(dtype=_i32)
        ct = torch.clamp(ct, max=N_CARDTYPES - 1)
        oh_ct = _oh(ct, k.iota21)
        dlt = torch.where(live & oh_ct, k.i1, k.i0)
        draw = _wrap8(draw - dlt)
        hand = _wrap8(hand + dlt)
        cum = torch.where(live, cum - (k.iota21 >= ct).to(_i32), cum)
        nid = torch.where(live, _wrap8(nid - 1), nid)
        sel = sel | torch.where(live, _bit_mask_w(PLAY0 + 1 + ct), k.i0)
        msp = _bit_mask_w(SPECIAL0 + 1 + ct)
        new_sp = (sel & ~msp) | torch.where(
            _get1(k.card_is_special, ct, k.iota21), msp, k.i0)
        sel = torch.where(live, new_sp, sel)
    return v._replace(draw=draw, hand=hand, discard=discard, n_in_draw=nid,
                      n_in_hand=_wrap8(v.n_in_hand + n_eff),
                      sel=sel, rng=rng, tainted=taint)


def _activate_p(v: PView, idx) -> PView:
    """Deck::activate (src/cards.cpp:242-253)."""
    k = _k(v.rng)
    oh_c = _oh(idx, k.iota21)
    prev = _get1(v.hand, idx, k.iota21)
    dlt = torch.where(oh_c, k.i1, k.i0)
    return v._replace(
        hand=_wrap8(v.hand - dlt), active=_wrap8(v.active + dlt),
        n_in_hand=_wrap8(v.n_in_hand - 1),
        n_active=_wrap8(v.n_active + 1),
        idx_last=idx,
        sel=_sel_card_bits(
            v.sel, idx, prev > 1,
            (prev > 1) & _get1(k.card_is_special, idx, k.iota21)))


def _play_last_activated_p(v: PView) -> PView:
    """src/cards.cpp:255-261."""
    k = _k(v.rng)
    idx = v.idx_last
    oh_c = _oh(idx, k.iota21)
    single_i = _get1(k.card_single_i, idx, k.iota21)
    return v._replace(
        active=_wrap8(v.active - torch.where(oh_c, k.i1, k.i0)),
        played=_wrap8(v.played + torch.where(oh_c & (single_i == 0),
                                             k.i1, k.i0)),
        n_active=_wrap8(v.n_active - 1))


def _play_immediate_p(v: PView, idx) -> PView:
    """src/cards.cpp:263-273."""
    k = _k(v.rng)
    oh_c = _oh(idx, k.iota21)
    prev = _get1(v.hand, idx, k.iota21)
    dlt = torch.where(oh_c, k.i1, k.i0)
    return v._replace(
        hand=_wrap8(v.hand - dlt), played=_wrap8(v.played + dlt),
        n_in_hand=_wrap8(v.n_in_hand - 1),
        sel=_sel_card_bits(
            v.sel, idx, prev > 1,
            (prev > 1) & _get1(k.card_is_special, idx, k.iota21)))


def _remove_immediate_p(v: PView, idx) -> PView:
    """src/cards.cpp:281-290."""
    k = _k(v.rng)
    oh_c = _oh(idx, k.iota21)
    prev = _get1(v.hand, idx, k.iota21)
    play_bit = _bit_get_w(v.sel, PLAY0 + 1 + idx) & (prev > 1)
    remove_bit = _bit_get_w(v.sel, REMOVE0 + 1 + idx) & (prev > 1)
    return v._replace(
        hand=_wrap8(v.hand - torch.where(oh_c, k.i1, k.i0)),
        n_in_hand=_wrap8(v.n_in_hand - 1),
        sel=_sel_card_bits(
            v.sel, idx, play_bit,
            play_bit & _get1(k.card_is_special, idx, k.iota21),
            remove_bit=remove_bit))


def _pick_actives_p(v: PView, n, to_discard) -> PView:
    """Player::discard_cards / remove_cards (src/player.cpp:85-131)."""
    k = _k(v.rng)
    n_avail = v.n_active
    n = torch.where(to_discard, n, torch.minimum(n, n_avail))
    active, discard, n_act = v.active, v.discard, v.n_active
    rng, taint = v.rng, v.tainted
    for j in range(5):
        live = j < n
        t, rng, tt = R.uniform_int_fast_maybe(rng, n_avail - j, live)
        taint = taint | tt
        cum = _csum_incl(active)
        ct = torch.clamp((cum <= t).sum(dtype=_i32), max=N_CARDTYPES - 1)
        oh_ct = _oh(ct, k.iota21)
        active = _wrap8(active - torch.where(live & oh_ct, k.i1, k.i0))
        discard = _wrap8(discard + torch.where(live & to_discard & oh_ct,
                                               k.i1, k.i0))
        n_act = torch.where(live, _wrap8(n_act - 1), n_act)
    return v._replace(active=active, discard=discard, n_active=n_act,
                      rng=rng, tainted=taint)


# ----------------------------------------------------------------- masks
def _disable_playing_p(v: PView) -> PView:
    """src/player.cpp:191-196."""
    k = _k(v.rng)
    m = k.head_w(PLAY0, 44)
    return v._replace(sel=(v.sel & ~m) | (k.null_w & m))


def _enable_playing_p(v: PView) -> PView:
    """src/player.cpp:198-206."""
    k = _k(v.rng)
    play = v.hand > 0
    m = k.head_w(REMOVE0, 22)
    sel = (v.sel & ~m) | (k.null_w & m)
    sel = _set_head_w(sel, play, PLAY0 + 1)
    sel = _set_head_w(sel, play & k.card_is_special, SPECIAL0 + 1)
    return v._replace(sel=sel)


def _shop_avail(shop_stock, in_market, n_in_market, coins):
    """Shop::set_available_mask -> 18 bools (src/cards.cpp:109-121)."""
    k = _k(shop_stock)
    open_slots = n_in_market < MKT_BOARD_SLOTS
    afford = coins > k.shop_cost
    return torch.where(open_slots, (shop_stock > 0) & afford,
                       in_market & afford)


def _ball_at_p(ball_p, kk):
    """ball-row entry (req, n_req, is_end) at ball index kk."""
    k = _k(ball_p[0])
    breq, bnr, bend = ball_p
    m = _oh(kk, k.iota19)
    req = torch.where(m, breq, -1).amax()
    req = torch.where(req < 0, 5, req)
    return (req, torch.where(m, bnr, torch.zeros_like(bnr)).amax(),
            torch.where(m, bend, torch.zeros_like(bend)).amax())


def _movement_mask_row(ball_p, m_eff, resources, n_active):
    """Map::set_movement_mask (src/map.cpp:369-387) against one player's
    pregathered ball row, after an optional first hop ``m_eff``."""
    k = _k(ball_p[0])
    row_req, row_nr, _ = ball_p
    kidx = torch.where(_oh(m_eff, k.iota7[:, None]), k.pair,
                       torch.zeros_like(k.pair)).amax(0)[1:]   # (6,)
    onek = _oh(kidx[:, None], k.iota19[None, :])               # (6,19)
    req = torch.where(onek, row_req[None, :], -1).amax(-1)
    req = torch.where(req < 0, 5, req)
    n_req = torch.where(onek, row_nr[None, :], 0).amax(-1)
    ridx = torch.clamp(req, max=2)
    res = torch.where(ridx == 0, resources[0],
                      torch.where(ridx == 1, resources[1], resources[2]))
    filled = torch.where(req >= 3, n_active > n_req,
                         res >= n_req.to(_f32))
    return (req != 5) & filled


def _obs_mask(m, phase, mv, shop_av):
    """cog_env::update_observation — move/shop heads of a stored mask
    (src/environment.cpp:252-279), packed words."""
    k = _k(m)
    ms = k.head_w(MOVE0, 26)
    m = (m & ~ms) | (k.null_w & ms)
    m = m | torch.where(phase == TurnPhase.MOVEMENT,
                        _pack_head_w(mv, MOVE0 + 1), k.i0)
    m = m | torch.where(phase == TurnPhase.BUYING,
                        _pack_head_w(shop_av, SHOP0 + 1), k.i0)
    return m


# ----------------------------------------------------------------- reset
def _player_reset(s: EnvState, p: int) -> EnvState:
    """Player::reset (src/player.cpp:29-43); the `played` pile survives."""
    k = _k(s.rng)
    oh_p = _oh(p, k.iota4)
    z21 = torch.zeros(N_CARDTYPES, dtype=_i32, device=s.rng.device)
    new_p = torch.stack([z21, z21, z21, _u8row(s.piles[:, PILE_PLAYED], p),
                         k.start_discard])
    piles = torch.where(_oh(p, k.iota4[:, None, None]), new_p[None], s.piles)
    s = s._replace(
        has_won=torch.where(oh_p, k.f_, s.has_won),
        mip=torch.where(oh_p, k.f_, s.mip),
        next_card_free=torch.where(oh_p, k.f_, s.next_card_free),
        next_move_free=torch.where(oh_p, k.f_, s.next_move_free),
        n_removes=torch.where(oh_p, k.i0, s.n_removes),
        steps_taken=torch.where(oh_p, k.i0, s.steps_taken),
        n_movements=torch.where(oh_p, k.i0, s.n_movements),
        n_added=torch.where(oh_p, k.i0, s.n_added),
        piles=piles,
        n_in_draw=torch.where(oh_p, k.i0, s.n_in_draw),
        n_in_hand=torch.where(oh_p, k.i0, s.n_in_hand),
        n_active=torch.where(oh_p, k.i0, s.n_active),
        sel_mask=_mask_reset_w(s.sel_mask))
    s = _pview_embed(s, p, _deck_draw_p(_pview(s, p), HAND_SIZE))
    return s._replace(storage_masks=_put_row(s.storage_masks, p, s.sel_mask))


def _update_observation_ball(s: EnvState, agent: int, ball) -> EnvState:
    """update_observation against pregathered (4, 19) ball rows."""
    k = _k(s.rng)
    req, nr, end = ball
    oh = _oh(agent, k.iota4[:, None])
    row = tuple(torch.where(oh, x, torch.zeros_like(x)).sum(0, dtype=_i32)
                for x in (req, nr, end))
    mv = _movement_mask_row(row, k.i0, s.resources,
                            _get1(s.n_active, agent, k.iota4))
    m = _obs_mask(_wrow(s.storage_masks, agent), s.phase, mv,
                  _shop_avail(s.shop_stock, s.in_market, s.n_in_market,
                              s.resources[2]))
    return s._replace(storage_masks=_put_row(s.storage_masks, agent, m))


def w3_words_from_cells(req, nr, end):
    """pack_ball_words' w3 for every player from (4, 19) ball rows."""
    ids = cell_type_ids(req, nr, end)
    w3 = torch.zeros_like(ids[..., 0])
    for i in range(6):
        w3 = w3 | (ids[..., 1 + i] << (5 * i))
    return w3 | (end[..., 0] << 30)


def reset_body(s: EnvState, player_xy, ball) -> EnvState:
    """Everything in cog_env::reset AFTER map generation, with the map
    reads pregathered (engine.reset_body): ``player_xy`` (4, 2) already
    gated by add_players, ``ball`` the (req, nr, end) (4, 19) rows at
    those positions. Touches only DYN fields. Single env."""
    k = _k(s.rng)
    s = s._replace(agent=k.i0.clone(), phase=k.i0.clone())
    for p in range(MAX_N_PLAYERS):
        s = _select(p < s.n_players, _player_reset(s, p), s)
    s = s._replace(player_xy=player_xy)
    # Shop::reset (src/cards.cpp:94-100): n_in_market untouched
    s = s._replace(shop_stock=torch.full_like(s.shop_stock, 3),
                   in_market=k.shop_mkt0, done=k.f_,
                   turn_counter=k.i0.clone())
    for p in range(MAX_N_PLAYERS):
        s = _select(p < s.n_players, _update_observation_ball(s, p, ball), s)
    return s._replace(sel_mask=_wrow(s.storage_masks, s.agent),
                      w3_cache=w3_words_from_cells(*ball))


# ---------------------------------------------------------- map reads
def _ball_ids_xy(map_ids, min_xy, player_xy):
    """Every player's 19-cell ball as raw cell-type ids (4, 19): the
    reference's size_t truncation of half-integer offsets
    (src/map.cpp:273-275; d >= 0 -> d//2+1, d == -1 -> 1, d <= -2 -> 0),
    off-grid reads the sentinel id 0."""
    k = _k(map_ids)
    tgt = player_xy[:, None, :] + k.ball[None, :, :]            # (4,19,2)
    d = tgt - min_xy
    idx = torch.where(d >= 0, (d >> 1) + 1,
                      torch.where(d == -1, k.i1, k.i0))
    ix, iy = idx[..., 0], idx[..., 1]
    in_grid = (ix >= 0) & (ix < GRIDSIZE) & (iy >= 0) & (iy < GRIDSIZE)
    lin = (torch.clamp(ix, 0, GRIDSIZE - 1) * GRIDSIZE
           + torch.clamp(iy, 0, GRIDSIZE - 1))
    return torch.where(in_grid, map_ids[lin], k.i0)


def _ball_cells_xy(map_ids, min_xy, player_xy):
    """(req, n_req, is_end), each (4, 19), of every player's ball."""
    return _decode_cells(_ball_ids_xy(map_ids, min_xy, player_xy))


def pack_ball_words(pids, pend0):
    """Pack one step's map read into 4 i32 words (engine.pack_ball_words):
    the 19 ball ids at bits [5k, 5k+5) of w0..w2, and w3 = the six 1-hop
    ids at bits [5(i-1), 5i) plus the player's own is_end at bit 30."""
    ws = []
    for j in range(3):
        w = torch.zeros_like(pids[..., 0])
        for kk in range(N_BALL):
            lo = 5 * kk - 32 * j
            if -4 <= lo <= 31:
                idk = pids[..., kk]
                w = w | (idk << lo if lo >= 0 else idk >> -lo)
        ws.append(w)
    w3 = torch.zeros_like(pids[..., 0])
    for i in range(6):
        w3 = w3 | (pids[..., 1 + i] << (5 * i))
    return ws[0], ws[1], ws[2], w3 | (pend0 << 30)


def _ball_p_ids(w0, w1, w2):
    """Unpack the current player's 19 ball ids from w0..w2."""
    ws = (w0, w1, w2)
    cells = []
    for kk in range(N_BALL):
        j, sh = divmod(5 * kk, 32)
        c = (ws[j] >> sh) & 31
        if sh > 27:   # cell straddles into the next word
            c = (c & ((1 << (32 - sh)) - 1)) | ((ws[j + 1] << (32 - sh)) & 31)
        cells.append(c)
    return torch.stack(cells, dim=-1)


def _ball_q_row(w3):
    """Next-agent pseudo ball row from their packed one-hop word: real
    values at the six 1-hop indices and the own is_end at index 0,
    sentinel elsewhere."""
    k = _k(w3)
    qids = torch.stack([(w3 >> (5 * i)) & 31 for i in range(6)], dim=-1)
    req6, nr6, end6 = _decode_cells(qids)
    end0 = ((w3 >> 30) & 1).reshape(1)
    five = torch.full((1,), 5, dtype=_i32, device=w3.device)
    req = torch.cat([five, req6, five.expand(12)])
    z1 = k.i0.reshape(1)
    nr = torch.cat([z1, nr6, z1.expand(12)])
    end = torch.cat([end0, end6, z1.expand(12)])
    return req, nr, end


def ball_words(s: EnvState):
    """The step's entire map read as 4 i32 words (engine.ball_words)."""
    k = _k(s.rng)
    ids = _ball_ids_xy(s.map_ids, s.min_xy, s.player_xy)      # (4, 19)
    oh_p = _oh(s.agent, k.iota4[:, None])
    pids = torch.where(oh_p, ids, k.i0).amax(0)               # (19,)
    e0 = torch.where(oh_p[:, 0], ids[:, 0], k.i0).amax()
    pend0 = (torch.full_like(e0, _END_L) >> e0) & 1
    return pack_ball_words(pids, pend0)


# ------------------------------------------------------------------ step
def _end_turn_p(v: PView):
    """Player::end_turn (src/player.cpp:170-180). Returns (view, saved)."""
    k = _k(v.rng)
    actpl = _wrap8(v.active + v.played)
    z21 = torch.zeros_like(v.active)
    v = v._replace(discard=_wrap8(v.discard + actpl), active=z21,
                   played=z21, n_active=k.i0)
    n_draw = HAND_SIZE - v.n_in_hand
    v = _select(n_draw > 0,
                _deck_draw_p(v, torch.clamp(n_draw, min=0)), v)
    return v._replace(resources=torch.zeros_like(v.resources)), v.sel


def _run_special_p(v: PView, special, ball_p) -> PView:
    """Card special actions (src/cards.cpp:8-36) + the shop-disable
    continuation (src/environment.cpp:156-159)."""
    k = _k(v.rng)
    shop1_w = k.head_w(SHOP0 + 1, 18)
    move_w = k.head_w(MOVE0, 7)

    def put_shop(m, v):
        return (m & ~shop1_w) | _pack_head_w(
            _shop_avail(v.shop_stock, v.in_market, v.n_in_market, k.f0),
            SHOP0 + 1)

    def f_transmit(v):
        m = (v.storage & ~move_w) | (k.null_w & move_w)
        m = (m & ~shop1_w) | _pack_head_w(v.shop_stock > 0, SHOP0 + 1)
        v = _disable_playing_p(v._replace(storage=m))
        return v._replace(next_card_free=k.t_)

    nd = torch.where(
        special == T.SPECIAL_DRAW3, 3,
        torch.where(special == T.SPECIAL_DRAW1_REMOVE1, 1,
                    torch.where((special == T.SPECIAL_DRAW2)
                                | (special == T.SPECIAL_DRAW2_REMOVE2),
                                2, 0))).to(_i32)
    sd = _deck_draw_p(v, nd)

    def f_draw_remove(v):
        w0 = v.storage[0]
        w1 = (v.storage[1] & 0xFFF) | ((w0 & 0xFFFFF) << 12)
        w2 = (v.storage[2] & ~3) | (_shr(w0, 20) & 3)
        m = put_shop(torch.stack([w0, w1, w2]), v)
        v = _disable_playing_p(v._replace(storage=m))
        return v._replace(n_removes=nd)

    def f_native(v):
        mv = _movement_mask_row(ball_p, k.i0,
                                torch.full_like(v.resources, 100.0),
                                torch.full_like(k.i0, 100))
        m = ((v.storage & ~k.head_w(MOVE0 + 1, 6))
             | _pack_head_w(mv, MOVE0 + 1))
        m = put_shop(m, v)
        v = _disable_playing_p(v._replace(storage=m))
        return v._replace(next_move_free=k.t_)

    def f_shop_disable(v):
        return v._replace(storage=put_shop(v.storage, v))

    out = _select(special == T.SPECIAL_TRANSMIT, f_transmit(v), v)
    out = _select((special == T.SPECIAL_DRAW2)
                  | (special == T.SPECIAL_DRAW3), sd, out)
    out = _select((special == T.SPECIAL_DRAW1_REMOVE1)
                  | (special == T.SPECIAL_DRAW2_REMOVE2),
                  f_draw_remove(sd), out)
    out = _select(special == T.SPECIAL_NATIVE, f_native(v), out)
    out = _select(special == T.SPECIAL_SHOP_DISABLE, f_shop_disable(v), out)
    return out


def _step_pre(s: EnvState, p) -> EnvState:
    """steps_taken/info bookkeeping + INACTIVE->MOVEMENT phase entry
    (src/environment.cpp:97-98,226-231)."""
    k = _k(s.rng)
    one = torch.where(_oh(p, k.iota4), k.i1, k.i0)
    return s._replace(
        info_steps=_wrap8(s.info_steps + one),
        phase=torch.where(s.phase == TurnPhase.INACTIVE,
                          torch.full_like(s.phase, int(TurnPhase.MOVEMENT)),
                          s.phase),
        steps_taken=_wrap8(s.steps_taken + one))


def step_env(s: EnvState, action) -> EnvState:
    """cog_env::step (src/environment.cpp:91-224) with the given action
    (5,) i32 (play, play_special, remove, move, get_from_shop); a done env
    dead-steps, unchanged (engine.step_env)."""
    return step_core(s, action, ball_words(s))


def step_core(s: EnvState, action, ball) -> EnvState:
    """The map-free step body on the pregathered ``ball`` words
    (engine.step_core)."""
    p = s.agent
    s1 = _step_pre(s, p)
    return _step_from_view(s, s1, _pview(s1, p), p, action, ball)


def fused_sample_step(s: EnvState, srng, ball, mask_src: str = "storage",
                      gate_dead: bool = False):
    """Sampler + step sharing one player projection
    (engine.fused_sample_step). Returns (state', srng', action).
    ``gate_dead`` freezes a done env's sampler stream."""
    p = s.agent
    s1 = _step_pre(s, p)
    v = _pview(s1, p)
    mask = v.storage if mask_src == "storage" else s.sel_mask
    live = ~s.done if gate_dead else None
    action, srng, tainted = _sample_action_w(srng, mask, live)
    s2 = _step_from_view(s, s1, v, p, action, ball)
    return s2._replace(rng_tainted=s2.rng_tainted | tainted), srng, action


def _step_from_view(s0: EnvState, s: EnvState, v: PView, p, action,
                    ball) -> EnvState:
    k = _k(s.rng)
    a_play, a_sp, a_rm, a_mv, a_shop = (action[i] for i in range(5))
    w0, w1, w2, _ = ball
    pids = _ball_p_ids(w0, w1, w2)
    ball_p = _decode_cells(pids)

    b_play = a_play > 0
    b_special = (a_play == 0) & (a_sp > 0)
    b_move = (a_play == 0) & (a_sp == 0) & (a_mv > 0)
    b_else = (a_play == 0) & (a_sp == 0) & (a_mv == 0)
    b_shop = b_else & (a_shop > 0)
    b_remove = b_else & (a_shop == 0) & (a_rm > 0)
    b_null = b_else & (a_shop == 0) & (a_rm == 0)

    def f_play(v):      # src/environment.cpp:104-108, src/player.cpp:47-69
        idx = torch.clamp(a_play - 1, 0, N_CARDTYPES - 1)
        oh_c = _oh(idx, k.iota21)
        res_mov = torch.stack([
            torch.where(oh_c, k.card_res[:, c], k.f0).amax()
            for c in range(3)])
        coin = res_mov[2]
        res_buy = v.resources + torch.where(
            k.iota3 == 2, torch.where(coin > 0, coin, 0.5), k.f0)
        res = torch.where(v.phase == TurnPhase.MOVEMENT, res_mov,
                          torch.where(v.phase == TurnPhase.BUYING, res_buy,
                                      v.resources))
        return _activate_p(v._replace(resources=res), idx)

    def f_special(v):   # src/environment.cpp:110-112
        idx = torch.clamp(a_sp - 1, 0, N_CARDTYPES - 1)
        return _select(_get1(k.card_single, idx, k.iota21),
                       _remove_immediate_p(v, idx),
                       _play_immediate_p(v, idx))

    def f_move(v):      # src/environment.cpp:115-125
        dxy = torch.where(_oh(a_mv, k.iota7[:, None]), k.dir_dbl,
                          torch.full_like(k.dir_dbl, -(1 << 20))).amax(0)
        v = v._replace(xy=v.xy + dxy)
        kidx = torch.where(_oh(a_mv, k.iota7), k.pair[0], k.i0).amax()
        req, n_req, is_end = _ball_at_p(ball_p, kidx)
        p_free = v.next_move_free
        p_res = ~p_free & (req < 3)
        p_pick = ~p_free & ((req == 3) | (req == 4))
        ridx = torch.clamp(req, max=2)
        oh_r = _oh(ridx, k.iota3)
        left = torch.where(
            ridx == 0, v.resources[0],
            torch.where(ridx == 1, v.resources[1],
                        v.resources[2])) - n_req.to(_f32)
        res = torch.where(oh_r, left, k.f0)
        first = ~v.mip
        with_play = _play_last_activated_p(v)._replace(mip=k.t_)
        res_state = _select(first, with_play, v)._replace(resources=res)
        pick_state = _pick_actives_p(v, n_req, req == 3)._replace(
            resources=torch.zeros_like(v.resources), mip=k.f_)
        free_state = _enable_playing_p(v._replace(next_move_free=k.f_))
        v = _merge(v, (p_free, free_state), (p_res, res_state),
                   (p_pick, pick_state))
        return v._replace(n_movements=v.n_movements + 1,
                          has_won=is_end > 0)

    def f_else_body(v):  # src/environment.cpp:128-174
        v = v._replace(next_move_free=k.f_)

        def f_shop(v):
            i = torch.clamp(a_shop - 1, 0, N_BUYABLETYPES - 1)
            oh_i = _oh(i, k.iota18)
            free = v.next_card_free
            in_mkt_i = _any1(v.in_market & oh_i)
            n_mkt = _wrap8(v.n_in_market + torch.where(
                free, k.i0, 1 - in_mkt_i.to(_i32)))
            in_mkt = torch.where(free, v.in_market, v.in_market | oh_i)
            stock = _wrap8(v.shop_stock - torch.where(oh_i, k.i1, k.i0))
            stock_i = torch.where(oh_i, stock, k.i0).amax()
            close = (stock_i == 0) & _any1(in_mkt & oh_i)
            in_mkt = torch.where(close, in_mkt & (k.iota18 != i), in_mkt)
            n_mkt = torch.where(close, _wrap8(n_mkt - 1), n_mkt)
            card = torch.where(oh_i, k.shop_type, k.i0).amax()
            cost = torch.where(oh_i, k.shop_cost, k.f0).amax()
            res = torch.where(free, v.resources, v.resources - torch.where(
                k.iota3 == 2, cost, k.f0))
            phase = torch.where(free, v.phase, torch.where(
                v.phase == 2, k.i0, v.phase + 1))
            oh_card = _oh(card, k.iota21)
            return v._replace(
                shop_stock=stock, in_market=in_mkt, n_in_market=n_mkt,
                resources=res, phase=phase,
                discard=_wrap8(v.discard + torch.where(oh_card, k.i1, k.i0)),
                n_added=_wrap8(v.n_added + 1))

        def f_remove(v):
            idx = torch.clamp(a_rm - 1, 0, N_CARDTYPES - 1)
            v = _remove_immediate_p(v, idx)
            v = v._replace(n_removes=_wrap8(v.n_removes - 1))
            return _select(v.n_removes == 0, _enable_playing_p(v), v)

        def f_null(v):
            v = v._replace(phase=torch.where(v.phase == 2, k.i0,
                                             v.phase + 1))
            pending = v.n_removes > 0
            cleared = _enable_playing_p(v._replace(n_removes=k.i0))
            return _select(pending, cleared, v)

        return f_shop(v), f_remove(v), f_null(v)

    shop_v, remove_v, null_v = f_else_body(v)
    v = _merge(v, (b_play, f_play(v)), (b_special, f_special(v)),
               (b_move, f_move(v)), (b_shop, shop_v),
               (b_remove, remove_v), (b_null, null_v))
    # next_card_free tail (src/environment.cpp:170-173)
    freed = _enable_playing_p(v._replace(next_card_free=k.f_))
    v = _select(b_else & v.next_card_free, freed, v)

    # pending special id (executed after update_observation)
    special = torch.where(
        b_special,
        _get1(k.card_special, torch.clamp(a_sp - 1, 0, N_CARDTYPES - 1),
              k.iota21), k.i0)
    special = torch.where(
        (a_play == 0) & (a_sp == 0) & (a_mv == 0) & (a_shop == 0)
        & (a_rm > 0) & (v.n_removes != 0),
        torch.full_like(special, T.SPECIAL_SHOP_DISABLE), special)

    # movement_in_progress teardown (src/environment.cpp:176-179), gated
    # on the raw action.move field
    tear = v.mip & (a_mv == 0)
    v = _select(tear, v._replace(mip=k.f_,
                                 resources=torch.zeros_like(v.resources)), v)

    # maybe_end_turn (src/environment.cpp:244-250)
    rotate = v.has_won | (v.phase == TurnPhase.INACTIVE)
    et_v, saved = _end_turn_p(v)
    q = p + 1
    q = torch.where(q >= s.n_players, k.i0, q)

    # the agent's one-hop word (pack_ball_words' w3). It is read when the
    # turn next comes to the agent, where the reference reads the agent's
    # current cell (src/environment.cpp:187-207), so a move that ends the
    # turn (onto an end cell) stores the word of the cell it reached: ball
    # cells pair[a_mv] around the ball's centre. The JAX engine stores the
    # word of the cell the agent left (the ball's w3), stale until the
    # agent's next step; any other step stores, as there, the cell it
    # started on.
    m = torch.where(b_move & rotate & (a_mv < 7), a_mv, k.i0)
    hop = torch.where(_oh(m, k.iota7[:, None]), k.pair, k.i0).amax(0)
    ring = torch.where(_oh(hop[:, None], k.iota19), pids, k.i0).amax(1)
    w3_own = (ring[1:] << (5 * k.iota7[:6])).sum(dtype=_i32) \
        | (_ball_at_p(ball_p, hop[0])[2] << 30)
    w3_cache = torch.where(_oh(p, k.iota4), w3_own, s.w3_cache)
    row_q = _wrow(s.storage_masks, q)
    sel_next = torch.where(q == p, saved, row_q)
    v = _select(rotate, et_v._replace(sel=sel_next), v)

    # update_observation for the post-rotation agent r
    rot_other = rotate & (q != p)
    storage_r = torch.where(rotate, saved, v.storage)
    storage_r = torch.where(rot_other, row_q, storage_r)
    n_active_r = torch.where(rot_other, _get1(s.n_active, q, k.iota4),
                             v.n_active)
    ball_q = _ball_q_row(torch.where(_oh(q, k.iota4), w3_cache,
                                     k.i0).sum(dtype=_i32))
    ball_r = tuple(torch.where(rotate, b, a) for a, b in zip(ball_p, ball_q))
    m_eff = torch.where(b_move & ~rotate, a_mv, k.i0)
    mv_mask = _movement_mask_row(ball_r, m_eff, v.resources, n_active_r)
    new_mask_r = _obs_mask(storage_r, v.phase, mv_mask,
                           _shop_avail(v.shop_stock, v.in_market,
                                       v.n_in_market, v.resources[2]))

    # special function (src/environment.cpp:183-186)
    v = v._replace(storage=new_mask_r)
    v = _select(special > 0, _run_special_p(v, special, ball_p), v)

    # single-pass write-back
    mask_p_final = torch.where(rotate, saved, v.storage)
    mask_r_final = torch.where(rotate, new_mask_r, v.storage)
    r_idx = torch.where(rotate, q, p)
    s = _pview_embed(s, p, v._replace(storage=mask_p_final))
    s = s._replace(
        storage_masks=_put_row(s.storage_masks, r_idx, mask_r_final),
        agent=r_idx, turn_counter=s.turn_counter + rotate.to(_i32),
        w3_cache=w3_cache)

    # done check (src/environment.cpp:187-207)
    k0 = torch.where(_oh(m_eff, k.iota7), k.pair[:, 0], k.i0).amax()
    _, _, on_end = _ball_at_p(ball_r, k0)
    end_now = (special == 0) & ((on_end > 0)
                                | (s.turn_counter >= s.max_steps))
    hw = s.has_won.to(_f32)
    n_winners = hw.sum()
    live = k.iota4 < s.n_players
    # two separately rounded f32 ops, as in the JAX engine (no FMA)
    returns = s.n_players.to(_f32) * hw - n_winners
    finished = s._replace(
        done=k.t_,
        info_total=s.turn_counter,
        info_steps=torch.where(live, s.steps_taken, s.info_steps),
        info_returns=torch.where(live, returns, s.info_returns),
        rewards=torch.where(live, returns, s.rewards),
        info_travelled=torch.where(live, s.n_movements, s.info_travelled),
        info_added=torch.where(live, s.n_added, s.info_added),
        info_removed=torch.where(live, s.n_added, s.info_removed),
        info_card_uses=torch.where(live, s.n_added, s.info_card_uses))
    s = _select(end_now, finished, s)
    return _select(s0.done, s0, s)


def _sample_action_w(rng, w, live=None):
    """action_sampler::sample (include/sampler.h:14-79) on a packed (3,)
    word mask: per head a uniform pick over the valid indices; exactly five
    engine draws (none where ``live`` is False)."""
    outs = []
    tainted = torch.zeros((), dtype=torch.bool, device=rng.device)
    for off, width in _HEAD_DEFS:
        f = _head_field_w(w, off, width)
        iota = torch.arange(width, dtype=_i32, device=rng.device)
        bits = (f >> iota) & 1
        n = bits.sum(dtype=_i32)
        if live is None:
            pos, rng, tt = R.uniform_int_fast(rng, torch.clamp(n, min=1))
        else:
            pos, rng, tt = R.uniform_int_fast_maybe(
                rng, torch.clamp(n, min=1), live)
        tainted = tainted | tt
        csum = _csum_incl(bits) - bits
        match = (bits == 1) & (csum == pos)
        val = torch.where(match, iota, 0).sum(dtype=_i32)
        outs.append(torch.where(n > 0, val, 0).to(_i32))
    return torch.stack(outs), rng, tainted


def sample_action(rng, mask, live=None):
    """action_sampler::sample on the flat (92,) bool mask
    (engine.sample_action). Returns (action (5,), rng, tainted); with
    ``live`` False no engine draw is consumed."""
    return _sample_action_w(rng, pack_mask(mask), live)


# -------------------------------------------------------- batched entries
def _unread_static(n_players, max_steps, map_ids, min_xy):
    z = torch.zeros_like(n_players)
    return (map_ids, min_xy, z == 0, z != 0, n_players, z, z, max_steps)


def vstep(dyn, srng, map_ids, min_xy, n_players, max_steps,
          mask_src: str = "storage", gate_dead: bool = False):
    """One batched sample+step: ``dyn`` is the tuple of env-major DYN
    fields. Returns (dyn', srng', actions (n, 5) i32)."""
    def one(dyn, srng, map_ids, min_xy, n_players, max_steps):
        s = merge_state(_unread_static(n_players, max_steps, map_ids,
                                       min_xy), dyn)
        s, srng, act = fused_sample_step(s, srng, ball_words(s), mask_src,
                                         gate_dead)
        return split_state(s)[1], srng, act
    return vmap(one)(tuple(dyn), srng, map_ids, min_xy, n_players,
                     max_steps)


def vstep_actions(dyn, actions, map_ids, min_xy, n_players, max_steps):
    """One batched step with given actions (n, 5) i32 (`step_env` on every
    env): ``dyn`` is the tuple of env-major DYN fields. Returns dyn'."""
    def one(dyn, action, map_ids, min_xy, n_players, max_steps):
        s = merge_state(_unread_static(n_players, max_steps, map_ids,
                                       min_xy), dyn)
        return split_state(step_env(s, action))[1]
    return vmap(one)(tuple(dyn), actions, map_ids, min_xy, n_players,
                     max_steps)


def vsample(srng, mask_words, live=None):
    """The batched sampler on packed (n, 3) i32 mask words; ``live`` an
    optional (n,) bool (a False env draws nothing). Returns (actions
    (n, 5), srng', tainted (n,))."""
    if live is None:
        return vmap(_sample_action_w)(srng, mask_words)
    return vmap(_sample_action_w)(srng, mask_words, live)


def vreset_body(dyn, n_players, player_xy, req, nr, end):
    """Batched `reset_body` on env-major DYN fields."""
    def one(dyn, n_players, xy, req, nr, end):
        z = torch.zeros_like(n_players)
        static = (z, z, z == 0, z != 0, n_players, z, z, z)
        s = reset_body(merge_state(static, dyn), xy, (req, nr, end))
        return split_state(s)[1]
    return vmap(one)(tuple(dyn), n_players, player_xy, req, nr, end)


# --------------------------------------------------------- kernel carry
# The kernels' layout: every DYN field flattened per env and stacked
# field-major, env-minor into one int32 (W, n) tensor (word f*n + e holds
# word f of env e, so a warp's loads coalesce). Bools ride as 0/1, f32
# fields as their bit patterns. csrc/engine.cuh mirrors these offsets.
DYN_LAYOUT = []
_off = 0
for _f in DYN_FIELDS:
    _shape, _dt = FIELD_SPECS[_f]
    _size = int(np.prod(_shape)) if _shape else 1
    DYN_LAYOUT.append((_f, _shape, _dt, _off, _size))
    _off += _size
CARRY_WORDS = _off


def pack_dyn(dyn) -> torch.Tensor:
    """Env-major DYN fields (tuple in DYN_FIELDS order) -> (W, n) carry."""
    n = dyn[0].shape[0]
    parts = []
    for x, (_, _, dt, _, size) in zip(dyn, DYN_LAYOUT):
        x = x.reshape(n, size)
        if dt == torch.bool:
            x = x.to(_i32)
        elif dt == _f32:
            x = x.contiguous().view(_i32)
        parts.append(x)
    return torch.cat(parts, 1).t().contiguous()


def unpack_dyn(carry) -> tuple:
    """(W, n) carry -> env-major DYN fields (tuple in DYN_FIELDS order)."""
    n = carry.shape[1]
    out = []
    for _, shape, dt, off, size in DYN_LAYOUT:
        x = carry[off:off + size].t().contiguous().reshape((n,) + shape)
        if dt == torch.bool:
            x = x != 0
        elif dt == _f32:
            x = x.view(_f32)
        out.append(x)
    return tuple(out)


def _prelude_out(q, device):
    """Empty (player_xy (q,4,2), req, nr, end (q,4,19)) int32 tensors."""
    return (torch.empty((q, MAX_N_PLAYERS, 2), dtype=_i32, device=device),
            *(torch.empty((q, MAX_N_PLAYERS, N_BALL), dtype=_i32,
                          device=device) for _ in range(3)))


def reset_map_prelude_plain(rng, n_pieces, difficulty, n_players):
    """The plain version of K3 with its prelude (`reset_map_prelude`):
    `mapgen.generate_map_plain`, the add_players gate and the ball
    pregather in torch, on the tensors' device."""
    from .mapgen import generate_map_plain
    gen = generate_map_plain(rng, n_pieces, difficulty)
    k = _k(rng)
    n_players = torch.as_tensor(n_players, device=rng.device).to(_i32)
    n_players = n_players.expand(rng.shape[0])[:, None]
    # add_players (src/map.cpp:343-354, oracle-patched bounds)
    gate = ((gen.player_start_no > 0) & (gen.player_start_no < n_players + 1)
            & (k.iota4 < n_players))
    player_xy = torch.where(gate[..., None], gen.player_start_xy, k.i0)
    ball = vmap(_ball_cells_xy)(gen.ids, gen.min_xy, player_xy)
    return gen, player_xy, ball


def reset_map_prelude(rng, n_pieces, difficulty, n_players):
    """Map generation + the add_players gate + the ball pregather, batched
    (engine.reset_map_prelude): the map-reading half of cog_env::reset.
    Map generation consumes a copy of the engine stream. Returns
    (gen, player_xy (n,4,2), (req, nr, end) each (n,4,19)). CUDA tensors
    run all of it as one launch of K3 (`mapgen.launch`), CPU tensors
    `reset_map_prelude_plain`."""
    from . import mapgen as MG
    rng = rng.to(_i32).contiguous()
    if not rng.is_cuda:
        return reset_map_prelude_plain(rng, n_pieces, difficulty, n_players)
    pre = _prelude_out(rng.shape[0], rng.device)
    gen = MG.launch_out(rng, n_pieces, difficulty, n_players, pre)
    return gen, pre[0], pre[1:]


def reset_map_prelude_rows_plain(rng, n_pieces, difficulty, n_players, idx,
                                 maps, count=None, prelude=None, work=None):
    """The plain version of `reset_map_prelude_rows`:
    `reset_map_prelude_plain` on the gathered rows (the first ``count``
    of them with ``count``), scattered back; with ``prelude``, written
    into its first rows too, and with ``work`` ((q, 2) int32) each
    generated env's trips and retries, as K3 writes them."""
    if count is not None:
        idx = idx[:int(count)]
        if not idx.numel():   # an empty queue generates nothing
            pre = prelude or _prelude_out(0, rng.device)
            return pre[0], pre[1:]
    rows = idx.long()
    gen, player_xy, ball = reset_map_prelude_plain(
        rng[rows], n_pieces[rows], difficulty[rows], n_players[rows])
    for t, v in zip(maps, (gen.ids, gen.min_xy, gen.ok, gen.overflow)):
        t[rows] = v
    if work is not None:
        work[:rows.numel()] = torch.stack([gen.trips, gen.retries], 1)
    if prelude is None:
        return player_xy, ball
    for t, v in zip(prelude, (player_xy, *ball)):
        t[:rows.numel()] = v
    return prelude[0], prelude[1:]


def reset_map_prelude_rows(rng, n_pieces, difficulty, n_players, idx, maps):
    """`reset_map_prelude` for the envs ``idx`` ((q,) int32, unique) of a
    batch: ``rng`` and the parameters are (n,) int32 batch arrays, and
    ``maps`` = (map_ids, min_xy, map_ok, map_overflow) the batch's, whose
    rows ``idx`` are written in place. Returns (player_xy (q,4,2), (req,
    nr, end) each (q,4,19)). On CUDA tensors one launch of K3, which reads
    and writes the batch's rows itself; on CPU tensors
    `reset_map_prelude_rows_plain`."""
    from . import mapgen as MG
    if not rng.is_cuda:
        return reset_map_prelude_rows_plain(rng, n_pieces, difficulty,
                                            n_players, idx, maps)
    pre = _prelude_out(idx.shape[0], rng.device)
    MG.launch(rng, n_pieces, difficulty, maps, idx=idx, n_players=n_players,
              prelude=pre)
    return pre[0], pre[1:]
