"""Procedural map generation in plain torch, batched over envs.

Port of ``eldorado_tpu/core/mapgen.py`` (the reference's recursive generator,
src/map.cpp:697-742 with the oracle's erase-by-position patch, as a flat
explicit-stack state machine). Every tensor carries a leading env axis; a
host loop runs `_trip` until every env is finished or aborted, and `_trip`
is a no-op on those lanes, so each env's stream and result are exactly the
single-env generator's.

* Recursion (depth <= MAX_FAILURES = 5) is an explicit frame stack; each
  frame owns a copy of the caller's engine state (C++ passes the engine by
  value).
* Pushing past depth 5 aborts the generation: ``ok`` comes back False.
* More than MAX_PLACED placements sets ``overflow``.
* Each env counts its trips (until it finishes or aborts) and its retries
  (child frames pushed, the push that aborts included): the reference's
  ``generate(..., failures + 1, ...)`` calls.
* Rasterisation is last-writer-wins, as a scatter-max over
  (slot << 7 | features).
* Overlap is the reference's exact point-set semantics through the static
  pairwise (size, rot, size, rot, center-delta) bit table.

In the JAX package this ran as XLA, outside any Pallas kernel. Here this
module holds the plain version (`generate_map_plain`) and the wrapper of
K3 (`launch`, csrc/mapgen.cu), the hand-written kernel that runs one env's
generator per warp; `generate_map` takes the plain version on CPU tensors
and K3 on CUDA tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..constants import GRIDSIZE, MAX_N_PLAYERS
from ..ops import rng as R
from . import cells as CE
from . import tables as T

MAX_DEPTH = 5            # == MAX_FAILURES
MAX_PLACED = 48          # placed-piece slot budget (see the JAX module)
_ENTRY, _LOOP, _END, _POP = 0, 1, 2, 3
_RES_LOOP_INC, _RES_POP = 0, 1

_i32 = torch.int32
_OVL_DMAX = 12
_OVL_ND = 2 * _OVL_DMAX + 1


def _build_pair_overlap():
    """Bit table: does a (size, rot) candidate at center delta (dx, dy)
    intersect a placed (size, rot) piece? Bit dy+12 of word
    [sa, ra, sb, rb, dx+12]."""
    tmpl = [np.asarray(T.LARGE_XY), np.asarray(T.SMALL_XY),
            np.asarray(T.END_XY)]
    tbl = np.zeros((3, 6, 3, 6, _OVL_ND), np.int32)
    for sa in range(3):
        for ra in range(6):
            fa = T.rotate_xy(tmpl[sa], ra)
            for sb in range(3):
                for rb in range(6):
                    fb = T.rotate_xy(tmpl[sb], rb)
                    d = (fb[:, None, :] - fa[None, :, :]).reshape(-1, 2)
                    assert int(np.abs(d).max()) <= _OVL_DMAX
                    np.bitwise_or.at(tbl[sa, ra, sb, rb], d[:, 0] + _OVL_DMAX,
                                     np.int32(1) << (d[:, 1] + _OVL_DMAX))
    return tbl.reshape(-1)


_DIFF_MASK = [sum(1 << i for i in range(T.N_TRAVEL_PIECES)
                  if T.PIECE_DIFFICULTY[T.TRAVEL_PIECE_0 + i] <= d)
              for d in range(3)]

# (seed, n_pieces, difficulty) whose generation finishes with more than
# MAX_PLACED placements (retries stacked 52 pieces): overflow, not abort
OVERFLOW_CASES = ((20138, 16, 2), (42602, 16, 2), (99058, 14, 2))


def mixed_batch(n: int, seed: int = 0):
    """Reset parameters of a mixed batch of ``n`` >= 3 envs, as numpy
    int64 arrays (seeds, n_players 1-4, n_pieces 1-16, difficulty 0-2)
    drawn from ``seed``; many lanes ask for more pieces than their
    difficulty has and abort, and the last three are `OVERFLOW_CASES`.
    The batch on which K3 is held to the plain version."""
    g = np.random.default_rng(seed)
    seeds = g.integers(0, 1 << 31, n)
    players = g.integers(1, 5, n)
    pieces = g.integers(1, 17, n)
    diff = g.integers(0, 3, n)
    for j, (s, p, d) in enumerate(OVERFLOW_CASES):
        seeds[n - 3 + j], pieces[n - 3 + j], diff[n - 3 + j] = s, p, d
    return seeds, players, pieces, diff


class _Consts:
    def __init__(self, device):
        def t(x):
            return torch.as_tensor(np.asarray(x), device=device)
        i = _i32
        self.rot00 = t(T.ROT[:, 0, 0]).to(i)
        self.rot01 = t(T.ROT[:, 0, 1]).to(i)
        self.rot10 = t(T.ROT[:, 1, 0]).to(i)
        self.rot11 = t(T.ROT[:, 1, 1]).to(i)
        self.piece_x = t(T.PIECE_XY[:, :, 0]).to(i)
        self.piece_y = t(T.PIECE_XY[:, :, 1]).to(i)
        self.piece_valid = t(T.PIECE_HEX_VALID)
        self.piece_packed = t(T.PIECE_HEX[:, :, 0].astype(np.int32)
                              | (T.PIECE_HEX[:, :, 1].astype(np.int32) << 3)
                              | (T.PIECE_HEX[:, :, 2].astype(np.int32) << 6))
        self.piece_start = t(T.PIECE_HEX[:, :, 3]).to(i)
        self.piece_size = t(T.PIECE_SIZE).to(i)
        self.piece_type = t(T.PIECE_TYPE).to(i)
        self.conn_n = t(T.CONN_N).to(i)
        self.conn_coord = t(T.CONN_COORD).to(i)
        self.conn_nrot = t(T.CONN_NROT).to(i)
        self.conn_rot = t(T.CONN_ROT).to(i)
        self.diff_mask = t(_DIFF_MASK).to(i)
        self.ovl = t(_build_pair_overlap()).to(i)


@functools.lru_cache(maxsize=None)
def _K(device) -> _Consts:
    return _Consts(device)


@dataclasses.dataclass
class MapGenState:
    entries: torch.Tensor       # (n, MAX_PLACED) piece ids, -1 empty
    entry_rot: torch.Tensor     # (n, MAX_PLACED) rotation at placement
    entry_center: torch.Tensor  # (n, MAX_PLACED, 2) center at placement
    n_entries: torch.Tensor     # (n,)
    min_xy: torch.Tensor        # (n, 2)
    max_xy: torch.Tensor        # (n, 2)
    piece_rot: torch.Tensor     # (n, 20) keyed by piece id
    piece_center: torch.Tensor  # (n, 20, 2)
    frame_rng: torch.Tensor     # (n, MAX_DEPTH)
    frame_i: torch.Tensor       # (n, MAX_DEPTH)
    frame_valid: torch.Tensor   # (n, MAX_DEPTH) eligible-piece bitmask
    frame_resume: torch.Tensor  # (n, MAX_DEPTH)
    sp: torch.Tensor            # (n,)
    pc: torch.Tensor            # (n,)
    finished: torch.Tensor      # (n,) bool
    aborted: torch.Tensor       # (n,) bool
    overflow: torch.Tensor      # (n,) bool
    trips: torch.Tensor         # (n,) trips run while alive
    retries: torch.Tensor       # (n,) child frames pushed

    def _replace(self, **kw) -> "MapGenState":
        return dataclasses.replace(self, **kw)


_MG_FIELDS = tuple(f.name for f in dataclasses.fields(MapGenState))


@dataclasses.dataclass
class MapGenOut:
    ids: torch.Tensor              # (n, 2304) cell-type-id planes
    min_xy: torch.Tensor           # (n, 2)
    player_start_xy: torch.Tensor  # (n, 4, 2)
    player_start_no: torch.Tensor  # (n, 4)
    ok: torch.Tensor               # (n,) bool
    overflow: torch.Tensor         # (n,) bool: MAX_PLACED bust
    # (n,) int32 generator trips and retries (the plain version's; None
    # from K3, which writes them to a queue's work buffer)
    trips: torch.Tensor = None
    retries: torch.Tensor = None


def _bw(pred, a, b):
    """Per-env where: pred (n,) broadcast over a's trailing dims."""
    return torch.where(pred.reshape(pred.shape + (1,) * (a.ndim - 1)), a, b)


def _merge(base, *branches):
    out = {}
    for f in _MG_FIELDS:
        lb = getattr(base, f)
        val = lb
        for pred, tree in branches:
            lv = getattr(tree, f)
            if lv is not lb:
                val = _bw(pred, lv, val)
        out[f] = val
    return MapGenState(**out)


def _select(pred, a, b):
    return _merge(b, (pred, a))


def _take(arr, idx):
    """arr[e, idx[e]] for arr (n, K, ...) and idx (n,)."""
    ar = torch.arange(arr.shape[0], device=arr.device)
    return arr[ar, idx.long()]


def _put(arr, idx, val):
    """arr with arr[e, idx[e]] = val[e] (one-hot write)."""
    hit = torch.arange(arr.shape[1], device=arr.device) == idx[:, None]
    hit = hit.reshape(hit.shape + (1,) * (arr.ndim - 2))
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    if val.ndim:
        val = val.reshape((val.shape[0], 1) + tuple(val.shape[1:]))
    return torch.where(hit, val, arr)


def _rot(k, x, y, times):
    r = (times % 6).long()
    return (k.rot00[r] * x + k.rot01[r] * y, k.rot10[r] * x + k.rot11[r] * y)


def _uid_maybe(s: MapGenState, nrange, do):
    """uniform_int(0, nrange-1) on each env's current frame engine, drawn
    only where ``do``."""
    v, x = R.uniform_int_maybe(_take(s.frame_rng, s.sp), nrange, do)
    return v, s._replace(frame_rng=_put(s.frame_rng, s.sp, x))


def _add_piece(s: MapGenState, pid, cx, cy, rot) -> MapGenState:
    """reference: src/map.cpp:309-341 (bounds include the previous bounds)."""
    k = _K(s.sp.device)
    rot6 = rot % 6
    bx, by = k.piece_x[pid.long()], k.piece_y[pid.long()]      # (n,37)
    valid = k.piece_valid[pid.long()]
    px, py = _rot(k, bx, by, rot6[:, None])
    px, py = px + cx[:, None], py + cy[:, None]
    overflow = s.overflow | (s.n_entries >= MAX_PLACED)
    slot = torch.clamp(s.n_entries, max=MAX_PLACED - 1)
    coord = torch.stack([cx, cy], -1)
    big = 1 << 20
    vmin = torch.stack([torch.where(valid, px, big).amin(1),
                        torch.where(valid, py, big).amin(1)], -1)
    vmax = torch.stack([torch.where(valid, px, -big).amax(1),
                        torch.where(valid, py, -big).amax(1)], -1)
    return s._replace(
        entries=_put(s.entries, slot, pid),
        entry_rot=_put(s.entry_rot, slot, rot6),
        entry_center=_put(s.entry_center, slot, coord),
        n_entries=s.n_entries + 1,
        min_xy=torch.minimum(s.min_xy, vmin),
        max_xy=torch.maximum(s.max_xy, vmax),
        piece_rot=_put(s.piece_rot, pid, rot6),
        piece_center=_put(s.piece_center, pid, coord),
        overflow=overflow)


def _try_add_random(s: MapGenState, pid, active):
    """reference: src/map.cpp:277-307. Returns (state, success). Candidates
    are enumerated placed-piece-major then connection-entry; the overlap
    test uses each candidate's first rotation option only. ``active``
    gates the draws. Only the first P placed rows are materialised, P the
    largest n_entries of the batch capped at MAX_PLACED (rows beyond a
    lane's own n_entries are masked, exactly as the full 48-row table
    would be; past the cap, n_entries counts writes to the clamped last
    slot)."""
    k = _K(s.sp.device)
    n = pid.shape[0]
    P = max(1, min(MAX_PLACED, int(s.n_entries.max())))
    nsize = k.piece_size[pid.long()]                            # (n,)
    epid = torch.where(s.entries >= 0, s.entries, 0)[:, :P].long()
    psize = k.piece_size[epid]                                  # (n,P)
    ptype = k.piece_type[epid]
    prot = torch.gather(s.piece_rot, 1, epid)
    pcx = torch.gather(s.piece_center[..., 0], 1, epid)
    pcy = torch.gather(s.piece_center[..., 1], 1, epid)
    ns = nsize[:, None].expand(n, P).long()
    ps, pt = psize.long(), ptype.long()
    nconn = k.conn_n[ps, pt, ns]                                # (n,P)
    rows = torch.arange(P, device=pid.device)
    kk = torch.arange(21, device=pid.device)
    live = ((rows[None, :] < s.n_entries[:, None])[:, :, None]
            & (kk[None, None, :] < nconn[:, :, None]))          # (n,P,21)

    cc = k.conn_coord[ps, pt, ns]                               # (n,P,21,2)
    cx, cy = _rot(k, cc[..., 0], cc[..., 1], prot[:, :, None])
    cx, cy = cx + pcx[:, :, None], cy + pcy[:, :, None]
    crot0 = (k.conn_rot[ps, pt, ns][..., 0] + prot[:, :, None]) % 6
    cbase = (nsize[:, None, None] * 6 + crot0) * 3              # (n,P,21)

    hit = torch.zeros_like(live)
    for f in range(P):
        dx = cx - s.entry_center[:, f, 0][:, None, None]
        dy = cy - s.entry_center[:, f, 1][:, None, None]
        inr = (dx.abs() <= _OVL_DMAX) & (dy.abs() <= _OVL_DMAX)
        idx = (((cbase + psize[:, f][:, None, None]) * 6
                + s.entry_rot[:, f][:, None, None]) * _OVL_ND
               + torch.clamp(dx + _OVL_DMAX, 0, _OVL_ND - 1))
        w = k.ovl[idx.long()]
        b = (w >> torch.clamp(dy + _OVL_DMAX, 0, 31)) & 1
        hit = hit | (inr & (b > 0)
                     & (f < s.n_entries)[:, None, None])
    flat_ok = (live & ~hit).reshape(n, P * 21)
    n_valid = flat_ok.sum(1, dtype=_i32)
    have = (n_valid > 0) & active
    pos, s = _uid_maybe(s, n_valid, have)
    fo = flat_ok.to(_i32)
    csum = torch.cumsum(fo, 1) - fo
    pick = torch.argmax((flat_ok & (csum == pos[:, None])).to(_i32), 1)
    pe, pk = pick // 21, pick % 21
    ar = torch.arange(n, device=pid.device)
    px_, py_ = cx[ar, pe, pk], cy[ar, pe, pk]
    ps_e, pt_e = ps[ar, pe], pt[ar, pe]
    nrots = k.conn_nrot[ps_e, pt_e, ns[:, 0], pk]
    r, s = _uid_maybe(s, nrots, have)
    rot = k.conn_rot[ps_e, pt_e, ns[:, 0], pk, r.long()] + prot[ar, pe]
    placed = _add_piece(s, pid, px_, py_, rot)
    return _select(have, placed, s), have


def _map_clear(s: MapGenState) -> MapGenState:
    """Map::reset (src/map.cpp:744-752); piece transforms survive."""
    return s._replace(entries=torch.full_like(s.entries, -1),
                      n_entries=torch.zeros_like(s.n_entries),
                      min_xy=torch.zeros_like(s.min_xy),
                      max_xy=torch.zeros_like(s.max_xy))


def _push_child(s: MapGenState, resume: int) -> MapGenState:
    """generate(..., failures+1, <engine copy>); depth overflow == the
    reference's throw (it fires at child entry, before any draw). Either
    counts as a retry."""
    abort = s.sp >= MAX_DEPTH - 1
    sp1 = torch.clamp(s.sp + 1, max=MAX_DEPTH - 1)
    return s._replace(
        retries=s.retries + 1,
        frame_resume=_put(s.frame_resume, s.sp, resume),
        frame_rng=_bw(abort, s.frame_rng,
                      _put(s.frame_rng, sp1, _take(s.frame_rng, s.sp))),
        sp=torch.where(abort, s.sp, sp1),
        pc=torch.where(abort, s.pc, _ENTRY),
        aborted=s.aborted | abort)


def _trip(s: MapGenState, n_pieces, difficulty) -> MapGenState:
    """One flat trip of the recursive generator (mapgen._trip): the
    branches share one gated placement attempt, and every draw is gated
    by its branch, so each lane consumes exactly its branch's stream. A
    finished or aborted lane is left as it is; a live one counts the
    trip."""
    k = _K(s.sp.device)
    alive = ~(s.finished | s.aborted)
    is_entry = alive & (s.pc == _ENTRY)
    is_loop = alive & (s.pc == _LOOP)
    is_end = alive & (s.pc == _END)
    is_pop = alive & (s.pc == _POP)

    i = _take(s.frame_i, s.sp)
    at_end = i >= n_pieces
    loop_act = is_loop & ~at_end

    two = torch.full_like(s.sp, 2)
    start, s = _uid_maybe(s, two, is_entry)
    valid = _take(s.frame_valid, s.sp)
    iota16 = torch.arange(16, dtype=_i32, device=s.sp.device)
    bits = (valid[:, None] >> iota16) & 1
    nv = bits.sum(1, dtype=_i32)
    have_piece = nv > 0
    pos, s = _uid_maybe(s, nv, loop_act & have_piece)
    csum = torch.cumsum(bits, 1) - bits
    idx = torch.argmax(((bits == 1) & (csum == pos[:, None])).to(_i32),
                       1).to(_i32)
    e, s = _uid_maybe(s, two, is_end)

    zero = torch.zeros_like(s.sp)
    entered = _add_piece(s, T.START_PIECE_0 + start, zero, zero, zero)
    entered = entered._replace(
        frame_valid=_put(entered.frame_valid, entered.sp,
                         k.diff_mask[difficulty.long()]),
        frame_i=_put(entered.frame_i, entered.sp, 0),
        pc=torch.full_like(s.pc, _LOOP))

    pid = torch.where(is_end, T.END_PIECE_0 + e, T.TRAVEL_PIECE_0 + idx)
    attempt_act = (loop_act & have_piece) | is_end
    s2, success = _try_add_random(s, pid, attempt_act)

    loop_ok = s2._replace(
        frame_valid=_put(s2.frame_valid, s2.sp,
                         valid & ~(torch.ones_like(idx) << idx)),
        frame_i=_put(s2.frame_i, s2.sp, i + 1))
    loop_fail = _push_child(s2, _RES_LOOP_INC)
    end_ok = s2._replace(pc=torch.full_like(s.pc, _POP))
    end_fail = _push_child(_map_clear(s2), _RES_POP)

    at_root = s.sp == 0
    sp1 = torch.clamp(s.sp - 1, min=0)
    resume = _take(s.frame_resume, sp1)
    inc = resume == _RES_LOOP_INC
    popped = s._replace(
        sp=sp1,
        frame_i=_bw(inc, _put(s.frame_i, sp1, _take(s.frame_i, sp1) + 1),
                    s.frame_i),
        pc=torch.where(inc, _LOOP, _POP).to(_i32))

    out = _merge(
        s,
        (is_entry, entered),
        (loop_act & success, loop_ok),
        (loop_act & ~success, loop_fail),
        (is_loop & at_end, s._replace(pc=torch.full_like(s.pc, _END))),
        (is_end & success, end_ok),
        (is_end & ~success, end_fail),
        (is_pop & at_root, s._replace(finished=torch.ones_like(s.finished))),
        (is_pop & ~at_root, popped))
    return out._replace(trips=s.trips + alive.to(_i32))


def _finalize(s: MapGenState) -> MapGenOut:
    """Final rasterisation (src/map.cpp:389-405), last writer wins."""
    k = _K(s.sp.device)
    n = s.sp.shape[0]
    dev = s.sp.device
    epid = torch.where(s.entries >= 0, s.entries, 0).long()      # (n,P)
    bx, by = k.piece_x[epid], k.piece_y[epid]                    # (n,P,37)
    valid = k.piece_valid[epid]
    packed = k.piece_packed[epid]
    px, py = _rot(k, bx, by, s.entry_rot[:, :, None])
    px = px + s.entry_center[:, :, 0:1]
    py = py + s.entry_center[:, :, 1:2]
    live = valid & (torch.arange(MAX_PLACED, device=dev)[None, :, None]
                    < s.n_entries[:, None, None])
    ix = ((px - s.min_xy[:, 0, None, None]) >> 1) + 1
    iy = ((py - s.min_xy[:, 1, None, None]) >> 1) + 1
    in_grid = (ix >= 0) & (ix < GRIDSIZE) & (iy >= 0) & (iy < GRIDSIZE)
    keep = (live & in_grid).reshape(n, -1)
    G2 = GRIDSIZE * GRIDSIZE
    lin = torch.where(keep, (ix * GRIDSIZE + iy).reshape(n, -1), G2)
    slot = torch.arange(MAX_PLACED * 37, dtype=_i32, device=dev)
    val = torch.where(keep, (slot << 7) | packed.reshape(n, -1), -1)
    canvas = torch.full((n, G2 + 1), -1, dtype=_i32, device=dev)
    canvas = canvas.scatter_reduce(1, lin.long(), val.to(_i32), "amax")
    canvas = canvas[:, :G2]
    filled = canvas >= 0
    ids = torch.where(filled, CE.cell_type_ids(canvas & 7, (canvas >> 3) & 7,
                                               (canvas >> 6) & 1), 0)
    pid0 = torch.where(s.entries[:, 0] >= 0, s.entries[:, 0], 0).long()
    starts = k.piece_start[pid0, :MAX_N_PLAYERS]
    start_xy = torch.stack([px[:, 0, :MAX_N_PLAYERS],
                            py[:, 0, :MAX_N_PLAYERS]], -1)
    return MapGenOut(ids=ids.to(_i32), min_xy=s.min_xy,
                     player_start_xy=start_xy.to(_i32),
                     player_start_no=starts,
                     ok=~(s.aborted | s.overflow),
                     overflow=s.overflow & ~s.aborted,
                     trips=s.trips, retries=s.retries)


def _per_env(v, n, dev):
    """An int or (n,) tensor as a contiguous (n,) int32 tensor on dev."""
    return torch.as_tensor(v, device=dev).to(_i32).expand(n).contiguous()


def generate_map_plain(rng_state, n_pieces, difficulty) -> MapGenOut:
    """The plain version of K3's generation (`generate_map`): a host loop
    of `_trip` over the whole batch. Trips run on CUDA tensors (where only
    a check against K3 should run this) are counted in
    ``generate_map_plain.cuda_trips``."""
    rng_state = rng_state.to(_i32)
    n = rng_state.shape[0]
    dev = rng_state.device

    def z(*shape):
        return torch.zeros((n,) + shape, dtype=_i32, device=dev)

    nb = torch.zeros(n, dtype=torch.bool, device=dev)
    s = MapGenState(
        entries=torch.full((n, MAX_PLACED), -1, dtype=_i32, device=dev),
        entry_rot=z(MAX_PLACED), entry_center=z(MAX_PLACED, 2),
        n_entries=z(), min_xy=z(2), max_xy=z(2),
        piece_rot=z(T.N_PIECES_TOTAL), piece_center=z(T.N_PIECES_TOTAL, 2),
        frame_rng=rng_state[:, None].expand(n, MAX_DEPTH).clone(),
        frame_i=z(MAX_DEPTH), frame_valid=z(MAX_DEPTH),
        frame_resume=z(MAX_DEPTH), sp=z(), pc=z(),
        finished=nb, aborted=nb, overflow=nb, trips=z(), retries=z())
    n_pieces = _per_env(n_pieces, n, dev)
    difficulty = _per_env(difficulty, n, dev)
    while bool((~(s.finished | s.aborted)).any()):
        if dev.type == "cuda":
            generate_map_plain.cuda_trips += 1
        s = _trip(s, n_pieces, difficulty)
    return _finalize(s)


generate_map_plain.cuda_trips = 0


def check_launch(rng, n_pieces, difficulty, maps, idx=None, starts=None,
                 n_players=None, prelude=None, count=None, work=None):
    """`launch`'s checks of its arguments (CUDA tensors only), and of
    ``count`` ((1,) int32 on the device) and ``work`` ((q, 2) int32),
    which `launch_generate_map` takes for a queue launched at its
    capacity. Returns their device."""
    from ..ops.step_kernel import _check, _device_of
    from .engine import N_BALL
    n = rng.shape[0]
    q = n if idx is None else idx.shape[0]
    map_ids, min_xy, ok, overflow = maps
    for name, t in (("rng", rng), ("n_pieces", n_pieces),
                    ("difficulty", difficulty)):
        _check(t, name, (n,))
    _check(map_ids, "map_ids", (n, GRIDSIZE * GRIDSIZE))
    _check(min_xy, "min_xy", (n, 2))
    _check(ok, "ok", (n,), torch.bool)
    _check(overflow, "overflow", (n,), torch.bool)
    outs = list(maps)
    if idx is not None:
        _check(idx, "idx", (q,))
        outs.append(idx)
    if count is not None:
        _check(count, "count", (1,))
        outs.append(count)
    if work is not None:
        _check(work, "work", (q, 2))
        outs.append(work)
    if starts is not None:
        _check(starts[0], "start_xy", (q, MAX_N_PLAYERS, 2))
        _check(starts[1], "start_no", (q, MAX_N_PLAYERS))
        outs += starts
    if prelude is not None:
        _check(n_players, "n_players", (n,))
        _check(prelude[0], "player_xy", (q, MAX_N_PLAYERS, 2))
        for name, t in zip(("req", "nr", "end"), prelude[1:]):
            _check(t, name, (q, MAX_N_PLAYERS, N_BALL))
        outs += [n_players, *prelude]
    dev = _device_of([rng, n_pieces, difficulty] + outs)
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on a CUDA device, not {dev}")
    if map_ids.data_ptr() % 16:
        raise ValueError("map_ids must be 16-byte aligned")
    return dev


def launch(rng, n_pieces, difficulty, maps, idx=None, starts=None,
           n_players=None, prelude=None, shape=None) -> None:
    """Launch K3 (csrc/mapgen.cu) on the card: map generation, and with
    ``prelude`` the add_players gate and the ball rows, for q envs.

    ``rng``, ``n_pieces``, ``difficulty`` and ``n_players`` are (n,) int32
    batch arrays, read at the rows ``idx`` ((q,) int32, unique; rows
    0..q-1 without it). ``maps`` = (map_ids (n, 2304), min_xy (n, 2) int32,
    ok (n,), overflow (n,) bool) are written at those rows and nowhere
    else. ``starts`` = (start_xy (q, 4, 2), start_no (q, 4)) and
    ``prelude`` = (player_xy (q, 4, 2), req, nr, end (q, 4, 19)), int32,
    are written at 0..q-1 when given. ``shape`` = (envs per block, 1-4;
    whether the pair table is staged in shared memory) picks a launch
    shape other than the default (`launch_shape`). Counted in
    ``generate_map.launches``.
    """
    check_launch(rng, n_pieces, difficulty, maps, idx, starts, n_players,
                 prelude)
    launch_generate_map(rng, n_pieces, difficulty, maps, idx, starts,
                        n_players, prelude, shape)


def launch_generate_map(rng, n_pieces, difficulty, maps, idx=None,
                        starts=None, n_players=None, prelude=None,
                        shape=None, count=None, work=None) -> None:
    """K3's launch alone, on CUDA tensors that `check_launch` has checked
    (the chunk loop's launch, which checks once per call); the arguments
    as `launch`'s, and ``count``: a (1,) int32 on the device that limits
    the launch to the slots below it (a queue launched at its capacity and
    sized on the card); ``work``: a (q, 2) int32 into which each generated
    slot writes its generator trips and retries."""
    from ..ops import build

    def ptr(t):
        return None if t is None else t.data_ptr()
    dev = rng.device
    st = starts or (None, None)
    pre = prelude or (None,) * 4
    lib = build.load()
    args = (rng.data_ptr(), ptr(idx), n_pieces.data_ptr(),
            difficulty.data_ptr(),
            ptr(n_players if prelude is not None else None),
            _K(dev).ovl.data_ptr(), *(t.data_ptr() for t in maps),
            ptr(st[0]), ptr(st[1]), *map(ptr, pre),
            rng.shape[0] if idx is None else idx.shape[0], ptr(count),
            ptr(work))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if shape is None:
            err = lib.ed_generate_map(*args, stream)
        else:
            err = lib.ed_generate_map_shaped(*args, int(shape[0]),
                                             int(bool(shape[1])), stream)
    build.check(err, "generate_map")
    generate_map.launches += 1


def launch_shape(q: int, shape=None) -> dict:
    """K3's launch for a q-env queue on the current device, in the default
    shape or ``shape`` = (envs per block, pair table in shared memory):
    envs and threads per block, blocks, shared bytes per block, blocks
    resident per SM, and where the pair table is."""
    from ..ops import build
    envs, shared = shape if shape is not None else (0, 0)
    out = (ctypes.c_int * 5)()
    build.check(build.load().ed_generate_map_shape(int(envs), int(shared),
                                                   out), "generate_map_shape")
    return {"envs_per_block": out[0], "threads": out[1],
            "blocks": (q + out[0] - 1) // out[0], "smem_bytes": out[2],
            "blocks_per_sm": out[3], "ovl_shared": bool(out[4])}


def launch_out(rng, n_pieces, difficulty, n_players=None, prelude=None):
    """K3 on (n,) engine words ``rng`` with per-env (int or (n,))
    parameters into a new `MapGenOut` (and ``prelude``'s tensors, with
    ``n_players``); returns the MapGenOut."""
    n, dev = rng.shape[0], rng.device

    def z(*shape, dtype=_i32):
        return torch.empty((n,) + shape, dtype=dtype, device=dev)
    gen = MapGenOut(ids=z(GRIDSIZE * GRIDSIZE), min_xy=z(2),
                    player_start_xy=z(MAX_N_PLAYERS, 2),
                    player_start_no=z(MAX_N_PLAYERS), ok=z(dtype=torch.bool),
                    overflow=z(dtype=torch.bool))
    launch(rng, _per_env(n_pieces, n, dev), _per_env(difficulty, n, dev),
           (gen.ids, gen.min_xy, gen.ok, gen.overflow),
           starts=(gen.player_start_xy, gen.player_start_no),
           n_players=(None if n_players is None
                      else _per_env(n_players, n, dev)), prelude=prelude)
    return gen


def generate_map(rng_state, n_pieces, difficulty) -> MapGenOut:
    """Run the full generator from each env's engine state ``rng_state``
    ((n,) int32; consumed by value — callers keep their own stream).
    ``n_pieces`` and ``difficulty`` are ints or (n,) tensors. ``ok`` is
    False where the reference would have thrown generate_map_failure (or
    on capacity overflow). CPU tensors run `generate_map_plain`, CUDA
    tensors one launch of K3."""
    rng_state = rng_state.to(_i32).contiguous()
    if rng_state.device.type == "cpu":
        return generate_map_plain(rng_state, n_pieces, difficulty)
    return launch_out(rng_state, n_pieces, difficulty)


generate_map.launches = 0
