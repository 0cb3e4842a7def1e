"""Canonical cell-type encoding: the 5-bit id plane IS the map state.

Port of ``eldorado_tpu/core/cells.py``. The obs raster only ever contains
hexes from the fixed piece library (reference: src/map.cpp:113-152): 18
distinct (requirement, n_required, is_end) triples plus the empty/sentinel
cell (5, 0, 0) = id 0, so the reference's (48, 48, 7) u8 observation
round-trips losslessly through one i32 id per cell. Every function here is
elementwise over any leading batch shape and runs on the tensors' device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import GRIDSIZE
from . import tables as T

_i32 = torch.int32

_CELL_TRIPLES = [(5, 0, 0)] + sorted(
    {tuple(int(x) for x in h[:3])
     for h in T.PIECE_HEX[T.PIECE_HEX_VALID.astype(bool)]} - {(5, 0, 0)})
N_CELL_TYPES = len(_CELL_TRIPLES)
assert N_CELL_TYPES <= 32, _CELL_TRIPLES
assert not any(t[0] < 5 and t[1] == 0 for t in _CELL_TRIPLES), _CELL_TRIPLES
# decode LUTs bit-packed into scalar ints (3 bits per id, two words)
_REQ_L0 = sum(_CELL_TRIPLES[i][0] << (3 * i) for i in range(10))
_REQ_L1 = sum(_CELL_TRIPLES[i][0] << (3 * (i - 10))
              for i in range(10, N_CELL_TYPES))
_NR_L0 = sum(_CELL_TRIPLES[i][1] << (3 * i) for i in range(10))
_NR_L1 = sum(_CELL_TRIPLES[i][1] << (3 * (i - 10))
             for i in range(10, N_CELL_TYPES))
_END_L = sum(_CELL_TRIPLES[i][2] << i for i in range(N_CELL_TYPES))


def cell_type_ids(req, nr, end):
    """(req, n_req, is_end) -> 5-bit cell-type id, elementwise (unknown
    triples map to the sentinel id 0)."""
    key = (req << 4) | (nr << 1) | end
    out = torch.zeros_like(key)
    for i, (r, n, e) in enumerate(_CELL_TRIPLES[1:], start=1):
        out = torch.where(key == ((r << 4) | (n << 1) | e),
                          torch.full_like(key, i), out)
    return out


def decode_cells(ids):
    """5-bit type ids -> (req, n_req, is_end), any shape."""
    lo = ids < 10
    s3 = 3 * torch.where(lo, ids, ids - 10)
    req = torch.where(lo, torch.full_like(ids, _REQ_L0) >> s3,
                      torch.full_like(ids, _REQ_L1) >> s3) & 7
    nr = torch.where(lo, torch.full_like(ids, _NR_L0) >> s3,
                     torch.full_like(ids, _NR_L1) >> s3) & 7
    return req, nr, (torch.full_like(ids, _END_L) >> ids) & 1


def expand_obs(ids):
    """(..., 2304) id planes -> the reference-ABI (..., 48, 48, 7) u8 map
    observation (include/api.h:84-129; rasterised in src/map.cpp:389-405):
    channel req+1 holds n_required for requirement cells, channel 6 holds
    is_end. Cold-boundary helper (goldens, tests)."""
    ids = ids.to(_i32)
    lead = ids.shape[:-1]
    req, nr, end = decode_cells(ids)
    ch = torch.where(req < 5, req + 1, torch.zeros_like(req))
    chval = torch.where(req < 5, nr, torch.zeros_like(nr))
    iota7 = torch.arange(7, dtype=_i32, device=ids.device)
    cellch = torch.where(iota7 == ch[..., None], chval[..., None],
                         torch.zeros((), dtype=_i32, device=ids.device))
    cellch = torch.where(iota7 == 6, end[..., None], cellch)
    return cellch.to(torch.uint8).reshape(lead + (GRIDSIZE, GRIDSIZE, 7))


def ids_from_obs(obs):
    """Reference-ABI (..., 48, 48, 7) map observation -> (..., 2304) i32
    id planes, the exact inverse of `expand_obs`."""
    cell = obs.to(_i32)
    reqch = cell[..., 1:6]
    present = reqch > 0
    first = torch.argmax(present.to(_i32), dim=-1).to(_i32)
    req = torch.where(present.any(-1), first, torch.full_like(first, 5))
    nr = torch.where(present, reqch, torch.zeros_like(reqch)).amax(-1)
    ids = cell_type_ids(req, nr, cell[..., 6])
    return ids.reshape(ids.shape[:-2] + (GRIDSIZE * GRIDSIZE,))


def expand_obs_np(ids):
    """Numpy `expand_obs` for host-side consumers (the feed's
    ObsReconstructor): (n, 2304) id planes -> (n, 48, 48, 7) u8."""
    ids = np.asarray(ids).reshape(-1, GRIDSIZE * GRIDSIZE).astype(np.int64)
    trip = np.asarray(_CELL_TRIPLES, np.int64)          # (NT, 3)
    req, nr, end = trip[ids, 0], trip[ids, 1], trip[ids, 2]
    out = np.zeros(ids.shape + (7,), np.uint8)
    filled = req < 5
    np.put_along_axis(out, np.where(filled, req + 1, 0)[..., None],
                      np.where(filled, nr, 0)[..., None].astype(np.uint8),
                      axis=-1)
    out[..., 6] = end
    return out.reshape(out.shape[0], GRIDSIZE, GRIDSIZE, 7)
