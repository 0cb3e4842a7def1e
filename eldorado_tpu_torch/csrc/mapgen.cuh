// K3's per-env logic: procedural map generation and the map prelude of
// cog_env::reset, one env per warp (or, through the lane shim's loop form,
// per thread).
//
// Computes what eldorado_tpu_torch/core/mapgen.py (generate_map_plain,
// itself the port of eldorado_tpu/core/mapgen.py::generate_map) and
// core/engine.py (the prelude of reset_map_prelude) compute: the
// reference's recursive generator (src/map.cpp:697-742 with the oracle's
// erase-by-position patch) as a flat machine of trips over an explicit
// frame stack. The plain version runs every branch of a trip on every lane
// and keeps one; here an env's warp runs its taken branch only, trip after
// trip, until the env finishes or aborts, so the draws and the placements
// are those of one env of the plain version:
//
// * every draw is the exact rejection loop (rng.cuh's uniform_int);
// * a child frame starts from a copy of its parent's current engine, and
//   the parent resumes with its own; a push at depth kMaxDepth - 1 aborts,
//   and the env's state freezes there;
// * candidates are enumerated placed-slot-major, then connection index;
//   the overlap test reads each candidate's first rotation option through
//   the pair bit table (mapgen._build_pair_overlap, passed in as `ovl`);
//   the pos-th free candidate is drawn, then its rotation;
// * a candidate's position comes from piece_* (keyed by piece id: that
//   piece's latest placement), the overlap test from entry_* (keyed by
//   slot); the two differ once a retry has stacked a map on the first;
// * placement n_entries >= kMaxPlaced sets `overflow` and writes the
//   clamped last slot; a cleared map keeps the piece transforms;
// * the raster is last-writer-wins in (slot, hex) order, so the hexes are
//   written in that order into a zeroed raster.
//
// The tables are the plain version's (core/tables.py), pinned to it by
// tests/test_torch_tables.py. They live in global memory (ED_TABLE): the
// lanes of a warp read them at unrelated indices, which the constant
// cache would serialise. tests/mapgen_host.cpp builds this header with
// g++ (the lane shim's loop form) and tests/test_torch_mapgen_host.py
// holds it to the plain version.
#pragma once

#include "engine.cuh"  // and through it lanes.cuh and rng.cuh's ED_TABLE

namespace ed {

constexpr int kMaxDepth = 5;     // == MAX_FAILURES
constexpr int kMaxPlaced = 48;   // placed-piece slot budget (mapgen.MAX_PLACED)
constexpr int kPieces = 20;
constexpr int kMaxHex = 37;
constexpr int kMaxConn = 21;
constexpr int kTravelPiece0 = 2, kEndPiece0 = 18;
constexpr int kOvlDmax = 12, kOvlNd = 2 * kOvlDmax + 1;
constexpr int kOvlWords = 3 * 6 * 3 * 6 * kOvlNd;
constexpr int kPlayers = 4;
constexpr int PC_ENTRY = 0, PC_LOOP = 1, PC_END = 2, PC_POP = 3;
constexpr int RES_LOOP_INC = 0, RES_POP = 1;

// (6, 2, 2) rotation powers; hex coordinates of the three piece sizes
// (3, 37, 2), zero-padded (PIECE_XY[p] == SIZE_XY[PIECE_SIZE[p]]); per
// piece: hex count, size, type, the four start numbers of its first
// hexes, and per hex req | nr << 3 | end << 6; the eligible travel
// pieces per difficulty; the connection tables [placed size, placed
// type, new size] with their (21, 2) coordinates and (21, 6) rotations.
ED_TABLE int ROT[24] = {1, 0, 0, 1, 0, -1, 1, 1, -1, -1, 1, 0, -1, 0, 0, -1, 0,
    1, -1, -1, 1, 1, -1, 0};
ED_TABLE int SIZE_XY[222] = {0, -6, 2, -6, 4, -6, 6, -6, -2, -4, 0, -4, 2, -4,
    4, -4, 6, -4, -4, -2, -2, -2, 0, -2, 2, -2, 4, -2, 6, -2, -6, 0, -4, 0, -2,
    0, 0, 0, 2, 0, 4, 0, 6, 0, -6, 2, -4, 2, -2, 2, 0, 2, 2, 2, 4, 2, -6, 4,
    -4, 4, -2, 4, 0, 4, 2, 4, -6, 6, -4, 6, -2, 6, 0, 6, -3, -2, -1, -2, 1, -2,
    3, -2, 5, -2, -5, 0, -3, 0, -1, 0, 1, 0, 3, 0, 5, 0, -5, 2, -3, 2, -1, 2,
    1, 2, 3, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 0,
    -2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
ED_TABLE int PIECE_N_HEX[20] = {37, 37, 37, 37, 37, 37, 37, 37, 37, 37, 37, 37,
    37, 37, 16, 16, 16, 16, 3, 3};
ED_TABLE int PIECE_SIZE[20] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
    1, 1, 2, 2};
ED_TABLE int PIECE_TYPE[20] = {0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 2, 2};
ED_TABLE int PIECE_START[80] = {1, 2, 3, 4, 4, 3, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
ED_TABLE int PIECE_PACKED[740] = {5, 5, 5, 5, 8, 8, 8, 8, 8, 8, 8, 10, 8, 9, 8,
    8, 10, 8, 9, 8, 10, 8, 8, 5, 10, 8, 8, 8, 9, 5, 8, 8, 10, 8, 12, 8, 8, 5,
    5, 5, 5, 8, 8, 8, 8, 8, 8, 8, 9, 8, 8, 8, 9, 8, 10, 8, 10, 8, 8, 8, 10, 8,
    8, 8, 8, 8, 8, 10, 5, 8, 8, 9, 12, 9, 8, 8, 9, 9, 10, 11, 8, 10, 9, 10, 11,
    9, 9, 10, 10, 9, 10, 11, 5, 9, 11, 11, 9, 9, 10, 10, 11, 9, 8, 10, 11, 9,
    9, 8, 8, 11, 11, 16, 8, 8, 8, 8, 9, 9, 9, 8, 8, 9, 17, 9, 9, 8, 16, 8, 8,
    5, 17, 9, 16, 8, 26, 5, 8, 9, 8, 5, 10, 26, 8, 8, 25, 5, 8, 16, 8, 8, 8,
    11, 11, 17, 5, 16, 8, 11, 16, 11, 8, 9, 10, 5, 5, 27, 9, 9, 5, 10, 11, 11,
    24, 5, 8, 10, 8, 16, 8, 16, 10, 8, 11, 8, 12, 11, 11, 8, 12, 11, 10, 10,
    24, 16, 16, 8, 18, 19, 8, 11, 8, 8, 17, 5, 8, 17, 20, 5, 5, 25, 16, 8, 17,
    5, 9, 9, 8, 11, 9, 9, 11, 11, 8, 8, 8, 11, 11, 9, 5, 16, 8, 11, 8, 11, 8,
    9, 10, 5, 5, 27, 9, 9, 5, 10, 11, 11, 24, 5, 8, 10, 8, 16, 8, 16, 10, 8,
    11, 8, 12, 16, 16, 16, 8, 16, 8, 8, 8, 17, 16, 8, 10, 10, 9, 17, 8, 8, 10,
    18, 10, 9, 17, 10, 18, 18, 10, 9, 17, 18, 5, 18, 9, 17, 26, 18, 10, 9, 16,
    16, 16, 8, 16, 8, 8, 8, 17, 16, 8, 10, 10, 9, 17, 8, 8, 10, 18, 10, 9, 17,
    10, 18, 18, 10, 9, 17, 18, 5, 18, 9, 17, 26, 18, 10, 9, 10, 10, 10, 19, 10,
    18, 18, 5, 11, 10, 18, 8, 8, 19, 11, 10, 10, 24, 12, 8, 19, 11, 9, 17, 8,
    16, 19, 11, 9, 5, 17, 9, 19, 9, 9, 9, 9, 16, 16, 16, 8, 8, 8, 8, 8, 16, 8,
    16, 24, 24, 25, 16, 12, 8, 8, 8, 8, 8, 12, 16, 34, 24, 24, 16, 8, 16, 8, 8,
    8, 8, 8, 16, 16, 16, 16, 16, 8, 24, 8, 8, 8, 24, 12, 8, 16, 5, 24, 9, 12,
    5, 8, 8, 8, 8, 9, 9, 8, 18, 16, 5, 8, 8, 16, 12, 16, 8, 16, 16, 18, 8, 16,
    12, 8, 8, 8, 33, 5, 5, 34, 8, 5, 9, 8, 8, 18, 8, 5, 8, 8, 19, 8, 8, 5, 8,
    19, 5, 5, 5, 5, 8, 19, 8, 8, 8, 8, 8, 9, 9, 10, 9, 9, 8, 10, 18, 9, 8, 8,
    8, 18, 26, 9, 16, 8, 8, 8, 8, 34, 8, 8, 8, 8, 16, 9, 26, 18, 10, 8, 8, 9,
    9, 10, 8, 8, 9, 9, 18, 16, 10, 10, 18, 10, 5, 5, 33, 5, 10, 10, 8, 16, 8,
    10, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 25, 17,
    9, 17, 25, 8, 9, 9, 9, 9, 11, 9, 19, 25, 16, 9, 5, 5, 5, 5, 5, 5, 5, 5, 5,
    5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 8, 27, 8, 8, 17, 16, 11, 16, 26, 9, 16,
    11, 10, 10, 9, 24, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5,
    5, 5, 8, 8, 5, 10, 10, 8, 24, 5, 10, 12, 10, 8, 8, 5, 10, 10, 5, 5, 5, 5,
    5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 73, 73, 73, 5, 5, 5, 5,
    5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5,
    5, 5, 5, 5, 5, 72, 72, 72, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5,
    5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5};
ED_TABLE int DIFF_MASK[3] = {137, 60395, 65535};
ED_TABLE int CONN_N[27] = {14, 21, 0, 14, 21, 7, 14, 21, 7, 6, 0, 0, 6, 0, 0,
    6, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
ED_TABLE int CONN_NROT[567] = {6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 1, 1,
    1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 6, 6, 6,
    6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 1,
    1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 6, 6,
    6, 6, 6, 6, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 6, 6, 6, 6, 6, 6, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 6,
    6, 6, 6, 6, 6, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1};
ED_TABLE int CONN_COORD[1134] = {8, 6, 6, 8, -6, 14, -8, 14, -14, 8, -14, 6,
    -8, -6, -6, -8, 6, -14, 8, -14, 14, -8, 14, -6, 8, 6, 6, 8, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 7, 5, 5, 7, 3, -7, 10, -5, 10, -3, 10, -10,
    3, -10, 5, -10, 7, -3, -7, -5, -5, -7, -3, 7, -10, 5, -10, 3, -10, 10, -3,
    10, -5, 10, -7, 3, 7, 5, 5, 7, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 8, 6, 6, 8, -6, 14, -8, 14, -14, 8, -14, 6, -8, -6, -6, -8, 6,
    -14, 8, -14, 14, -8, 14, -6, 8, 6, 6, 8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 3, 7, 5, 5, 7, 3, -7, 10, -5, 10, -3, 10, -10, 3, -10, 5, -10, 7,
    -3, -7, -5, -5, -7, -3, 7, -10, 5, -10, 3, -10, 10, -3, 10, -5, 10, -7, 3,
    7, 5, 5, 7, 3, 0, 8, -8, 8, -8, 0, 0, -8, 8, -8, 8, 0, 0, 8, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 6,
    6, 8, -6, 14, -8, 14, -14, 8, -14, 6, -8, -6, -6, -8, 6, -14, 8, -14, 14,
    -8, 14, -6, 8, 6, 6, 8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 7, 5,
    5, 7, 3, -7, 10, -5, 10, -3, 10, -10, 3, -10, 5, -10, 7, -3, -7, -5, -5,
    -7, -3, 7, -10, 5, -10, 3, -10, 10, -3, 10, -5, 10, -7, 3, 7, 5, 5, 7, 3,
    0, 8, -8, 8, -8, 0, 0, -8, 8, -8, 8, 0, 0, 8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 10, -5, 10, -3,
    10, 7, -10, 5, -10, 3, -10, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7,
    10, -5, 10, -3, 10, 7, -10, 5, -10, 3, -10, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, -7, 10, -5, 10, -3, 10, 7, -10, 5, -10, 3, -10, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
ED_TABLE int CONN_ROT[3402] = {-2, -1, 0, 1, 2, 3, -2, -1, 0, 1, 2, 3, -1, 0,
    1, 2, 3, 4, -1, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 5, 0, 1, 2, 3, 4, 5, 1, 2, 3,
    4, 5, 6, 1, 2, 3, 4, 5, 6, 2, 3, 4, 5, 6, 7, 2, 3, 4, 5, 6, 7, 3, 4, 5, 6,
    7, 8, 3, 4, 5, 6, 7, 8, 4, 5, 6, 7, 8, 9, 4, 5, 6, 7, 8, 9, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 2, 0, 0, 0, 0, -1, 2, 0, 0, 0, 0,
    -1, 2, 0, 0, 0, 0, 0, 3, 0, 0, 0, 0, 0, 3, 0, 0, 0, 0, 0, 3, 0, 0, 0, 0, 1,
    4, 0, 0, 0, 0, 1, 4, 0, 0, 0, 0, 1, 4, 0, 0, 0, 0, 2, 5, 0, 0, 0, 0, 2, 5,
    0, 0, 0, 0, 2, 5, 0, 0, 0, 0, 3, 6, 0, 0, 0, 0, 3, 6, 0, 0, 0, 0, 3, 6, 0,
    0, 0, 0, 4, 7, 0, 0, 0, 0, 4, 7, 0, 0, 0, 0, 4, 7, 0, 0, 0, 0, 5, 8, 0, 0,
    0, 0, 5, 8, 0, 0, 0, 0, 5, 8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -2, -1, 0, 1, 2, 3, -2, -1, 0,
    1, 2, 3, -1, 0, 1, 2, 3, 4, -1, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 5, 0, 1, 2,
    3, 4, 5, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 5, 6, 2, 3, 4, 5, 6, 7, 2, 3, 4, 5,
    6, 7, 3, 4, 5, 6, 7, 8, 3, 4, 5, 6, 7, 8, 4, 5, 6, 7, 8, 9, 4, 5, 6, 7, 8,
    9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 2, 0, 0, 0, 0,
    -1, 2, 0, 0, 0, 0, -1, 2, 0, 0, 0, 0, 0, 3, 0, 0, 0, 0, 0, 3, 0, 0, 0, 0,
    0, 3, 0, 0, 0, 0, 1, 4, 0, 0, 0, 0, 1, 4, 0, 0, 0, 0, 1, 4, 0, 0, 0, 0, 2,
    5, 0, 0, 0, 0, 2, 5, 0, 0, 0, 0, 2, 5, 0, 0, 0, 0, 3, 6, 0, 0, 0, 0, 3, 6,
    0, 0, 0, 0, 3, 6, 0, 0, 0, 0, 4, 7, 0, 0, 0, 0, 4, 7, 0, 0, 0, 0, 4, 7, 0,
    0, 0, 0, 5, 8, 0, 0, 0, 0, 5, 8, 0, 0, 0, 0, 5, 8, 0, 0, 0, 0, -3, 0, 0, 0,
    0, 0, -2, 0, 0, 0, 0, 0, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0,
    0, 0, 2, 0, 0, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -2,
    -1, 0, 1, 2, 3, -2, -1, 0, 1, 2, 3, -1, 0, 1, 2, 3, 4, -1, 0, 1, 2, 3, 4,
    0, 1, 2, 3, 4, 5, 0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 5, 6, 2,
    3, 4, 5, 6, 7, 2, 3, 4, 5, 6, 7, 3, 4, 5, 6, 7, 8, 3, 4, 5, 6, 7, 8, 4, 5,
    6, 7, 8, 9, 4, 5, 6, 7, 8, 9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, -1, 2, 0, 0, 0, 0, -1, 2, 0, 0, 0, 0, -1, 2, 0, 0, 0, 0, 0, 3, 0, 0,
    0, 0, 0, 3, 0, 0, 0, 0, 0, 3, 0, 0, 0, 0, 1, 4, 0, 0, 0, 0, 1, 4, 0, 0, 0,
    0, 1, 4, 0, 0, 0, 0, 2, 5, 0, 0, 0, 0, 2, 5, 0, 0, 0, 0, 2, 5, 0, 0, 0, 0,
    3, 6, 0, 0, 0, 0, 3, 6, 0, 0, 0, 0, 3, 6, 0, 0, 0, 0, 4, 7, 0, 0, 0, 0, 4,
    7, 0, 0, 0, 0, 4, 7, 0, 0, 0, 0, 5, 8, 0, 0, 0, 0, 5, 8, 0, 0, 0, 0, 5, 8,
    0, 0, 0, 0, -3, 0, 0, 0, 0, 0, -2, 0, 0, 0, 0, 0, -1, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 2, 0, 0, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, -2, -1, 0, 1, 2, 3, -2, -1, 0, 1, 2, 3, -2, -1, 0, 1, 2,
    3, -2, -1, 0, 1, 2, 3, -2, -1, 0, 1, 2, 3, -2, -1, 0, 1, 2, 3, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -2, -1, 0, 1, 2, 3, -2, -1, 0, 1, 2,
    3, -2, -1, 0, 1, 2, 3, -2, -1, 0, 1, 2, 3, -2, -1, 0, 1, 2, 3, -2, -1, 0,
    1, 2, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -2, -1, 0, 1,
    2, 3, -2, -1, 0, 1, 2, 3, -2, -1, 0, 1, 2, 3, -2, -1, 0, 1, 2, 3, -2, -1,
    0, 1, 2, 3, -2, -1, 0, 1, 2, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

#ifdef __CUDACC__
// the pair table through the read-only data path (K3's global copy)
struct OvlLdg {
  const int* p;
  __device__ __forceinline__ int operator[](int i) const {
    return __ldg(p + i);
  }
};
#endif

// the pair table read plainly (a shared-memory copy; the host)
struct OvlPlain {
  const int* p;
  ED_LANE int operator[](int i) const { return p[i]; }
};

// ---- the generator ---------------------------------------------------------
// A placed slot as the overlap test reads it, in one 16-byte load: its
// center, its offset into a candidate's row of the pair table (from its
// size and rotation), and its piece id (-1: none).
struct alignas(16) Slot {
  int x, y, key, pid;
};
constexpr int kSlotPad = 3;  // the overlap test reads slots four at a time

// The generator's arrays, which the lanes read: the placed slots and
// their rotations, each piece's latest placement, and the frame stack's
// saved frames (a parent's engine, loop index, eligible pieces and resume
// point while its child runs).
struct MapSlots {
  Slot slot[kMaxPlaced + kSlotPad];
  int entry_rot[kMaxPlaced];
  int piece_rot[kPieces], piece_x[kPieces], piece_y[kPieces];
  uint32_t frame_rng[kMaxDepth];
  int frame_i[kMaxDepth], frame_valid[kMaxDepth], frame_resume[kMaxDepth];
};

// One env's scratch: its 48 x 48 raster, then its slots (in K3 the warp's
// part of the block's shared memory).
struct alignas(16) MapScratch {
  int raster[kMapCells];
  MapSlots s;
};

// The generator's scalars (the plain version's MapGenState without the
// arrays), in registers, identical in every lane.
struct MapGen {
  MapSlots& m;
  uint32_t rng = 0;  // the current frame's engine,
  int i = 0, valid = 0;  // its loop index and its eligible travel pieces
  int n_entries = 0, min_x = 0, min_y = 0, max_x = 0, max_y = 0;
  int sp = 0, pc = 0, finished = 0, aborted = 0, overflow = 0;
  int trips = 0, retries = 0;  // trips run (`count_trips`), frames pushed
};

// x mod 6 in [0, 6), as torch's % on a negative x
ED_HD int mod6(int x) {
  const int r = x % 6;
  return r < 0 ? r + 6 : r;
}

// hex h of a piece of size `size`, rotated by r in [0, 6), at (cx, cy)
ED_HD void hex_xy(int size, int h, int r, int cx, int cy, int& x, int& y) {
  const int bx = SIZE_XY[2 * (size * kMaxHex + h)];
  const int by = SIZE_XY[2 * (size * kMaxHex + h) + 1];
  x = ROT[4 * r] * bx + ROT[4 * r + 1] * by + cx;
  y = ROT[4 * r + 2] * bx + ROT[4 * r + 3] * by + cy;
}

// a draw on the current frame's engine; n < 1 clamps to 1
ED_HD int draw(MapGen& g, int n) {
  return (int)uniform_int(g.rng, n < 1 ? 1u : (uint32_t)n);
}

// Map::add_piece (src/map.cpp:309-341; mapgen._add_piece): the piece's
// bounding box across the lanes, then the leader writes its slot
template <class L>
ED_HD void add_piece(MapGen& g, int pid, int cx, int cy, int rot) {
  const int r = mod6(rot);
  const int size = PIECE_SIZE[pid], nh = PIECE_N_HEX[pid];
  const Box b = L::box([&](int l, Box& bx) {
    for (int h = l; h < nh; h += kLanes) {
      int x, y;
      hex_xy(size, h, r, cx, cy, x, y);
      box_add(bx, x, y);
    }
  });
  if (g.n_entries >= kMaxPlaced) g.overflow = 1;
  const int slot = g.n_entries < kMaxPlaced ? g.n_entries : kMaxPlaced - 1;
  L::sync();  // every lane has read the slots it needed
  if (L::leader()) {
    g.m.slot[slot] = Slot{cx, cy, (size * 6 + r) * kOvlNd + kOvlDmax, pid};
    g.m.entry_rot[slot] = r;
    g.m.piece_rot[pid] = r;
    g.m.piece_x[pid] = cx;
    g.m.piece_y[pid] = cy;
  }
  L::sync();
  g.n_entries += 1;
  g.min_x = b.lo_x < g.min_x ? b.lo_x : g.min_x;
  g.min_y = b.lo_y < g.min_y ? b.lo_y : g.min_y;
  g.max_x = b.hi_x > g.max_x ? b.hi_x : g.max_x;
  g.max_y = b.hi_y > g.max_y ? b.hi_y : g.max_y;
}

// the connection-table row of slot e's piece for a new piece of size nsize
ED_HD int conn_row(const MapGen& g, int e, int nsize) {
  const int p = g.m.slot[e].pid >= 0 ? g.m.slot[e].pid : 0;
  return (PIECE_SIZE[p] * 3 + PIECE_TYPE[p]) * 3 + nsize;
}

// connection k (of table row c) of slot e's piece: its position (x, y),
// from the piece's latest placement, and that placement's rotation prot
ED_HD void candidate(const MapGen& g, int e, int c, int k, int& x, int& y,
                     int& prot) {
  const int p = g.m.slot[e].pid >= 0 ? g.m.slot[e].pid : 0;
  prot = g.m.piece_rot[p];
  const int ccx = CONN_COORD[2 * (c * kMaxConn + k)];
  const int ccy = CONN_COORD[2 * (c * kMaxConn + k) + 1];
  x = ROT[4 * prot] * ccx + ROT[4 * prot + 1] * ccy + g.m.piece_x[p];
  y = ROT[4 * prot + 2] * ccx + ROT[4 * prot + 3] * ccy + g.m.piece_y[p];
}

// Candidate b = e * kMaxConn + k (connection k of slot e) is free for a
// piece of size nsize: b names a connection, and the piece placed there in
// the connection's first rotation option overlaps no placed slot (through
// the pair bit table, mapgen._build_pair_overlap). The slots are tested
// four at a time, so that their loads are in flight together: a slot's
// center delta is clamped into the table's window, which keeps every
// index in the table, and the window test masks the bit.
template <class Ovl>
ED_HD bool is_free(const MapGen& g, int b, int nsize, int placed, Ovl ovl) {
  const int e = b / kMaxConn, k = b - e * kMaxConn;
  if (e >= placed) return false;
  const int c = conn_row(g, e, nsize);
  if (k >= CONN_N[c]) return false;
  int x, y, prot;
  candidate(g, e, c, k, x, y, prot);
  const int row = (nsize * 6 + mod6(CONN_ROT[6 * (c * kMaxConn + k)] + prot))
                  * 3 * 6 * kOvlNd;
  bool hit = false;
  for (int f0 = 0; f0 < placed && !hit; f0 += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const Slot sl = g.m.slot[f0 + j];
      const int dx = x - sl.x, dy = y - sl.y;
      const bool near = f0 + j < placed && dx >= -kOvlDmax &&
                        dx <= kOvlDmax && dy >= -kOvlDmax && dy <= kOvlDmax;
      const int cx = dx < -kOvlDmax ? -kOvlDmax : dx > kOvlDmax ? kOvlDmax : dx;
      const int cy = dy < -kOvlDmax ? -kOvlDmax : dy > kOvlDmax ? kOvlDmax : dy;
      hit |= near & (((ovl[row + sl.key + cx] >> (cy + kOvlDmax)) & 1) != 0);
    }
  }
  return !hit;
}

// Map::try_add_random (src/map.cpp:277-307; mapgen._try_add_random):
// places piece pid at a random free connection; false (and no draw) when
// none is free. Candidates are enumerated placed-slot-major, then by
// connection index: ballot round w tests candidates 32w to 32w + 31, one a
// lane, and its ballot is word w of the free candidates' bits; the pos-th
// free candidate is drawn, then its rotation.
template <class L, class Ovl>
ED_HD bool try_add_random(MapGen& g, int pid, Ovl ovl) {
  const int nsize = PIECE_SIZE[pid];
  const int placed = g.n_entries < kMaxPlaced ? g.n_entries : kMaxPlaced;
  const int rounds = (placed * kMaxConn + kLanes - 1) / kLanes;
  typename L::Words words;
  words.clear();
  int n_free = 0;
  for (int w = 0; w < rounds; ++w) {
    const uint32_t bits = L::ballot([&](int l) {
      return is_free(g, kLanes * w + l, nsize, placed, ovl);
    });
    words.set(w, bits);
    n_free += ED_POPC(bits);
  }
  if (n_free == 0) return false;
  const int b = words.nth(draw(g, n_free));
  const int pe = b / kMaxConn, pk = b % kMaxConn;
  const int c = conn_row(g, pe, nsize);
  int x, y, prot;
  candidate(g, pe, c, pk, x, y, prot);
  const int r = draw(g, CONN_NROT[c * kMaxConn + pk]);
  add_piece<L>(g, pid, x, y, CONN_ROT[6 * (c * kMaxConn + pk) + r] + prot);
  return true;
}

// generate(..., failures + 1, <engine copy>) (mapgen._push_child): the
// leader saves the parent's frame; the child starts from a copy of the
// parent's engine. A push at depth kMaxDepth - 1 aborts, and the env's
// state freezes there; it counts as a retry all the same.
template <class L>
ED_HD void push_child(MapGen& g, int resume) {
  g.retries += 1;
  if (g.sp >= kMaxDepth - 1) {
    g.aborted = 1;
    return;
  }
  L::sync();
  if (L::leader()) {
    g.m.frame_rng[g.sp] = g.rng;
    g.m.frame_i[g.sp] = g.i;
    g.m.frame_valid[g.sp] = g.valid;
    g.m.frame_resume[g.sp] = resume;
  }
  L::sync();
  g.sp += 1;
  g.pc = PC_ENTRY;
}

// one trip of the generator (mapgen._trip) for an env still running; the
// loop and end branches share one placement attempt
template <class L, class Ovl>
ED_HD void trip(MapGen& g, int n_pieces, int difficulty, Ovl ovl) {
  const int i = g.i;
  if (g.pc == PC_ENTRY) {
    add_piece<L>(g, draw(g, 2), 0, 0, 0);  // start piece 0 or 1
    g.valid = DIFF_MASK[difficulty];
    g.i = 0;
    g.pc = PC_LOOP;
  } else if (g.pc == PC_POP) {
    if (g.sp == 0) {
      g.finished = 1;
      return;
    }
    g.sp -= 1;  // the parent resumes with its own engine
    g.rng = g.m.frame_rng[g.sp];
    g.i = g.m.frame_i[g.sp];
    g.valid = g.m.frame_valid[g.sp];
    const bool inc = g.m.frame_resume[g.sp] == RES_LOOP_INC;
    if (inc) g.i += 1;
    g.pc = inc ? PC_LOOP : PC_POP;
  } else if (g.pc == PC_LOOP && i >= n_pieces) {
    g.pc = PC_END;
  } else {
    // the loop draws one of the frame's eligible travel pieces, the end
    // branch one of the two end pieces
    const bool loop = g.pc == PC_LOOP;
    const uint32_t valid = (uint32_t)g.valid & 0xFFFFu;
    const int nv = ED_POPC(valid);
    int pid;
    if (loop) {
      pid = kTravelPiece0 + (nv > 0 ? nth_bit(valid, draw(g, nv)) : 0);
    } else {
      pid = kEndPiece0 + draw(g, 2);
    }
    const bool placed =
        (!loop || nv > 0) && try_add_random<L>(g, pid, ovl);
    if (loop && placed) {
      g.valid &= ~(1 << (pid - kTravelPiece0));
      g.i = i + 1;
    } else if (loop) {
      push_child<L>(g, RES_LOOP_INC);
    } else if (placed) {
      g.pc = PC_POP;
    } else {  // Map::reset (src/map.cpp:744-752), then a retry
      L::sync();
      L::each([&](int l) {
        for (int e = l; e < kMaxPlaced; e += kLanes) g.m.slot[e].pid = -1;
      });
      L::sync();
      g.n_entries = g.min_x = g.min_y = g.max_x = g.max_y = 0;
      push_child<L>(g, RES_POP);
    }
  }
}

// The trips a generation ran, from its retries, so that the trip loop
// carries no counter: a frame that runs to its end takes n + 4 trips (its
// entry, one a piece index, the loop's end, the end piece and its pop),
// whatever its children did, so a generation that finishes took (n + 4) x
// (1 + retries). One that aborted holds sp + 1 open frames: each took its
// entry, its indices below the one it failed at and the failing trip (i +
// 2), or, where its end piece failed (at i == n), n + 3; the other retries
// - (sp + 1) frames it pushed ran to their ends.
ED_HD int count_trips(const MapGen& g, int n_pieces) {
  const int whole = (n_pieces > 0 ? n_pieces : 0) + 4;
  if (!g.aborted) return whole * (1 + g.retries);
  int open = g.i + (g.pc == PC_END ? 3 : 2);
  for (int d = 0; d < g.sp; ++d)
    open += g.m.frame_i[d] + (g.m.frame_resume[d] == RES_POP ? 3 : 2);
  return whole * (g.retries - (g.sp + 1)) + open;
}

// the whole generator from engine state `rng`, consumed by value
template <class L, class Ovl>
ED_HD void generate(MapGen& g, uint32_t rng, int n_pieces, int difficulty,
                    Ovl ovl) {
  L::each([&](int l) {
    for (int e = l; e < kMaxPlaced + kSlotPad; e += kLanes)
      g.m.slot[e] = Slot{0, 0, kOvlDmax, -1};
    for (int e = l; e < kMaxPlaced; e += kLanes) g.m.entry_rot[e] = 0;
    for (int p = l; p < kPieces; p += kLanes)
      g.m.piece_rot[p] = g.m.piece_x[p] = g.m.piece_y[p] = 0;
  });
  L::sync();
  g.rng = rng;
  g.i = g.valid = 0;
  g.n_entries = g.min_x = g.min_y = g.max_x = g.max_y = 0;
  g.sp = g.pc = g.finished = g.aborted = g.overflow = 0;
  g.retries = 0;
  difficulty = difficulty < 0 ? 0 : difficulty > 2 ? 2 : difficulty;
  while (!g.finished && !g.aborted) trip<L>(g, n_pieces, difficulty, ovl);
  g.trips = count_trips(g, n_pieces);
}

// the final rasterisation (src/map.cpp:389-405; mapgen._finalize) into the
// (48 x 48) raster of cell-type ids: zeroed, then the hexes in (slot, hex)
// order, the last writer winning. A piece's hexes share their coordinates'
// parities, so within a slot they fall on distinct cells and the lanes
// write them at once; a sync orders one slot's writes before the next's.
template <class L>
ED_HD void raster(const MapGen& g, int* ids) {
  L::each([&](int l) {
    Quad* q = reinterpret_cast<Quad*>(ids);
    for (int j = l; j < kMapCells / 4; j += kLanes) q[j] = Quad{0, 0, 0, 0};
  });
  L::sync();
  const int placed = g.n_entries < kMaxPlaced ? g.n_entries : kMaxPlaced;
  for (int e = 0; e < placed; ++e) {
    const Slot sl = g.m.slot[e];
    const int pid = sl.pid, r = g.m.entry_rot[e], cx = sl.x, cy = sl.y;
    const int size = PIECE_SIZE[pid], nh = PIECE_N_HEX[pid];
    L::each([&](int l) {
      for (int h = l; h < nh; h += kLanes) {
        int x, y;
        hex_xy(size, h, r, cx, cy, x, y);
        const int ix = ((x - g.min_x) >> 1) + 1, iy = ((y - g.min_y) >> 1) + 1;
        if (ix >= 0 && ix < kGrid && iy >= 0 && iy < kGrid) {
          const int p = PIECE_PACKED[pid * kMaxHex + h];
          ids[ix * kGrid + iy] = cell_type_id(p & 7, (p >> 3) & 7, (p >> 6) & 1);
        }
      }
    });
    L::sync();
  }
}

// K3's arguments. Per-env inputs and the batch outputs are read and
// written at row idx[e] (row e without idx); the queue-width outputs at
// e. start_xy / start_no, the prelude's outputs (with n_players) and work
// may be null.
struct MapArgs {
  const int* rng;         // (n,) engine words, consumed by value
  const int* idx;         // (q,) rows, unique; or null
  const int* n_pieces;    // (n,)
  const int* difficulty;  // (n,)
  const int* n_players;   // (n,)
  const int* ovl;         // (kOvlWords,) pair bit table, 16-byte aligned
  int* map_ids;           // (n, 2304), 16-byte aligned
  int* min_xy;            // (n, 2)
  unsigned char* ok;      // (n,) bool
  unsigned char* overflow;
  int* start_xy;          // (q, 4, 2)
  int* start_no;          // (q, 4)
  int* player_xy;         // (q, 4, 2)
  int* req;               // (q, 4, 19)
  int* nr;
  int* end;
  int q;
  int* work;              // (q, 2): the env's trips and retries
};

ED_HD int map_row(const MapArgs& a, int e) { return a.idx ? a.idx[e] : e; }

// The start positions (slot 0's first four hexes and its piece's start
// numbers; piece 0 where slot 0 is empty) and the prelude of
// reset_map_prelude: add_players (src/map.cpp:343-354) and every player's
// 19-cell ball (engine._ball_cells_xy) read from the env's raster, a
// lane per cell.
template <class L>
ED_HD void map_prelude(const MapArgs& a, int e, int row, const MapGen& g,
                       const int* ids) {
  const Slot s0 = g.m.slot[0];
  const int pid = s0.pid >= 0 ? s0.pid : 0;
  const int size = PIECE_SIZE[pid], r = g.m.entry_rot[0];
  const int cx = s0.x, cy = s0.y;
  const int np = a.player_xy ? a.n_players[row] : 0;
  L::each([&](int l) {
    if (l < kPlayers) {
      int x, y;
      hex_xy(size, l, r, cx, cy, x, y);
      if (a.start_xy) {
        a.start_xy[2 * kPlayers * e + 2 * l] = x;
        a.start_xy[2 * kPlayers * e + 2 * l + 1] = y;
      }
      if (a.start_no) a.start_no[kPlayers * e + l] = PIECE_START[kPlayers * pid + l];
    }
    if (!a.player_xy) return;
    for (int j = l; j < kPlayers * kBall; j += kLanes) {
      const int p = j / kBall, k = j - p * kBall;
      int x, y;
      hex_xy(size, p, r, cx, cy, x, y);
      const int no = PIECE_START[kPlayers * pid + p];
      const bool gate = no > 0 && no < np + 1 && p < np;
      x = gate ? x : 0;
      y = gate ? y : 0;
      if (k == 0) {
        a.player_xy[2 * kPlayers * e + 2 * p] = x;
        a.player_xy[2 * kPlayers * e + 2 * p + 1] = y;
      }
      const int ix = grid_index(x + BALL[2 * k] - g.min_x);
      const int iy = grid_index(y + BALL[2 * k + 1] - g.min_y);
      const bool in_grid = ix >= 0 && ix < kGrid && iy >= 0 && iy < kGrid;
      const size_t o = (size_t)e * kPlayers * kBall + j;
      decode_cell(in_grid ? ids[ix * kGrid + iy] : 0, a.req[o], a.nr[o],
                  a.end[o]);
    }
  });
}

// Env e: its generation, raster (staged in the scratch, then written to
// the batch row whole, 16 bytes a lane per store), flags, counts, start
// positions and prelude.
template <class L, class Ovl>
ED_HD void map_env(const MapArgs& a, int e, MapScratch& sc, Ovl ovl) {
  const int row = map_row(a, e);
  MapGen g{sc.s};
  generate<L>(g, (uint32_t)a.rng[row], a.n_pieces[row], a.difficulty[row],
              ovl);
  raster<L>(g, sc.raster);
  L::each([&](int l) {
    const Quad* src = reinterpret_cast<const Quad*>(sc.raster);
    Quad* dst = reinterpret_cast<Quad*>(a.map_ids + (size_t)row * kMapCells);
    for (int j = l; j < kMapCells / 4; j += kLanes) dst[j] = src[j];
  });
  if (L::leader()) {
    a.min_xy[2 * row] = g.min_x;
    a.min_xy[2 * row + 1] = g.min_y;
    a.ok[row] = !(g.aborted || g.overflow);
    a.overflow[row] = g.overflow && !g.aborted;
    if (a.work) {
      a.work[2 * e] = g.trips;
      a.work[2 * e + 1] = g.retries;
    }
  }
  map_prelude<L>(a, e, row, g, sc.raster);
}

}  // namespace ed
