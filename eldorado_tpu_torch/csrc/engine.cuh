// The game logic of the CUDA kernels: one env per thread, scalar C++; the
// reset (K2) one env per warp, through the lanes of lanes.cuh.
//
// This computes what eldorado_tpu/core/engine.py computes (fused_sample_step
// and reset_body), written as straight branchy code instead of the JAX
// engine's compute-every-branch-and-select form: on Hopper each thread runs
// its own env, so only the taken branch is paid for. Semantics are copied
// site by site: u_char fields held in int and wrapped with wrap8 at the JAX
// engine's sites, the two-attempt rejection draws of rng.cuh, integer
// prefix sums, the packed 3-word masks, and the reference quirks noted in
// the JAX engine (info_removed/info_card_uses take n_added, ...).
//
// State layout: `Env` mirrors one env's column of the field-major,
// env-minor carry of eldorado_tpu_torch/core/engine.py (pack_dyn): word f
// of env e lives at carry[f * n + e]. The OFF_* constants are that layout
// (tests/test_torch_tables.py holds them to engine.DYN_LAYOUT) and the
// static_asserts below tie them to this struct. The kernels keep each
// env's `Env` in an `EnvSlot` of shared memory, padded to an odd number of
// words (step_kernel.cuh says why).
#pragma once

#include <math.h>
#include <stddef.h>
#include <string.h>

#include "lanes.cuh"  // and through it rng.cuh

#ifdef __CUDACC__
#define ED_CONST static __constant__ const
#else
#define ED_CONST static const
#endif

namespace ed {

constexpr int kGrid = 48;
constexpr int kMapCells = kGrid * kGrid;
constexpr int kCards = 21;
constexpr int kShop = 18;
constexpr int kBall = 19;
constexpr int kHandSize = 4;
constexpr int kMktSlots = 6;
constexpr int kCellTypes = 19;
constexpr int kCarryWords = 570;

constexpr int PLAY0 = 0, SPECIAL0 = 22, REMOVE0 = 44, MOVE0 = 66, SHOP0 = 73;
constexpr int SP_TRANSMIT = 1, SP_DRAW2 = 2, SP_DRAW3 = 3,
              SP_DRAW1_REMOVE1 = 4, SP_DRAW2_REMOVE2 = 5, SP_NATIVE = 6,
              SP_SHOP_DISABLE = 7;

// carry offsets (engine.DYN_LAYOUT)
constexpr int OFF_RNG = 0;
constexpr int OFF_PLAYER_XY = 1;
constexpr int OFF_PILES = 9;
constexpr int OFF_N_IN_HAND = 429;
constexpr int OFF_N_ACTIVE = 433;
constexpr int OFF_N_IN_DRAW = 437;
constexpr int OFF_IDX_LAST = 441;
constexpr int OFF_HAS_WON = 445;
constexpr int OFF_MIP = 449;
constexpr int OFF_NEXT_CARD_FREE = 453;
constexpr int OFF_NEXT_MOVE_FREE = 457;
constexpr int OFF_N_REMOVES = 461;
constexpr int OFF_STEPS_TAKEN = 465;
constexpr int OFF_N_MOVEMENTS = 469;
constexpr int OFF_N_ADDED = 473;
constexpr int OFF_SHOP_STOCK = 477;
constexpr int OFF_IN_MARKET = 495;
constexpr int OFF_N_IN_MARKET = 513;
constexpr int OFF_PHASE = 514;
constexpr int OFF_AGENT = 515;
constexpr int OFF_RESOURCES = 516;
constexpr int OFF_TURN_COUNTER = 519;
constexpr int OFF_DONE = 520;
constexpr int OFF_SEL_MASK = 521;
constexpr int OFF_STORAGE_MASKS = 524;
constexpr int OFF_W3_CACHE = 536;
constexpr int OFF_REWARDS = 540;
constexpr int OFF_INFO_TOTAL = 544;
constexpr int OFF_INFO_STEPS = 545;
constexpr int OFF_INFO_RETURNS = 549;
constexpr int OFF_INFO_TRAVELLED = 553;
constexpr int OFF_INFO_ADDED = 557;
constexpr int OFF_INFO_REMOVED = 561;
constexpr int OFF_INFO_CARD_USES = 565;
constexpr int OFF_RNG_TAINTED = 569;

// static tables (core/tables.py, core/cells.py, engine._BALL/_PAIR/_DIR_DBL)
ED_CONST int CARD_SINGLE[21] = {0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 0, 1, 0};
ED_CONST int CARD_SPECIAL[21] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6};
ED_CONST int CARD_RES[63] = {1, 0, 0, 2, 0, 0, 3, 0, 0, 5, 0, 0, 6, 0, 0, 0, 1, 0, 0, 3, 0, 0, 0, 1, 0, 0, 2, 0, 0, 3, 0, 0, 4, 0, 0, 4, 1, 1, 1, 2, 2, 2, 4, 4, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
ED_CONST int SHOP_TYPE[18] = {1, 2, 3, 4, 6, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
ED_CONST int SHOP_COST[18] = {1, 3, 5, 3, 2, 2, 3, 3, 5, 2, 4, 4, 4, 4, 2, 4, 3, 5};
ED_CONST int SHOP_MKT0[18] = {1, 1, 0, 0, 0, 1, 0, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0, 0};
ED_CONST int CELL_TRIPLES[57] = {5, 0, 0, 0, 1, 0, 0, 1, 1, 0, 2, 0, 0, 3, 0, 1, 1, 0, 1, 1, 1, 1, 2, 0, 1, 3, 0, 1, 4, 0, 2, 1, 0, 2, 2, 0, 2, 3, 0, 2, 4, 0, 3, 1, 0, 3, 2, 0, 3, 3, 0, 4, 1, 0, 4, 2, 0};
ED_CONST int BALL[38] = {0, 0, 2, 0, 0, 2, -2, 2, -2, 0, 0, -2, 2, -2, 4, 0, 2, 2, 4, -2, 0, 4, -2, 4, -4, 4, -4, 2, -4, 0, -2, -2, 0, -4, 2, -4, 4, -4};
ED_CONST int PAIR[49] = {0, 1, 2, 3, 4, 5, 6, 1, 7, 8, 2, 0, 6, 9, 2, 8, 10, 11, 3, 0, 1, 3, 2, 11, 12, 13, 4, 0, 4, 0, 3, 13, 14, 15, 5, 5, 6, 0, 4, 15, 16, 17, 6, 9, 1, 0, 5, 17, 18};
ED_CONST int DIR_DBL[14] = {0, 0, 2, 0, 0, 2, -2, 2, -2, 0, 0, -2, 2, -2};
ED_CONST int START_DISCARD[21] = {3, 0, 0, 0, 0, 1, 0, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// One env's dynamic state, field for field the carry column. Bools are
// 0/1 ints; u_char fields are ints in [0, 255].
struct Env {
  uint32_t rng;
  int xy[4][2];
  int piles[4][5][kCards];  // draw, hand, active, played, discard
  int n_in_hand[4], n_active[4], n_in_draw[4], idx_last[4];
  int has_won[4], mip[4], ncf[4], nmf[4];
  int n_removes[4], steps_taken[4], n_movements[4], n_added[4];
  int shop_stock[kShop], in_market[kShop];
  int n_in_market, phase, agent;
  float res[3];
  int turn_counter, done;
  uint32_t sel[3], storage[4][3], w3[4];
  float rewards[4];
  int info_total, info_steps[4];
  float info_returns[4];
  int info_travelled[4], info_added[4], info_removed[4], info_card_uses[4];
  int tainted;
};
static_assert(sizeof(Env) == 4 * kCarryWords, "Env must mirror the carry");
static_assert(offsetof(Env, piles) == 4 * OFF_PILES, "carry layout");
static_assert(offsetof(Env, n_in_hand) == 4 * OFF_N_IN_HAND, "carry layout");
static_assert(offsetof(Env, shop_stock) == 4 * OFF_SHOP_STOCK, "carry layout");
static_assert(offsetof(Env, res) == 4 * OFF_RESOURCES, "carry layout");
static_assert(offsetof(Env, sel) == 4 * OFF_SEL_MASK, "carry layout");
static_assert(offsetof(Env, storage) == 4 * OFF_STORAGE_MASKS, "carry layout");
static_assert(offsetof(Env, w3) == 4 * OFF_W3_CACHE, "carry layout");
static_assert(offsetof(Env, rewards) == 4 * OFF_REWARDS, "carry layout");
static_assert(offsetof(Env, info_returns) == 4 * OFF_INFO_RETURNS, "layout");
static_assert(offsetof(Env, tainted) == 4 * OFF_RNG_TAINTED, "carry layout");

// One env's slot in a block's shared memory: the Env, then one pad word,
// so that consecutive slots start kSlotWords words apart. kSlotWords is
// odd, so word f of the 32 slots of a warp lies in 32 different banks.
constexpr int kSlotWords = kCarryWords + 1;
struct EnvSlot {
  Env env;
  int pad;
};
static_assert(kSlotWords % 2 == 1, "an odd stride spreads a warp's banks");
static_assert(sizeof(EnvSlot) == 4 * kSlotWords, "slot stride");
static_assert(offsetof(EnvSlot, env) == 0, "the slot keeps Env's offsets");

// Word f of an env held as its carry column.
ED_HD int env_word(const Env& s, int f) {
  int v;
  memcpy(&v, reinterpret_cast<const char*>(&s) + 4 * f, 4);
  return v;
}

ED_HD void set_env_word(Env& s, int f, int v) {
  memcpy(reinterpret_cast<char*>(&s) + 4 * f, &v, 4);
}

// The column of env e: word f at carry[f * n + e] (coalesced per warp).
ED_HD void load_env(Env& s, const int* carry, int n, int e) {
  for (int f = 0; f < kCarryWords; ++f)
    set_env_word(s, f, carry[(size_t)f * n + e]);
}

ED_HD void store_env(const Env& s, int* carry, int n, int e) {
  for (int f = 0; f < kCarryWords; ++f)
    carry[(size_t)f * n + e] = env_word(s, f);
}

// ---- block staging (K1-act, csrc/step_actions.cu) -----------------------
// K1-act's block: kActEnvs envs, kActWarps warps; warp 0 steps the envs on
// its first kActEnvs lanes. The threads of a block stage the (570, V) tile
// of its V envs together: the tile is cut into units, one word or one
// 16-byte vector of four neighbouring envs, numbered field-major (the
// units of field f, then of f + 1), so that consecutive threads load
// consecutive addresses. Each thread takes per_pass units in a pass, all
// loads before its shared stores; pass p's k-th unit of thread t is
// (p * per_pass + k) * threads + t. kActUnits is one pass over a full
// tile of 16-byte units. tests/test_torch_engine_host.py checks that the
// units of every block cover each (field, env) exactly once.
constexpr int kActEnvs = 16;
constexpr int kActWarps = 8;
constexpr int kActUnits = 9;

struct TilePlan {
  int width;      // envs per unit: 4 (16 bytes) or 1 (a word)
  int per_field;  // units per field row
  int units;      // units in the tile
  int per_pass;   // units a thread loads before its shared stores
  int passes;     // passes of the block's threads
};

// The plan of a V-env tile in units of ``width`` envs (V % width == 0)
// for ``threads`` threads taking ``per_pass`` units a pass.
ED_HD TilePlan tile_plan(int envs, int width, int threads, int per_pass) {
  TilePlan p;
  p.width = width;
  p.per_field = envs / width;
  p.units = kCarryWords * p.per_field;
  p.per_pass = per_pass;
  p.passes = (p.units + threads * per_pass - 1) / (threads * per_pass);
  return p;
}

ED_HD int tile_unit(const TilePlan& p, int threads, int tid, int pass,
                    int k) {
  return (pass * p.per_pass + k) * threads + tid;
}

// Unit u's field and its first env in the tile.
ED_HD void tile_field_env(const TilePlan& p, int u, int& f, int& e) {
  f = u / p.per_field;
  e = (u - f * p.per_field) * p.width;
}

ED_HD int wrap8(int x) { return x & 0xFF; }

// ---- packed 92-bit masks: 3 little-endian words ----------------------
// bits [off, off+width) of word j
ED_HD uint32_t head_word(int j, int off, int width) {
  int lo = off > 32 * j ? off : 32 * j;
  int hi = off + width < 32 * j + 32 ? off + width : 32 * j + 32;
  if (lo >= hi) return 0u;
  uint32_t m = (hi - lo == 32) ? 0xFFFFFFFFu : ((1u << (hi - lo)) - 1u);
  return m << (lo - 32 * j);
}

// NULL mask: index 0 of each of the five heads
ED_HD uint32_t null_word(int j) {
  return j == 0 ? (1u | (1u << 22)) : j == 1 ? (1u << 12)
                                             : ((1u << 2) | (1u << 9));
}

// m := (m & ~H) | (NULL & H) for the head range H = [off, off+width)
ED_HD void null_heads(uint32_t m[3], int off, int width) {
  for (int j = 0; j < 3; ++j) {
    uint32_t h = head_word(j, off, width);
    m[j] = (m[j] & ~h) | (null_word(j) & h);
  }
}

ED_HD int get_bit(const uint32_t m[3], int pos) {
  return (m[pos >> 5] >> (pos & 31)) & 1u;
}

ED_HD void put_bit(uint32_t m[3], int pos, int bit) {
  uint32_t b = 1u << (pos & 31);
  m[pos >> 5] = bit ? (m[pos >> 5] | b) : (m[pos >> 5] & ~b);
}

// bits [off, off+width) (width <= 22) as one value (engine._head_field_w)
ED_HD uint32_t head_field(const uint32_t m[3], int off, int width) {
  int j0 = off >> 5, sh = off & 31;
  uint32_t f = m[j0] >> sh;
  if (sh + width > 32) f |= m[j0 + 1] << (32 - sh);
  return f & ((1u << width) - 1u);
}

// ---- map cells ---------------------------------------------------------
ED_HD void decode_cell(int id, int& req, int& nr, int& end) {
  if (id < 0 || id >= kCellTypes) id = 0;
  req = CELL_TRIPLES[3 * id];
  nr = CELL_TRIPLES[3 * id + 1];
  end = CELL_TRIPLES[3 * id + 2];
}

ED_HD int cell_type_id(int req, int nr, int end) {
  int key = (req << 4) | (nr << 1) | end;
  int out = 0;
  for (int i = 1; i < kCellTypes; ++i) {
    int k = (CELL_TRIPLES[3 * i] << 4) | (CELL_TRIPLES[3 * i + 1] << 1)
            | CELL_TRIPLES[3 * i + 2];
    if (key == k) out = i;
  }
  return out;
}

struct Ball {  // (req, n_req, is_end) at the 19 ball offsets
  int req[kBall], nr[kBall], end[kBall];
};

// Map::set_movement_mask (src/map.cpp:369-387) against one ball row,
// after an optional first hop m_eff (engine._movement_mask_row).
ED_HD void movement_mask(const Ball& b, int m_eff, const float res[3],
                         int n_active, int mv[6]) {
  for (int j = 0; j < 6; ++j) {
    int k = PAIR[7 * m_eff + 1 + j];
    int req = b.req[k], n_req = b.nr[k];
    int ridx = req < 2 ? req : 2;
    bool filled = req >= 3 ? n_active > n_req : res[ridx] >= (float)n_req;
    mv[j] = (req != 5) && filled;
  }
}

// Shop::set_available_mask (src/cards.cpp:109-121)
ED_HD void shop_avail(const int stock[kShop], const int in_mkt[kShop],
                      int n_in_market, float coins, int out[kShop]) {
  bool open_slots = n_in_market < kMktSlots;
  for (int i = 0; i < kShop; ++i) {
    bool afford = coins > (float)SHOP_COST[i];
    out[i] = open_slots ? (stock[i] > 0 && afford) : (in_mkt[i] && afford);
  }
}

// cog_env::update_observation: move/shop heads of a stored mask
// (src/environment.cpp:252-279)
ED_HD void obs_mask(uint32_t m[3], int phase, const int mv[6],
                    const int shop[kShop]) {
  null_heads(m, MOVE0, 26);
  if (phase == 1)
    for (int j = 0; j < 6; ++j) m[(MOVE0 + 1 + j) >> 5] |=
        (uint32_t)mv[j] << ((MOVE0 + 1 + j) & 31);
  if (phase == 2)
    for (int i = 0; i < kShop; ++i) m[(SHOP0 + 1 + i) >> 5] |=
        (uint32_t)shop[i] << ((SHOP0 + 1 + i) & 31);
}

// ---- the current player's view ----------------------------------------
// The acting player's fields and the shared step mutables, as references
// into the Env (engine.PView): the step reads and writes the state where
// it lives, with no per-step copy in or out.
struct View {
  int (&pile)[5][kCards];  // draw, hand, active, played, discard
  int &n_in_hand, &n_active, &n_in_draw, &idx_last;
  int (&xy)[2];
  uint32_t (&storage)[3];
  int &has_won, &mip, &ncf, &nmf, &n_removes, &n_movements, &n_added;
  uint32_t (&sel)[3];
  float (&res)[3];
  int &phase;
  int (&shop_stock)[kShop];
  int (&in_market)[kShop];
  int &n_in_market;
  uint32_t &rng;
  int &tainted;
};
constexpr int DRAW = 0, HAND = 1, ACTIVE = 2, PLAYED = 3, DISCARD = 4;

ED_HD View view_of(Env& s, int p) {
  return View{s.piles[p],     s.n_in_hand[p],   s.n_active[p],
              s.n_in_draw[p], s.idx_last[p],    s.xy[p],
              s.storage[p],   s.has_won[p],     s.mip[p],
              s.ncf[p],       s.nmf[p],         s.n_removes[p],
              s.n_movements[p], s.n_added[p],   s.sel,
              s.res,          s.phase,          s.shop_stock,
              s.in_market,    s.n_in_market,    s.rng,
              s.tainted};
}

// ---- deck ----------------------------------------------------------------
// Deck::draw (src/cards.cpp:183-211): recycle at most once, clamp, then up
// to four uniform picks scanning the draw-pile counts (engine._deck_draw_p)
ED_HD void deck_draw(View& v, int n) {
  int nid = v.n_in_draw;
  if (nid < n) {
    int sum = 0;
    for (int c = 0; c < kCards; ++c) {
      sum += v.pile[DISCARD][c];
      v.pile[DRAW][c] = wrap8(v.pile[DRAW][c] + v.pile[DISCARD][c]);
      v.pile[DISCARD][c] = 0;
    }
    nid = wrap8(nid + sum);
  }
  int n_eff = n < nid ? n : nid;
  int cum[kCards];
  int acc = 0;
  for (int c = 0; c < kCards; ++c) cum[c] = (acc += v.pile[DRAW][c]);
  for (int j = 0; j < kHandSize; ++j) {
    bool live = j < n_eff;
    int t = uniform_int_fast_maybe(v.rng, nid, live, v.tainted);
    if (!live) continue;
    int ct = 0;
    for (int c = 0; c < kCards; ++c) ct += cum[c] <= t;
    if (ct > kCards - 1) ct = kCards - 1;
    v.pile[DRAW][ct] = wrap8(v.pile[DRAW][ct] - 1);
    v.pile[HAND][ct] = wrap8(v.pile[HAND][ct] + 1);
    for (int c = ct; c < kCards; ++c) cum[c] -= 1;
    nid = wrap8(nid - 1);
    put_bit(v.sel, PLAY0 + 1 + ct, 1);
    put_bit(v.sel, SPECIAL0 + 1 + ct, CARD_SPECIAL[ct] > 0);
  }
  v.n_in_draw = nid;
  v.n_in_hand = wrap8(v.n_in_hand + n_eff);
}

// Deck::activate (src/cards.cpp:242-253)
ED_HD void activate(View& v, int idx) {
  int prev = v.pile[HAND][idx];
  v.pile[HAND][idx] = wrap8(prev - 1);
  v.pile[ACTIVE][idx] = wrap8(v.pile[ACTIVE][idx] + 1);
  v.n_in_hand = wrap8(v.n_in_hand - 1);
  v.n_active = wrap8(v.n_active + 1);
  v.idx_last = idx;
  put_bit(v.sel, PLAY0 + 1 + idx, prev > 1);
  put_bit(v.sel, SPECIAL0 + 1 + idx, prev > 1 && CARD_SPECIAL[idx] > 0);
}

// src/cards.cpp:255-261
ED_HD void play_last_activated(View& v) {
  int idx = v.idx_last;
  if (idx >= 0 && idx < kCards) {
    v.pile[ACTIVE][idx] = wrap8(v.pile[ACTIVE][idx] - 1);
    if (!CARD_SINGLE[idx])
      v.pile[PLAYED][idx] = wrap8(v.pile[PLAYED][idx] + 1);
  }
  v.n_active = wrap8(v.n_active - 1);
}

// src/cards.cpp:263-273
ED_HD void play_immediate(View& v, int idx) {
  int prev = v.pile[HAND][idx];
  v.pile[HAND][idx] = wrap8(prev - 1);
  v.pile[PLAYED][idx] = wrap8(v.pile[PLAYED][idx] + 1);
  v.n_in_hand = wrap8(v.n_in_hand - 1);
  put_bit(v.sel, PLAY0 + 1 + idx, prev > 1);
  put_bit(v.sel, SPECIAL0 + 1 + idx, prev > 1 && CARD_SPECIAL[idx] > 0);
}

// src/cards.cpp:281-290
ED_HD void remove_immediate(View& v, int idx) {
  int prev = v.pile[HAND][idx];
  int play_bit = get_bit(v.sel, PLAY0 + 1 + idx) && prev > 1;
  int remove_bit = get_bit(v.sel, REMOVE0 + 1 + idx) && prev > 1;
  v.pile[HAND][idx] = wrap8(prev - 1);
  v.n_in_hand = wrap8(v.n_in_hand - 1);
  put_bit(v.sel, PLAY0 + 1 + idx, play_bit);
  put_bit(v.sel, SPECIAL0 + 1 + idx, play_bit && CARD_SPECIAL[idx] > 0);
  put_bit(v.sel, REMOVE0 + 1 + idx, remove_bit);
}

// Player::discard_cards / remove_cards (src/player.cpp:85-131)
ED_HD void pick_actives(View& v, int n, bool to_discard) {
  int n_avail = v.n_active;
  if (!to_discard && n_avail < n) n = n_avail;
  for (int j = 0; j < 5; ++j) {
    bool live = j < n;
    int t = uniform_int_fast_maybe(v.rng, n_avail - j, live, v.tainted);
    if (!live) continue;
    int ct = 0, acc = 0;
    for (int c = 0; c < kCards; ++c) ct += (acc += v.pile[ACTIVE][c]) <= t;
    if (ct > kCards - 1) ct = kCards - 1;
    v.pile[ACTIVE][ct] = wrap8(v.pile[ACTIVE][ct] - 1);
    if (to_discard) v.pile[DISCARD][ct] = wrap8(v.pile[DISCARD][ct] + 1);
    v.n_active = wrap8(v.n_active - 1);
  }
}

// ---- selected-mask edits ---------------------------------------------------
ED_HD void disable_playing(View& v) {  // src/player.cpp:191-196
  null_heads(v.sel, PLAY0, 44);
}

ED_HD void enable_playing(View& v) {   // src/player.cpp:198-206
  null_heads(v.sel, REMOVE0, 22);
  for (int c = 0; c < kCards; ++c) {
    int play = v.pile[HAND][c] > 0;
    put_bit(v.sel, PLAY0 + 1 + c, play);
    put_bit(v.sel, SPECIAL0 + 1 + c, play && CARD_SPECIAL[c] > 0);
  }
}

// storage shop bits := the shop's availability at zero coins
ED_HD void put_shop(uint32_t m[3], const View& v) {
  int av[kShop];
  shop_avail(v.shop_stock, v.in_market, v.n_in_market, 0.0f, av);
  for (int i = 0; i < kShop; ++i) put_bit(m, SHOP0 + 1 + i, av[i]);
}

// Player::end_turn (src/player.cpp:170-180); writes the saved mask
ED_HD void end_turn(View& v, uint32_t saved[3]) {
  for (int c = 0; c < kCards; ++c) {
    v.pile[DISCARD][c] = wrap8(v.pile[DISCARD][c] + v.pile[ACTIVE][c]
                               + v.pile[PLAYED][c]);
    v.pile[ACTIVE][c] = 0;
    v.pile[PLAYED][c] = 0;
  }
  v.n_active = 0;
  int n_draw = kHandSize - v.n_in_hand;
  if (n_draw > 0) deck_draw(v, n_draw);
  for (int j = 0; j < 3; ++j) {
    v.res[j] = 0.0f;
    saved[j] = v.sel[j];
  }
}

// card specials (src/cards.cpp:8-36) and the shop-disable continuation
// (src/environment.cpp:156-159), after update_observation
ED_HD void run_special(View& v, int special, const Ball& ball_p) {
  int nd = special == SP_DRAW3 ? 3
           : special == SP_DRAW1_REMOVE1 ? 1
           : (special == SP_DRAW2 || special == SP_DRAW2_REMOVE2) ? 2 : 0;
  if (special == SP_TRANSMIT) {
    null_heads(v.storage, MOVE0, 7);
    for (int i = 0; i < kShop; ++i)
      put_bit(v.storage, SHOP0 + 1 + i, v.shop_stock[i] > 0);
    disable_playing(v);
    v.ncf = 1;
  } else if (special == SP_DRAW2 || special == SP_DRAW3) {
    deck_draw(v, nd);
  } else if (special == SP_DRAW1_REMOVE1 || special == SP_DRAW2_REMOVE2) {
    deck_draw(v, nd);
    // remove head := play head incl. index 0 (src/cards.cpp:18)
    uint32_t w0 = v.storage[0];
    v.storage[1] = (v.storage[1] & 0xFFFu) | ((w0 & 0xFFFFFu) << 12);
    v.storage[2] = (v.storage[2] & ~3u) | ((w0 >> 20) & 3u);
    put_shop(v.storage, v);
    disable_playing(v);
    v.n_removes = nd;
  } else if (special == SP_NATIVE) {
    float hundred[3] = {100.0f, 100.0f, 100.0f};
    int mv[6];
    movement_mask(ball_p, 0, hundred, 100, mv);
    for (int j = 0; j < 6; ++j) put_bit(v.storage, MOVE0 + 1 + j, mv[j]);
    put_shop(v.storage, v);
    disable_playing(v);
    v.nmf = 1;
  } else if (special == SP_SHOP_DISABLE) {
    put_shop(v.storage, v);
  }
}

// ---- sampler ---------------------------------------------------------------
// The position of the (pos+1)-th set bit of the head field f (pos <
// popcount(f) <= 22). On the card one __fns; on the host (the g++ tests)
// the scan it replaces, which tests/test_torch_engine_host.py holds it to.
ED_HD int nth_set_bit(uint32_t f, int pos) {
#ifdef __CUDA_ARCH__
  return (int)__fns(f, 0, pos + 1);
#else
  int val = 0, seen = 0;
  for (int b = 0; b < 22; ++b) {
    if ((f >> b) & 1u) {
      if (seen == pos) val = b;
      ++seen;
    }
  }
  return val;
#endif
}

// action_sampler::sample (include/sampler.h:14-79) on a packed mask: per
// head a uniform pick over the set bits, five engine draws (none when
// !live). engine._sample_action_w. A head's count of set bits is at most
// its width, 22, so each draw takes its constants from SMALL_RANGE; the
// five heads' rows are read first, together, so that their loads are in
// flight at once and not one in each head's turn of the draw chain.
ED_HD void sample_action(uint32_t& rng, const uint32_t m[3], bool live,
                         int act[5], int& tainted) {
  const int offs[5] = {PLAY0, SPECIAL0, REMOVE0, MOVE0, SHOP0};
  const int widths[5] = {22, 22, 22, 7, 19};
  uint32_t f[5];
  SmallRange row[5];
  for (int h = 0; h < 5; ++h) {
    f[h] = head_field(m, offs[h], widths[h]);
    row[h] = SMALL_RANGE[ED_POPC(f[h])];
  }
  for (int h = 0; h < 5; ++h) {
    int pos = uniform_small_fast_maybe(rng, row[h], live, tainted);
    act[h] = f[h] != 0 ? nth_set_bit(f[h], pos) : 0;
  }
}

// Whether each of the five actions lies inside its head (the widths of
// sample_action: engine._HEAD_DEFS). step_live indexes its tables with
// them, so a step with given actions is run only where this holds.
ED_HD bool actions_in_heads(const int act[5]) {
  const int widths[5] = {22, 22, 22, 7, 19};
  bool ok = true;
  for (int h = 0; h < 5; ++h) ok = ok && act[h] >= 0 && act[h] < widths[h];
  return ok;
}

// ---- step ----------------------------------------------------------------
// The agent's 19-cell ball straight from the env's id plane: the
// reference's size_t truncation of half-integer offsets
// (src/map.cpp:273-275; d >= 0 -> d/2+1, d == -1 -> 1, else 0), off-grid
// cells read the sentinel id 0 (engine._ball_ids_xy).
ED_HD int grid_index(int d) { return d >= 0 ? (d >> 1) + 1 : (d == -1); }

ED_HD void ball_ids(const int* map, int mx, int my, int x, int y,
                    int ids[kBall]) {
  for (int k = 0; k < kBall; ++k) {
    int ix = grid_index(x + BALL[2 * k] - mx);
    int iy = grid_index(y + BALL[2 * k + 1] - my);
    bool in_grid = ix >= 0 && ix < kGrid && iy >= 0 && iy < kGrid;
    ids[k] = in_grid ? map[ix * kGrid + iy] : 0;
  }
}

// cog_env::step (src/environment.cpp:91-224) for an env that is not done,
// after the step_pre bookkeeping (engine._step_from_view).
ED_HD void step_live(Env& s, const int act[5], const int ids[kBall],
                     int n_players, int max_steps) {
  const int p = s.agent;
  const int a_play = act[0], a_sp = act[1], a_rm = act[2], a_mv = act[3],
            a_shop = act[4];
  Ball ball_p;
  for (int k = 0; k < kBall; ++k)
    decode_cell(ids[k], ball_p.req[k], ball_p.nr[k], ball_p.end[k]);

  const bool b_play = a_play > 0;
  const bool b_special = a_play == 0 && a_sp > 0;
  const bool b_move = a_play == 0 && a_sp == 0 && a_mv > 0;
  const bool b_else = a_play == 0 && a_sp == 0 && a_mv == 0;


  // v is player p's part of s: every write through v is a write to s.
  // Below, s is read only at the next player q != p (the rotation), never
  // at a field v has changed.
  View v = view_of(s, p);
  if (b_play) {  // src/environment.cpp:104-108, src/player.cpp:47-69
    int idx = a_play - 1 < kCards - 1 ? a_play - 1 : kCards - 1;
    float mov[3];
    for (int c = 0; c < 3; ++c) mov[c] = (float)CARD_RES[3 * idx + c];
    float coin = mov[2];
    if (v.phase == 1) {
      for (int c = 0; c < 3; ++c) v.res[c] = mov[c];
    } else if (v.phase == 2) {
      for (int c = 0; c < 3; ++c)
        v.res[c] = v.res[c] + (c == 2 ? (coin > 0.0f ? coin : 0.5f) : 0.0f);
    }
    activate(v, idx);
  } else if (b_special) {  // src/environment.cpp:110-112
    int idx = a_sp - 1 < kCards - 1 ? a_sp - 1 : kCards - 1;
    if (CARD_SINGLE[idx]) remove_immediate(v, idx);
    else play_immediate(v, idx);
  } else if (b_move) {  // src/environment.cpp:115-125
    bool ok_dir = a_mv < 7;
    v.xy[0] += ok_dir ? DIR_DBL[2 * a_mv] : -(1 << 20);
    v.xy[1] += ok_dir ? DIR_DBL[2 * a_mv + 1] : -(1 << 20);
    int k = ok_dir ? PAIR[a_mv] : 0;
    int req = ball_p.req[k], n_req = ball_p.nr[k], is_end = ball_p.end[k];
    if (v.nmf) {                    // free move
      v.nmf = 0;
      enable_playing(v);
    } else if (req < 3) {           // resource requirement
      int ridx = req < 2 ? req : 2;
      float left = v.res[ridx] - (float)n_req;
      if (!v.mip) {
        play_last_activated(v);
        v.mip = 1;
      }
      for (int c = 0; c < 3; ++c) v.res[c] = c == ridx ? left : 0.0f;
    } else if (req == 3 || req == 4) {  // DISCARD / REMOVE hex
      pick_actives(v, n_req, req == 3);
      for (int c = 0; c < 3; ++c) v.res[c] = 0.0f;
      v.mip = 0;
    }
    v.n_movements += 1;
    v.has_won = is_end > 0;
  } else {  // src/environment.cpp:128-174
    v.nmf = 0;
    if (a_shop > 0) {
      int i = a_shop - 1 < kShop - 1 ? a_shop - 1 : kShop - 1;
      bool free_card = v.ncf;
      int n_mkt = wrap8(v.n_in_market + (free_card ? 0 : 1 - v.in_market[i]));
      if (!free_card) v.in_market[i] = 1;
      v.shop_stock[i] = wrap8(v.shop_stock[i] - 1);
      if (v.shop_stock[i] == 0 && v.in_market[i]) {
        v.in_market[i] = 0;
        n_mkt = wrap8(n_mkt - 1);
      }
      v.n_in_market = n_mkt;
      if (!free_card) {
        for (int c = 0; c < 3; ++c)
          v.res[c] = v.res[c] - (c == 2 ? (float)SHOP_COST[i] : 0.0f);
        v.phase = v.phase == 2 ? 0 : v.phase + 1;
      }
      int card = SHOP_TYPE[i];
      v.pile[DISCARD][card] = wrap8(v.pile[DISCARD][card] + 1);
      v.n_added = wrap8(v.n_added + 1);
    } else if (a_rm > 0) {
      int idx = a_rm - 1 < kCards - 1 ? a_rm - 1 : kCards - 1;
      remove_immediate(v, idx);
      v.n_removes = wrap8(v.n_removes - 1);
      if (v.n_removes == 0) enable_playing(v);
    } else {
      v.phase = v.phase == 2 ? 0 : v.phase + 1;
      if (v.n_removes > 0) {
        v.n_removes = 0;
        enable_playing(v);
      }
    }
  }
  // next_card_free tail (src/environment.cpp:170-173)
  if (b_else && v.ncf) {
    v.ncf = 0;
    enable_playing(v);
  }
  int special = 0;
  if (b_special) {
    int idx = a_sp - 1 < kCards - 1 ? a_sp - 1 : kCards - 1;
    special = CARD_SPECIAL[idx];
  }
  if (b_else && a_shop == 0 && a_rm > 0 && v.n_removes != 0)
    special = SP_SHOP_DISABLE;
  // movement_in_progress teardown on the raw move field
  // (src/environment.cpp:176-179)
  if (v.mip && a_mv == 0) {
    v.mip = 0;
    for (int c = 0; c < 3; ++c) v.res[c] = 0.0f;
  }

  // maybe_end_turn (src/environment.cpp:244-250)
  const bool rotate = v.has_won || v.phase == 0;
  int q = p + 1;
  if (q >= n_players) q = 0;
  // refresh the agent's one-hop word (engine.pack_ball_words w3). It is
  // read when the turn next comes to the agent, where the reference reads
  // the agent's current cell (its is_end ends the game,
  // src/environment.cpp:187-207), so a move that ends the turn (onto an
  // end cell) stores the word of the cell it reached: the ball cells
  // PAIR[7 * a_mv + 0..6] around the ball's centre. The JAX engine stores
  // the word of the cell the agent left, stale until the agent's next
  // step; any other step stores, as there, the cell it started on.
  uint32_t w3c[4];
  for (int j = 0; j < 4; ++j) w3c[j] = s.w3[j];
  {
    const int m = b_move && rotate && a_mv < 7 ? a_mv : 0;
    uint32_t w = 0;
    for (int i = 0; i < 6; ++i)
      w |= (uint32_t)ids[PAIR[7 * m + 1 + i]] << (5 * i);
    w3c[p] = w | ((uint32_t)ball_p.end[PAIR[7 * m]] << 30);
  }
  uint32_t saved[3] = {0u, 0u, 0u};
  if (rotate) {
    end_turn(v, saved);
    for (int j = 0; j < 3; ++j) v.sel[j] = q == p ? saved[j] : s.storage[q][j];
  }
  const bool rot_other = rotate && q != p;
  uint32_t mask_r[3];
  for (int j = 0; j < 3; ++j)
    mask_r[j] = rot_other ? s.storage[q][j] : rotate ? saved[j] : v.storage[j];
  const int n_active_r = rot_other ? s.n_active[q] : v.n_active;
  // the post-rotation agent's ball: the agent's own, or the next agent's
  // one-hop cells from the w3 cache (engine._ball_q_row)
  Ball ball_r;
  if (rotate) {
    uint32_t wq = w3c[q];
    for (int k = 0; k < kBall; ++k) {
      ball_r.req[k] = 5;
      ball_r.nr[k] = 0;
      ball_r.end[k] = 0;
    }
    for (int i = 0; i < 6; ++i)
      decode_cell((wq >> (5 * i)) & 31u, ball_r.req[1 + i], ball_r.nr[1 + i],
                  ball_r.end[1 + i]);
    ball_r.end[0] = (wq >> 30) & 1u;
  } else {
    ball_r = ball_p;
  }
  const int m_eff = (b_move && !rotate) ? a_mv : 0;
  int mv[6], av[kShop];
  movement_mask(ball_r, m_eff, v.res, n_active_r, mv);
  shop_avail(v.shop_stock, v.in_market, v.n_in_market, v.res[2], av);
  obs_mask(mask_r, v.phase, mv, av);

  // a pending special implies no rotation: it edits the new mask of p
  for (int j = 0; j < 3; ++j) v.storage[j] = mask_r[j];
  if (special > 0) run_special(v, special, ball_p);

  const int r = rotate ? q : p;
  if (rotate)
    for (int j = 0; j < 3; ++j) v.storage[j] = saved[j];
  for (int j = 0; j < 3; ++j) s.storage[r][j] = rotate ? mask_r[j] : v.storage[j];
  s.agent = r;
  s.turn_counter += rotate;
  for (int j = 0; j < 4; ++j) s.w3[j] = w3c[j];

  // done check (src/environment.cpp:187-207)
  const int on_end = ball_r.end[PAIR[7 * m_eff]];
  if (special == 0 && (on_end > 0 || s.turn_counter >= max_steps)) {
    float n_winners = 0.0f;
    for (int j = 0; j < 4; ++j) n_winners += (float)s.has_won[j];
    s.done = 1;
    s.info_total = s.turn_counter;
    for (int j = 0; j < 4 && j < n_players; ++j) {
      // two separately rounded ops (no FMA: built with --fmad=false)
      float ret = (float)n_players * (float)s.has_won[j] - n_winners;
      s.info_steps[j] = s.steps_taken[j];
      s.info_returns[j] = ret;
      s.rewards[j] = ret;
      s.info_travelled[j] = s.n_movements[j];
      s.info_added[j] = s.n_added[j];
      s.info_removed[j] = s.n_added[j];    // reference quirk, kept
      s.info_card_uses[j] = s.n_added[j];  // reference quirk, kept
    }
  }
}

// steps_taken / info bookkeeping + INACTIVE -> MOVEMENT for the agent p of
// a live env (src/environment.cpp:97-98,226-231; engine._step_pre)
ED_HD void step_pre(Env& s, int p) {
  s.info_steps[p] = wrap8(s.info_steps[p] + 1);
  if (s.phase == 0) s.phase = 1;
  s.steps_taken[p] = wrap8(s.steps_taken[p] + 1);
}

// The step of live env s, whose agent is p, with the actions ``act``
// (engine.step_core): the bookkeeping, then the agent's ball read from the
// env's (2304,) id plane ``map``, then the step body. The actions must lie
// inside their heads' widths (actions_in_heads): step_live indexes its
// tables with them.
ED_HD void step_agent(Env& s, int p, const int act[5], const int* map,
                      int mx, int my, int n_players, int max_steps) {
  step_pre(s, p);
  int ids[kBall];
  ball_ids(map, mx, my, s.xy[p][0], s.xy[p][1], ids);
  step_live(s, act, ids, n_players, max_steps);
}

// One step of env s with the given actions (engine.step_env): a done env
// dead-steps, unchanged.
ED_HD void step_given(Env& s, const int act[5], const int* map, int mx,
                      int my, int n_players, int max_steps) {
  if (!s.done)
    step_agent(s, s.agent, act, map, mx, my, n_players, max_steps);
}

// One fused sample + step (engine.fused_sample_step) on env s: sample_action
// on the agent's mask, then the step of step_given with the agent read
// once, before the draws.
ED_HD void sample_step(Env& s, uint32_t& srng, const int* map, int mx,
                       int my, int n_players, int max_steps, int mask_sel,
                       int gate_dead, int act[5]) {
  const int p = s.agent;
  const uint32_t* mask = mask_sel ? s.sel : s.storage[p];
  int tainted = 0;
  sample_action(srng, mask, !(gate_dead && s.done), act, tainted);
  if (!s.done) step_agent(s, p, act, map, mx, my, n_players, max_steps);
  s.tainted |= tainted;
}

// ---- per-step records (stream.pack_step / pack_step_full, vec.pack_traj)
// kRecordCompact, kRecordFull or kRecordTraj int32 words of the post-step
// state of env s, after a step that sampled ``act`` with p_pre the agent
// at its entry (the actor). The feed's layouts: stream.py's module
// docstring; jnp.round and torch.round round half to even, as rintf does
// in the default rounding mode. The trajectory record holds rollout's
// per-step fields exactly (vec.py's TRAJ_WORDS): word 0 as the compact
// one, then the 4 rewards and the 3 resources as their f32 bits and the
// 3 sel words.
constexpr int kRecordCompact = 5;
constexpr int kRecordFull = 40;
constexpr int kRecordTraj = 11;

ED_HD int round_even(float x) { return (int)rintf(x); }

ED_HD int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

template <int kWords>
ED_HD void write_record(const Env& s, const int act[5], int p_pre, int* rec) {
  static_assert(kWords == kRecordCompact || kWords == kRecordFull
                || kWords == kRecordTraj, "width");
  uint32_t w0 = ((uint32_t)s.done << 25) | ((uint32_t)s.agent << 26)
                | ((uint32_t)s.phase << 28);
  for (int h = 0; h < 5; ++h) w0 |= (uint32_t)act[h] << (5 * h);
  if constexpr (kWords == kRecordTraj) {
    rec[0] = (int)w0;
    memcpy(rec + 1, s.rewards, sizeof(s.rewards));
    memcpy(rec + 5, s.res, sizeof(s.res));
    for (int j = 0; j < 3; ++j) rec[8 + j] = (int)s.sel[j];
    return;
  }
  uint32_t w1 = 0;
  for (int i = 0; i < 4; ++i)  // 4-bit two's complement
    w1 |= ((uint32_t)round_even(s.rewards[i]) & 0xFu) << (4 * i);
  const int mach = round_even(s.res[0]), padd = round_even(s.res[1]);
  const int coin2 = round_even(s.res[2] * 2.0f);
  w1 |= ((uint32_t)clamp_int(mach, 0, 7) << 16)
        | ((uint32_t)clamp_int(padd, 0, 7) << 19)
        | ((uint32_t)clamp_int(coin2, 0, 1023) << 22);
  rec[0] = (int)w0;
  rec[1] = (int)w1;
  for (int j = 0; j < 3; ++j) rec[2 + j] = (int)s.sel[j];
  if constexpr (kWords == kRecordFull) {
    // the actor's 105 pile counts, one full u8 each, 4 to a word
    const int* pp = &s.piles[p_pre][0][0];
    for (int w = 0; w < 27; ++w) {
      uint32_t v = 0;
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * w + k;
        if (j < 5 * kCards) v |= ((uint32_t)pp[j] & 255u) << (8 * k);
      }
      rec[5 + w] = (int)v;
    }
    uint32_t w32 = 0;
    int max_stock = s.shop_stock[0];
    for (int k = 0; k < kShop; ++k)
      max_stock = s.shop_stock[k] > max_stock ? s.shop_stock[k] : max_stock;
    for (int k = 0; k < 16; ++k)
      w32 |= ((uint32_t)s.shop_stock[k] & 3u) << (2 * k);
    const bool over_r = mach > 31 || padd > 31 || coin2 > 4095;
    const uint32_t w33 =
        ((uint32_t)s.shop_stock[16] & 3u) | (((uint32_t)s.shop_stock[17] & 3u) << 2)
        | ((uint32_t)p_pre << 4) | ((uint32_t)(max_stock > 3) << 7)
        | ((uint32_t)clamp_int(mach, 0, 31) << 8)
        | ((uint32_t)clamp_int(padd, 0, 31) << 13)
        | ((uint32_t)clamp_int(coin2, 0, 4095) << 18)
        | ((uint32_t)over_r << 30);
    rec[32] = (int)w32;
    rec[33] = (int)w33;
    for (int j = 0; j < 3; ++j) {
      rec[34 + j] = (int)s.storage[p_pre][j];
      rec[37 + j] = (int)s.storage[s.agent][j];
    }
  }
}

// ---- K1's work for one env over one launch ---------------------------
// ``n_steps`` fused steps of env s; with kRecord > 0, after step t its
// record at rec + t * rec_stride. Returns the dead steps (the env done at
// entry). The kernel runs this on the env's shared-memory slot, the host
// harness of tests/test_torch_engine_host.py on a host array of slots.
template <int kRecord>
ED_HD unsigned long long run_steps(Env& s, uint32_t& srng, const int* map,
                                   int mx, int my, int n_players,
                                   int max_steps, int mask_sel,
                                   int gate_dead, int n_steps, int act[5],
                                   int* rec, size_t rec_stride) {
  unsigned long long n_dead = 0;
  for (int t = 0; t < n_steps; ++t) {
    n_dead += s.done;  // a step is dead when the env is done at entry
    const int p_pre = s.agent;
    sample_step(s, srng, map, mx, my, n_players, max_steps, mask_sel,
                gate_dead, act);
    if constexpr (kRecord > 0)
      write_record<kRecord>(s, act, p_pre, rec + (size_t)t * rec_stride);
  }
  return n_dead;
}

// ---- P3: K1 cut at the boundaries of sample_step -------------------------
// An empty asm that claims to change x: the compiler must recompute what
// depends on x in every round instead of hoisting it out of the loop.
#ifdef __CUDACC__
#define ED_OPAQUE(x) asm volatile("mov.b32 %0, %0;" : "+r"(x))
#else
#define ED_OPAQUE(x) asm volatile("" : "+r"(x))
#endif

// The wrapping sum of the env's 570 carry words.
ED_HD uint32_t env_word_sum(const Env& s) {
  uint32_t sum = 0;
  for (int f = 0; f < kCarryWords; ++f) sum += (uint32_t)env_word(s, f);
  return sum;
}

// ``n_steps`` rounds of sample_step (storage mask, no gate_dead) cut after
// stage kCut, and the checksum of what is live at the cut
// (ops/probes.step_prefix_plain defines it): 0 stages the env only; 1 also
// samples the five heads each round (sample_action); 2 also reads the
// agent's 19 ball ids when the env is not done (ball_ids); 3 is the whole
// sample_step, so the state advances. Below 3 only srng advances, and the
// agent index is made opaque each round so the sampling and the ball read
// stay inside the loop, as in K1.
template <int kCut>
ED_HD uint32_t step_prefix(Env& s, uint32_t& srng, const int* map, int mx,
                           int my, int n_players, int max_steps,
                           int n_steps) {
  uint32_t chk = 0;
  for (int t = 0; t < n_steps && kCut >= 1; ++t) {
    int p = s.agent;
    if (kCut < 3) ED_OPAQUE(p);
    int act[5];
    int tainted = 0;
    sample_action(srng, s.storage[p], true, act, tainted);
    for (int h = 0; h < 5; ++h) chk += (uint32_t)act[h];
    if (kCut >= 2 && !s.done) {
      if (kCut == 3) step_pre(s, p);
      int ids[kBall];
      ball_ids(map, mx, my, s.xy[p][0], s.xy[p][1], ids);
      for (int k = 0; k < kBall; ++k) chk += (uint32_t)ids[k];
      if (kCut == 3) step_live(s, act, ids, n_players, max_steps);
    }
    if (kCut == 3) s.tainted |= tainted;
  }
  return chk + env_word_sum(s) + srng;
}

// ---- reset (K2) ----------------------------------------------------------
// Everything in cog_env::reset after map generation (engine.reset_body),
// one env per warp in the lane form of lanes.cuh. The reset reads nine
// words of the env's old column (RESET_READS) and writes the words that
// reset_writes names; K2 (csrc/reset_kernel.cu) moves only those between
// a column reset in place and the env's slot, and copies the others
// through into a new carry.

// K2's blocks: in place a warp a block, one env; into a new carry
// kResetEnvs envs a block, a warp each, whose threads write the block's
// tile out kResetUnits words a pass (tile_plan's word units).
// ops/step_kernel.py's RESET_ENVS mirrors kResetEnvs.
constexpr int kResetEnvs = 16;
constexpr int kResetUnits = 6;

// The words of an env's column that the reset reads before it writes
// them: the engine and its taint flag (the deals'
// draws), sel (each deal's mask starts from it), the resources and
// n_in_market (update_observation's masks). Every other word it reads it
// has written first (n_players >= 1, so agent 0's mask, which sel takes
// last, is one of them).
constexpr int kResetReads = 9;
ED_CONST int RESET_READS[kResetReads] = {
    OFF_RNG,           OFF_SEL_MASK,    OFF_SEL_MASK + 1,
    OFF_SEL_MASK + 2,  OFF_RESOURCES,   OFF_RESOURCES + 1,
    OFF_RESOURCES + 2, OFF_N_IN_MARKET, OFF_RNG_TAINTED};

// Whether the reset writes word f of an env of n_players players: of
// every env the engine, the positions, the shop, phase and agent, the turn
// counter, done, sel, the w3 words and the taint flag; of each player
// below n_players its draw, hand, active and discard piles, its 11
// counters and its storage mask. Every other word keeps its value: the
// played piles, idx_last, n_in_market, the resources, the rewards and the
// info fields, and the piles, counters and mask of a player at or past
// n_players.
ED_CX bool reset_writes(int f, int n_players) {
  constexpr int kPile = 5 * kCards;
  if (f < OFF_PILES) return true;  // rng, player_xy
  if (f < OFF_N_IN_HAND)
    return (f - OFF_PILES) / kPile < n_players
           && (f - OFF_PILES) % kPile / kCards != PLAYED;
  if (f < OFF_IDX_LAST) return (f - OFF_N_IN_HAND) % 4 < n_players;
  if (f < OFF_HAS_WON) return false;  // idx_last
  if (f < OFF_SHOP_STOCK) return (f - OFF_HAS_WON) % 4 < n_players;
  if (f < OFF_N_IN_MARKET) return true;  // shop_stock, in_market
  if (f < OFF_PHASE) return false;       // n_in_market
  if (f < OFF_RESOURCES) return true;    // phase, agent
  if (f < OFF_TURN_COUNTER) return false;
  if (f < OFF_STORAGE_MASKS) return true;  // turn_counter, done, sel
  if (f < OFF_W3_CACHE) return (f - OFF_STORAGE_MASKS) / 3 < n_players;
  if (f < OFF_REWARDS) return true;  // w3_cache
  return f == OFF_RNG_TAINTED;       // the rewards and info fields kept
}

// The words reset_writes names, a bit a word: word f of an env of n
// players is bit f % 32 of bits[n][f / 32] (n = 0-4; every count past 4
// writes what 4 do, every count below 0 what 0 does).
constexpr int kWriteWords = (kCarryWords + 31) / 32;
struct WriteSet {
  uint32_t bits[5][kWriteWords];
};

ED_CX WriteSet write_set() {
  WriteSet w{};
  for (int np = 0; np <= 4; ++np)
    for (int f = 0; f < kCarryWords; ++f)
      if (reset_writes(f, np)) w.bits[np][f / 32] |= 1u << (f % 32);
  return w;
}

ED_TABLE WriteSet RESET_WRITES = write_set();

// The row of RESET_WRITES of an env of n_players players.
ED_HD const uint32_t* write_bits(int n_players) {
  return RESET_WRITES.bits[n_players < 0 ? 0 : n_players > 4 ? 4 : n_players];
}

// Whether row w of RESET_WRITES holds word f.
ED_HD bool writes_word(const uint32_t* w, int f) {
  return (w[f >> 5] >> (f & 31)) & 1u;
}

// Lane l's part of loading the words RESET_READS names of column ``col``
// of a (570, n) carry into the env's slot.
ED_HD void load_read_set(Env& s, const int* carry, int n, int col, int l) {
  if (l < kResetReads) {
    const int f = RESET_READS[l];
    set_env_word(s, f, carry[(size_t)f * n + col]);
  }
}

// Player::reset's deal (src/player.cpp:29-43): its piles reset, the
// player's Deck::draw of kHandSize cards recycles the discard pile, the
// kStartDeck cards of START_DISCARD, into the draw pile, and its draw j
// takes the engine's next value t in a range of kStartDeck - j, whichever
// cards the draws before it picked, then the card at position t of the
// remaining draw pile in card order. So every deal's draws, in player
// order, can run ahead of the picks they make, and a deal is the slots it
// takes of the start deck laid out in card order (START_SLOTS).
constexpr int kStartDeck = 8;
constexpr int kResetPhase = 0;  // cog_env::reset leaves the phase INACTIVE
static_assert(kStartDeck <= 8 && 4 * kHandSize <= kLanes,
              "a deal's draw fits in 3 bits, its slots in 8, the draws in "
              "the lanes");

// The deals' draws: draw j (player j / kHandSize's draw j % kHandSize) is
// the 3-bit value whose bit b is bit j of bit[b].
struct Deal {
  uint32_t bit[3];
};

ED_HD int deal_value(const Deal& d, int j) {
  return (int)(((d.bit[0] >> j) & 1u) | (((d.bit[1] >> j) & 1u) << 1)
               | (((d.bit[2] >> j) & 1u) << 2));
}

// Draw j's first attempt on the engine x0, as if every draw before it was
// taken on its first: the engine j + 1 steps on; its value, or -1 when
// uniform_int_fast would reject it.
ED_HD int first_attempt(uint32_t x0, int j) {
  const SmallRange& row = SMALL_RANGE[kStartDeck - j % kHandSize];
  const uint32_t r = minstd_skip(x0, j + 1) - 1;
  return r < row.past ? (int)small_quotient(row, r) : -1;
}

// The draws of the first n_players deals from the engine ``rng``, in
// player order; a double rejection OR-ed into ``tainted``. Each lane takes
// its own draw's first attempt (lane l, draw l), and when no draw rejects,
// as nearly always, those are the draws and the engine ends 4 * n_players
// steps on; else every lane runs the draws in sequence (deck_draw's
// uniform_int_fast_maybe).
template <class L>
ED_HD Deal deal_draws(uint32_t& rng, int& tainted, int n_players) {
  const int draws = kHandSize * (n_players < 4 ? n_players : 4);
  const uint32_t x0 = rng;
  // bits[0]: the draws whose first attempt rejects; bits[1 + b]: bit b of
  // each draw's value
  uint32_t bits[4];
  L::ballots(bits, [&](int l, bool (&p)[4]) {
    const int v = l < draws ? first_attempt(x0, l) : 0;
    p[0] = v < 0;
    for (int b = 0; b < 3; ++b) p[1 + b] = (v >> b) & 1;
  });
  Deal d;
  if (bits[0] == 0u) {
    for (int b = 0; b < 3; ++b) d.bit[b] = bits[1 + b];
    rng = minstd_skip(x0, draws);
    return d;
  }
  d.bit[0] = d.bit[1] = d.bit[2] = 0u;
  for (int j = 0; j < draws; ++j) {
    const int v = uniform_int_fast_maybe(
        rng, kStartDeck - j % kHandSize, true, tainted);
    for (int b = 0; b < 3; ++b) d.bit[b] |= (uint32_t)((v >> b) & 1) << j;
  }
  return d;
}

// START_SLOTS[c]: the slots of the start deck that hold card c,
// START_DISCARD's cards laid out in card order, a bit a slot.
ED_TABLE uint32_t START_SLOTS[kCards] = {7, 0, 0, 0, 0, 8, 0, 240, 0, 0, 0,
                                         0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// m |= the play and special bits of the cards in ``held`` (bit c: card
// c), as Deck::draw sets them for each card it deals.
ED_HD void put_hand_bits(uint32_t m[3], uint32_t held) {
  for (int c = 0; c < kCards; ++c)
    if ((held >> c) & 1u) {
      put_bit(m, PLAY0 + 1 + c, 1);
      put_bit(m, SPECIAL0 + 1 + c, CARD_SPECIAL[c] > 0);
    }
}

// The reset of the env in slot s with the lanes L: ``xy`` its (4, 2)
// add_players positions, ``req``/``nr``/``end`` its (4, 19) ball rows at
// them. ``stage(l)`` runs in lane l beside the first lane step, which
// touches none of the words RESET_READS names: K2's forms load them
// there. Only those words need hold the env's old values.
template <class L, class Stage>
ED_HD void reset_env(Env& s, int n_players, const int* xy, const int* req,
                     const int* nr, const int* end, Stage stage) {
  L::each([&](int l) {
    stage(l);
    if (l == 0) {
      s.agent = 0;
      s.phase = kResetPhase;
      s.done = 0;
      s.turn_counter = 0;
    }
    if (l < 8) s.xy[l >> 1][l & 1] = xy[l];
    // Shop::reset (src/cards.cpp:94-100): n_in_market untouched
    if (l < kShop) {
      s.shop_stock[l] = 3;
      s.in_market[l] = SHOP_MKT0[l];
    }
    // player l's counters after Player::reset and its deal
    if (l < 4 && l < n_players) {
      s.has_won[l] = s.mip[l] = s.ncf[l] = s.nmf[l] = 0;
      s.n_removes[l] = s.steps_taken[l] = s.n_movements[l] = 0;
      s.n_added[l] = s.n_active[l] = 0;
      s.n_in_draw[l] = kStartDeck - kHandSize;
      s.n_in_hand[l] = kHandSize;
    }
    // player l's w3 word from its ball row (pack_ball_words), all four
    if (l < 4) {
      uint32_t w = 0;
      for (int i = 0; i < 6; ++i) {
        const int k = kBall * l + 1 + i;
        w |= (uint32_t)cell_type_id(req[k], nr[k], end[k]) << (5 * i);
      }
      s.w3[l] = w | ((uint32_t)end[kBall * l] << 30);
    }
  });
  L::sync();
  // every lane, on identical registers: the deals' draws; each live
  // player's slots of the start deck (8 bits a player in ``dealt``) and
  // cards (bit c: card c); the mask each deal starts from, sel after
  // ActionMask::reset
  uint32_t rng = s.rng;
  int tainted = s.tainted;
  const Deal deal = deal_draws<L>(rng, tainted, n_players);
  uint32_t dealt = 0, held[4];
  for (int p = 0; p < 4 && p < n_players; ++p) {
    uint32_t left = (1u << kStartDeck) - 1u, mine = 0u;
    for (int j = 0; j < kHandSize; ++j) {
      const int t = deal_value(deal, kHandSize * p + j);
      const uint32_t slot = 1u << nth_set_bit(left, t);
      left &= ~slot;
      mine |= slot;
    }
    dealt |= mine << (8 * p);
  }
  L::ballots(held, [&](int c, bool (&p)[4]) {
    const uint32_t slots = c < kCards ? START_SLOTS[c] : 0u;
    for (int q = 0; q < 4; ++q) p[q] = ((dealt >> (8 * q)) & slots) != 0u;
  });
  uint32_t m0[3] = {s.sel[0], s.sel[1], s.sel[2]};
  null_heads(m0, PLAY0, 66);
  for (int j = 0; j < 3; ++j) m0[j] |= null_word(j);
  L::sync();  // every lane has read rng, tainted and sel: written next
  L::each([&](int l) {
    if (l == 0) {
      s.rng = rng;
      s.tainted = tainted;
    }
    // card l of each live player's piles: the recycled start deck in the
    // draw pile, less the cards dealt to the hand
    if (l < kCards) {
      const uint32_t slots = START_SLOTS[l];
      for (int p = 0; p < 4 && p < n_players; ++p) {
        const int dealt_l = ED_POPC((dealt >> (8 * p)) & slots);
        s.piles[p][DRAW][l] = START_DISCARD[l] - dealt_l;
        s.piles[p][HAND][l] = dealt_l;
        s.piles[p][ACTIVE][l] = s.piles[p][DISCARD][l] = 0;
      }
    }
    // player l's mask: its cards' bits, then update_observation at the
    // reset's phase; sel becomes agent 0's
    if (l < 4 && l < n_players) {
      uint32_t h = held[0];
      for (int q = 1; q < 4; ++q) h = l == q ? held[q] : h;
      uint32_t m[3] = {m0[0], m0[1], m0[2]};
      put_hand_bits(m, h);
      Ball b;
      for (int k = 0; k < kBall; ++k) {
        b.req[k] = req[kBall * l + k];
        b.nr[k] = nr[kBall * l + k];
        b.end[k] = end[kBall * l + k];
      }
      int mv[6], av[kShop];
      movement_mask(b, 0, s.res, s.n_active[l], mv);
      shop_avail(s.shop_stock, s.in_market, s.n_in_market, s.res[2], av);
      obs_mask(m, kResetPhase, mv, av);
      for (int j = 0; j < 3; ++j) s.storage[l][j] = m[j];
      if (l == 0)
        for (int j = 0; j < 3; ++j) s.sel[j] = m[j];
    }
  });
}

// K2's work for one env in place: the reset in the env's slot, with the
// words RESET_READS names of column ``col`` loaded beside its first lane
// step, then the words it writes back into the column; every other word
// of the column keeps its value.
template <class L>
ED_HD void reset_column(Env& s, int* carry, int n, int col, int n_players,
                        const int* xy, const int* req, const int* nr,
                        const int* end) {
  reset_env<L>(s, n_players, xy, req, nr, end,
               [&](int l) { load_read_set(s, carry, n, col, l); });
  L::sync();
  L::each([&](int l) {
    const uint32_t* w = write_bits(n_players);
    for (int k = 0; k < kWriteWords; ++k)
      if ((w[k] >> l) & 1u) {
        const int f = kLanes * k + l;
        carry[(size_t)f * n + col] = env_word(s, f);
      }
  });
}

// The reset on a whole Env in one thread (the host harnesses, e.g.
// tests/traj_host.cpp): reset_env through the loop form of the lanes.
ED_HD void reset_body(Env& s, int n_players, const int* xy, const int* req,
                      const int* nr, const int* end) {
  reset_env<LoopLanes>(s, n_players, xy, req, nr, end, [](int) {});
}

}  // namespace ed
