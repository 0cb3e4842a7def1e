// K1's per-env work (ed::run_steps of eldorado_tpu_torch/csrc/engine.cuh)
// as a host function, for tests/test_torch_engine_host.py: g++ builds it,
// ctypes loads it. Each env is staged into an EnvSlot of a host array
// (the kernel's shared-memory slot, padded stride and all), stepped, and
// written back, with the kernel's argument layout. Beside it the per-env
// work of K1-act (csrc/step_actions.cu: ed::actions_in_heads, then
// ed::step_given) and of K1-sample (csrc/sample.cu: ed::sample_action);
// the sampler's SMALL_RANGE table and nth_set_bit (rng.cuh, engine.cuh);
// and K1-act's block staging plan (ed::tile_plan and its kin), looped as
// the kernel loops it. K2's per-env work (csrc/reset_kernel.cu: in place
// ed::reset_column, into a new carry ed::reset_env, then the column out)
// through the lane shim's loop form,
// each env's slot filled with noise first, as shared memory holds
// whatever it held; its read and write sets; its new-carry tile plan.
#include <stdint.h>

#include <vector>

#include "engine.cuh"

namespace {

template <int kRecord>
void run(const int* carry_in, int* carry_out, const int* srng_in,
         int* srng_out, const int* map_ids, const int* min_xy,
         const int* n_players, const int* max_steps, int* actions,
         unsigned long long* dead, int* records, int n, int n_steps,
         int mask_sel, int gate_dead) {
  std::vector<ed::EnvSlot> slots(n);
  for (int e = 0; e < n; ++e) {
    ed::Env& s = slots[e].env;
    ed::load_env(s, carry_in, n, e);
    uint32_t srng = (uint32_t)srng_in[e];
    int act[5] = {0, 0, 0, 0, 0};
    *dead += ed::run_steps<kRecord>(
        s, srng, map_ids + (size_t)e * ed::kMapCells, min_xy[2 * e],
        min_xy[2 * e + 1], n_players[e], max_steps[e], mask_sel, gate_dead,
        n_steps, act, kRecord ? records + (size_t)e * kRecord : nullptr,
        (size_t)n * kRecord);
    ed::store_env(s, carry_out, n, e);
    srng_out[e] = (int)srng;
    for (int h = 0; h < 5; ++h) actions[5 * e + h] = act[h];
  }
}

}  // namespace

// The arguments of ed_fused_step (csrc/step_kernel.cu) without K1-null and
// the stream; returns 1 for a record width other than 0, 5, 40 or 11.
extern "C" int ed_host_fused_step(const int* carry_in, int* carry_out,
                                  const int* srng_in, int* srng_out,
                                  const int* map_ids, const int* min_xy,
                                  const int* n_players, const int* max_steps,
                                  int* actions, unsigned long long* dead,
                                  int* records, int n, int n_steps,
                                  int mask_sel, int gate_dead,
                                  int record_words) {
  switch (record_words) {
    case 0:
      run<0>(carry_in, carry_out, srng_in, srng_out, map_ids, min_xy,
             n_players, max_steps, actions, dead, records, n, n_steps,
             mask_sel, gate_dead);
      return 0;
    case ed::kRecordCompact:
      run<ed::kRecordCompact>(carry_in, carry_out, srng_in, srng_out, map_ids,
                              min_xy, n_players, max_steps, actions, dead,
                              records, n, n_steps, mask_sel, gate_dead);
      return 0;
    case ed::kRecordFull:
      run<ed::kRecordFull>(carry_in, carry_out, srng_in, srng_out, map_ids,
                           min_xy, n_players, max_steps, actions, dead,
                           records, n, n_steps, mask_sel, gate_dead);
      return 0;
    case ed::kRecordTraj:
      run<ed::kRecordTraj>(carry_in, carry_out, srng_in, srng_out, map_ids,
                           min_xy, n_players, max_steps, actions, dead,
                           records, n, n_steps, mask_sel, gate_dead);
      return 0;
    default:
      return 1;
  }
}

// The arguments of ed_step_actions (csrc/step_actions.cu) without the
// stream: counts[0] += envs refused for their actions, counts[1] += envs
// done after the step.
extern "C" void ed_host_step_actions(const int* carry_in, int* carry_out,
                                     const int* actions, const int* map_ids,
                                     const int* min_xy, const int* n_players,
                                     const int* max_steps, int* counts,
                                     int n) {
  std::vector<ed::EnvSlot> slots(n);
  for (int e = 0; e < n; ++e) {
    ed::Env& s = slots[e].env;
    ed::load_env(s, carry_in, n, e);
    const int* act = actions + 5 * e;
    const bool ok = ed::actions_in_heads(act);
    if (ok)
      ed::step_given(s, act, map_ids + (size_t)e * ed::kMapCells,
                     min_xy[2 * e], min_xy[2 * e + 1], n_players[e],
                     max_steps[e]);
    ed::store_env(s, carry_out, n, e);
    counts[0] += !ok;
    counts[1] += s.done != 0;
  }
}

// The arguments of ed_sample (csrc/sample.cu) without the stream.
extern "C" void ed_host_sample(const int* srng_in, int* srng_out,
                               const int* mask_words,
                               const unsigned char* live, int* actions,
                               unsigned char* tainted, int n) {
  for (int e = 0; e < n; ++e) {
    uint32_t rng = (uint32_t)srng_in[e];
    const uint32_t m[3] = {(uint32_t)mask_words[3 * e],
                           (uint32_t)mask_words[3 * e + 1],
                           (uint32_t)mask_words[3 * e + 2]};
    int t = 0;
    ed::sample_action(rng, m, live == nullptr || live[e] != 0,
                      actions + 5 * e, t);
    srng_out[e] = (int)rng;
    tainted[e] = (unsigned char)t;
  }
}

// SMALL_RANGE row n: out = scaling, past, magic, shift.
extern "C" void ed_host_small_range(int n, uint32_t* out) {
  const ed::SmallRange& row = ed::SMALL_RANGE[n];
  out[0] = row.scaling;
  out[1] = row.past;
  out[2] = row.magic;
  out[3] = (uint32_t)row.shift;
}

// out[k] = minstd_skip(x, k) for k < kMinstdPows.
extern "C" void ed_host_minstd_skip(uint32_t x, uint32_t* out) {
  for (int k = 0; k < ed::kMinstdPows; ++k) out[k] = ed::minstd_skip(x, k);
}

// q[i] = r[i] / SMALL_RANGE[n].scaling by the row's reciprocal.
extern "C" void ed_host_small_quotient(int n, const uint32_t* r, uint32_t* q,
                                       int count) {
  for (int i = 0; i < count; ++i)
    q[i] = ed::small_quotient(ed::SMALL_RANGE[n], r[i]);
}

// out[i] = nth_set_bit(f[i], pos[i]) (the host branch).
extern "C" void ed_host_nth_set_bit(const uint32_t* f, const int* pos,
                                    int* out, int count) {
  for (int i = 0; i < count; ++i) out[i] = ed::nth_set_bit(f[i], pos[i]);
}

namespace {

// A block staging plan over an n-env carry in blocks of G envs and
// ``threads`` threads taking ``units`` units a pass, as the kernels loop
// it: adds 1 to staged[f * n + e] for every (field, env) a unit moves.
void tile_cover(int n, int G, int threads, int units, bool vec,
                int* staged) {
  for (int e0 = 0; e0 < n; e0 += G) {
    const int V = G < n - e0 ? G : n - e0;
    const ed::TilePlan p = ed::tile_plan(V, vec ? 4 : 1, threads, units);
    for (int pass = 0; pass < p.passes; ++pass)
      for (int k = 0; k < units; ++k)
        for (int tid = 0; tid < threads; ++tid) {
          const int u = ed::tile_unit(p, threads, tid, pass, k);
          if (u >= p.units) continue;
          int f, e;
          ed::tile_field_env(p, u, f, e);
          for (int j = 0; j < p.width; ++j) ++staged[f * n + e0 + e + j];
        }
  }
}

// noise in every word of a slot (a 32-bit LCG from ``seed``)
void fill_slot(ed::EnvSlot& slot, uint32_t& seed) {
  for (int f = 0; f < ed::kCarryWords; ++f) {
    seed = seed * 1664525u + 1013904223u;
    ed::set_env_word(slot.env, f, (int)seed);
  }
}

}  // namespace

// K1-act's staging over an n-env carry in blocks of ed::kActEnvs envs
// and ed::kActWarps warps, as the kernel runs it; ``vec_ok``: the carries
// are 16-byte aligned (the way out is the same plan).
extern "C" void ed_host_tile_cover(int n, int vec_ok, int* staged) {
  tile_cover(n, ed::kActEnvs, 32 * ed::kActWarps, ed::kActUnits,
             vec_ok && n % 4 == 0, staged);
}

// K2's new-carry tile out in blocks of ed::kResetEnvs envs, a warp each,
// by words.
extern "C" void ed_host_reset_tile_cover(int n, int* staged) {
  tile_cover(n, ed::kResetEnvs, ed::kLanes * ed::kResetEnvs,
             ed::kResetUnits, false, staged);
}

// The arguments of ed_fused_reset (csrc/reset_kernel.cu) without the
// stream, then ``seed``, the noise each env's slot holds before the reset.
// With idx (in place, carry_in == carry_out): ed::reset_column. Without:
// ed::reset_env with the words RESET_READS names of column e loaded, then
// the column out, each word the reset writes from the slot and every
// other copied through from carry_in.
extern "C" void ed_host_fused_reset(const int* carry_in, int* carry_out,
                                    const int* idx, const int* n_players,
                                    const int* xy, const int* req,
                                    const int* nr, const int* end, int n,
                                    int q, uint32_t seed) {
  ed::EnvSlot slot;
  for (int e = 0; e < q; ++e) {
    fill_slot(slot, seed);
    ed::Env& s = slot.env;
    const size_t b = (size_t)e * 4 * ed::kBall;
    if (idx != nullptr) {
      const int col = idx[e];
      ed::reset_column<ed::LoopLanes>(s, carry_out, n, col, n_players[col],
                                      xy + 8 * e, req + b, nr + b, end + b);
      continue;
    }
    const int np = n_players[e];
    ed::reset_env<ed::LoopLanes>(
        s, np, xy + 8 * e, req + b, nr + b, end + b,
        [&](int l) { ed::load_read_set(s, carry_in, q, e, l); });
    const uint32_t* w = ed::write_bits(np);
    for (int f = 0; f < ed::kCarryWords; ++f)
      carry_out[(size_t)f * q + e] = ed::writes_word(w, f)
                                         ? ed::env_word(s, f)
                                         : carry_in[(size_t)f * q + e];
  }
}

// K2's word sets: reads[f] = 1 where RESET_READS names word f;
// writes[(np - 1) * 570 + f]: RESET_WRITES holds word f for np = 1-4.
extern "C" void ed_host_reset_sets(unsigned char* reads,
                                   unsigned char* writes) {
  for (int f = 0; f < ed::kCarryWords; ++f) {
    reads[f] = 0;
    for (int np = 1; np <= 4; ++np)
      writes[(np - 1) * ed::kCarryWords + f] =
          ed::writes_word(ed::write_bits(np), f);
  }
  for (int i = 0; i < ed::kResetReads; ++i) reads[ed::RESET_READS[i]] = 1;
}

// The words and player counts (np = -2 to 6) where the table RESET_WRITES
// and the predicate reset_writes it is built from disagree.
extern "C" int ed_host_write_table_mismatches() {
  int bad = 0;
  for (int np = -2; np <= 6; ++np)
    for (int f = 0; f < ed::kCarryWords; ++f)
      bad += ed::writes_word(ed::write_bits(np), f) != ed::reset_writes(f, np);
  return bad;
}

// out[c] = START_SLOTS[c] and start[c] = START_DISCARD[c] for every card.
extern "C" void ed_host_start_slots(uint32_t* out, int* start) {
  for (int c = 0; c < ed::kCards; ++c) {
    out[c] = ed::START_SLOTS[c];
    start[c] = ed::START_DISCARD[c];
  }
}
