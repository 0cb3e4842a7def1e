// K1's per-env work (ed::run_steps of eldorado_tpu_torch/csrc/engine.cuh)
// as a host function, for tests/test_torch_engine_host.py: g++ builds it,
// ctypes loads it. Each env is staged into an EnvSlot of a host array
// (the kernel's shared-memory slot, padded stride and all), stepped, and
// written back, with the kernel's argument layout. Beside it the per-env
// work of K1-act (csrc/step_actions.cu: ed::actions_in_heads, then
// ed::step_given) and of K1-sample (csrc/sample.cu: ed::sample_action);
// the sampler's SMALL_RANGE table and nth_set_bit (rng.cuh, engine.cuh);
// and K1-act's block staging plan (ed::tile_plan and its kin), looped as
// the kernel loops it.
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

// K1-act's staging over an n-env carry in blocks of ed::kActEnvs envs
// and ed::kActWarps warps, as the kernel runs it; ``vec_ok``: the carries
// are 16-byte aligned. Adds 1 to staged[f * n + e] for every (field, env)
// a unit moves in (the way out is the same plan).
extern "C" void ed_host_tile_cover(int n, int vec_ok, int* staged) {
  const int G = ed::kActEnvs, threads = 32 * ed::kActWarps;
  const bool vec = vec_ok && n % 4 == 0;
  for (int e0 = 0; e0 < n; e0 += G) {
    const int V = G < n - e0 ? G : n - e0;
    const ed::TilePlan p = ed::tile_plan(V, vec ? 4 : 1, threads,
                                         ed::kActUnits);
    for (int pass = 0; pass < p.passes; ++pass)
      for (int k = 0; k < ed::kActUnits; ++k)
        for (int tid = 0; tid < threads; ++tid) {
          const int u = ed::tile_unit(p, threads, tid, pass, k);
          if (u >= p.units) continue;
          int f, e;
          ed::tile_field_env(p, u, f, e);
          for (int j = 0; j < p.width; ++j) ++staged[f * n + e0 + e + j];
        }
  }
}
