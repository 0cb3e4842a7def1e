// K1's per-env work (ed::run_steps of eldorado_tpu_torch/csrc/engine.cuh)
// as a host function, for tests/test_torch_engine_host.py: g++ builds it,
// ctypes loads it. Each env is staged into an EnvSlot of a host array
// (the kernel's shared-memory slot, padded stride and all), stepped, and
// written back, with the kernel's argument layout. Beside it the per-env
// work of K1-act (csrc/step_actions.cu: ed::actions_in_heads, then
// ed::step_given) and of K1-sample (csrc/sample.cu: ed::sample_action).
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
