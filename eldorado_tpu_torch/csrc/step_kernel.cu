// K1: the fused sample + step kernel, a whole rollout chunk per launch.
//
// Replaces the TPU kernel eldorado_tpu/ops/step_kernel.py::make_fused_step
// (the Pallas program `fused_blocked`, body `kernel` -> `_step_values` ->
// engine.fused_sample_step). Per env it samples the five action heads from
// the storage or sel mask and runs the whole game step; it computes what
// the Pallas kernel computes, not its block structure.
//
// Design: one thread per env, and the T-step chunk loop runs inside the
// launch, so the env's 570-word state is read from the field-major carry
// once (coalesced: word f of env e at carry[f * n + e]), kept in the
// thread's registers / local memory for T steps, and written once. Each
// step reads the agent's 19-cell ball straight from the env's (2304,) id
// plane (at 4096 envs the planes are 37.7 MB, inside the 50 MB L2), so no
// per-step table is built. The step itself is branchy scalar integer code:
// what bounds it on this card is latency and divergence, not bytes or
// FLOPs. At 4096 envs a launch is 32 blocks of 128 threads, about one warp
// per SM on the H100's 132 SMs, so occupancy is low; raising it is later
// work (ROADMAP).
//
// K1-null (kNull = true) replaces make_fused_step(null_body=True)
// (step_kernel.py:624-630): the same launch and the same staging of each
// env through load_env / store_env, but no step, so the carry and srng come
// out unchanged, the actions zero and `dead` untouched. It reads K1's
// launch and state-staging floor; P1 (probes.cu) reads the bare copy rate.
#include <cuda_runtime.h>

#include "engine.cuh"

namespace {

template <bool kNull>
__global__ void __launch_bounds__(128)
fused_step_kernel(const int* __restrict__ carry_in, int* __restrict__ carry_out,
                  const int* __restrict__ srng_in, int* __restrict__ srng_out,
                  const int* __restrict__ map_ids, const int* __restrict__ min_xy,
                  const int* __restrict__ n_players,
                  const int* __restrict__ max_steps, int* __restrict__ actions,
                  unsigned long long* dead, int n, int n_steps, int mask_sel,
                  int gate_dead) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  ed::Env s;
  ed::load_env(s, carry_in, n, e);
  uint32_t srng = (uint32_t)srng_in[e];
  int act[5] = {0, 0, 0, 0, 0};
  unsigned long long n_dead = 0;
  if constexpr (!kNull) {
    const int* map = map_ids + (size_t)e * ed::kMapCells;
    const int mx = min_xy[2 * e], my = min_xy[2 * e + 1];
    const int np = n_players[e], ms = max_steps[e];
    for (int t = 0; t < n_steps; ++t) {
      n_dead += s.done;  // a step is dead when the env is done at entry
      ed::sample_step(s, srng, map, mx, my, np, ms, mask_sel, gate_dead,
                      act);
    }
  }
  ed::store_env(s, carry_out, n, e);
  srng_out[e] = (int)srng;
  for (int h = 0; h < 5; ++h) actions[5 * e + h] = act[h];
  if (dead != nullptr && n_dead) atomicAdd(dead, n_dead);
}

}  // namespace

extern "C" int ed_fused_step(const void* carry_in, void* carry_out,
                             const void* srng_in, void* srng_out,
                             const void* map_ids, const void* min_xy,
                             const void* n_players, const void* max_steps,
                             void* actions, void* dead, int n, int n_steps,
                             int mask_sel, int gate_dead, int null_body,
                             void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  auto kernel = null_body ? fused_step_kernel<true> : fused_step_kernel<false>;
  kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const int*)carry_in, (int*)carry_out, (const int*)srng_in,
      (int*)srng_out, (const int*)map_ids, (const int*)min_xy,
      (const int*)n_players, (const int*)max_steps, (int*)actions,
      (unsigned long long*)dead, n, n_steps, mask_sel, gate_dead);
  return (int)cudaGetLastError();
}
