// K1: the fused sample + step kernel, a whole rollout chunk per launch.
//
// The kernel template and its launcher. step_kernel.cu instantiates the
// record-free K1 and K1-null and holds the C entry; step_compact.cu and
// step_full.cu instantiate the two record widths, so that nvcc builds the
// three large instantiations in parallel.
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
//
// The learner feed (kRecord = 5 or 40 words; stream.py): the JAX package
// packs each step's records in XLA after every one-step Pallas call
// (eldorado_tpu/vec.py:366-383). Here one launch runs a whole chunk, so
// only the kernel sees each step's post-step state: after every step,
// thread e writes its record to records[(t * n + e) * kRecord + w], the
// (T, n, kRecord) layout of the JAX package's unblock_packed. A step's
// records are kRecord * 4 bytes per env: at 4096 envs, 40 words are
// 0.66 MB per step; at K1's ~55 us per step (H100 80GB HBM3, 700 W;
// PERF.md) that is about 12 GB/s, far below HBM's rate, so the cost to
// watch is registers and stack, not bytes. The writes are strided by
// kRecord words across a warp; coalescing them is later work. kRecord = 0
// is the record-free K1, unchanged.
#pragma once

#include <cuda_runtime.h>

#include "engine.cuh"

namespace ed {

template <bool kNull, int kRecord>
__global__ void __launch_bounds__(128)
fused_step_kernel(const int* __restrict__ carry_in, int* __restrict__ carry_out,
                  const int* __restrict__ srng_in, int* __restrict__ srng_out,
                  const int* __restrict__ map_ids, const int* __restrict__ min_xy,
                  const int* __restrict__ n_players,
                  const int* __restrict__ max_steps, int* __restrict__ actions,
                  unsigned long long* dead, int* __restrict__ records, int n,
                  int n_steps, int mask_sel, int gate_dead) {
  static_assert(!(kNull && kRecord), "K1-null writes no records");
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  Env s;
  load_env(s, carry_in, n, e);
  uint32_t srng = (uint32_t)srng_in[e];
  int act[5] = {0, 0, 0, 0, 0};
  unsigned long long n_dead = 0;
  if constexpr (!kNull) {
    const int* map = map_ids + (size_t)e * kMapCells;
    const int mx = min_xy[2 * e], my = min_xy[2 * e + 1];
    const int np = n_players[e], ms = max_steps[e];
    for (int t = 0; t < n_steps; ++t) {
      n_dead += s.done;  // a step is dead when the env is done at entry
      const int p_pre = s.agent;
      sample_step(s, srng, map, mx, my, np, ms, mask_sel, gate_dead,
                      act);
      if constexpr (kRecord > 0)
        write_record<kRecord>(s, act, p_pre,
                                  records + ((size_t)t * n + e) * kRecord);
    }
  }
  store_env(s, carry_out, n, e);
  srng_out[e] = (int)srng;
  for (int h = 0; h < 5; ++h) actions[5 * e + h] = act[h];
  if (dead != nullptr && n_dead) atomicAdd(dead, n_dead);
}

// The kernel's arguments, as the C entry receives them.
struct StepArgs {
  const int* carry_in;
  int* carry_out;
  const int* srng_in;
  int* srng_out;
  const int* map_ids;
  const int* min_xy;
  const int* n_players;
  const int* max_steps;
  int* actions;
  unsigned long long* dead;
  int* records;
  int n, n_steps, mask_sel, gate_dead;
};

template <bool kNull, int kRecord>
int launch_fused_step(const StepArgs& a, cudaStream_t stream) {
  const int threads = 128;
  fused_step_kernel<kNull, kRecord>
      <<<(a.n + threads - 1) / threads, threads, 0, stream>>>(
          a.carry_in, a.carry_out, a.srng_in, a.srng_out, a.map_ids,
          a.min_xy, a.n_players, a.max_steps, a.actions, a.dead, a.records,
          a.n, a.n_steps, a.mask_sel, a.gate_dead);
  return (int)cudaGetLastError();
}

// step_compact.cu and step_full.cu
int launch_fused_step_compact(const StepArgs& a, cudaStream_t stream);
int launch_fused_step_full(const StepArgs& a, cudaStream_t stream);

}  // namespace ed
