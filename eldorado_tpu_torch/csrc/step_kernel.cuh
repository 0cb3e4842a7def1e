// K1: the fused sample + step kernel, a whole rollout chunk per launch.
//
// The kernel template and its launcher. step_kernel.cu instantiates the
// record-free K1 and K1-null and holds the C entry; step_compact.cu,
// step_full.cu and step_traj.cu instantiate the three record widths, so
// that nvcc builds the large instantiations in parallel.
//
// Replaces the TPU kernel eldorado_tpu/ops/step_kernel.py::make_fused_step
// (the Pallas program `fused_blocked`, body `kernel` -> `_step_values` ->
// engine.fused_sample_step). Per env it samples the five action heads from
// the storage or sel mask and runs the whole game step; it computes what
// the Pallas kernel computes, not its block structure.
//
// Design: one thread per env, and the T-step chunk loop runs inside the
// launch (run_steps), so the env's 570-word state is read from the
// field-major carry once (coalesced: word f of env e at carry[f * n + e])
// and written once. Each step reads the agent's 19-cell ball straight from
// the env's (2304,) id plane, so no per-step table is built.
//
// What bounds it on this card (PERF.md's kernel table, NVIDIA H100 80GB
// HBM3 at 700 W): not bytes (a 1500-step launch at 4096 envs moves about
// 56 MB, 0.01 us per step at HBM's rate) and not the instruction count
// (2668 PTX instructions per env-step, 1944 of them integer: 0.48 us per
// step on the int32 lanes), but the latency of the step body, branchy
// scalar integer code that reads and writes the env's state at every
// turn. So the state has
// to sit in the fastest memory a thread can index: kept in local memory
// (a 3552-byte stack frame per thread), K1's time per step followed the
// stack bytes resident per SM, from 0.012 ms at 113 KB per SM to
// 0.055-0.128 ms at 455 KB and more, beyond the SM's 256 KB of L1.
//
// This layout: one warp per block, so 4096 envs are 128 blocks on 128
// SMs; each thread's Env lives in its EnvSlot of the block's dynamic
// shared memory (load_env / store_env stage it in and out; 32 slots are
// 73,088 B, above the default 48 KB, hence allow_slots), padded to an odd
// stride of 571 words so that a warp's 32 accesses to one field fall in
// 32 banks; and the acting player's View refers into the slot instead of
// copying about 170 words in and out every step. What stays in local
// memory is the step's small scratch (ball rows, prefix sums), which fits
// in L1. Up to 3 blocks fit on an SM (3 x 73,088 B of its 228 KB), so
// 12,672 envs run in one wave; beyond that, e.g. 16384 envs (512 blocks,
// 396 resident), a second wave follows the first, and the time per step
// doubles with the envs (the rate per env stays). K1 then takes 7.6 us
// per step at 4096 envs, 16x its instruction bound: what is left is one
// warp's dependent chain and its divergence, one warp per SM.
//
// K1-null (kNull = true) replaces make_fused_step(null_body=True)
// (step_kernel.py:624-630): the same launch and the same staging of each
// env through load_env / store_env, but no step, so the carry and srng come
// out unchanged, the actions zero and `dead` untouched. It stages through
// the same shared slots, so it reads K1's launch and state-staging floor;
// P1 (probes.cu) reads the bare copy rate.
//
// The learner feed (kRecord = 5 or 40 words; stream.py): the JAX package
// packs each step's records in XLA after every one-step Pallas call
// (eldorado_tpu/vec.py:366-383). Here one launch runs a whole chunk, so
// only the kernel sees each step's post-step state: after every step,
// thread e writes its record to records[(t * n + e) * kRecord + w], the
// (T, n, kRecord) layout of the JAX package's unblock_packed. A step's
// records are kRecord * 4 bytes per env: at 4096 envs, 40 words are
// 0.66 MB per step, far below HBM's rate at K1's time per step, so the
// cost to watch is registers, not bytes. The writes are strided by kRecord
// words across a warp; coalescing them is later work. kRecord = 11 is the
// trajectory record of vec.rollout (the per-step outputs of the JAX
// package's rollout, eldorado_tpu/vec.py:169), the f32 fields whole.
// kRecord = 0 is the record-free K1.
#pragma once

#include <cuda_runtime.h>

#include "engine.cuh"

namespace ed {

// One env per thread, kStepThreads threads (one warp) per block, and each
// thread's env in its EnvSlot of the block's dynamic shared memory.
constexpr int kStepThreads = 32;
constexpr int kSlotBytes = 4 * kSlotWords;
constexpr int kStepSmemBytes = kStepThreads * kSlotBytes;

// This thread's env: its slot of the block's dynamic shared memory.
__device__ __forceinline__ Env& env_slot() {
  extern __shared__ int ed_slots[];
  return reinterpret_cast<EnvSlot*>(ed_slots)[threadIdx.x].env;
}

// Lets kKernel take kStepSmemBytes of dynamic shared memory, more than the
// 48 KB a launch gets by default. Set before every launch: it costs the
// host microseconds, and K1 launches once per chunk.
template <auto kKernel>
cudaError_t allow_slots() {
  return cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStepSmemBytes);
}

// A launch of kKernel over n envs in slotted blocks.
template <auto kKernel, typename... Args>
int launch_slotted(int n, cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_slots<kKernel>();
  if (err != cudaSuccess) return (int)err;
  kKernel<<<(n + kStepThreads - 1) / kStepThreads, kStepThreads,
            kStepSmemBytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <bool kNull, int kRecord>
__global__ void __launch_bounds__(kStepThreads)
fused_step_kernel(const int* __restrict__ carry_in, int* __restrict__ carry_out,
                  const int* __restrict__ srng_in, int* __restrict__ srng_out,
                  const int* __restrict__ map_ids, const int* __restrict__ min_xy,
                  const int* __restrict__ n_players,
                  const int* __restrict__ max_steps, int* __restrict__ actions,
                  unsigned long long* dead, int* __restrict__ records, int n,
                  int n_steps, int mask_sel, int gate_dead) {
  static_assert(!(kNull && kRecord), "K1-null writes no records");
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;  // the ragged last block
  Env& s = env_slot();
  load_env(s, carry_in, n, e);
  uint32_t srng = (uint32_t)srng_in[e];
  int act[5] = {0, 0, 0, 0, 0};
  unsigned long long n_dead = 0;
  if constexpr (!kNull)
    n_dead = run_steps<kRecord>(
        s, srng, map_ids + (size_t)e * kMapCells, min_xy[2 * e],
        min_xy[2 * e + 1], n_players[e], max_steps[e], mask_sel, gate_dead,
        n_steps, act, kRecord ? records + (size_t)e * kRecord : nullptr,
        (size_t)n * kRecord);
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
  return launch_slotted<fused_step_kernel<kNull, kRecord>>(
      a.n, stream, a.carry_in, a.carry_out, a.srng_in, a.srng_out,
      a.map_ids, a.min_xy, a.n_players, a.max_steps, a.actions, a.dead,
      a.records, a.n, a.n_steps, a.mask_sel, a.gate_dead);
}

// step_compact.cu, step_full.cu and step_traj.cu
int launch_fused_step_compact(const StepArgs& a, cudaStream_t stream);
int launch_fused_step_full(const StepArgs& a, cudaStream_t stream);
int launch_fused_step_traj(const StepArgs& a, cudaStream_t stream);

}  // namespace ed
