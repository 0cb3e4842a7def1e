// K1-sample: the masked-uniform sampler alone (vec.vec_sample,
// VecEnv.sample).
//
// Replaces eldorado_tpu/vec.py::vec_sample's jax.vmap(E.sample_action)
// (:132-138), which the JAX build leaves to XLA (no Pallas kernel):
// action_sampler::sample (include/sampler.h:14-79) for every env, each
// with its own minstd engine, on the env's packed 3-word mask; with
// ``live``, a done env draws nothing (engine._sample_action_w(live=...)).
// The per-env code is K1's own ed::sample_action (engine.cuh), so the
// sampler a learner calls and the one inside K1 are one function.
//
// Two entries. ed_sample takes the masks as (n, 3) words (vec_sample and
// compat.action_sampler). ed_sample_carry is what the JAX package's
// VecEnv.sample (eldorado_tpu/vec.py:877-882) does in one XLA program,
// here in one launch: thread e reads its agent from the (570, n) carry,
// then its agent's three storage-mask words (or the three sel-mask
// words), samples, and ORs its tainted flag into the carry's rng_tainted
// row in place (a write only where the flag is set).
//
// Design: one thread per env, one warp per block, so that 4096 envs are
// 128 warps on 128 SMs; no shared memory. The chain of one head is two
// dependent engine draws, the scaling and rejection bound of its count of
// set bits (a 23-row table, ed::SMALL_RANGE, with the reciprocal that
// replaces the quotient's division) and one __fns for the picked bit.
//
// What bounds it: neither bytes (42 B an env, 0.17 MB at 4096 envs) nor
// instructions (a few hundred an env) but the latency of each thread's
// chain and of the launch itself, a few microseconds (PERF.md sets the
// time of an empty launch beside it).
#include <cuda_runtime.h>

#include "engine.cuh"

namespace {

constexpr int kSampleThreads = 32;

template <bool kCarry>
__global__ void __launch_bounds__(kSampleThreads)
sample_kernel(const int* __restrict__ srng_in, int* __restrict__ srng_out,
              const int* __restrict__ mask_words, int* __restrict__ carry,
              const unsigned char* __restrict__ live,
              int* __restrict__ actions, unsigned char* __restrict__ tainted,
              int n, int mask_sel) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t rng = (uint32_t)srng_in[e];
  uint32_t m[3];
  if constexpr (kCarry) {
    const int row = mask_sel ? ed::OFF_SEL_MASK
                             : ed::OFF_STORAGE_MASKS
                                   + 3 * carry[(size_t)ed::OFF_AGENT * n + e];
    for (int k = 0; k < 3; ++k)
      m[k] = (uint32_t)carry[(size_t)(row + k) * n + e];
  } else {
    for (int k = 0; k < 3; ++k) m[k] = (uint32_t)mask_words[3 * e + k];
  }
  int act[5], t = 0;
  ed::sample_action(rng, m, live == nullptr || live[e] != 0, act, t);
  srng_out[e] = (int)rng;
  for (int h = 0; h < 5; ++h) actions[5 * e + h] = act[h];
  if constexpr (kCarry) {
    if (t) carry[(size_t)ed::OFF_RNG_TAINTED * n + e] |= 1;
  } else {
    tainted[e] = (unsigned char)t;
  }
}

__global__ void empty_kernel() {}

int blocks(int n) { return (n + kSampleThreads - 1) / kSampleThreads; }

}  // namespace

// srng_in / srng_out (n,) int32 engines; mask_words (n, 3) int32; live
// (n,) bool or null (every env draws); actions (n, 5) int32; tainted (n,)
// bool.
extern "C" int ed_sample(const void* srng_in, void* srng_out,
                         const void* mask_words, const void* live,
                         void* actions, void* tainted, int n, void* stream) {
  if (n <= 0) return 0;
  sample_kernel<false><<<blocks(n), kSampleThreads, 0, (cudaStream_t)stream>>>(
      (const int*)srng_in, (int*)srng_out, (const int*)mask_words, nullptr,
      (const unsigned char*)live, (int*)actions, (unsigned char*)tainted, n,
      0);
  return (int)cudaGetLastError();
}

// The same sampler on each env's active mask read from ``carry`` ((570, n)
// int32): its agent's storage row, or (mask_sel) its sel mask; the
// tainted flags OR into the carry's rng_tainted row in place.
extern "C" int ed_sample_carry(const void* srng_in, void* srng_out,
                               void* carry, const void* live, void* actions,
                               int n, int mask_sel, void* stream) {
  if (n <= 0) return 0;
  sample_kernel<true><<<blocks(n), kSampleThreads, 0, (cudaStream_t)stream>>>(
      (const int*)srng_in, (int*)srng_out, nullptr, (int*)carry,
      (const unsigned char*)live, (int*)actions, nullptr, n, mask_sel);
  return (int)cudaGetLastError();
}

// An empty kernel of n threads in blocks of ``threads``: the launch floor
// a kernel's time is read against (K1-sample's grid at threads == 32; K2's,
// a warp per env, in place at 32 and into a new carry at 32 *
// ed::kResetEnvs).
extern "C" int ed_empty(int n, int threads, void* stream) {
  if (n < 1) n = 1;
  empty_kernel<<<(n + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
