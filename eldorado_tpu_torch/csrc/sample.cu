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
// Design: one thread per env, one warp per block, so that 4096 envs are
// 128 warps on 128 SMs (the chain of five heads' draws and bit scans is
// one thread's latency, as in K1); no shared memory. Thread e reads its
// engine, its three mask words and its live flag, and writes its five
// actions, its engine and its tainted flag.
//
// What bounds it: neither bytes (42 B an env, 0.17 MB at 4096 envs) nor
// instructions (a few hundred an env) but the latency of each thread's
// chain and of the launch itself, a few microseconds.
#include <cuda_runtime.h>

#include "engine.cuh"

namespace {

constexpr int kSampleThreads = 32;

__global__ void __launch_bounds__(kSampleThreads)
sample_kernel(const int* __restrict__ srng_in, int* __restrict__ srng_out,
              const int* __restrict__ mask_words,
              const unsigned char* __restrict__ live,
              int* __restrict__ actions, unsigned char* __restrict__ tainted,
              int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t rng = (uint32_t)srng_in[e];
  const uint32_t m[3] = {(uint32_t)mask_words[3 * e],
                         (uint32_t)mask_words[3 * e + 1],
                         (uint32_t)mask_words[3 * e + 2]};
  int act[5], t = 0;
  ed::sample_action(rng, m, live == nullptr || live[e] != 0, act, t);
  srng_out[e] = (int)rng;
  for (int h = 0; h < 5; ++h) actions[5 * e + h] = act[h];
  tainted[e] = (unsigned char)t;
}

}  // namespace

// srng_in / srng_out (n,) int32 engines; mask_words (n, 3) int32; live
// (n,) bool or null (every env draws); actions (n, 5) int32; tainted (n,)
// bool.
extern "C" int ed_sample(const void* srng_in, void* srng_out,
                         const void* mask_words, const void* live,
                         void* actions, void* tainted, int n, void* stream) {
  if (n <= 0) return 0;
  sample_kernel<<<(n + kSampleThreads - 1) / kSampleThreads, kSampleThreads,
                  0, (cudaStream_t)stream>>>(
      (const int*)srng_in, (int*)srng_out, (const int*)mask_words,
      (const unsigned char*)live, (int*)actions, (unsigned char*)tainted, n);
  return (int)cudaGetLastError();
}
