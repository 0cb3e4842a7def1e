// The cost probes of K1: P1 null copy, P2 op chain, P3 step prefix.
//
// They replace the TPU probes of tools/ (each a Pallas program timed by
// differencing two step counts) and answer the same question on this card:
// what bounds K1. The wrappers, the plain versions and the checksum's
// definition are in eldorado_tpu_torch/ops/probes.py; the timing tools in
// eldorado_tpu_torch/tools/.
//
// P1 `ed_null_copy` replaces tools/tpu_null_kernel.py (`kernel`, the
// pallas_call at :105): every word of K1's carry in and out, the floor of
// moving the state. A grid-stride copy of the (570, n) int32 carry, 16 bytes
// a thread per access where the word count and both pointers allow it,
// neighbouring threads on neighbouring addresses. Bytes bound it: at 4096
// envs 9.3 MB in and 9.3 MB out, which fit in the 50 MB L2, so the tools
// evict the L2 before each timed launch. The TPU kernel
// also read its hoisted constants; they have no counterpart here, because
// engine.cuh keeps its tables in __constant__ memory.
//
// P2 `ed_op_chain` replaces tools/tpu_op_cost.py::build (the pallas_call at
// :62): k dependent int32 ops on one operand shape, one thread per element,
// exactly the tool's body. The arithmetic runs on uint32_t (signed overflow
// is undefined in C++; int32 wraps in JAX and torch) and `>>` on the signed
// value, which is arithmetic as in JAX. k is a template argument over the
// few values the tools and tests use (the switch in ed_op_chain, which
// ops/probes.OP_CHAIN_K mirrors) and the chain is fully unrolled, so no
// loop counter is counted as op cost. A single chain is latency-bound at
// small shapes and issue-bound once the card is full.
//
// P3 `ed_step_prefix` replaces tools/tpu_prefix_profile.py (`kernel2`, the
// pallas_call at :178). The TPU probe cut a jaxpr plan the port does not
// have; this one cuts K1 at the boundaries of ed::sample_step (engine.cuh,
// ed::step_prefix): 0 load, 1 sample, 2 ball read, 3 the whole step. The
// per-step cost against the cut splits K1's time among staging, sampling,
// the gather and the step body. Same layout as K1, so that the cuts still
// describe K1's time: one thread per env, one warp per block, each env in
// its shared-memory slot (step_kernel.cuh); like K1 latency-bound.
#include <cuda_runtime.h>

#include "step_kernel.cuh"

namespace {

// ---- P1 -------------------------------------------------------------------
__global__ void __launch_bounds__(256)
null_copy_vec4(const int4* __restrict__ in, int4* __restrict__ out,
               size_t count) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += stride)
    out[i] = in[i];
}

__global__ void __launch_bounds__(256)
null_copy_word(const int* __restrict__ in, int* __restrict__ out,
               size_t count) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += stride)
    out[i] = in[i];
}

// ---- P2 -------------------------------------------------------------------
template <int kPairs, bool kSel>
__global__ void __launch_bounds__(128)
op_chain_kernel(const int* __restrict__ x, const int* __restrict__ y,
                int* __restrict__ out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  uint32_t v = (uint32_t)x[i], w = (uint32_t)y[i];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    if (kSel) {  // v = (v & 3) > 1 ? v + w : v - w;  w ^= v >> 1
      v = (v & 3u) > 1u ? v + w : v - w;
      w ^= (uint32_t)((int32_t)v >> 1);
    } else {     // v += w;  w ^= v
      v += w;
      w ^= v;
    }
  }
  out[i] = (int)(v + w);
}

template <int kPairs>
cudaError_t launch_op_chain(const int* x, const int* y, int* out, int count,
                            int sel, cudaStream_t stream) {
  const int threads = 128, blocks = (count + threads - 1) / threads;
  if (sel)
    op_chain_kernel<kPairs, true><<<blocks, threads, 0, stream>>>(x, y, out,
                                                                  count);
  else
    op_chain_kernel<kPairs, false><<<blocks, threads, 0, stream>>>(x, y, out,
                                                                   count);
  return cudaGetLastError();
}

// ---- P3 -------------------------------------------------------------------
template <int kCut>
__global__ void __launch_bounds__(ed::kStepThreads)
step_prefix_kernel(const int* __restrict__ carry,
                   const int* __restrict__ srng_in,
                   const int* __restrict__ map_ids,
                   const int* __restrict__ min_xy,
                   const int* __restrict__ n_players,
                   const int* __restrict__ max_steps, int* __restrict__ out,
                   int n, int n_steps) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  ed::Env& s = ed::env_slot();
  ed::load_env(s, carry, n, e);
  uint32_t srng = (uint32_t)srng_in[e];
  out[e] = (int)ed::step_prefix<kCut>(
      s, srng, map_ids + (size_t)e * ed::kMapCells, min_xy[2 * e],
      min_xy[2 * e + 1], n_players[e], max_steps[e], n_steps);
}

}  // namespace

extern "C" int ed_null_copy(const void* in, void* out, int rows, int n,
                            void* stream) {
  const size_t count = (size_t)rows * n;
  if (count == 0) return 0;
  const int threads = 256, max_blocks = 132 * 8;  // 8 blocks on each SM
  const bool vec4 = count % 4 == 0
                    && ((uintptr_t)in | (uintptr_t)out) % 16 == 0;
  const size_t items = vec4 ? count / 4 : count;
  size_t blocks = (items + threads - 1) / threads;
  if (blocks > (size_t)max_blocks) blocks = max_blocks;
  if (vec4)
    null_copy_vec4<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int4*)in, (int4*)out, items);
  else
    null_copy_word<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)in, (int*)out, items);
  return (int)cudaGetLastError();
}

// k: one of ops/probes.OP_CHAIN_K; sel: 0 for the add chain, 1 for sel
extern "C" int ed_op_chain(const void* x, const void* y, void* out, int count,
                           int k, int sel, void* stream) {
  if (count <= 0) return 0;
  const int* xi = (const int*)x;
  const int* yi = (const int*)y;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 2: return (int)launch_op_chain<1>(xi, yi, o, count, sel, st);
    case 6: return (int)launch_op_chain<3>(xi, yi, o, count, sel, st);
    case 64: return (int)launch_op_chain<32>(xi, yi, o, count, sel, st);
    case 4096: return (int)launch_op_chain<2048>(xi, yi, o, count, sel, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ed_step_prefix(const void* carry, const void* srng,
                              const void* map_ids, const void* min_xy,
                              const void* n_players, const void* max_steps,
                              void* out, int n, int n_steps, int cut,
                              void* stream) {
  if (n <= 0) return 0;
  const int* c = (const int*)carry;
  const int* r = (const int*)srng;
  const int* m = (const int*)map_ids;
  const int* xy = (const int*)min_xy;
  const int* np = (const int*)n_players;
  const int* ms = (const int*)max_steps;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cut) {
    case 0: return ed::launch_slotted<step_prefix_kernel<0>>(
        n, st, c, r, m, xy, np, ms, (int*)out, n, n_steps);
    case 1: return ed::launch_slotted<step_prefix_kernel<1>>(
        n, st, c, r, m, xy, np, ms, (int*)out, n, n_steps);
    case 2: return ed::launch_slotted<step_prefix_kernel<2>>(
        n, st, c, r, m, xy, np, ms, (int*)out, n, n_steps);
    case 3: return ed::launch_slotted<step_prefix_kernel<3>>(
        n, st, c, r, m, xy, np, ms, (int*)out, n, n_steps);
    default: return (int)cudaErrorInvalidValue;
  }
}
