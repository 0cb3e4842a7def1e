// K1-act: one step of every env with the caller's actions (vec.vec_step).
//
// Replaces eldorado_tpu/vec.py::vec_step's jax.vmap(E.step_env) (:116-129),
// which the JAX build leaves to XLA (no Pallas kernel): engine.step_env on
// every env, a done env dead-stepping. It is K1 without the sampler, one
// step a launch, the learner choosing the actions between launches.
//
// Each env is staged into an EnvSlot of shared memory (K1's odd-stride
// slots), stepped there by ed::step_given with its row of the (n, 5)
// actions, and staged out into a new carry, so a caller that refuses the
// step still holds the carry it passed. The actions come from the
// learner, so the kernel checks them first: an env whose action lies
// outside its head (ed::actions_in_heads) is not stepped, and its column
// goes through unchanged, so no table is indexed out of its bounds. The
// block adds its count of such envs to counts[0] and its count of envs
// done after the step to counts[1] (one atomic each, and none for a zero);
// block 0 writes to counts[2] whether the staging ran by 16-byte vectors
// (1) or by words (0). The wrapper reads the three in one copy, raises on
// the first, and hands the second to vec_step's reset.
//
// What bounds it on this card: bytes. One step a launch reads and writes
// each env's whole 570-word column, 4.6 KB an env (18.7 MB at 4096 envs,
// 5.6 us at HBM's 3.35 TB/s), while the step itself is about 2700
// instructions an env. Staged as K1 stages (thread e alone moving its
// column a word at a time, load_env / store_env, one warp a block), one
// load is in flight per thread, and a step costs the staging floor
// (K1-null, about 19 us at 4096 envs) plus one step's chain (about 8 us).
//
// So the kernel stages with the whole block (engine.cuh's kActEnvs = 16
// envs, kActWarps = 8 warps): together the 256 threads copy the (570, 16)
// tile of the carry into the 16 slots, unit by unit as ed::tile_plan
// numbers them: 16-byte vectors (four envs of one field row) when n is a
// multiple of 4 and both carries 16-byte aligned, otherwise words, a
// branch inside the kernel. Every thread issues the kActUnits loads of its
// pass (non-coherent, not allocating in L1) before its shared stores, P1's
// pattern, which halves the staging floor; the way out is the same with
// 16-byte streaming stores. At n = 1 (cog_env) the block's threads share
// the 570 words. Warp 0 steps the 16 envs on its first 16 lanes: the step
// keeps a stack frame in local memory, a cache line per word per warp
// whatever its live lanes, so a step spread over many thin warps cost
// several times more with a cold L2. It was the fastest of 17 launch
// shapes measured on the H100 (PERF.md: envs per block, warps, stepping
// warps, a warp-specialized block and TMA boxes).
#include <cuda_runtime.h>

#include "step_kernel.cuh"

namespace {

constexpr int kEnvs = ed::kActEnvs, kThreads = 32 * ed::kActWarps;
constexpr int kUnits = ed::kActUnits;
constexpr int kSmemBytes = kEnvs * ed::kSlotBytes;
static_assert(kEnvs % 4 == 0 && kEnvs <= 32, "16-byte units, warp 0 steps");
static_assert(kSmemBytes <= 48 * 1024, "no opt-in to more shared memory");

__device__ __forceinline__ int4 load_stream(const int* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The tile of the envs [e0, e0 + p.per_field * p.width) of the carry into
// the slots (kIn: from ``in``), or out of them (!kIn: into ``out``).
template <bool kIn, bool kVec>
__device__ __forceinline__ void tile_move(int* slots, const int* in, int* out,
                                          int n, int e0,
                                          const ed::TilePlan& p) {
  constexpr int W = ed::kSlotWords;
  const int tid = threadIdx.x;
  for (int pass = 0; pass < p.passes; ++pass) {
    if constexpr (kVec) {
      int4 v[kUnits];
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const int u = ed::tile_unit(p, kThreads, tid, pass, k);
        if (u >= p.units) continue;
        int f, e;
        ed::tile_field_env(p, u, f, e);
        if constexpr (kIn) {
          v[k] = load_stream(in + (size_t)f * n + e0 + e);
        } else {
          const int* w = slots + e * W + f;
          v[k] = make_int4(w[0], w[W], w[2 * W], w[3 * W]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const int u = ed::tile_unit(p, kThreads, tid, pass, k);
        if (u >= p.units) continue;
        int f, e;
        ed::tile_field_env(p, u, f, e);
        if constexpr (kIn) {
          int* w = slots + e * W + f;
          w[0] = v[k].x;
          w[W] = v[k].y;
          w[2 * W] = v[k].z;
          w[3 * W] = v[k].w;
        } else {
          __stcs(reinterpret_cast<int4*>(out + (size_t)f * n + e0 + e),
                 v[k]);
        }
      }
    } else {
      int v[kUnits];
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const int u = ed::tile_unit(p, kThreads, tid, pass, k);
        if (u >= p.units) continue;
        int f, e;
        ed::tile_field_env(p, u, f, e);
        v[k] = kIn ? in[(size_t)f * n + e0 + e] : slots[e * W + f];
      }
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const int u = ed::tile_unit(p, kThreads, tid, pass, k);
        if (u >= p.units) continue;
        int f, e;
        ed::tile_field_env(p, u, f, e);
        if constexpr (kIn)
          slots[e * W + f] = v[k];
        else
          out[(size_t)f * n + e0 + e] = v[k];
      }
    }
  }
}

// The block's V envs from e0, in or out: by 16-byte units when ``vec``
// (a full tile with its plan folded at compile time), else by words.
template <bool kIn>
__device__ __forceinline__ void tile_stage(int* slots, const int* in,
                                           int* out, int n, int e0, int V,
                                           bool vec) {
  if (vec && V == kEnvs)
    tile_move<kIn, true>(slots, in, out, n, e0,
                         ed::tile_plan(kEnvs, 4, kThreads, kUnits));
  else if (vec)
    tile_move<kIn, true>(slots, in, out, n, e0,
                         ed::tile_plan(V, 4, kThreads, kUnits));
  else
    tile_move<kIn, false>(slots, in, out, n, e0,
                          ed::tile_plan(V, 1, kThreads, kUnits));
}

__global__ void __launch_bounds__(kThreads)
step_actions_kernel(const int* __restrict__ carry_in,
                    int* __restrict__ carry_out,
                    const int* __restrict__ actions,
                    const int* __restrict__ map_ids,
                    const int* __restrict__ min_xy,
                    const int* __restrict__ n_players,
                    const int* __restrict__ max_steps,
                    int* __restrict__ counts, int n) {
  extern __shared__ int ed_slots[];
  const int e0 = blockIdx.x * kEnvs;
  const int V = min(kEnvs, n - e0);
  // n % 4 == 0 makes every unit's address 16-byte aligned
  const bool vec = n % 4 == 0
                   && (((size_t)carry_in | (size_t)carry_out) & 15) == 0;
  const int le = threadIdx.x;  // warp 0's first kEnvs lanes step
  const bool stepped = le < V;
  // the step's other inputs, read before the staging so that their loads
  // are in flight beside its loads instead of starting the step's chain
  const int e = e0 + le;
  int act[5], mx = 0, my = 0, np = 0, ms = 0;
  if (stepped) {
    for (int h = 0; h < 5; ++h) act[h] = actions[5 * e + h];
    mx = min_xy[2 * e];
    my = min_xy[2 * e + 1];
    np = n_players[e];
    ms = max_steps[e];
  }
  tile_stage<true>(ed_slots, carry_in, carry_out, n, e0, V, vec);
  __syncthreads();
  bool ok = true, done = false;
  if (stepped) {
    ed::Env& s = reinterpret_cast<ed::EnvSlot*>(ed_slots)[le].env;
    ok = ed::actions_in_heads(act);
    if (ok)
      ed::step_given(s, act, map_ids + (size_t)e * ed::kMapCells, mx, my, np,
                     ms);
    done = s.done != 0;
  }
  const int bad = __syncthreads_count(stepped && !ok);
  const int n_done = __syncthreads_count(stepped && done);
  tile_stage<false>(ed_slots, carry_in, carry_out, n, e0, V, vec);
  if (threadIdx.x == 0) {
    if (bad) atomicAdd(&counts[0], bad);
    if (n_done) atomicAdd(&counts[1], n_done);
    if (blockIdx.x == 0) counts[2] = vec;
  }
}

}  // namespace

// carry_in / carry_out: (570, n) int32, two tensors; actions (n, 5);
// map_ids (n, 2304), min_xy (n, 2), n_players / max_steps (n,); counts
// (3,) int32, the first two zeroed by the caller: envs refused for their
// actions, envs done after the step, and whether the staging ran by
// 16-byte vectors.
extern "C" int ed_step_actions(const void* carry_in, void* carry_out,
                               const void* actions, const void* map_ids,
                               const void* min_xy, const void* n_players,
                               const void* max_steps, void* counts, int n,
                               void* stream) {
  if (n <= 0) return 0;
  step_actions_kernel<<<(n + kEnvs - 1) / kEnvs, kThreads, kSmemBytes,
                        (cudaStream_t)stream>>>(
      (const int*)carry_in, (int*)carry_out, (const int*)actions,
      (const int*)map_ids, (const int*)min_xy, (const int*)n_players,
      (const int*)max_steps, (int*)counts, n);
  return (int)cudaGetLastError();
}
