// K2: the reset body after map generation, one warp per queued env.
//
// Replaces the TPU kernel eldorado_tpu/ops/step_kernel.py::make_fused_reset
// (:420, call :533; the Pallas program `fused_reset` -> `_reset_values` ->
// engine.reset_body): for each live player Player::reset (deck redraw from
// the engine stream), the add_players positions, the shop reset, the
// movement and shop masks from the pregathered (4, 19) ball rows, then
// sel_mask and w3_cache.
//
// What bounds it on this card: neither bytes (a 128-env queue reset in
// place must move 0.36 MB, 0.1 us at HBM's rate) nor instructions (about
// 12,000 an env), but each env's chain:
// the column index, then the words read, the lane steps and the draws
// between them, then the words written. The first design ran the chain
// on a thread per env, one warp a block (a 128-env queue on 4 SMs); each
// thread staged its whole 570-word column into shared memory and back, a
// word at a time, and ran the body's 450 writes and 16 draws in sequence,
// though the body reads only nine words of the old column: 0.060 ms per
// 128-env queue and 0.028 at one env on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md).
//
// Design: a warp per env (engine.cuh's reset_env through the lanes of
// lanes.cuh), so a 128-env queue is 128 warps on 128 SMs. The lanes load
// the nine words RESET_READS names beside the first lane step (the words
// that need neither the old column nor the draws: positions, shop,
// counters, w3); every lane then takes one of the deals' draws by jumping
// the engine ahead (all in sequence in the rare case a first attempt is
// rejected) and deals the cards as bits of the start deck; the lanes
// write the piles and masks. In place (``idx``), a warp a block, the
// lanes store back only the words the reset writes, lane l word 32 k + l
// where bit l of word k of its row of RESET_WRITES is set: every other
// word of the column keeps its value, and the columns are unique, so each
// has one writer. Into a new carry (no ``idx``: vec_reset), kResetEnvs
// envs a block write their tile out with neighbouring threads on
// neighbouring envs (tile_plan's word units), each word from the slot
// where the reset wrote it and otherwise from the old column. Those two
// block shapes were the fastest of 1, 4 and 8 envs a block in place and
// of 4, 8 and 16 into a new carry; copying the old carry whole and then
// resetting the copy in place took twice the tile's time. Measured on
// that card: 0.0072-0.0077 ms per queue of 1 to 128 envs, of which 0.0020
// is the launch; 0.019 ms into a new 4096-env carry (0.032 before).
#include <cuda_runtime.h>

#include "engine.cuh"

namespace {

// A new carry's tile of the block's V envs from e0 out: each word the
// env's reset wrote from its slot, every other word copied through from
// the old column in ``in``.
template <int kEnvs>
__device__ __forceinline__ void tile_out(const ed::EnvSlot* slots,
                                         const int* in, int* out,
                                         const int* np, int q, int e0,
                                         const ed::TilePlan& p) {
  constexpr int kThreads = ed::kLanes * kEnvs;
  constexpr int kUnits = ed::kResetUnits;
  const int tid = threadIdx.x;
  for (int pass = 0; pass < p.passes; ++pass) {
    int v[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = ed::tile_unit(p, kThreads, tid, pass, k);
      if (u >= p.units) continue;
      int f, e;
      ed::tile_field_env(p, u, f, e);
      v[k] = ed::writes_word(ed::write_bits(np[e]), f)
                 ? ed::env_word(slots[e].env, f)
                 : __ldg(in + (size_t)f * q + e0 + e);
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = ed::tile_unit(p, kThreads, tid, pass, k);
      if (u >= p.units) continue;
      int f, e;
      ed::tile_field_env(p, u, f, e);
      out[(size_t)f * q + e0 + e] = v[k];
    }
  }
}

// A warp per env: in place (idx) a warp a block, each warp its own
// column; into a new carry ed::kResetEnvs envs a block and their tile.
template <bool kInPlace>
__global__ void __launch_bounds__(ed::kLanes
                                  * (kInPlace ? 1 : ed::kResetEnvs))
fused_reset_kernel(const int* carry_in, int* carry_out,
                   const int* __restrict__ idx,
                   const int* __restrict__ n_players,
                   const int* __restrict__ xy,
                   const int* __restrict__ req, const int* __restrict__ nr,
                   const int* __restrict__ end, int n, int q) {
  constexpr int kEnvs = kInPlace ? 1 : ed::kResetEnvs;
  __shared__ ed::EnvSlot slots[kEnvs];
  const int warp = threadIdx.x / ed::kLanes;
  const int e = blockIdx.x * kEnvs + warp;
  const size_t b = (size_t)e * 4 * ed::kBall;
  ed::Env& s = slots[warp].env;
  if constexpr (kInPlace) {
    if (e >= q) return;
    const int col = idx[e];
    ed::reset_column<ed::WarpLanes>(s, carry_out, n, col, n_players[col],
                                    xy + 8 * (size_t)e, req + b, nr + b,
                                    end + b);
  } else {
    __shared__ int np[kEnvs];
    if (e < q) {
      const int np_e = n_players[e];
      np[warp] = np_e;
      ed::reset_env<ed::WarpLanes>(
          s, np_e, xy + 8 * (size_t)e, req + b, nr + b, end + b,
          [&](int l) { ed::load_read_set(s, carry_in, q, e, l); });
    }
    __syncthreads();
    const int e0 = blockIdx.x * kEnvs, V = min(kEnvs, q - e0);
    constexpr int kThreads = ed::kLanes * kEnvs;
    if (V == kEnvs)  // a full tile: the plan folds at compile time
      tile_out<kEnvs>(slots, carry_in, carry_out, np, q, e0,
                      ed::tile_plan(kEnvs, 1, kThreads, ed::kResetUnits));
    else
      tile_out<kEnvs>(slots, carry_in, carry_out, np, q, e0,
                      ed::tile_plan(V, 1, kThreads, ed::kResetUnits));
  }
}

}  // namespace

// carry_in / carry_out: (570, n), the same tensor for the in-place form;
// idx (q,) unique columns, or null (then n == q and carry_out is a new
// tensor); n_players (n,) read at the column; player_xy (q, 4, 2) and
// req / nr / end (q, 4, 19) at e.
extern "C" int ed_fused_reset(const void* carry_in, void* carry_out,
                              const void* idx, const void* n_players,
                              const void* player_xy, const void* req,
                              const void* nr, const void* end, int n, int q,
                              void* stream) {
  if (q <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int *in = (const int*)carry_in, *ix = (const int*)idx,
            *np = (const int*)n_players, *pxy = (const int*)player_xy,
            *rq = (const int*)req, *rn = (const int*)nr, *re = (const int*)end;
  int* out = (int*)carry_out;
  if (idx != nullptr)
    fused_reset_kernel<true>
        <<<q, ed::kLanes, 0, s>>>(in, out, ix, np, pxy, rq, rn, re, n, q);
  else
    fused_reset_kernel<false><<<(q + ed::kResetEnvs - 1) / ed::kResetEnvs,
                                ed::kLanes * ed::kResetEnvs, 0, s>>>(
        in, out, ix, np, pxy, rq, rn, re, n, q);
  return (int)cudaGetLastError();
}
