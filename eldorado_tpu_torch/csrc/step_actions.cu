// K1-act: one step of every env with the caller's actions (vec.vec_step).
//
// Replaces eldorado_tpu/vec.py::vec_step's jax.vmap(E.step_env) (:116-129),
// which the JAX build leaves to XLA (no Pallas kernel): engine.step_env on
// every env, a done env dead-stepping. It is K1 without the sampler, one
// step a launch, the learner choosing the actions between launches.
//
// Design: K1's layout (step_kernel.cuh): one thread per env, one warp per
// block, each env's Env in its EnvSlot of dynamic shared memory; thread e
// stages column e of the (570, n) carry in (load_env), runs ed::step_given
// with row e of the (n, 5) actions, and stages the column out into a new
// carry (store_env), so a caller that refuses the step still holds the
// carry it passed. The actions come from the learner, so the kernel checks
// them first: an env whose action lies outside its head
// (ed::actions_in_heads) is not stepped, and its column goes through
// unchanged, so no table is indexed out of its bounds. Each warp adds its
// count of such envs to counts[0] and its count of envs done after the
// step to counts[1] (a ballot, one atomic a warp); the wrapper reads both
// in one copy, raises on the first, and hands the second to vec_step's
// reset.
//
// What bounds it on this card: bytes. One step a launch reads and writes
// each env's whole 570-word column, 4.6 KB an env (18.7 MB at 4096 envs,
// 5.6 us at HBM's 3.35 TB/s), while the step itself is about 2700
// instructions an env (0.5 us on the int32 lanes at 4096 envs). With one
// warp on each SM and one load in flight per thread the staging is far
// from HBM's rate: K1-null, the same staging without a step, takes about
// 19 us at 4096 envs (PERF.md). So K1-act is that staging floor plus one
// step's latency chain; K1 pays the staging once per chunk instead.
#include <cuda_runtime.h>

#include "step_kernel.cuh"

namespace {

__global__ void __launch_bounds__(ed::kStepThreads)
step_actions_kernel(const int* __restrict__ carry_in,
                    int* __restrict__ carry_out,
                    const int* __restrict__ actions,
                    const int* __restrict__ map_ids,
                    const int* __restrict__ min_xy,
                    const int* __restrict__ n_players,
                    const int* __restrict__ max_steps,
                    int* __restrict__ counts, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;  // the ragged last block
  ed::Env& s = ed::env_slot();
  ed::load_env(s, carry_in, n, e);
  int act[5];
  for (int h = 0; h < 5; ++h) act[h] = actions[5 * e + h];
  const bool ok = ed::actions_in_heads(act);
  if (ok)
    ed::step_given(s, act, map_ids + (size_t)e * ed::kMapCells, min_xy[2 * e],
                   min_xy[2 * e + 1], n_players[e], max_steps[e]);
  ed::store_env(s, carry_out, n, e);
  // one warp a block: the lanes below n take part in the ballots
  const int lanes = n - (int)(blockIdx.x * blockDim.x);
  const unsigned live = lanes >= 32 ? 0xffffffffu : (1u << lanes) - 1u;
  const unsigned bad = __ballot_sync(live, !ok);
  const unsigned done = __ballot_sync(live, s.done != 0);
  if (threadIdx.x == 0) {
    if (bad) atomicAdd(&counts[0], __popc(bad));
    if (done) atomicAdd(&counts[1], __popc(done));
  }
}

}  // namespace

// carry_in / carry_out: (570, n) int32, two tensors; actions (n, 5);
// map_ids (n, 2304), min_xy (n, 2), n_players / max_steps (n,); counts
// (2,) int32, zeroed by the caller: envs refused for their actions, envs
// done after the step.
extern "C" int ed_step_actions(const void* carry_in, void* carry_out,
                               const void* actions, const void* map_ids,
                               const void* min_xy, const void* n_players,
                               const void* max_steps, void* counts, int n,
                               void* stream) {
  if (n <= 0) return 0;
  return ed::launch_slotted<step_actions_kernel>(
      n, (cudaStream_t)stream, (const int*)carry_in, (int*)carry_out,
      (const int*)actions, (const int*)map_ids, (const int*)min_xy,
      (const int*)n_players, (const int*)max_steps, (int*)counts, n);
}
