// K1: the record-free instantiation, K1-null, and the C entries that pick
// an instantiation (step_kernel.cuh holds the kernel and its design notes).
#include "step_kernel.cuh"

// record_words: 0 (no records), ed::kRecordCompact or ed::kRecordFull;
// records may be null when it is 0. Returns cudaErrorInvalidValue for any
// other width, or for records asked of K1-null.
extern "C" int ed_fused_step(const void* carry_in, void* carry_out,
                             const void* srng_in, void* srng_out,
                             const void* map_ids, const void* min_xy,
                             const void* n_players, const void* max_steps,
                             void* actions, void* dead, void* records, int n,
                             int n_steps, int mask_sel, int gate_dead,
                             int null_body, int record_words, void* stream) {
  if (n <= 0) return 0;
  const ed::StepArgs a = {
      (const int*)carry_in, (int*)carry_out, (const int*)srng_in,
      (int*)srng_out, (const int*)map_ids, (const int*)min_xy,
      (const int*)n_players, (const int*)max_steps, (int*)actions,
      (unsigned long long*)dead, (int*)records, n, n_steps, mask_sel,
      gate_dead};
  cudaStream_t st = (cudaStream_t)stream;
  if (null_body)
    return record_words == 0 ? ed::launch_fused_step<true, 0>(a, st)
                             : (int)cudaErrorInvalidValue;
  switch (record_words) {
    case 0: return ed::launch_fused_step<false, 0>(a, st);
    case ed::kRecordCompact: return ed::launch_fused_step_compact(a, st);
    case ed::kRecordFull: return ed::launch_fused_step_full(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1's block on the current device: out[0..2] = threads per block, shared
// bytes per block, and blocks of the record-free K1 resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int ed_fused_step_occupancy(void* out) {
  int* o = (int*)out;
  o[0] = ed::kStepThreads;
  o[1] = ed::kStepSmemBytes;
  cudaError_t err = ed::allow_slots<ed::fused_step_kernel<false, 0>>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &o[2], ed::fused_step_kernel<false, 0>, ed::kStepThreads,
        ed::kStepSmemBytes);
  return (int)err;
}
