// K1 writing the learner feed's compact records (5 words per env per
// step): its own source, so that nvcc builds it beside step_kernel.cu.
#include "step_kernel.cuh"

namespace ed {

int launch_fused_step_compact(const StepArgs& a, cudaStream_t stream) {
  return launch_fused_step<false, kRecordCompact>(a, stream);
}

}  // namespace ed
