// K1 writing the learner feed's full records (40 words per env per
// step): its own source, so that nvcc builds it beside step_kernel.cu.
#include "step_kernel.cuh"

namespace ed {

int launch_fused_step_full(const StepArgs& a, cudaStream_t stream) {
  return launch_fused_step<false, kRecordFull>(a, stream);
}

}  // namespace ed
