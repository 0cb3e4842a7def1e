// K1 writing the trajectory record (11 words per env per step: the
// per-step fields of vec.rollout and vec.kernel_rollout, engine.cuh's
// kRecordTraj): its own source, so that nvcc builds it beside
// step_kernel.cu.
#include "step_kernel.cuh"

namespace ed {

int launch_fused_step_traj(const StepArgs& a, cudaStream_t stream) {
  return launch_fused_step<false, kRecordTraj>(a, stream);
}

}  // namespace ed
