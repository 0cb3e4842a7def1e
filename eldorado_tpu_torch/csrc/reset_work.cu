// K2's work, for counting: the per-env code K2 runs in place (engine.cuh's
// reset_column), through the lane shim's loop form, one thread per env. It
// is not part of the kernel library; tools/inst_count.py compiles it to PTX
// and counts the instructions its threads execute (count_k2_work). That
// count is the reset's work, each lane's part run once, without the copies
// of the deals' draws and masks that K2's other lanes run beside the
// first: the instruction side of K2's bound. The env's slot sits in the
// thread's local memory.
#include <cuda_runtime.h>

#include "engine.cuh"

__global__ void fused_reset_work_kernel(int* carry, const int* idx,
                                        const int* n_players, const int* xy,
                                        const int* req, const int* nr,
                                        const int* end, int n, int q) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= q) return;
  const int col = idx[e];
  const size_t b = (size_t)e * 4 * ed::kBall;
  ed::EnvSlot slot;
  ed::reset_column<ed::LoopLanes>(slot.env, carry, n, col, n_players[col],
                                  xy + 8 * (size_t)e, req + b, nr + b,
                                  end + b);
}
