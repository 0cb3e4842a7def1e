// K3's work, for counting: the per-env code K3 runs (mapgen.cuh's map_env),
// through the lane shim's loop form, one thread per env. It is not part of
// the kernel library; tools/inst_count.py compiles it to PTX and counts the
// instructions its threads execute (count_k3_work). That count is the
// generation's work, each candidate tested once and the scalar chain run
// once, without the copies of the scalar chain that K3's other 31 lanes
// run beside the first: the instruction side of K3's bound. The scratch
// (raster and slots) sits in the thread's local memory.
#include <cuda_runtime.h>

#include "mapgen.cuh"

__global__ void generate_map_work_kernel(
    const int* rng, const int* idx, const int* n_pieces,
    const int* difficulty, const int* n_players, const int* ovl,
    int* map_ids, int* min_xy, unsigned char* ok, unsigned char* overflow,
    int* start_xy, int* start_no, int* player_xy, int* req, int* nr,
    int* end, int q) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= q) return;
  const ed::MapArgs a = {rng,      idx,      n_pieces, difficulty, n_players,
                         ovl,      map_ids,  min_xy,   ok,         overflow,
                         start_xy, start_no, player_xy, req,       nr,
                         end,      q};
  ed::MapScratch scratch;
  ed::map_env<ed::LoopLanes>(a, e, scratch, ed::OvlLdg{ovl});
}
