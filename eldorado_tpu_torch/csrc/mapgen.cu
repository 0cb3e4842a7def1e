// K3: map generation and the map prelude of cog_env::reset, one launch per
// reset queue.
//
// Replaces eldorado_tpu/core/mapgen.py::generate_map (:416) with its
// prelude eldorado_tpu/core/engine.py::reset_map_prelude (:1122). The TPU
// build left them in XLA as a vmapped while_loop, not a Pallas kernel: a
// batch of lanes ran every branch of every trip in lockstep until the
// slowest lane was done. The port's plain version (core/mapgen.py) does
// the same in torch, with a host loop that reads the device every trip.
//
// What bounds it: not bytes (a 128-env queue writes 1.2 MB of map rows,
// 0.4 us at HBM's rate) and not the work's instructions (about 50,000 PTX
// instructions per env in one thread), but the latency of each env's
// generation, a long chain of dependent branchy integer work and table
// reads, trip after trip; the slowest env of a queue, the one whose
// retries stacked the most slots, sets the launch's time. Run one env per
// thread, as the first version of this kernel did, the chain was a
// thread's whole generation: the overlap test of every connection of every
// placed slot against every placed slot, in sequence; a 128-env queue was
// 4 warps on 4 SMs, the 32 envs of a warp paid for the union of their
// trips, and each thread's state sat on a 1.3 KB local-memory stack.
//
// Design: one warp per env (mapgen.cuh's map_env with WarpLanes), so a
// 128-env queue is 128 warps. The scalar chain (draws, frames, control)
// runs in every lane on identical register values; the candidate scan, the
// hot loop, splits across the lanes: ballot round w tests candidates 32w
// to 32w + 31 against the placed slots, so an attempt takes ceil(placed *
// 21 / 32) rounds instead of placed * 21 serial tests, and the ballots are
// the free-candidate bit words of the serial scan, bit for bit. A lane
// tests its candidate against four slots at a time (16-byte slot records,
// four pair-table reads in flight). A piece's bounding box is a warp
// reduction, its hexes rasterise a lane each. Each env's slots (MapSlots,
// 1.3 KB) and its 48 x 48 raster (9,216 B) sit in the block's dynamic
// shared memory: the raster is zeroed and drawn there, then written to the
// batch row whole with 16-byte stores (coalesced: a warp writes 512
// contiguous bytes per store), and the prelude's 4 x 19 ball cells read it
// there, a lane per cell.
//
// Launch shape: a block holds 1 to 4 envs (a warp each), and the 8,100-word
// pair table is read through L1 (__ldg) or staged once per block in shared
// memory (32,400 B); ed_generate_map_shaped launches any of them. The
// default, four envs a block with the table through L1 (42,176 B of
// shared memory a block, 5 blocks resident per SM), was the fastest shape
// on an H100 at both of the main path's widths (chip_smoke.py phase 5;
// PERF.md): at 4096 envs 4% ahead of one env a block and 1.5-3.9x ahead
// of the staged table, whose 32 KB per block cuts the blocks resident per
// SM; at 128 envs 1% ahead of one env a block and 7-53% ahead of the
// staged table.
#include <cuda_runtime.h>

#include "mapgen.cuh"

namespace {

constexpr int kMaxEnvsPerBlock = 4;
constexpr int kDefaultEnvs = 4;
constexpr bool kDefaultOvlShared = false;
constexpr int kOvlBytes = 4 * ed::kOvlWords;
static_assert(sizeof(ed::MapScratch) % 16 == 0, "16-byte aligned scratch");
static_assert(ed::kOvlWords % 4 == 0, "the table copies in 16-byte words");

int smem_bytes(int envs, bool ovl_shared) {
  return envs * (int)sizeof(ed::MapScratch) + (ovl_shared ? kOvlBytes : 0);
}

template <bool kOvlShared>
__global__ void __launch_bounds__(kMaxEnvsPerBlock * ed::kLanes)
generate_map_kernel(const int* __restrict__ rng, const int* __restrict__ idx,
                    const int* __restrict__ n_pieces,
                    const int* __restrict__ difficulty,
                    const int* __restrict__ n_players,
                    const int* __restrict__ ovl, int* map_ids, int* min_xy,
                    unsigned char* ok, unsigned char* overflow, int* start_xy,
                    int* start_no, int* player_xy, int* req, int* nr,
                    int* end, int q, const int* __restrict__ count,
                    int* work) {
  extern __shared__ __align__(16) unsigned char ed_map_smem[];
  const ed::MapArgs a = {rng,      idx,      n_pieces, difficulty, n_players,
                         ovl,      map_ids,  min_xy,   ok,         overflow,
                         start_xy, start_no, player_xy, req,       nr,
                         end,      q,        work};
  const int envs = blockDim.x / ed::kLanes, warp = threadIdx.x / ed::kLanes;
  ed::MapScratch* scratch = reinterpret_cast<ed::MapScratch*>(ed_map_smem);
  const int e = blockIdx.x * envs + warp;
  // with a device count, slots at or past it are empty: their warps skip
  // the env, after the block's table staging
  const bool live = e < q && (count == nullptr || e < *count);
  if constexpr (kOvlShared) {
    ed::Quad* tab = reinterpret_cast<ed::Quad*>(scratch + envs);
    const ed::Quad* src = reinterpret_cast<const ed::Quad*>(ovl);
    for (int j = threadIdx.x; j < ed::kOvlWords / 4; j += blockDim.x)
      tab[j] = __ldg(src + j);
    __syncthreads();
    if (live)
      ed::map_env<ed::WarpLanes>(
          a, e, scratch[warp], ed::OvlPlain{reinterpret_cast<int*>(tab)});
  } else {
    if (live)
      ed::map_env<ed::WarpLanes>(a, e, scratch[warp], ed::OvlLdg{ovl});
  }
}

template <bool kOvlShared>
cudaError_t allow_smem(int envs) {
  return cudaFuncSetAttribute(generate_map_kernel<kOvlShared>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(envs, kOvlShared));
}

template <bool kOvlShared>
int launch(const ed::MapArgs& a, const int* count, int envs,
           cudaStream_t stream) {
  const cudaError_t err = allow_smem<kOvlShared>(envs);
  if (err != cudaSuccess) return (int)err;
  generate_map_kernel<kOvlShared>
      <<<(a.q + envs - 1) / envs, envs * ed::kLanes,
         smem_bytes(envs, kOvlShared), stream>>>(
          a.rng, a.idx, a.n_pieces, a.difficulty, a.n_players, a.ovl,
          a.map_ids, a.min_xy, a.ok, a.overflow, a.start_xy, a.start_no,
          a.player_xy, a.req, a.nr, a.end, a.q, count, a.work);
  return (int)cudaGetLastError();
}

}  // namespace

// rng / n_pieces / difficulty / n_players: (n,) int32, read at idx[e]
// (at e where idx is null); ovl the (8100,) pair table and map_ids (n,
// 2304), both 16-byte aligned; min_xy (n, 2), ok / overflow (n,) bool:
// written at those rows. start_xy (q, 4, 2) and start_no (q, 4) may be
// null; player_xy (q, 4, 2) and req / nr / end (q, 4, 19) are null
// together, and n_players with them. count, a (1,) int32 on the device or
// null: with it, only the slots e < *count generate (a queue launched at its
// capacity, sized on the card); null: all q. work, a (q, 2) int32 or null:
// each generated slot's generator trips and retries (child frames pushed,
// the one that aborts included). envs_per_block in 1..4 (else
// cudaErrorInvalidValue); ovl_shared stages the pair table in each block's
// shared memory instead of reading it through L1.
extern "C" int ed_generate_map_shaped(
    const void* rng, const void* idx, const void* n_pieces,
    const void* difficulty, const void* n_players, const void* ovl,
    void* map_ids, void* min_xy, void* ok, void* overflow, void* start_xy,
    void* start_no, void* player_xy, void* req, void* nr, void* end, int q,
    const void* count, void* work, int envs_per_block, int ovl_shared,
    void* stream) {
  if (envs_per_block < 1 || envs_per_block > kMaxEnvsPerBlock)
    return (int)cudaErrorInvalidValue;
  if (q <= 0) return 0;
  const ed::MapArgs a = {
      (const int*)rng,        (const int*)idx,        (const int*)n_pieces,
      (const int*)difficulty, (const int*)n_players,  (const int*)ovl,
      (int*)map_ids,          (int*)min_xy,           (unsigned char*)ok,
      (unsigned char*)overflow, (int*)start_xy,       (int*)start_no,
      (int*)player_xy,        (int*)req,              (int*)nr,
      (int*)end,              q,                      (int*)work};
  cudaStream_t st = (cudaStream_t)stream;
  const int* c = (const int*)count;
  return ovl_shared ? launch<true>(a, c, envs_per_block, st)
                    : launch<false>(a, c, envs_per_block, st);
}

// The arguments of ed_generate_map_shaped without the shape: the default.
extern "C" int ed_generate_map(const void* rng, const void* idx,
                               const void* n_pieces, const void* difficulty,
                               const void* n_players, const void* ovl,
                               void* map_ids, void* min_xy, void* ok,
                               void* overflow, void* start_xy, void* start_no,
                               void* player_xy, void* req, void* nr, void* end,
                               int q, const void* count, void* work,
                               void* stream) {
  return ed_generate_map_shaped(rng, idx, n_pieces, difficulty, n_players,
                                ovl, map_ids, min_xy, ok, overflow, start_xy,
                                start_no, player_xy, req, nr, end, q, count,
                                work, kDefaultEnvs, kDefaultOvlShared, stream);
}

// K3's block for a shape (envs_per_block 0: the default shape) on the
// current device: out[0..4] = envs per block, threads per block, shared
// bytes per block, blocks resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and whether the pair
// table is in shared memory.
extern "C" int ed_generate_map_shape(int envs_per_block, int ovl_shared,
                                     void* out) {
  if (envs_per_block == 0) {
    envs_per_block = kDefaultEnvs;
    ovl_shared = kDefaultOvlShared;
  }
  if (envs_per_block < 1 || envs_per_block > kMaxEnvsPerBlock)
    return (int)cudaErrorInvalidValue;
  int* o = (int*)out;
  o[0] = envs_per_block;
  o[1] = envs_per_block * ed::kLanes;
  o[2] = smem_bytes(envs_per_block, ovl_shared != 0);
  o[4] = ovl_shared != 0;
  cudaError_t err;
  if (ovl_shared) {
    err = allow_smem<true>(envs_per_block);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &o[3], generate_map_kernel<true>, o[1], o[2]);
  } else {
    err = allow_smem<false>(envs_per_block);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &o[3], generate_map_kernel<false>, o[1], o[2]);
  }
  return (int)err;
}
