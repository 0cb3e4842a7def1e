// The chunk loop's reset queue on the card: select (which envs a chunk
// boundary resets, and how many) and settle (the queue's outcome), so that
// a boundary chooses, sizes, resets and settles its queue in stream order
// and the host reads nothing between chunks.
//
// Replaces no TPU kernel. The JAX package took each queue with a sort of
// the done keys inside its jitted chunk loop (eldorado_tpu/vec.py:_reset_q)
// and wrote the flags there too; the port did the same with torch ops
// around a host read of the queue's length, which only sized K3's and
// K2's launches and left the card idle through the queue's host work. K3
// and K2 now take the count from device memory (mapgen.cu,
// reset_kernel.cu), launched at the queue's capacity.
//
// What bounds them: neither bytes (select reads n done words, and the
// in-flight bytes in the async mode, and writes q_cap + 1 words: 16 KB at
// 4096 envs, 5 ns at HBM's rate; settle touches 10 bytes a queued env, 14
// with K3's trips) nor instructions, but the launch and a block's few
// barriers. So each is one block: select's threads walk the flags a
// block-wide tile at a time (a ballot and a scan of the warps' counts order
// the done envs by index) and stop once q_cap are taken; settle's threads
// take a queue slot each and reduce the flags with one barrier each, and
// K3's trips with a warp reduction each between the same barriers.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// idx[0..q_cap) = the lowest-indexed envs e with done[e] != 0 and not
// inflight[e], ascending, then n in every slot past them; *count = how
// many were taken (at most q_cap). With inflight, each taken env's flag is
// set.
__global__ void __launch_bounds__(kMaxThreads)
queue_select_kernel(const int* __restrict__ done, unsigned char* inflight,
                    int* idx, int* count, int n, int q_cap) {
  __shared__ int warp_end[kMaxThreads / kLanes];  // inclusive prefix counts
  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
  const int warps = blockDim.x / kLanes;
  int taken = 0;  // the same in every thread
  for (int t0 = 0; t0 < n && taken < q_cap; t0 += blockDim.x) {
    const int e = t0 + tid;
    const bool take = e < n && done[e] != 0 && !(inflight && inflight[e]);
    const unsigned votes = __ballot_sync(kFull, take);
    if (lane == 0) warp_end[warp] = __popc(votes);
    __syncthreads();
    if (warp == 0) {
      int v = lane < warps ? warp_end[lane] : 0;
      for (int d = 1; d < kLanes; d <<= 1) {
        const int up = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += up;
      }
      if (lane < warps) warp_end[lane] = v;
    }
    __syncthreads();
    const int slot = taken + (warp ? warp_end[warp - 1] : 0)
                     + __popc(votes & ((1u << lane) - 1u));
    if (take && slot < q_cap) {
      idx[slot] = e;
      if (inflight) inflight[e] = 1;
    }
    taken += warp_end[warps - 1];
    __syncthreads();  // warp_end is rewritten by the next tile
  }
  taken = min(taken, q_cap);
  for (int s = taken + tid; s < q_cap; s += blockDim.x) idx[s] = n;
  if (tid == 0) *count = taken;
}

// Over the queue's slots below *count: every env takes the whole queue's
// map outcome (ok: all of them ok; overflow: any of them overflowed), the
// queue's count is added to tally[0], a failure sets tally[1] and an
// overflow tally[2]; with inflight, each env's flag is cleared. With work
// (K3's per-slot trips and retries), work_tally gains the queue's trips
// and count x its most trips (the lanes' time K3's launch holds while it
// waits for its slowest env). A slot a thread; all reads come before the
// first write (the barriers).
__global__ void __launch_bounds__(kMaxThreads)
queue_settle_kernel(const int* __restrict__ idx, const int* __restrict__ count,
                    unsigned char* ok, unsigned char* overflow,
                    unsigned char* inflight, long long* tally,
                    const int* __restrict__ work, long long* work_tally) {
  __shared__ int sums[2];  // trips, most trips
  const int k = *count, s = threadIdx.x;
  const bool live = s < k;
  // every load is issued before the first barrier, so that their
  // latencies overlap
  const int trips = work && live ? work[2 * s] : 0;
  const int row = live ? idx[s] : 0;
  const bool my_ok = !live || ok[row], my_over = live && overflow[row];
  if (work && s == 0) sums[0] = sums[1] = 0;
  const bool all_ok = __syncthreads_and(my_ok) != 0;
  if (work) {  // each warp reduces its slots, its lane 0 adds them in
    const int t = __reduce_add_sync(kFull, trips);
    const int m = __reduce_max_sync(kFull, trips);
    if (s % kLanes == 0 && t > 0) {
      atomicAdd(&sums[0], t);
      atomicMax(&sums[1], m);
    }
  }
  const bool any_over = __syncthreads_or(my_over) != 0;
  if (live) {
    ok[row] = all_ok;
    overflow[row] = any_over;
    if (inflight) inflight[row] = 0;
  }
  if (s == 0 && k > 0) {
    tally[0] += k;
    if (!all_ok) tally[1] = 1;
    if (any_over) tally[2] = 1;
    if (work) {
      work_tally[0] += sums[0];
      work_tally[1] += (long long)k * sums[1];
    }
  }
}

int threads_for(int n) {
  return min(kMaxThreads, (n + kLanes - 1) / kLanes * kLanes);
}

}  // namespace

// done (n,) int32 (the carry's done row); inflight (n,) bool or null;
// idx (q_cap,) and count (1,) int32, written; 1 <= q_cap <= 1024.
extern "C" int ed_queue_select(const void* done, void* inflight, void* idx,
                               void* count, int n, int q_cap, void* stream) {
  if (n <= 0 || q_cap <= 0) return 0;
  if (q_cap > kMaxThreads) return (int)cudaErrorInvalidValue;
  queue_select_kernel<<<1, threads_for(n), 0, (cudaStream_t)stream>>>(
      (const int*)done, (unsigned char*)inflight, (int*)idx, (int*)count, n,
      q_cap);
  return (int)cudaGetLastError();
}

// idx (q_cap,) and count (1,) int32 as select wrote them; ok / overflow
// (n,) bool, the batch's map flags; inflight (n,) bool or null; tally
// (3,) int64: episodes, failed, overflow; work (q_cap, 2) int32, K3's
// trips and retries by slot, and work_tally (2,) int64: trips, count x
// most trips, both null or neither.
extern "C" int ed_queue_settle(const void* idx, const void* count, void* ok,
                               void* overflow, void* inflight, void* tally,
                               const void* work, void* work_tally, int q_cap,
                               void* stream) {
  if (q_cap <= 0) return 0;
  if (q_cap > kMaxThreads) return (int)cudaErrorInvalidValue;
  if ((work == nullptr) != (work_tally == nullptr))
    return (int)cudaErrorInvalidValue;
  queue_settle_kernel<<<1, threads_for(q_cap), 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const int*)count, (unsigned char*)ok,
      (unsigned char*)overflow, (unsigned char*)inflight, (long long*)tally,
      (const int*)work, (long long*)work_tally);
  return (int)cudaGetLastError();
}
