// The lane shim: one env per warp, written once for the card and the host.
//
// K3 (mapgen.cuh) and K2 (engine.cuh's reset_env) run one env per warp.
// An env's scalar chain (K3's draws, frame stack and control; K2's deal
// draws) runs in every lane on identical values held in registers, so
// every lane draws the same numbers from its own copy of the env's engine
// and takes the same branches; the work that is parallel over items (K3's
// candidate scan, the bounding box of a piece's hexes, the raster and the
// ball cells; K2's piles, shop, masks and carry words) is split across
// the 32 lanes. The cooperative steps come in two forms with one
// interface:
//
// * WarpLanes (the kernels): the calling warp; lane l takes item l, a
//   ballot or a reduction is the warp's, and sync() is __syncwarp();
// * LoopLanes: one thread runs the 32 lanes of each step in a loop, in lane
//   order. The g++ host tests and the work count (mapgen_work.cu) run it.
//
// Shared arrays every lane reads (K3's MapSlots and raster, K2's env slot)
// are written only by the leader (lane 0), or by each lane at its own
// items, with a sync() between the writes and every read of the words
// written.
#pragma once

#include "rng.cuh"

#ifdef __CUDACC__
#define ED_POPC(x) __popc(x)
#else
#define ED_POPC(x) __builtin_popcount(x)
#endif

namespace ed {

constexpr int kLanes = 32;
constexpr uint32_t kAllLanes = 0xFFFFFFFFu;

#ifdef __CUDACC__
#define ED_LANE __device__ __forceinline__
using Quad = int4;  // 16 bytes: one vector load or store
#else
#define ED_LANE inline
struct alignas(16) Quad {
  int x, y, z, w;
};
#endif

// the bounding box of a set of hexes; empty, it holds the plain version's
// starting bounds of +-2^20
struct Box {
  int lo_x, lo_y, hi_x, hi_y;
};

ED_HD Box empty_box() {
  return Box{1 << 20, 1 << 20, -(1 << 20), -(1 << 20)};
}

ED_HD void box_add(Box& b, int x, int y) {
  b.lo_x = x < b.lo_x ? x : b.lo_x;
  b.lo_y = y < b.lo_y ? y : b.lo_y;
  b.hi_x = x > b.hi_x ? x : b.hi_x;
  b.hi_y = y > b.hi_y ? y : b.hi_y;
}

// the index of the n-th set bit of w (it has more than n): a binary search
// on the set-bit counts of the lower halves
ED_HD int nth_bit(uint32_t w, int n) {
  int i = 0;
  for (int s = 16; s > 0; s >>= 1) {
    const int c = ED_POPC(w & ((1u << s) - 1u));
    if (n >= c) {
      n -= c;
      w >>= s;
      i += s;
    }
  }
  return i;
}

struct LoopLanes {
  ED_LANE static bool leader() { return true; }
  ED_LANE static void sync() {}
  // body(l) for every lane l
  template <class F>
  ED_LANE static void each(F body) {
    for (int l = 0; l < kLanes; ++l) body(l);
  }
  // bit l: pred(l)
  template <class F>
  ED_LANE static uint32_t ballot(F pred) {
    uint32_t bits = 0;
    for (int l = 0; l < kLanes; ++l) bits |= (pred(l) ? 1u : 0u) << l;
    return bits;
  }
  // bit l of bits[i]: p[i] after pred(l, p), one call a lane
  template <int N, class F>
  ED_LANE static void ballots(uint32_t (&bits)[N], F pred) {
    for (int i = 0; i < N; ++i) bits[i] = 0;
    for (int l = 0; l < kLanes; ++l) {
      bool p[N];
      pred(l, p);
      for (int i = 0; i < N; ++i) bits[i] |= (p[i] ? 1u : 0u) << l;
    }
  }
  // the box of every lane's hexes; add(l, box) adds lane l's
  template <class F>
  ED_LANE static Box box(F add) {
    Box b = empty_box();
    for (int l = 0; l < kLanes; ++l) add(l, b);
    return b;
  }
  // 32 words of candidate bits, word w from ballot round w
  struct Words {
    uint32_t w[kLanes];
    ED_LANE void clear() {
      for (int i = 0; i < kLanes; ++i) w[i] = 0;
    }
    ED_LANE void set(int i, uint32_t bits) { w[i] = bits; }
    // the index of the pos-th set bit of the 32 words in order
    ED_LANE int nth(int pos) const {
      for (int i = 0;; ++i) {
        const int cnt = ED_POPC(w[i]);
        if (pos < cnt) return kLanes * i + nth_bit(w[i], pos);
        pos -= cnt;
      }
    }
  };
};

#ifdef __CUDACC__
struct WarpLanes {
  __device__ __forceinline__ static int lane() {
    return (int)(threadIdx.x & (kLanes - 1));
  }
  __device__ __forceinline__ static bool leader() { return lane() == 0; }
  __device__ __forceinline__ static void sync() { __syncwarp(); }
  template <class F>
  __device__ __forceinline__ static void each(F body) {
    body(lane());
  }
  template <class F>
  __device__ __forceinline__ static uint32_t ballot(F pred) {
    return __ballot_sync(kAllLanes, pred(lane()));
  }
  template <int N, class F>
  __device__ __forceinline__ static void ballots(uint32_t (&bits)[N],
                                                 F pred) {
    bool p[N];
    pred(lane(), p);
#pragma unroll
    for (int i = 0; i < N; ++i) bits[i] = __ballot_sync(kAllLanes, p[i]);
  }
  template <class F>
  __device__ __forceinline__ static Box box(F add) {
    Box b = empty_box();
    add(lane(), b);
    return Box{__reduce_min_sync(kAllLanes, b.lo_x),
               __reduce_min_sync(kAllLanes, b.lo_y),
               __reduce_max_sync(kAllLanes, b.hi_x),
               __reduce_max_sync(kAllLanes, b.hi_y)};
  }
  // lane l keeps word l
  struct Words {
    uint32_t mine;
    __device__ __forceinline__ void clear() { mine = 0; }
    __device__ __forceinline__ void set(int i, uint32_t bits) {
      if (lane() == i) mine = bits;
    }
    // the word holding the pos-th set bit from the lanes' prefix sums of
    // set-bit counts, then the bit within it
    __device__ __forceinline__ int nth(int pos) const {
      const int l = lane(), cnt = __popc(mine);
      int incl = cnt;
      for (int d = 1; d < kLanes; d <<= 1) {
        const int v = __shfl_up_sync(kAllLanes, incl, d);
        if (l >= d) incl += v;
      }
      const int w = __ffs(__ballot_sync(kAllLanes, incl > pos)) - 1;
      const uint32_t word = __shfl_sync(kAllLanes, mine, w);
      const int before = __shfl_sync(kAllLanes, incl - cnt, w);
      return kLanes * w + nth_bit(word, pos - before);
    }
  };
};
#endif

}  // namespace ed
