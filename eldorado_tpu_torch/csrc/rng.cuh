// Bit-exact libstdc++ minstd_rand0 / uniform_int_distribution for the
// CUDA kernels: the arithmetic of eldorado_tpu_torch/ops/rng.py (itself the
// port of eldorado_tpu/ops/rng.py) on uint32_t, where the mod-2^32 wrap of
// next_u31 is defined behaviour and every right shift is logical.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define ED_HD __device__ __forceinline__
#define ED_CX __host__ __device__ constexpr
#define ED_TABLE static __device__ const
#else
#define ED_HD static inline
#define ED_CX static constexpr
#define ED_TABLE static const
#endif

namespace ed {

constexpr uint32_t kM = 2147483647u;          // 2^31 - 1
constexpr uint32_t kA = 16807u;
constexpr uint32_t kUrngRange = 2147483645u;  // engine max - min

// One minstd_rand0 step: x' = 16807 * x mod (2^31 - 1), x in [1, M-1].
ED_HD uint32_t next_u31(uint32_t x) {
  uint32_t lo = kA * (x & 0xFFFFu);
  uint32_t hi = kA * (x >> 16);
  uint32_t y = lo + ((hi & 0x7FFFu) << 16) + (hi >> 15);  // mod 2^32
  y = (y & 0x7FFFFFFFu) + (y >> 31);
  return y >= kM ? y - kM : y;
}

// The engine's multiplier to the powers 0-16 mod 2^31 - 1 (ED_TABLE: the
// lanes of a warp read it at different k); tests/test_torch_engine_host.py
// holds it to pow(16807, k, 2^31 - 1).
constexpr int kMinstdPows = 17;
ED_TABLE uint32_t MINSTD_POW[kMinstdPows] = {
    1u,          16807u,      282475249u,  1622650073u, 984943658u,
    1144108930u, 470211272u,  101027544u,  1457850878u, 1458777923u,
    2007237709u, 823564440u,  1115438165u, 1784484492u, 74243042u,
    114807987u,  1137522503u};

// The engine k steps on from x (k < kMinstdPows): a^k x mod 2^31 - 1, the
// 62-bit product folded twice.
ED_HD uint32_t minstd_skip(uint32_t x, int k) {
  uint64_t p = (uint64_t)x * MINSTD_POW[k];
  p = (p & kM) + (p >> 31);
  p = (p & kM) + (p >> 31);
  return (uint32_t)(p >= kM ? p - kM : p);
}

// uniform_int_distribution(0, n-1) exactly (rng.uniform_int): redraw until
// the value is accepted. Map generation draws this way. n >= 1.
ED_HD uint32_t uniform_int(uint32_t& x, uint32_t n) {
  const uint32_t scaling = kUrngRange / n;
  const uint32_t past = n * scaling;
  uint32_t r;
  do {
    x = next_u31(x);
    r = x - 1;
  } while (r >= past);
  return r / scaling;
}

// uniform_int_distribution(0, n-1) with two unrolled rejection attempts
// (rng.uniform_int_fast); ``tainted`` is set on a double rejection, where
// the value deviates from the exact stream. n >= 1.
ED_HD uint32_t uniform_int_fast(uint32_t& x, uint32_t n, int& tainted) {
  uint32_t scaling = kUrngRange / n;
  uint32_t past = n * scaling;
  uint32_t x1 = next_u31(x);
  uint32_t r1 = x1 - 1;
  bool ok1 = r1 < past;
  uint32_t x2 = next_u31(x1);
  uint32_t r2 = x2 - 1;
  tainted = (!ok1 && r2 >= past) ? 1 : 0;
  x = ok1 ? x1 : x2;
  return (ok1 ? r1 : r2) / scaling;
}

// rng.uniform_int_fast_maybe: n clamps to >= 1; when ``draw`` is false the
// stream is untouched and the value is 0. ORs the taint into ``taint``.
ED_HD int uniform_int_fast_maybe(uint32_t& x, int n, bool draw, int& taint) {
  if (!draw) return 0;
  int t = 0;
  uint32_t v = uniform_int_fast(x, n < 1 ? 1u : (uint32_t)n, t);
  taint |= t;
  return (int)v;
}

// uniform_int_fast's constants for the small ranges of the sampler's heads
// (a popcount of at most 22 bits), row n: scaling = kUrngRange / n, past =
// n * scaling, and scaling's reciprocal, r / scaling == umulhi(r, magic) >>
// shift for every r < 2^31 (round-up reciprocal with 31-bit dividends);
// row 0 is row 1 (the clamp). In global memory (ED_TABLE): the lanes of a
// warp read it at unrelated rows, which the constant cache would
// serialise. tests/test_torch_engine_host.py holds every row to the
// division it replaces.
struct SmallRange {
  uint32_t scaling, past, magic;
  int shift;
};
constexpr int kSmallRanges = 23;
ED_TABLE SmallRange SMALL_RANGE[kSmallRanges] = {
    {2147483645u, 2147483645u, 2147483652u, 30},
    {2147483645u, 2147483645u, 2147483652u, 30},
    {1073741822u, 2147483644u, 2147483653u, 29},
    {715827881u, 2147483643u, 3221225480u, 29},
    {536870911u, 2147483644u, 2147483653u, 28},
    {429496729u, 2147483645u, 2684354564u, 28},
    {357913940u, 2147483640u, 3221225485u, 28},
    {306783377u, 2147483639u, 3758096400u, 28},
    {268435455u, 2147483640u, 2147483657u, 27},
    {238609293u, 2147483637u, 2415919117u, 27},
    {214748364u, 2147483640u, 2684354571u, 27},
    {195225785u, 2147483635u, 2952790034u, 27},
    {178956970u, 2147483640u, 3221225485u, 27},
    {165191049u, 2147483637u, 3489660946u, 27},
    {153391688u, 2147483632u, 3758096413u, 27},
    {143165576u, 2147483640u, 4026531856u, 27},
    {134217727u, 2147483632u, 2147483665u, 26},
    {126322567u, 2147483639u, 2281701386u, 26},
    {119304646u, 2147483628u, 2415919127u, 26},
    {113025455u, 2147483645u, 2550136836u, 26},
    {107374182u, 2147483640u, 2684354571u, 26},
    {102261125u, 2147483625u, 2818572319u, 26},
    {97612892u, 2147483624u, 2952790050u, 26},
};

// r / row.scaling without a division (r < 2^31).
ED_HD uint32_t small_quotient(const SmallRange& row, uint32_t r) {
#ifdef __CUDA_ARCH__
  return __umulhi(r, row.magic) >> row.shift;
#else
  return (uint32_t)(((uint64_t)r * row.magic) >> 32) >> row.shift;
#endif
}

// uniform_int_fast_maybe for 0 <= n < kSmallRanges, the same draws and
// values, with n's constants ``row`` = SMALL_RANGE[n], read by the caller.
ED_HD int uniform_small_fast_maybe(uint32_t& x, const SmallRange& row,
                                   bool draw, int& taint) {
  if (!draw) return 0;
  const uint32_t x1 = next_u31(x);
  const uint32_t r1 = x1 - 1;
  const bool ok1 = r1 < row.past;
  const uint32_t x2 = next_u31(x1);
  const uint32_t r2 = x2 - 1;
  taint |= (!ok1 && r2 >= row.past) ? 1 : 0;
  x = ok1 ? x1 : x2;
  return (int)small_quotient(row, ok1 ? r1 : r2);
}

}  // namespace ed
