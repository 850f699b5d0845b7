// Device functions shared by the preprocessing kernels (fused.cu and the
// standalone decode, SigridHash, Bucketize and Log kernels), so a fused chain
// and its one-operator-per-pass lowering run the same arithmetic and cannot
// drift apart.  Words arrive as int32 tensors carrying uint32 bit patterns;
// the kernels reinterpret them as unsigned.
//
// Every source includes this header and builds to its own shared library, so
// each library defines `presto_error_string` once (kernels/_build.py hashes
// this header into every library's name, so an edit here rebuilds them all).

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace presto {

constexpr uint32_t kGolden = 0x9E3779B1u;
constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
constexpr uint32_t kC3 = 0xC2B2AE35u;

// SigridHash: seeded murmur3 finalizer, then range reduce (uint32 lanes).
__device__ __forceinline__ uint32_t sigridhash(uint32_t v, uint32_t seed, uint32_t d) {
  uint32_t h = (v ^ (seed * kGolden)) * kC1 + seed;
  h ^= h >> 16;
  h *= kC2;
  h ^= h >> 13;
  h *= kC3;
  h ^= h >> 16;
  return h % d;
}

// Bits of value j of a byte-split group: byte j of each of the 4 plane
// words, as two byte permutes of plane pairs and one merge.  No float
// arithmetic touches the bits, so NaN payloads survive.
template <int J>
__device__ __forceinline__ uint32_t bytesplit_bits(uint4 p) {
  constexpr uint32_t sel = J | ((J + 4) << 4);
  const uint32_t lo = __byte_perm(p.x, p.y, sel);  // [x.b_J, y.b_J, ..]
  const uint32_t hi = __byte_perm(p.z, p.w, sel);  // [z.b_J, w.b_J, ..]
  return __byte_perm(lo, hi, 0x5410);
}

template <int J>
__device__ __forceinline__ float bytesplit_value(uint4 p) {
  return __uint_as_float(bytesplit_bits<J>(p));
}

// log1p(max(x, 0)) in the comparison form: fmaxf(NaN, 0) would give 0, but
// the reference's max keeps NaN, and so does `x < 0 ? 0 : x`.
__device__ __forceinline__ float lognorm(float x) { return log1pf(x < 0.f ? 0.f : x); }

// Subnormal -> 0: the reference's compares (XLA on the CPU, and the TPU)
// treat subnormal inputs as zero, so Bucketize flushes values and
// boundaries alike.  Flushing keeps sorted boundaries sorted; NaN stays NaN.
__device__ __forceinline__ float flush_denormal(float x) {
  return fabsf(x) < FLT_MIN ? 0.f : x;
}

// Number of boundaries <= x over sorted, NaN-free (flushed) boundaries: the
// compare-and-count of the reference, +inf padding included.  NaN counts
// nothing.
__device__ __forceinline__ uint32_t bucket(const float* b, int m, float x) {
  x = flush_denormal(x);
  if (isnan(x)) return 0;
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return (uint32_t)lo;
}

// The 32 W-bit values of one bit-packed group, held in W words, LSB-first.
// Every (word, offset) is a compile-time constant; value j reads word wid+1
// only when it straddles a word edge, so no read leaves the group.  With `w`
// and `out` in registers and the loop unrolled, nothing touches memory.
template <int W>
__device__ __forceinline__ void unpack_group(const uint32_t* w, uint32_t out[32]) {
  constexpr uint32_t mask = W == 32 ? 0xFFFFFFFFu : ((1u << (W & 31)) - 1u);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int bit = j * W;
    const int wid = bit >> 5, off = bit & 31;
    uint32_t val = w[wid] >> off;
    if (off != 0 && off + W > 32) val |= w[wid + 1 < W ? wid + 1 : W - 1] << (32 - off);
    out[j] = val & mask;
  }
}

// Load one group's W words through the read-only cache into registers.
template <int W>
__device__ __forceinline__ void load_group(const uint32_t* __restrict__ p, uint32_t w[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] = __ldg(p + k);
}

// Launch-side test for the kernels' 16-byte vector accesses.
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace presto

// The width switch of the bit-packed kernels: expands CASE(W) for W in 1..32.
#define PRESTO_FOR_EACH_WIDTH(CASE)                                          \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9)    \
  CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16) CASE(17)    \
  CASE(18) CASE(19) CASE(20) CASE(21) CASE(22) CASE(23) CASE(24) CASE(25)    \
  CASE(26) CASE(27) CASE(28) CASE(29) CASE(30) CASE(31) CASE(32)

extern "C" const char* presto_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
