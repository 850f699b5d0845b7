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

// ---------------------------------------------------------------------------
// Bit-packed tiles: the one design of bitunpack (decode.cu) and fused_sparse
// (fused.cu), which differ only in the SigridHash applied to each value.
//
// (F, G, W) words -> (F, G, 32) values.  Group g of a feature holds values
// [32g, 32g + 32) in its W words, LSB-first; no value crosses into the next
// group.  A tile is up to kTileGroups groups of one feature: its words are
// one contiguous range of the input, its values one contiguous range of the
// output.  The block stages the tile's words in shared memory, then each
// warp takes one group at a time and lane j extracts value j, so every warp
// store writes one whole 128-byte line.

constexpr int kTileThreads = 256;  // 8 warps: 8 groups in flight per block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One-arrival transaction barrier; the init is made visible to the bulk
// copy (the async proxy) before any thread uses the barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(1u)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A range of n words goes by one bulk copy when its start and length are
// multiples of 16 bytes (the copy's rule); otherwise by 4-byte loads.
__device__ __forceinline__ bool bulk_ok(const uint32_t* src, int n) {
  return ((reinterpret_cast<uintptr_t>(src) & 15) | (n & 3)) == 0;
}

// One thread: copy n words global -> shared, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t* dst, const uint32_t* src, int n,
                                          uint64_t* bar) {
  const uint32_t bytes = 4u * n;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The whole block: copy n words global -> shared with coalesced 4-byte
// loads (the caller synchronises).
__device__ __forceinline__ void scalar_load(uint32_t* dst, const uint32_t* src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = __ldg(src + k);
}

// Where value j (j = the lane) lies in every group of width W: bits
// [jW, jW + W) span word lo and, when they straddle a word edge, word lo + 1.
// `hi` is clamped into the group; that is exact, because when value j does
// not straddle, the bits taken from `hi` land at or above bit W and the mask
// removes them.
struct LaneBits {
  int lo, hi, off;
  uint32_t mask;
  __device__ __forceinline__ explicit LaneBits(int width) {
    const int bit = (threadIdx.x & 31) * width;
    lo = bit >> 5;
    off = bit & 31;
    hi = min(lo + 1, width - 1);
    mask = 0xFFFFFFFFu >> (32 - width);
  }
  __device__ __forceinline__ uint32_t operator()(const uint32_t* group) const {
    return __funnelshift_r(group[lo], group[hi], off) & mask;
  }
};

// The values of n staged groups (s: their words) to `out` (their first
// value): warp w takes groups w, w + 8, ...; lane j stores value j.
template <bool kHash>
__device__ __forceinline__ void unpack_groups(const uint32_t* s, uint32_t* __restrict__ out,
                                              int n, int width, const LaneBits& bits,
                                              uint32_t seed, uint32_t d) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int g = threadIdx.x >> 5; g < n; g += kTileThreads / 32) {
    uint32_t v = bits(s + g * width);
    if (kHash) v = sigridhash(v, seed, d);
    out[g * 32 + lane] = v;
  }
}

constexpr int kTileGroups = 128;  // groups per tile: 12 KB of words at W = 24

// One stage, the body of bitunpack_kernel and fused_sparse_kernel: block
// (x, f) stages tile x of feature f and unpacks it.  Grid (ceil(G /
// kTileGroups), F); dynamic shared memory kTileGroups * W words.  The [seed, max] pair (params,
// read only when hashing) is read once per block.
template <bool kHash>
__device__ __forceinline__ void unpack_tile(const uint32_t* __restrict__ words,
                                            const uint32_t* __restrict__ params,
                                            uint32_t* __restrict__ out,
                                            long long groups_per_feature, int width) {
  extern __shared__ __align__(128) uint32_t s[];
  __shared__ uint64_t bar;
  const int f = blockIdx.y;
  const long long g0 = (long long)blockIdx.x * kTileGroups;
  const int n = (int)min((long long)kTileGroups, groups_per_feature - g0);
  const long long first = (long long)f * groups_per_feature + g0;
  const uint32_t* src = words + first * width;
  const int nw = n * width;
  const bool bulk = bulk_ok(src, nw);
  if (bulk) {
    if (threadIdx.x == 0) {
      mbar_init(&bar);
      bulk_load(s, src, nw, &bar);
    }
  } else {
    scalar_load(s, src, nw);
  }
  uint32_t seed = 0, d = 0;
  if (kHash) {
    seed = __ldg(params + 2 * f);
    d = __ldg(params + 2 * f + 1);
  }
  const LaneBits bits(width);
  __syncthreads();
  if (bulk) mbar_wait(&bar, 0);
  unpack_groups<kHash>(s, out + first * 32, n, width, bits, seed, d);
}

inline dim3 tile_grid(long long f, long long g) {
  return dim3((unsigned)((g + kTileGroups - 1) / kTileGroups), (unsigned)f);
}

inline size_t tile_smem(int width) { return (size_t)kTileGroups * width * sizeof(uint32_t); }

// Launch-side test for the kernels' 16-byte vector accesses.
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace presto

extern "C" const char* presto_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
