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

// Whether a pointer allows 16-byte vector accesses.
__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// Bucket tiles: the one design of bucketize (bucketize.cu) and fused_gen
// (fused.cu), which differ only in how a thread's values arrive (f32 loads,
// or byte-split words decoded in registers) and what leaves (the counts, or
// their SigridHash).
//
// Block (x, f) counts kBucketThreads * kBucketValues consecutive values of
// feature f against the feature's m sorted, NaN-free boundaries; thread t
// takes values [V t, V t + V) of the block's range (V = kBucketValues).  Each
// thread issues its value loads first and its share of the boundary loads
// next, so the two trips to device memory overlap; the block stores the
// boundaries in shared memory as a breadth-first (Eytzinger) tree and
// synchronises once.  The search is branchless and of fixed trip count, the
// same for every lane, with a thread's V values in lockstep (V independent
// shared loads in flight per step).  Step l reads level l of the tree, one
// contiguous range: the first five levels share one 128-byte row, and the
// lanes' probes of a deeper level spread over the banks (in sorted order,
// a warp's probes of one step of a binary search all fall in one bank).
//
// A tree of m > 32768 boundaries (2^16 floats and more) does not fit in the
// 227 KB a block may use.  For such m the kernels run a second mode: the
// block stages nothing, and each thread searches the sorted boundaries where
// they lie in device memory (`bucket_counts_global`), with the same lockstep
// and the same compare.  The feature's 128 KB and more of boundaries stay in
// the 50 MB L2, and the first probes, the same for every value, in L1.  The
// binding chooses the mode (`_binding.bucket_staged`).
//
// The tree: the first m - 1 boundaries as a complete binary tree of
// N = 2^L - 1 nodes, L = ceil(log2 m), node k's children at 2k + 1 and
// 2k + 2, in-order positions m - 1 .. N - 1 holding NaN (never <= x); slot N
// holds the last boundary.  After L steps of k = 2k + 1 + (s[k] <= x),
// k - N counts the tree's boundaries <= x, and the last boundary adds one if
// it is <= x: ceil(log2(m + 1)) probes when m is a power of two, one more
// otherwise.

constexpr int kBucketThreads = 256;
constexpr int kBucketValues = 4;  // per thread

// 1 if b <= x, else 0, with subnormal operands read as zero (.ftz) and NaN
// never <= anything: the reference's compare of flushed boundaries and
// values (XLA on the CPU, like the TPU, treats subnormal inputs as zero; C6).
// Flushing keeps sorted boundaries sorted, so the counts stay a prefix.
__device__ __forceinline__ uint32_t le_ftz(float b, float x) {
  uint32_t r;
  asm("{\n.reg .pred p;\nsetp.le.ftz.f32 p, %1, %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "f"(b), "f"(x));
  return r;
}

// L = ceil(log2 m): the depth of the tree over the first m - 1 boundaries.
__host__ __device__ __forceinline__ int tree_levels(int m) {
#ifdef __CUDA_ARCH__
  return m > 1 ? 32 - __clz(m - 1) : 0;
#else
  return m > 1 ? 32 - __builtin_clz(m - 1) : 0;
#endif
}

// Slot of in-order position i in the breadth-first layout of a complete tree
// of 2^L - 1 nodes: i + 1 = (2j + 1) 2^t puts it j-th on level L - 1 - t.
__device__ __forceinline__ int tree_slot(int i, int levels) {
  const int t = __ffs(i + 1) - 1;
  return (1 << (levels - 1 - t)) - 1 + ((i + 1) >> (t + 1));
}

// The block: the m boundaries at b into the tree s (the caller
// synchronises).  16-byte loads where the row is 16-byte aligned, else 4-byte
// loads; each thread has up to 4 loads in flight before it stores.
__device__ __forceinline__ void stage_tree(float* s, const float* __restrict__ b, int m,
                                           int levels) {
  const int nodes = (1 << levels) - 1;
  const int t = threadIdx.x, threads = blockDim.x;
  auto put = [&](int i, float v) { s[i < m - 1 ? tree_slot(i, levels) : nodes] = v; };
  if (aligned16(b) && (m & 3) == 0) {
    const float4* b4 = reinterpret_cast<const float4*>(b);
    const int quads = m >> 2;
    for (int q0 = t; q0 < quads; q0 += 4 * threads) {
      float4 r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u * threads < quads) r[u] = __ldg(b4 + q0 + u * threads);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * (q0 + u * threads);
        if (i < m) {
          put(i, r[u].x);
          put(i + 1, r[u].y);
          put(i + 2, r[u].z);
          put(i + 3, r[u].w);
        }
      }
    }
  } else {
    for (int i0 = t; i0 < m; i0 += 4 * threads) {
      float r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * threads < m) r[u] = __ldg(b + i0 + u * threads);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * threads < m) put(i0 + u * threads, r[u]);
    }
  }
  for (int i = max(m - 1, 0) + t; i < nodes; i += threads)
    s[tree_slot(i, levels)] = __int_as_float(0x7fffffff);  // NaN
}

// #{j < m : b[j] <= x} for a thread's kBucketValues values at once over the
// staged tree s (C1: NaN counts nothing; +inf counts every boundary, +inf
// padding included).
__device__ __forceinline__ void bucket_counts(const float* s, int m, int levels,
                                              const float (&x)[kBucketValues],
                                              uint32_t (&count)[kBucketValues]) {
  constexpr int V = kBucketValues;
  const uint32_t nodes = (1u << levels) - 1;
  const float last = m > 0 ? s[nodes] : __int_as_float(0x7fffffff);
  uint32_t k[V];
#pragma unroll
  for (int v = 0; v < V; ++v) k[v] = 0;
  for (int l = 0; l < levels; ++l) {
#pragma unroll
    for (int v = 0; v < V; ++v) k[v] = 2 * k[v] + 1 + le_ftz(s[k[v]], x[v]);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) count[v] = k[v] - nodes + le_ftz(last, x[v]);
}

// The same counts over the m sorted boundaries b in device memory (m >= 1),
// by a branchless search of fixed trip count.  Invariant: every boundary
// below `base` is <= x, and the count is at most base + n; a step probes
// b[base + n/2] and keeps the half that holds the count.  After
// ceil(log2 m) steps n = 1 and one more probe decides: ceil(log2 m) + 1
// dependent loads, the same for every lane.  The compare is le_ftz, so the
// counts are a prefix of the flushed boundaries exactly as in the tree.
__device__ __forceinline__ void bucket_counts_global(const float* __restrict__ b, int m,
                                                     const float (&x)[kBucketValues],
                                                     uint32_t (&count)[kBucketValues]) {
  constexpr int V = kBucketValues;
  uint32_t base[V];
#pragma unroll
  for (int v = 0; v < V; ++v) base[v] = 0;
  for (int n = m; n > 1; n -= n >> 1) {
    const uint32_t half = n >> 1;
#pragma unroll
    for (int v = 0; v < V; ++v) base[v] += le_ftz(__ldg(b + base[v] + half), x[v]) ? half : 0u;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) count[v] = base[v] + le_ftz(__ldg(b + base[v]), x[v]);
}

// The body of bucketize_kernel and fused_gen_kernel over n values per
// feature.  Grid bucket_grid(F, n), kBucketThreads threads, dynamic shared
// memory bucket_smem.  `staged`: the boundaries go into a tree in shared
// memory; otherwise they are searched in device memory (m > 32768).
// `load(k, x)` reads values k .. k + V - 1 of the block's feature into x
// (called only for k < n; the loader masks a ragged tail), `store(k, count)`
// writes their results.
template <class Load, class Store>
__device__ __forceinline__ void bucket_tile(const float* __restrict__ bounds, int m,
                                            bool staged, long long n, Load load,
                                            Store store) {
  constexpr int V = kBucketValues;
  extern __shared__ __align__(128) uint32_t s[];
  const long long k = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  const bool live = k < n;
  float x[V];
  if (live) load(k, x);
  const float* b = bounds + (long long)blockIdx.y * m;
  uint32_t count[V];
  if (staged) {  // the same for the whole block
    const int levels = tree_levels(m);
    float* tree = reinterpret_cast<float*>(s);
    stage_tree(tree, b, m, levels);
    __syncthreads();
    if (!live) return;
    bucket_counts(tree, m, levels, x, count);
  } else {
    if (!live) return;
    bucket_counts_global(b, m, x, count);
  }
  store(k, count);
}

inline dim3 bucket_grid(long long f, long long n) {
  constexpr long long per_block = (long long)kBucketThreads * kBucketValues;
  return dim3((unsigned)((n + per_block - 1) / per_block), (unsigned)f);
}

// Lets `kernel` take the shared memory of the tree over m boundaries, 2^L
// floats (above 48 KB only after this call); none when not `staged`.
template <class Kernel>
inline cudaError_t bucket_smem(Kernel kernel, int m, bool staged, size_t* bytes) {
  *bytes = staged && m > 0 ? sizeof(float) << tree_levels(m) : 0;
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

}  // namespace presto

extern "C" const char* presto_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
