// Fused ISP preprocessing kernels for Hopper (sm_90a).
//
// One kernel per column-family chain of the PreSto Transform: each reads the
// encoded page words once and writes train-ready values once, with every
// intermediate in registers or shared memory.  Plain C entry points, loaded
// with ctypes (kernels/_build.py, kernels/fused.py); each returns
// cudaGetLastError() so the caller can raise on a refused launch.  Launches go
// on the caller's stream and never synchronise.
//
// Words arrive as int32 tensors carrying uint32 bit patterns; the kernels
// reinterpret them as unsigned.  The tail is masked: no kernel needs the row
// groups padded to a block multiple, so any G (including the K*G of a
// megabatch) gives the same values as the plain versions in kernels/ref.py.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

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

// Value j of a byte-split group: byte j of each of the 4 plane words, as
// two byte permutes of plane pairs and one merge.
template <int J>
__device__ __forceinline__ float bytesplit_value(uint4 p) {
  constexpr uint32_t sel = J | ((J + 4) << 4);
  const uint32_t lo = __byte_perm(p.x, p.y, sel);  // [x.b_J, y.b_J, ..]
  const uint32_t hi = __byte_perm(p.z, p.w, sel);  // [z.b_J, w.b_J, ..]
  return __uint_as_float(__byte_perm(lo, hi, 0x5410));
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
// fused_dense — replaces repro/kernels/fused.py:fused_dense_pallas.
// (F, G, 4) plane words -> (F, G, 4) f32 log1p(max(x, 0)).
// Bound by bytes: 16 B in and 16 B out per group, a few integer ops and one
// log1pf per value.  Design: one thread per group, one 16-byte load, four
// byte-permuted floats, one 16-byte store; neighbouring threads touch
// neighbouring 16-byte words, so loads and stores are fully coalesced.
__global__ void fused_dense_kernel(const uint4* __restrict__ words,
                                   float4* __restrict__ out, long long n_groups) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_groups) return;
  const uint4 p = words[i];
  float4 r;
  r.x = lognorm(bytesplit_value<0>(p));
  r.y = lognorm(bytesplit_value<1>(p));
  r.z = lognorm(bytesplit_value<2>(p));
  r.w = lognorm(bytesplit_value<3>(p));
  out[i] = r;
}

// ---------------------------------------------------------------------------
// fused_sparse — replaces repro/kernels/fused.py:fused_sparse_pallas.
// (F, G, W) bit-packed words + (F, 2) [seed, max] -> (F, G, 32) int32.
// Bound by bytes: 4W B in and 128 B out per group of 32 ids.  Design: the
// TPU kernel's static shifts become a template on W, so every (word, bit)
// offset is a compile-time constant and the group's W words sit in
// registers.  One thread per group; value j reads word wid+1 only when it
// straddles a word edge, so no read leaves the group.  A thread's loads and
// stores are W and 32 words apart from its neighbour's: coalescing is poor
// in this first version (stores go out as 8 16-byte writes per thread).
template <int W>
__global__ void fused_sparse_kernel(const uint32_t* __restrict__ words,
                                    const uint32_t* __restrict__ params,
                                    int4* __restrict__ out,
                                    long long groups_per_feature, long long n_groups) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_groups) return;
  const long long f = i / groups_per_feature;
  const uint32_t seed = __ldg(params + 2 * f);
  const uint32_t d = __ldg(params + 2 * f + 1);
  const uint32_t* p = words + i * W;
  uint32_t w[W];
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] = __ldg(p + k);
  constexpr uint32_t mask = W == 32 ? 0xFFFFFFFFu : ((1u << (W & 31)) - 1u);
  int4* o = out + i * 8;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    uint32_t v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int bit = (q * 4 + t) * W;
      const int wid = bit >> 5, off = bit & 31;
      uint32_t val = w[wid] >> off;
      if (off != 0 && off + W > 32) val |= w[wid + 1 < W ? wid + 1 : W - 1] << (32 - off);
      v[t] = sigridhash(val & mask, seed, d);
    }
    o[q] = make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
  }
}

// ---------------------------------------------------------------------------
// fused_gen — replaces repro/kernels/fused.py:fused_gen_pallas.
// (F, G, 4) plane words + (F, m) sorted boundaries (+inf padded) + (F, 2)
// [seed, max] -> (F, G, 4) int32.
// Bound by bytes at these sizes: 16 B in and 16 B out per group plus the
// boundaries once per block; the TPU's m compares per value become a binary
// search of log2(m) steps.  Design: one block per (tile of groups, feature);
// the block stages its feature's boundaries in dynamic shared memory (4 KB at
// m=1024, 16 KB at m=4096), then one thread per group decodes its 4 values,
// searches, hashes and stores 16 bytes.
constexpr int kGenThreads = 256;

__global__ void fused_gen_kernel(const uint4* __restrict__ words,
                                 const float* __restrict__ bounds,
                                 const uint32_t* __restrict__ params,
                                 int4* __restrict__ out,
                                 long long groups_per_feature, int m) {
  extern __shared__ float sb[];
  const int f = blockIdx.y;
  const float* b = bounds + (long long)f * m;
  for (int k = threadIdx.x; k < m; k += blockDim.x) sb[k] = flush_denormal(b[k]);
  __syncthreads();
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (g >= groups_per_feature) return;
  const uint32_t seed = __ldg(params + 2 * f);
  const uint32_t d = __ldg(params + 2 * f + 1);
  const long long i = (long long)f * groups_per_feature + g;
  const uint4 p = words[i];
  out[i] = make_int4((int)sigridhash(bucket(sb, m, bytesplit_value<0>(p)), seed, d),
                     (int)sigridhash(bucket(sb, m, bytesplit_value<1>(p)), seed, d),
                     (int)sigridhash(bucket(sb, m, bytesplit_value<2>(p)), seed, d),
                     (int)sigridhash(bucket(sb, m, bytesplit_value<3>(p)), seed, d));
}

template <int W>
void launch_sparse(const uint32_t* words, const uint32_t* params, int4* out,
                   long long gpf, long long n, cudaStream_t stream) {
  constexpr int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  fused_sparse_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(words, params, out, gpf, n);
}

}  // namespace

extern "C" {

const char* presto_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int presto_fused_dense(const void* words, void* out, long long n_groups, void* stream) {
  constexpr int threads = 256;
  const long long blocks = (n_groups + threads - 1) / threads;
  fused_dense_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)words, (float4*)out, n_groups);
  return (int)cudaGetLastError();
}

int presto_fused_sparse(const void* words, const void* params, void* out, long long f,
                        long long g, int width, void* stream) {
  const uint32_t* w = (const uint32_t*)words;
  const uint32_t* p = (const uint32_t*)params;
  int4* o = (int4*)out;
  const long long n = f * g;
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
#define PRESTO_SPARSE_CASE(W) \
  case W: launch_sparse<W>(w, p, o, g, n, s); break;
    PRESTO_SPARSE_CASE(1) PRESTO_SPARSE_CASE(2) PRESTO_SPARSE_CASE(3) PRESTO_SPARSE_CASE(4)
    PRESTO_SPARSE_CASE(5) PRESTO_SPARSE_CASE(6) PRESTO_SPARSE_CASE(7) PRESTO_SPARSE_CASE(8)
    PRESTO_SPARSE_CASE(9) PRESTO_SPARSE_CASE(10) PRESTO_SPARSE_CASE(11) PRESTO_SPARSE_CASE(12)
    PRESTO_SPARSE_CASE(13) PRESTO_SPARSE_CASE(14) PRESTO_SPARSE_CASE(15) PRESTO_SPARSE_CASE(16)
    PRESTO_SPARSE_CASE(17) PRESTO_SPARSE_CASE(18) PRESTO_SPARSE_CASE(19) PRESTO_SPARSE_CASE(20)
    PRESTO_SPARSE_CASE(21) PRESTO_SPARSE_CASE(22) PRESTO_SPARSE_CASE(23) PRESTO_SPARSE_CASE(24)
    PRESTO_SPARSE_CASE(25) PRESTO_SPARSE_CASE(26) PRESTO_SPARSE_CASE(27) PRESTO_SPARSE_CASE(28)
    PRESTO_SPARSE_CASE(29) PRESTO_SPARSE_CASE(30) PRESTO_SPARSE_CASE(31) PRESTO_SPARSE_CASE(32)
#undef PRESTO_SPARSE_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int presto_fused_gen(const void* words, const void* bounds, const void* params, void* out,
                     long long f, long long g, int m, void* stream) {
  const size_t smem = (size_t)m * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_gen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((g + kGenThreads - 1) / kGenThreads), (unsigned)f);
  fused_gen_kernel<<<grid, kGenThreads, smem, (cudaStream_t)stream>>>(
      (const uint4*)words, (const float*)bounds, (const uint32_t*)params, (int4*)out, g, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
