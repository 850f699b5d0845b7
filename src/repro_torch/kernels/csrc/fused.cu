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
// The per-value arithmetic lives in common.cuh, shared with the standalone
// kernels of the host lowering.

#include "common.cuh"

namespace {

using namespace presto;

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
// registers (unpack_group<W>, common.cuh).  One thread per group.  A
// thread's loads and stores are W and 32 words apart from its neighbour's:
// coalescing is poor in this first version (stores go out as 8 16-byte
// writes per thread).
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
  uint32_t w[W], v[32];
  load_group<W>(words + i * W, w);
  unpack_group<W>(w, v);
  int4* o = out + i * 8;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    o[q] = make_int4((int)sigridhash(v[4 * q], seed, d), (int)sigridhash(v[4 * q + 1], seed, d),
                     (int)sigridhash(v[4 * q + 2], seed, d), (int)sigridhash(v[4 * q + 3], seed, d));
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
    PRESTO_FOR_EACH_WIDTH(PRESTO_SPARSE_CASE)
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
