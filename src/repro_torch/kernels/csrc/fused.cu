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

// ---------------------------------------------------------------------------
// fused_sparse — replaces repro/kernels/fused.py:fused_sparse_pallas.
// (F, G, W) bit-packed words + (F, 2) [seed, max] -> (F, G, 32) int32 ids.
// Bound by bytes: 4W B in and 128 B out per group of 32 ids; the hash (about
// 35 integer instructions per id, one 32-bit modulo among them) stays under
// the byte time.  Design: bitunpack's bit-packed tiles (common.cuh), each
// value hashed before its whole-line store; the block reads its feature's
// [seed, max] once.
__global__ void __launch_bounds__(kTileThreads)
    fused_sparse_kernel(const uint32_t* __restrict__ words, const uint32_t* __restrict__ params,
                        uint32_t* __restrict__ out, long long groups_per_feature, int width) {
  unpack_tile<true>(words, params, out, groups_per_feature, width);
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
  if (width < 1 || width > 32) return (int)cudaErrorInvalidValue;
  fused_sparse_kernel<<<tile_grid(f, g), kTileThreads, tile_smem(width), (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const uint32_t*)params, (uint32_t*)out, g, width);
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
