// Standalone Bucketize pass for Hopper (sm_90a): feature generation in the
// host (one-operator-per-pass) lowering.  Plain C entry point, loaded with
// ctypes (kernels/_build.py, kernels/bucketize.py); returns
// cudaGetLastError().  The launch goes on the caller's stream and never
// synchronises.
//
// bucketize — replaces repro/kernels/bucketize.py:bucketize_pallas.
// (F, R) f32 values + (F, m) sorted, NaN-free boundaries (+inf padded to a
// multiple of 128) -> (F, R) int32 counts #{j : b[j] <= x}.
// Bound by bytes at the path's sizes (8 B per value plus the boundaries
// once per block); the TPU's m compares per value become a binary search of
// log2(m) steps in shared memory.  Design: one block per (tile of values,
// feature), as fused_gen: the block stages its feature's boundaries, flushed
// of subnormals, in dynamic shared memory (4 KB at m=1024, 16 KB at m=4096),
// then each thread counts 4 consecutive values with the shared `bucket`
// (common.cuh), so this pass and fused_gen give the same counts for +inf,
// NaN and subnormals.  16-byte loads and stores when the rows are 16-byte
// aligned (aligned base and R % 4 == 0), else masked 4-byte accesses.

#include "common.cuh"

namespace {

using namespace presto;

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__global__ void bucketize_kernel(const float* __restrict__ values,
                                 const float* __restrict__ bounds,
                                 uint32_t* __restrict__ out, long long r, int m,
                                 bool vector_access) {
  extern __shared__ float sb[];
  const int f = blockIdx.y;
  const float* b = bounds + (long long)f * m;
  for (int k = threadIdx.x; k < m; k += blockDim.x) sb[k] = flush_denormal(b[k]);
  __syncthreads();
  const long long j = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * kPerThread;
  if (j >= r) return;
  const long long i = (long long)f * r + j;
  if (vector_access && j + kPerThread <= r) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(values + i));
    reinterpret_cast<uint4*>(out)[i / kPerThread] =
        make_uint4(bucket(sb, m, x.x), bucket(sb, m, x.y), bucket(sb, m, x.z),
                   bucket(sb, m, x.w));
    return;
  }
  for (int k = 0; k < kPerThread && j + k < r; ++k)
    out[i + k] = bucket(sb, m, __ldg(values + i + k));
}

}  // namespace

extern "C" {

int presto_bucketize(const void* values, const void* bounds, void* out, long long f,
                     long long r, int m, void* stream) {
  const size_t smem = (size_t)m * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bucketize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  constexpr long long per_block = (long long)kThreads * kPerThread;
  const dim3 grid((unsigned)((r + per_block - 1) / per_block), (unsigned)f);
  const bool vector_access = aligned16(values) && aligned16(out) && r % kPerThread == 0;
  bucketize_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)values, (const float*)bounds, (uint32_t*)out, r, m, vector_access);
  return (int)cudaGetLastError();
}

}  // extern "C"
