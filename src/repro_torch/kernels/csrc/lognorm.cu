// Standalone Log pass for Hopper (sm_90a): dense normalization in the host
// (one-operator-per-pass) lowering.  Plain C entry point, loaded with ctypes
// (kernels/_build.py, kernels/lognorm.py); returns cudaGetLastError().  The
// launch goes on the caller's stream and never synchronises.
//
// lognorm — replaces repro/kernels/lognorm.py:lognorm_pallas.
// n f32 values, any shape flattened -> log1p(x < 0 ? 0 : x), NaN kept (C5).
// Bound by bytes: 4 B in and 4 B out per value against one log1pf.  Design:
// each thread takes 4 consecutive values as one 16-byte load and store when
// both pointers are 16-byte aligned; the last partial vector, and every
// value of an unaligned view, takes masked 4-byte accesses in the same
// kernel.  The same `lognorm` as fused_dense (common.cuh), so
// bytesplit -> lognorm equals fused_dense bit for bit.

#include "common.cuh"

namespace {

using namespace presto;

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__global__ void lognorm_kernel(const float* __restrict__ x, float* __restrict__ out,
                               long long n, bool vector_access) {
  const long long j = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * kPerThread;
  if (j >= n) return;
  if (vector_access && j + kPerThread <= n) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + j));
    reinterpret_cast<float4*>(out)[j / kPerThread] =
        make_float4(lognorm(v.x), lognorm(v.y), lognorm(v.z), lognorm(v.w));
    return;
  }
  for (int k = 0; k < kPerThread && j + k < n; ++k) out[j + k] = lognorm(__ldg(x + j + k));
}

}  // namespace

extern "C" {

int presto_lognorm(const void* x, void* out, long long n, void* stream) {
  constexpr long long per_block = (long long)kThreads * kPerThread;
  const long long blocks = (n + per_block - 1) / per_block;
  lognorm_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n, aligned16(x) && aligned16(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
