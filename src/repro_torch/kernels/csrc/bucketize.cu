// Standalone Bucketize pass for Hopper (sm_90a): feature generation in the
// host (one-operator-per-pass) lowering.  Plain C entry point, loaded with
// ctypes (kernels/_build.py, kernels/bucketize.py); returns
// cudaGetLastError().  The launch goes on the caller's stream and never
// synchronises.
//
// bucketize — replaces repro/kernels/bucketize.py:bucketize_pallas.
// (F, R) f32 values + (F, m) sorted, NaN-free boundaries (+inf padded to a
// multiple of 128) -> (F, R) int32 counts #{j : b[j] <= x}.
// Bound by latency at the paths' sizes, as fused_gen: 8 B per value plus the
// boundaries once per block are under half a microsecond of bytes, while each
// value waits on two trips to device memory and a search of log2(m)
// dependent shared loads.  Design: the bucket tiles of common.cuh, shared
// with fused_gen, so this pass and fused_gen give the same counts for +inf,
// NaN and subnormals; thread t counts 4 consecutive values in lockstep.  An
// m above 32768 is searched in device memory (`staged` false).
// 16-byte loads and stores when the rows are 16-byte aligned (aligned base and
// R % 4 == 0), else masked 4-byte accesses.

#include "common.cuh"

namespace {

using namespace presto;

__global__ void bucketize_kernel(const float* __restrict__ values,
                                 const float* __restrict__ bounds, uint32_t* __restrict__ out,
                                 long long r, int m, bool staged, bool vector_access) {
  const long long first = (long long)blockIdx.y * r;
  bucket_tile(
      bounds, m, staged, r,
      [&](long long k, float(&x)[kBucketValues]) {
        if (vector_access) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(values + first + k));
          x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
          return;
        }
#pragma unroll
        for (int v = 0; v < kBucketValues; ++v) x[v] = k + v < r ? __ldg(values + first + k + v) : 0.f;
      },
      [&](long long k, const uint32_t(&c)[kBucketValues]) {
        if (vector_access) {
          *reinterpret_cast<uint4*>(out + first + k) = make_uint4(c[0], c[1], c[2], c[3]);
          return;
        }
#pragma unroll
        for (int v = 0; v < kBucketValues; ++v)
          if (k + v < r) out[first + k + v] = c[v];
      });
}

}  // namespace

extern "C" {

int presto_bucketize(const void* values, const void* bounds, void* out, long long f,
                     long long r, int m, int staged, void* stream) {
  size_t smem;
  const cudaError_t err = bucket_smem(bucketize_kernel, m, staged, &smem);
  if (err != cudaSuccess) return (int)err;
  const bool vector_access = aligned16(values) && aligned16(out) && r % 4 == 0;
  bucketize_kernel<<<bucket_grid(f, r), kBucketThreads, smem, (cudaStream_t)stream>>>(
      (const float*)values, (const float*)bounds, (uint32_t*)out, r, m, staged != 0, vector_access);
  return (int)cudaGetLastError();
}

}  // extern "C"
