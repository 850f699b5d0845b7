// Standalone SigridHash pass for Hopper (sm_90a): the hash of the host
// (one-operator-per-pass) lowering.  Plain C entry point, loaded with ctypes
// (kernels/_build.py, kernels/sigridhash.py); returns cudaGetLastError().
// The launch goes on the caller's stream and never synchronises.
//
// sigridhash — replaces repro/kernels/sigridhash.py:sigridhash_pallas.
// (F, N) int32 values + (F, 2) [seed, max] -> (F, N) int32 in [0, max).
// Bound by bytes: 4 B in and 4 B out per value against ~12 integer ops (one
// 32-bit modulo among them).  Design: the TPU grid's feature axis becomes
// blockIdx.y, so no thread divides to find its feature and the block reads
// its [seed, max] pair once; each thread hashes 4 consecutive values with
// one 16-byte load and store when the rows are 16-byte aligned (aligned base
// and N % 4 == 0), else with masked 4-byte accesses.  N is arbitrary (it
// reaches K*G*32 at a megabatch), so offsets are 64-bit.

#include "common.cuh"

namespace {

using namespace presto;

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__global__ void sigridhash_kernel(const uint32_t* __restrict__ values,
                                  const uint32_t* __restrict__ params,
                                  uint32_t* __restrict__ out, long long n,
                                  bool vector_access) {
  const int f = blockIdx.y;
  const uint32_t seed = __ldg(params + 2 * f);
  const uint32_t d = __ldg(params + 2 * f + 1);
  const long long j = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * kPerThread;
  if (j >= n) return;
  const long long i = (long long)f * n + j;
  if (vector_access && j + kPerThread <= n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(values + i));
    reinterpret_cast<uint4*>(out)[i / kPerThread] =
        make_uint4(sigridhash(v.x, seed, d), sigridhash(v.y, seed, d),
                   sigridhash(v.z, seed, d), sigridhash(v.w, seed, d));
    return;
  }
  for (int k = 0; k < kPerThread && j + k < n; ++k)
    out[i + k] = sigridhash(__ldg(values + i + k), seed, d);
}

}  // namespace

extern "C" {

int presto_sigridhash(const void* values, const void* params, void* out, long long f,
                      long long n, void* stream) {
  constexpr long long per_block = (long long)kThreads * kPerThread;
  const dim3 grid((unsigned)((n + per_block - 1) / per_block), (unsigned)f);
  const bool vector_access = aligned16(values) && aligned16(out) && n % kPerThread == 0;
  sigridhash_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)values, (const uint32_t*)params, (uint32_t*)out, n, vector_access);
  return (int)cudaGetLastError();
}

}  // extern "C"
