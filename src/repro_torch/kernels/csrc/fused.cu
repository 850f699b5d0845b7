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
// Bound by latency at the paths' sizes: 32 B per group plus the boundaries
// once per block are under half a microsecond of bytes, while each value
// waits on two trips to device memory and a search of log2(m) dependent
// shared loads.  Design: the bucket tiles of common.cuh (the TPU's m compares
// per value become a search of an Eytzinger tree, or of the sorted
// boundaries in device memory when m > 32768); thread t decodes group
// t's 4 values from its one 16-byte load, counts them in lockstep, hashes
// them and stores 16 bytes.  The block reads its feature's [seed, max] once.

__global__ void fused_gen_kernel(const uint4* __restrict__ words,
                                 const float* __restrict__ bounds,
                                 const uint32_t* __restrict__ params, uint4* __restrict__ out,
                                 long long groups_per_feature, int m, bool staged) {
  const int f = blockIdx.y;
  const uint32_t seed = __ldg(params + 2 * f);
  const uint32_t d = __ldg(params + 2 * f + 1);
  const long long first = (long long)f * groups_per_feature;
  bucket_tile(
      bounds, m, staged, 4 * groups_per_feature,
      [&](long long k, float(&x)[kBucketValues]) {
        const uint4 p = __ldg(words + first + k / 4);
        x[0] = bytesplit_value<0>(p);
        x[1] = bytesplit_value<1>(p);
        x[2] = bytesplit_value<2>(p);
        x[3] = bytesplit_value<3>(p);
      },
      [&](long long k, const uint32_t(&c)[kBucketValues]) {
        out[first + k / 4] = make_uint4(sigridhash(c[0], seed, d), sigridhash(c[1], seed, d),
                                        sigridhash(c[2], seed, d), sigridhash(c[3], seed, d));
      });
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
                     long long f, long long g, int m, int staged, void* stream) {
  size_t smem;
  const cudaError_t err = bucket_smem(fused_gen_kernel, m, staged, &smem);
  if (err != cudaSuccess) return (int)err;
  fused_gen_kernel<<<bucket_grid(f, 4 * g), kBucketThreads, smem, (cudaStream_t)stream>>>(
      (const uint4*)words, (const float*)bounds, (const uint32_t*)params, (uint4*)out, g, m, staged != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
