// Standalone columnar page decoders for Hopper (sm_90a): the Decode passes
// of the host (one-operator-per-pass) lowering.  Plain C entry points,
// loaded with ctypes (kernels/_build.py, kernels/decode.py); each returns
// cudaGetLastError() so the caller can raise on a refused launch.  Launches
// go on the caller's stream and never synchronise.  The tail is masked, so
// any G (including a megabatch's K*G) works.

#include "common.cuh"

namespace {

using namespace presto;

// ---------------------------------------------------------------------------
// bytesplit — replaces repro/kernels/decode.py:bytesplit_pallas.
// (F, G, 4) plane words -> (F, G, 4) f32 values, bit-exact (NaN payloads
// included): the kernel permutes bytes and stores the bits, with no float
// arithmetic.  Bound by bytes: 16 B in and 16 B out per group.  Design: one
// thread per group, one 16-byte load and one 16-byte store, neighbouring
// threads on neighbouring 16-byte words.  Words that are a view not aligned
// to 16 bytes take four 4-byte loads instead (the choice is uniform over the
// launch).
__global__ void bytesplit_kernel(const uint32_t* __restrict__ words,
                                 uint4* __restrict__ out, long long n_groups,
                                 bool vector_loads) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_groups) return;
  uint4 p;
  if (vector_loads) {
    p = reinterpret_cast<const uint4*>(words)[i];
  } else {
    const uint32_t* q = words + 4 * i;
    p = make_uint4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
  }
  out[i] = make_uint4(bytesplit_bits<0>(p), bytesplit_bits<1>(p), bytesplit_bits<2>(p),
                      bytesplit_bits<3>(p));
}

// bitunpack — replaces repro/kernels/decode.py:bitunpack_pallas.
// (F, G, W) bit-packed words -> (F, G, 32) int32 values.  Bound by bytes:
// 4W B in and 128 B out per group, against two shared-memory reads, a funnel
// shift and a mask per value.  Design: the bit-packed tiles of common.cuh
// with no hash: a block's tile of 128 groups arrives in shared memory by one
// bulk copy (4-byte loads where the range is not 16-byte aligned), lane j of
// a warp extracts value j of a group, and each warp store is one whole line.
__global__ void __launch_bounds__(kTileThreads)
    bitunpack_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
                     long long groups_per_feature, int width) {
  unpack_tile<false>(words, nullptr, out, groups_per_feature, width);
}

}  // namespace

extern "C" {

int presto_bitunpack(const void* words, void* out, long long f, long long g, int width,
                     void* stream) {
  if (width < 1 || width > 32) return (int)cudaErrorInvalidValue;
  bitunpack_kernel<<<tile_grid(f, g), kTileThreads, tile_smem(width), (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint32_t*)out, g, width);
  return (int)cudaGetLastError();
}

int presto_bytesplit(const void* words, void* out, long long n_groups, void* stream) {
  constexpr int threads = 256;
  const long long blocks = (n_groups + threads - 1) / threads;
  bytesplit_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint4*)out, n_groups, aligned16(words));
  return (int)cudaGetLastError();
}

}  // extern "C"
