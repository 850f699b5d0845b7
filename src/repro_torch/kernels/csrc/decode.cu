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
// bitunpack — replaces repro/kernels/decode.py:bitunpack_pallas.
// (F, G, W) bit-packed words -> (F, G, 32) int32 values.
// Bound by bytes: 4W B in and 128 B out per group of 32 values, a handful of
// shifts per value.  Design: the TPU kernel's static shifts become a
// template on W (unpack_group<W>, shared with fused_sparse), so the group's
// W words sit in registers and every (word, offset) is a constant.  One
// thread per group; as in fused_sparse, neighbouring threads' loads and
// stores are W and 32 words apart, so coalescing is poor in this first
// version.
template <int W>
__global__ void bitunpack_kernel(const uint32_t* __restrict__ words,
                                 uint4* __restrict__ out, long long n_groups) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_groups) return;
  uint32_t w[W], v[32];
  load_group<W>(words + i * W, w);
  unpack_group<W>(w, v);
  uint4* o = out + i * 8;
#pragma unroll
  for (int q = 0; q < 8; ++q) o[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int W>
void launch_bitunpack(const uint32_t* words, uint4* out, long long n, cudaStream_t stream) {
  constexpr int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  bitunpack_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(words, out, n);
}

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

}  // namespace

extern "C" {

int presto_bitunpack(const void* words, void* out, long long n_groups, int width,
                     void* stream) {
  const uint32_t* w = (const uint32_t*)words;
  uint4* o = (uint4*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
#define PRESTO_BITUNPACK_CASE(W) \
  case W: launch_bitunpack<W>(w, o, n_groups, s); break;
    PRESTO_FOR_EACH_WIDTH(PRESTO_BITUNPACK_CASE)
#undef PRESTO_BITUNPACK_CASE
    default: return (int)cudaErrorInvalidValue;
  }
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
