// Embedding bag of the one-device DLRM for Hopper (sm_90a): the mean-pooled
// (B, T, D) forward and the dense (T, R, D) table gradient, in float32 (the
// trainer) or float64 (the elastic drill's control).  Plain C entry points,
// loaded with ctypes (kernels/_build.py, kernels/embedding.py); each returns
// cudaGetLastError().  The launches go on the caller's stream and never
// synchronise.
//
// Replaces no Pallas kernel: the JAX package pools with a plain gather
// (repro/models/recsys.py:_local_bag) and leaves the gradient to XLA's
// scatter-add.  Before this, the port ran one F.embedding_bag over all
// S*L + G positions of a sample, the padding weighted 0, and its backward
// zero-filled the dense gradient, wrote a per-position intermediate and
// scattered it.
//
// Bound by bytes.  The forward gathers one D-element row per valid position
// (RM2 at 8,192 rows: 7.05 M rows, 3.6 GB in float32); the backward writes
// the whole dense gradient (RM2: 31.5 M rows, 16.1 GB) and reads grad_out
// once per valid position.  The design touches only valid positions and
// writes every gradient row exactly once:
//
// * forward: one warp a bag (b, t), each lane holding 4 elements of the row
//   per 128 columns.  The bag's ids are loaded 32 at a time, validity is a
//   ballot (position < length, 0 <= id < R), and only the set bits are
//   gathered, four rows in flight, summed in position order.  The mean is
//   sum / max(count, 1).  The bag's count goes to `counts`; with `keys` the
//   kernel also writes each position's flat row t*R + id, or T*R where the
//   position counts nothing, for the backward.
// * backward: the keys, stable-sorted with their positions (torch.sort, glue
//   between the two entry points), put every row's contributions together
//   in position order.  `bag_starts` marks each row's first sorted position
//   in a row -> start map (-1: no contribution); `bag_partials` sums every
//   aligned chunk of kChunk sorted positions that lies inside one row (a hot
//   row: under skew one Bucketized row takes thousands of lookups);
//   `bag_grad` then gives each warp 32 consecutive rows and writes each row
//   once: zeros, or the sum of grad_out[b, t] / count[b, t] over its
//   contributions in sorted order, whole chunks taken from their partials.
//   The zero-fill, the per-position intermediate and the scatter become one
//   streaming write of the gradient.  No float atomics: the same inputs give
//   the same bits.

#include "common.cuh"

namespace {

using namespace presto;

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;  // sorted positions a partial sum of a hot row covers
constexpr unsigned kFull = 0xFFFFFFFFu;

// The bag's geometry: T tables of R rows of D elements; a sample holds S
// multi-hot bags of L positions, then G one-hot bags (T = S + G), P = S*L + G
// positions in all.
struct Geometry {
  int tables, rows, dim, multi, len, one, per_sample;
};

// Four consecutive elements, moved as one float4 or two double2 (16-byte
// aligned: D is a multiple of 4 and the rows are 16-byte aligned).
__device__ __forceinline__ void load4(float (&x)[4], const float* p) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
}
__device__ __forceinline__ void load4(double (&x)[4], const double* p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
template <bool kStream>
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  const float4 q = make_float4(x[0], x[1], x[2], x[3]);
  if (kStream)
    __stcs(reinterpret_cast<float4*>(p), q);
  else
    *reinterpret_cast<float4*>(p) = q;
}
template <bool kStream>
__device__ __forceinline__ void store4(double* p, const double (&x)[4]) {
  const double2 a = make_double2(x[0], x[1]), b = make_double2(x[2], x[3]);
  double2* q = reinterpret_cast<double2*>(p);
  if (kStream) {
    __stcs(q, a);
    __stcs(q + 1, b);
  } else {
    q[0] = a;
    q[1] = b;
  }
}
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T, int NV>
struct Row {  // a warp's D elements: lane j holds columns 4j + 128q .. + 3
  T v[NV][4];
};

__device__ __forceinline__ int column(int q, int lane) { return (q * 32 + lane) * 4; }

template <typename T, int NV>
__device__ __forceinline__ void zero(Row<T, NV>& r) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) r.v[q][e] = T(0);
  }
}

template <typename T, int NV>
__device__ __forceinline__ void load_row(Row<T, NV>& r, const T* p, int dim, int lane) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    if (column(q, lane) < dim) {
      load4(r.v[q], p + column(q, lane));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) r.v[q][e] = T(0);
    }
  }
}

template <typename T, int NV>
__device__ __forceinline__ void add(Row<T, NV>& acc, const Row<T, NV>& x) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.v[q][e] += x.v[q][e];
  }
}

// acc += x / c, each quotient rounded (IEEE division), as grad_out / count
// and then a sum would be.
template <typename T, int NV>
__device__ __forceinline__ void add_quotient(Row<T, NV>& acc, const Row<T, NV>& x, T c) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.v[q][e] += div_rn(x.v[q][e], c);
  }
}

template <bool kStream, typename T, int NV>
__device__ __forceinline__ void store_row(T* p, const Row<T, NV>& r, int dim, int lane) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    if (column(q, lane) < dim) store4<kStream>(p + column(q, lane), r.v[q]);
  }
}

// Sum into `acc` the table rows of the positions whose bits `mask` sets
// (warp-uniform), in position order; lane j holds position j's row id.
// Four rows are loaded before any is added.
template <typename T, int NV>
__device__ __forceinline__ void gather_rows(Row<T, NV>& acc, const T* table, int id,
                                            unsigned mask, int dim, int lane) {
  while (mask) {
    int r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      r[u] = mask ? __shfl_sync(kFull, id, __ffs(mask) - 1) : -1;
      mask &= mask - 1;
    }
    Row<T, NV> x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r[u] >= 0)
        load_row(x[u], table + (long long)r[u] * dim, dim, lane);
      else
        zero(x[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (r[u] >= 0) add(acc, x[u]);
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    bag_forward_kernel(const T* __restrict__ tables, const int* __restrict__ multi_ids,
                       const int* __restrict__ lengths, const int* __restrict__ one_ids,
                       T* __restrict__ out, int* __restrict__ counts, int* __restrict__ keys,
                       long long bags, Geometry g) {
  const int lane = threadIdx.x & 31;
  const long long bag = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= bags) return;  // the whole warp
  const long long b = bag / g.tables;
  const int t = (int)(bag - b * g.tables);
  const T* table = tables + (long long)t * g.rows * g.dim;
  const int key_base = t * g.rows;
  const int none = g.tables * g.rows;  // the key of a position that counts nothing
  Row<T, NV> acc;
  zero(acc);
  int count = 0;
  if (t < g.multi) {
    const long long bag_in = b * g.multi + t;
    const int* ids = multi_ids + bag_in * g.len;
    const int n = min(max(__ldg(lengths + bag_in), 0), g.len);
    int* key_out = keys ? keys + b * g.per_sample + (long long)t * g.len : nullptr;
    for (int l0 = 0; l0 < g.len; l0 += 32) {
      const int l = l0 + lane;
      const int id = l < g.len ? __ldg(ids + l) : -1;
      const bool valid = l < n && id >= 0 && id < g.rows;
      if (key_out && l < g.len) key_out[l] = valid ? key_base + id : none;
      const unsigned mask = __ballot_sync(kFull, valid);
      count += __popc(mask);
      gather_rows(acc, table, id, mask, g.dim, lane);
    }
  } else {
    const int j = t - g.multi;
    const int id = __ldg(one_ids + b * g.one + j);  // the same id in every lane
    const bool valid = id >= 0 && id < g.rows;
    if (keys && lane == 0)
      keys[b * g.per_sample + (long long)g.multi * g.len + j] = valid ? key_base + id : none;
    count = valid;
    gather_rows(acc, table, id, valid ? 1u : 0u, g.dim, lane);
  }
  const T c = T(max(count, 1));
#pragma unroll
  for (int q = 0; q < NV; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.v[q][e] = div_rn(acc.v[q][e], c);
  }
  store_row<false>(out + bag * g.dim, acc, g.dim, lane);
  if (lane == 0) counts[bag] = count;
}

// What the backward kernels read: the sorted keys and the positions they
// came from, grad_out (B, T, D) by its strides, and the bags' counts.
template <typename T>
struct Sorted {
  const int* keys;
  const long long* perm;
  int n;  // sorted positions, B * P
  const T* grad_out;
  long long stride_b, stride_t;
  const int* counts;
};

// acc += the contributions of sorted positions [i, i + m) (m <= 32), all of
// table t: grad_out[b, t] / max(count[b, t], 1) in order.  Lane k resolves
// position i + k's sample; four rows are loaded before any is added.
template <typename T, int NV>
__device__ __forceinline__ void add_contributions(Row<T, NV>& acc, int i, int m, int t,
                                                  const Sorted<T>& s, const Geometry& g,
                                                  int lane) {
  int b = 0;
  T c = T(1);
  if (lane < m) {
    b = (int)__ldg(s.perm + i + lane) / g.per_sample;  // n < 2^31
    c = T(max(__ldg(s.counts + (long long)b * g.tables + t), 1));
  }
  const T* col = s.grad_out + (long long)t * s.stride_t;
  for (int k0 = 0; k0 < m; k0 += 4) {
    Row<T, NV> x[4];
    T cu[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int bk = __shfl_sync(kFull, b, (k0 + u) & 31);
      cu[u] = __shfl_sync(kFull, c, (k0 + u) & 31);
      if (k0 + u < m)
        load_row(x[u], col + (long long)bk * s.stride_b, g.dim, lane);
      else
        zero(x[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k0 + u < m) add_quotient(acc, x[u], cu[u]);
  }
}

// The first sorted position of every row that has one.
__global__ void bag_starts_kernel(const int* __restrict__ keys, int* __restrict__ starts, int n,
                                  int none) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = __ldg(keys + i);
  if (k < none && (i == 0 || __ldg(keys + i - 1) != k)) starts[k] = i;
}

// Whether the aligned chunk at sorted position i (i % kChunk == 0) lies
// inside the run of `row`; `bag_partials` and `bag_grad` ask the same.
template <typename T>
__device__ __forceinline__ bool whole_chunk(const Sorted<T>& s, long long i, int row) {
  return i + kChunk <= s.n && __ldg(s.keys + i) == row && __ldg(s.keys + i + kChunk - 1) == row;
}

// acc += partials[c], ..., partials[c + w - 1] in order, four loaded before
// any is added.
template <typename T, int NV>
__device__ __forceinline__ void add_partials(Row<T, NV>& acc, const T* partials, int c, int w,
                                             int dim, int lane) {
  for (int k0 = 0; k0 < w; k0 += 4) {
    Row<T, NV> x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k0 + u < w)
        load_row(x[u], partials + (long long)(c + k0 + u) * dim, dim, lane);
      else
        zero(x[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k0 + u < w) add(acc, x[u]);
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    bag_partials_kernel(Sorted<T> s, T* __restrict__ partials, int chunks, Geometry g) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= chunks) return;
  const int i0 = c * kChunk;
  const int row = i0 < s.n ? __ldg(s.keys + i0) : -1;
  if (row < 0 || row >= g.tables * g.rows || !whole_chunk(s, i0, row)) return;
  Row<T, NV> acc;
  zero(acc);
  for (int i = i0; i < i0 + kChunk; i += 32) add_contributions(acc, i, 32, row / g.rows, s, g, lane);
  store_row<false>(partials + (long long)c * g.dim, acc, g.dim, lane);
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    bag_grad_kernel(Sorted<T> s, const int* __restrict__ starts, const T* __restrict__ partials,
                    T* __restrict__ grad, Geometry g) {
  const int lane = threadIdx.x & 31;
  const int total = g.tables * g.rows;
  const long long r0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (r0 >= total) return;
  const int first = r0 + lane < total ? __ldg(starts + r0 + lane) : -1;
  const unsigned busy = __ballot_sync(kFull, first >= 0);
  const int n_rows = (int)min(32LL, total - r0);
  for (int k = 0; k < n_rows; ++k) {
    const int row = (int)r0 + k;
    Row<T, NV> acc;
    zero(acc);
    if ((busy >> k) & 1u) {
      const int t = row / g.rows;
      int i = __shfl_sync(kFull, first, k);
      for (;;) {
        if (i % kChunk == 0) {
          // the whole chunks from i on, 32 at a time: sorted, so a prefix
          // of the lanes
          const bool whole = whole_chunk(s, i + (long long)lane * kChunk, row);
          const int w = __popc(__ballot_sync(kFull, whole));
          add_partials(acc, partials, i / kChunk, w, g.dim, lane);
          i += w * kChunk;
          if (w == 32) continue;
        }
        // up to the next chunk edge, so a whole chunk is always seen there
        const int lim = min(32, kChunk - i % kChunk);
        const bool mine = lane < lim && i + lane < s.n && __ldg(s.keys + i + lane) == row;
        const int m = __popc(__ballot_sync(kFull, mine));  // sorted: a prefix of the lanes
        if (m > 0) add_contributions(acc, i, m, t, s, g, lane);
        i += m;
        if (m < lim) break;
      }
    }
    store_row<true>(grad + (long long)row * g.dim, acc, g.dim, lane);
  }
}

template <typename T, int NV>
cudaError_t forward(const void* tables, const int* multi_ids, const int* lengths,
                    const int* one_ids, void* out, int* counts, int* keys, long long bags,
                    const Geometry& g, cudaStream_t stream) {
  const long long blocks = (bags + kWarps - 1) / kWarps;
  bag_forward_kernel<T, NV><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)tables, multi_ids, lengths, one_ids, (T*)out, counts, keys, bags, g);
  return cudaGetLastError();
}

template <typename T, int NV>
cudaError_t backward(const void* grad_out, long long stride_b, long long stride_t,
                     const int* counts, const int* sorted_keys, const long long* perm, int n,
                     int* starts, void* partials, void* grad, const Geometry& g,
                     cudaStream_t stream) {
  const Sorted<T> s{sorted_keys, perm, n, (const T*)grad_out, stride_b, stride_t, counts};
  const int total = g.tables * g.rows;
  cudaError_t err = cudaMemsetAsync(starts, 0xFF, (size_t)total * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    bag_starts_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        sorted_keys, starts, n, total);
    const int chunks = n / kChunk;
    if (chunks > 0)
      bag_partials_kernel<T, NV><<<(chunks + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          s, (T*)partials, chunks, g);
  }
  const long long tiles = ((long long)total + 31) / 32;
  bag_grad_kernel<T, NV><<<(unsigned)((tiles + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      s, starts, (const T*)partials, (T*)grad, g);
  return cudaGetLastError();
}

Geometry geometry(int t, int r, int d, int s, int len, int one) {
  return Geometry{t, r, d, s, len, one, s * len + one};
}

// The instantiation for the element type and D: NV float4s (or double2
// pairs) a lane, NV = 1, 2 or 4 for D up to 128, 256 or 512.
template <template <typename, int> class Fn, typename... Args>
cudaError_t dispatch(bool f64, int d, Args... args) {
  if (f64) {
    if (d > 256) return Fn<double, 4>::run(args...);
    if (d > 128) return Fn<double, 2>::run(args...);
    return Fn<double, 1>::run(args...);
  }
  if (d > 256) return Fn<float, 4>::run(args...);
  if (d > 128) return Fn<float, 2>::run(args...);
  return Fn<float, 1>::run(args...);
}

template <typename T, int NV>
struct Forward {
  template <typename... Args>
  static cudaError_t run(Args... args) { return forward<T, NV>(args...); }
};

template <typename T, int NV>
struct Backward {
  template <typename... Args>
  static cudaError_t run(Args... args) { return backward<T, NV>(args...); }
};

}  // namespace

extern "C" {

// tables (T, R, D) f32 or f64 (`f64`), multi_ids (B, S, L) i32, lengths
// (B, S) i32, one_ids (B, G) i32 -> out (B, T, D) of the tables' type,
// counts (B, T) i32 and, where `keys` is not null, keys (B, P) i32.  D is a
// multiple of 4, at most 512.
int presto_embedding_bag_forward(const void* tables, const void* multi_ids, const void* lengths,
                                 const void* one_ids, void* out, void* counts, void* keys,
                                 long long b, int t, int r, int d, int s, int len, int one,
                                 int f64, void* stream) {
  const Geometry g = geometry(t, r, d, s, len, one);
  const long long bags = b * t;
  if (bags == 0) return (int)cudaSuccess;
  return (int)dispatch<Forward>(f64 != 0, d, tables, (const int*)multi_ids,
                                (const int*)lengths, (const int*)one_ids, out, (int*)counts,
                                (int*)keys, bags, g, (cudaStream_t)stream);
}

// grad_out (B, T, D) of the tables' type (unit stride along D, rows 16-byte
// aligned), counts (B, T) i32, the n = B * P keys sorted stably and their
// positions (i64) -> grad (T, R, D), every row written.  Scratch: starts
// (T * R) i32 and partials (n / 64, D) of the tables' type.
int presto_embedding_bag_backward(const void* grad_out, long long stride_b, long long stride_t,
                                  const void* counts, const void* sorted_keys, const void* perm,
                                  int n, void* starts, void* partials, void* grad, int t, int r,
                                  int d, int s, int len, int one, int f64, void* stream) {
  const Geometry g = geometry(t, r, d, s, len, one);
  return (int)dispatch<Backward>(f64 != 0, d, grad_out, stride_b, stride_t, (const int*)counts,
                                 (const int*)sorted_keys, (const long long*)perm, n,
                                 (int*)starts, partials, grad, g, (cudaStream_t)stream);
}

}  // extern "C"
