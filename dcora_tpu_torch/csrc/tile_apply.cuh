// Device helpers shared by the atomics SpMM kernels (spmm_tile.cu,
// spmm_grouped.cu): stage one T x T tile in shared memory and apply it to
// staged rows of X, forward (X_s A) or transposed (X_s A^T).
//
// Block shape: T x RG threads.  Thread (j, g) owns output column j and the
// RPT = RB / RG operand rows [g*RPT, g*RPT + RPT) of the block's RB rows.
// The tile sits in shared memory with a padded row stride TS = T + 1, so a
// warp reading a column (A[k][j], j = lane) and a warp reading a row
// (A[j][k], j = lane) both hit distinct banks: neither pass needs a second
// copy or a transpose.  X rows are staged as [RB][T] and read four at a
// time as 16-byte broadcasts.  Plain FMA in the working type: no TF32, no
// bf16.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dcora {

constexpr int T = 128;     // tile edge
constexpr int TS = T + 1;  // padded shared-memory row stride of a tile
constexpr int RG = 2;      // row groups per block
constexpr int NTHREADS = T * RG;

template <typename scalar_t>
struct Vec16;  // 16 bytes of scalar_t
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void unpack(const float4& q, float* out) {
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static void unpack(const double2& q, double* out) {
    out[0] = q.x; out[1] = q.y;
  }
};

// Bytes of dynamic shared memory: two staged X slabs [RB][T] and one tile.
template <typename scalar_t, int RB>
constexpr size_t smem_bytes() {
  return (size_t)(2 * RB * T + T * TS) * sizeof(scalar_t);
}

// As[T][TS] <- the T x T tile at A (row stride ld elements; A and ld keep
// every row 16-byte aligned).  Loads go out in batches of 8 vectors a
// thread before any of them is stored.
template <typename scalar_t>
__device__ __forceinline__ void stage_tile(scalar_t* __restrict__ As,
                                           const scalar_t* __restrict__ A,
                                           int64_t ld) {
  using V = Vec16<scalar_t>;
  constexpr int VPR = T / V::n;            // vectors per tile row
  constexpr int NV = T * VPR / NTHREADS;   // vectors per thread
  constexpr int B = 8;
  static_assert(NV % B == 0, "whole batches");
  const int tid = threadIdx.y * T + threadIdx.x;
#pragma unroll
  for (int b0 = 0; b0 < NV; b0 += B) {
    typename V::type q[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int v = tid + (b0 + b) * NTHREADS;
      q[b] = __ldg(reinterpret_cast<const typename V::type*>(
          A + (int64_t)(v / VPR) * ld + (v % VPR) * V::n));
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int v = tid + (b0 + b) * NTHREADS;
      scalar_t e[V::n];
      V::unpack(q[b], e);
#pragma unroll
      for (int u = 0; u < V::n; ++u) As[(v / VPR) * TS + (v % VPR) * V::n + u] = e[u];
    }
  }
}

// xs[RB][T] <- rows [row0, row0 + RB) of X[:, col*T : col*T + T]; rows past
// r_pad are zero.
template <typename scalar_t, int RB>
__device__ __forceinline__ void stage_x(scalar_t* __restrict__ xs,
                                        const scalar_t* __restrict__ X,
                                        int64_t kpad, int col, int row0,
                                        int nrow) {
  const int tid = threadIdx.y * T + threadIdx.x;
  for (int idx = tid; idx < RB * T; idx += NTHREADS) {
    const int i = idx / T;
    xs[idx] = (i < nrow)
                  ? X[(int64_t)(row0 + i) * kpad + (int64_t)col * T + idx % T]
                  : scalar_t(0);
  }
}

template <typename scalar_t>
__device__ __forceinline__ void load4(const scalar_t* p, scalar_t* out) {
  using V = Vec16<scalar_t>;
#pragma unroll
  for (int u = 0; u < 4; u += V::n)
    V::unpack(*reinterpret_cast<const typename V::type*>(p + u), out + u);
}

// acc[t] += sum_k xs[i0 + t][k] * A(k, j), where A(k, j) is As[k][j]
// (forward, TRANS = false) or As[j][k] (transposed, TRANS = true).
template <typename scalar_t, int RPT, bool TRANS>
__device__ __forceinline__ void apply_tile(scalar_t* acc,
                                           const scalar_t* __restrict__ As,
                                           const scalar_t* __restrict__ xs,
                                           int i0, int j) {
#pragma unroll 4
  for (int k = 0; k < T; k += 4) {
    scalar_t a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[q] = TRANS ? As[j * TS + k + q] : As[(k + q) * TS + j];
#pragma unroll
    for (int t = 0; t < RPT; ++t) {
      scalar_t x[4];
      load4(xs + (i0 + t) * T + k, x);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t] = fma(x[q], a[q], acc[t]);
    }
  }
}

// W[row0 + i0 + t, col*T + j] += acc[t] for the rows that exist.
template <typename scalar_t, int RPT>
__device__ __forceinline__ void add_out(scalar_t* __restrict__ W,
                                        const scalar_t* acc, int64_t kpad,
                                        int col, int row0, int nrow, int i0,
                                        int j) {
#pragma unroll
  for (int t = 0; t < RPT; ++t) {
    if (i0 + t < nrow)
      atomicAdd(W + (int64_t)(row0 + i0 + t) * kpad + (int64_t)col * T + j,
                acc[t]);
  }
}

}  // namespace dcora
