// Device helpers shared by the sub-block SpMM kernels (spmm_sym.cu,
// spmm_grouped.cu).  Both read Q as a list of its non-empty B x B
// sub-blocks instead of dense 128 x 128 tiles: on the pose graphs of this
// repository ~98.6 % of a stored tile's entries are zero.
//
// B is one compile-time constant, given to nvcc as -DDCORA_BLOCK
// (core/spmm.py: BLOCK).  A warp owns B output columns and RB rows of W:
// lane (i, q), q = lane % B, i = lane / B, computes column q for the rows
// i, i + LR, ... (LR = 32 / B lanes share a column).  A lane reads B
// consecutive scalars of X, and a row of a block, as 16-byte vectors.
// Plain FMA in the working type: no TF32, no bf16.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef DCORA_BLOCK
#error "build with -DDCORA_BLOCK=<sub-block edge> (core/spmm.py: BLOCK)"
#endif

namespace dcora_blocks {

constexpr int B = DCORA_BLOCK;
static_assert(B == 4 || B == 8, "sub-blocks are 4 x 4 or 8 x 8");
constexpr int WARP = 32;
constexpr int LR = WARP / B;  // lanes that share one output column
constexpr int WARPS = 4;      // warps per thread block

template <typename scalar_t>
struct Vec16;  // 16 bytes of scalar_t
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ void unpack(const float4& v, float* out) {
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ void unpack(const double2& v, double* out) {
    out[0] = v.x; out[1] = v.y;
  }
};

// out[0..B) <- p[0..B); p is B * sizeof(scalar_t) aligned (block rows and
// strips of X both are: kpad is a multiple of 128).
template <typename scalar_t>
__device__ __forceinline__ void load_b(const scalar_t* __restrict__ p,
                                       scalar_t* out) {
  using V = Vec16<scalar_t>;
  static_assert(B % V::n == 0, "a block row is whole 16-byte vectors");
  const typename V::type* v = reinterpret_cast<const typename V::type*>(p);
#pragma unroll
  for (int t = 0; t < B / V::n; ++t) V::unpack(__ldg(v + t), out + t * V::n);
}

// Entries a lane keeps in flight at once: fewer when it owns more rows, so
// that the staged operands stay in registers.
template <int RPL>
__host__ __device__ constexpr int unroll() {
  return RPL >= 4 ? 1 : 4 / RPL;
}

}  // namespace dcora_blocks
