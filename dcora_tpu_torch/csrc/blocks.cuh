// Device helpers shared by the sub-block SpMM kernels (spmm_sym.cu,
// spmm_tile.cu, spmm_grouped.cu).  All read Q as a list of its non-empty
// B x B sub-blocks instead of dense 128 x 128 tiles: on the pose graphs of
// this repository ~98.6 % of a stored tile's entries are zero.  Kernels 2
// and 3 (spmm_tile.cu, spmm_grouped.cu) store each block once and walk an
// output CSR of (block, side) items (strip_items_kernel below), each over
// its own layout.
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

// W = X Q, one warp per output strip s of B columns and RB rows, from an
// output CSR of items: strip s sums items out_ptr[s] .. out_ptr[s + 1] in
// that order, item i applying the block vals[out_ent[i]] to the B columns
// of X from out_src[i] & ~1.  Bit 0 of out_src clear: a forward item, the
// lane (i, q) takes column q of the block (B scalar loads); set: a
// transposed item, row q (one 16-byte vector).  So one stored block serves
// both of its products.  A lane keeps U items' blocks and X strips in
// flight, sums its items in the CSR's order (one fma chain) and writes its
// output once; strips at or past nlisted get zeros, so W needs no memset
// and the result is bitwise repeatable.  Tag names the kernel that
// instantiates it (its symbol in a profile).
template <typename Tag, typename scalar_t, int RB>
__global__ void __launch_bounds__(WARP * WARPS)
strip_items_kernel(const int32_t* __restrict__ out_ptr,
                   const int32_t* __restrict__ out_ent,
                   const int32_t* __restrict__ out_src,
                   const scalar_t* __restrict__ vals,
                   const scalar_t* __restrict__ X, scalar_t* __restrict__ W,
                   int nlisted, int nstrip, int r_pad, int64_t kpad) {
  constexpr int RPL = RB / LR;  // rows per lane
  constexpr int U = unroll<RPL>();
  const int s = blockIdx.x * WARPS + threadIdx.y;
  if (s >= nstrip) return;
  const int q = threadIdx.x % B;
  const int row0 = blockIdx.y * RB + threadIdx.x / B;

  scalar_t acc[RPL];
#pragma unroll
  for (int p = 0; p < RPL; ++p) acc[p] = scalar_t(0);

  const int i1 = s < nlisted ? out_ptr[s + 1] : 0;
  for (int i = s < nlisted ? out_ptr[s] : 0; i < i1; i += U) {
    int ent[U], src[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ent[u] = (i + u < i1) ? out_ent[i + u] : -1;
      src[u] = (i + u < i1) ? out_src[i + u] : 0;
    }
    scalar_t v[U][B];       // column q (forward) or row q (transposed)
    scalar_t x[U][RPL][B];  // X[:, src .. + B)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ent[u] < 0) continue;
      const scalar_t* A = vals + (int64_t)ent[u] * (B * B);
      if (src[u] & 1) {  // warp-uniform: every lane reads the same item
        load_b(A + q * B, v[u]);
      } else {
#pragma unroll
        for (int k = 0; k < B; ++k) v[u][k] = __ldg(A + k * B + q);
      }
      const int col = src[u] & ~1;
#pragma unroll
      for (int p = 0; p < RPL; ++p) {
        const int row = row0 + p * LR;
        if (row < r_pad) {
          load_b(X + (int64_t)row * kpad + col, x[u][p]);
        } else {
#pragma unroll
          for (int k = 0; k < B; ++k) x[u][p][k] = scalar_t(0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ent[u] < 0) continue;
#pragma unroll
      for (int p = 0; p < RPL; ++p) {
#pragma unroll
        for (int k = 0; k < B; ++k) acc[p] = fma(x[u][p][k], v[u][k], acc[p]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < RPL; ++p) {
    const int row = row0 + p * LR;
    if (row < r_pad) W[(int64_t)row * kpad + (int64_t)s * B + q] = acc[p];
  }
}

// One launch of strip_items_kernel over every strip of W [r_pad, kpad]
// (kpad / B strips; the CSR lists the first nlisted, out_ptr has nlisted
// + 1 entries).  Returns a cudaError_t as int.
template <typename Tag, typename scalar_t>
int launch_strip_items(const int32_t* out_ptr, const int32_t* out_ent,
                       const int32_t* out_src, const scalar_t* vals,
                       const scalar_t* X, scalar_t* W, int nlisted, int kpad,
                       int r_pad, cudaStream_t stream) {
  const int nstrip = kpad / B;
  if (nstrip == 0 || r_pad == 0) return 0;
  const dim3 block(WARP, WARPS);
  const unsigned gx = (nstrip + WARPS - 1) / WARPS;
  if (r_pad <= 8) {
    strip_items_kernel<Tag, scalar_t, 8><<<dim3(gx, 1), block, 0, stream>>>(
        out_ptr, out_ent, out_src, vals, X, W, nlisted, nstrip, r_pad, kpad);
  } else {
    strip_items_kernel<Tag, scalar_t, 16>
        <<<dim3(gx, (r_pad + 15) / 16), block, 0, stream>>>(
            out_ptr, out_ent, out_src, vals, X, W, nlisted, nstrip, r_pad,
            kpad);
  }
  return (int)cudaGetLastError();
}

}  // namespace dcora_blocks
