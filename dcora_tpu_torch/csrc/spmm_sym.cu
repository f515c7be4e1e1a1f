// Symmetric sparse SpMM  W = X Q  for Hopper (sm_90a), owner-computes over
// output strips of B scalar columns.
//
// Replaces the TPU kernel dcora_tpu/core/pallas_spmm.py:_grouped_kernel
// (run per width bucket by spmm_bucketed) on the default path.  X and W are
// [r_pad, kpad] row-major.  Q is given as a block CSR over output strips
// (core/spmm.build_output_csr): strip s lists the non-empty B x B blocks of
// both triangles that feed it, sorted by source strip t, each stored so
// that row q is output column sB + q:
//     W[:, sB + q] = sum_e sum_k X[:, src_e B + k] * vals_e[q][k].
//
// Design.  The TPU kernel multiplied dense 128 x 128 tiles on the matrix
// unit.  On the pose graphs here only 1.4 % of a stored tile's entries are
// non-zero and this kernel does no matrix-unit work, so a dense tile is
// bytes of zeros: the first version of this kernel (one block per output
// tile-column, dense tiles, every off-diagonal tile read twice) streamed
// 184 MB per f32 product on the 10,648-pose grid.  This one reads only the
// non-empty sub-blocks, 2.75 MB f32 at B = 4 with its indices (off-diagonal
// blocks stored twice, once per owning strip, already oriented, so a
// strip's entries are one contiguous stream).  One warp owns one strip and
// RB rows; a lane keeps UNROLL entries' source indices, block rows and X
// strips in flight before it uses any of them.  Each lane sums its entries
// in ascending source order and writes its output once: no atomics, a
// fixed summation order, every output written (a strip without entries
// writes zeros), so the result is bitwise repeatable.
//
// What bounds it: the few MB it reads sit in the 50 MB L2; each warp waits
// on three dependent loads (strip pointer -> source index -> X strip and
// block), so latency and the launch bound it, at ~5x the bytes bound.
// Device time per product at r_pad 8 on the 10,648-pose grid, one H100
// 80GB HBM3 at 700 W (tools/spmm_bench.py, PERF.md section 6): dense-tile
// design 0.0931-0.0957 ms f32 / 0.1645-0.1674 ms f64; this design 0.0061 /
// 0.0081 ms at B = 4 (0.0073 / 0.0156 at B = 8); bound 0.0012 / 0.0025 ms;
// torch.sparse.mm (cuSPARSE) 0.0390 / 0.0394 ms.

#include "blocks.cuh"

namespace {

using namespace dcora_blocks;

template <typename scalar_t, int RB>
__global__ void __launch_bounds__(WARP * WARPS)
spmm_sym_kernel(const int32_t* __restrict__ ptr,
                const int32_t* __restrict__ src,
                const scalar_t* __restrict__ vals,
                const scalar_t* __restrict__ X,
                scalar_t* __restrict__ W, int nstrip, int r_pad,
                int64_t kpad) {
  constexpr int RPL = RB / LR;  // rows per lane
  constexpr int U = unroll<RPL>();
  const int s = blockIdx.x * WARPS + threadIdx.y;
  if (s >= nstrip) return;
  const int q = threadIdx.x % B;
  const int row0 = blockIdx.y * RB + threadIdx.x / B;

  scalar_t acc[RPL];
#pragma unroll
  for (int p = 0; p < RPL; ++p) acc[p] = scalar_t(0);

  const int e1 = ptr[s + 1];
  for (int e = ptr[s]; e < e1; e += U) {
    int sr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) sr[u] = (e + u < e1) ? src[e + u] : -1;
    scalar_t v[U][B];
    scalar_t x[U][RPL][B];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (sr[u] < 0) continue;
      load_b(vals + (int64_t)(e + u) * (B * B) + q * B, v[u]);
#pragma unroll
      for (int p = 0; p < RPL; ++p) {
        const int row = row0 + p * LR;
        if (row < r_pad) {
          load_b(X + (int64_t)row * kpad + (int64_t)sr[u] * B, x[u][p]);
        } else {
#pragma unroll
          for (int k = 0; k < B; ++k) x[u][p][k] = scalar_t(0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (sr[u] < 0) continue;
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

template <typename scalar_t, int RB>
cudaError_t launch_rb(const int32_t* ptr, const int32_t* src,
                      const scalar_t* vals, const scalar_t* X, scalar_t* W,
                      int nstrip, int r_pad, int64_t kpad,
                      cudaStream_t stream) {
  const dim3 grid((nstrip + WARPS - 1) / WARPS, (r_pad + RB - 1) / RB);
  spmm_sym_kernel<scalar_t, RB><<<grid, dim3(WARP, WARPS), 0, stream>>>(
      ptr, src, vals, X, W, nstrip, r_pad, kpad);
  return cudaGetLastError();
}

template <typename scalar_t>
int launch(const int32_t* ptr, const int32_t* src, const scalar_t* vals,
           const scalar_t* X, scalar_t* W, int nstrip, int r_pad,
           cudaStream_t stream) {
  const int64_t kpad = (int64_t)nstrip * B;
  if (nstrip == 0 || r_pad == 0) return 0;
  return (int)((r_pad <= 8)
                   ? launch_rb<scalar_t, 8>(ptr, src, vals, X, W, nstrip,
                                            r_pad, kpad, stream)
                   : launch_rb<scalar_t, 16>(ptr, src, vals, X, W, nstrip,
                                             r_pad, kpad, stream));
}

}  // namespace

extern "C" {

int dcora_spmm_sym_f32(const void* ptr, const void* src, const void* vals,
                       const void* X, void* W, int nstrip, int r_pad,
                       void* stream) {
  return launch<float>(static_cast<const int32_t*>(ptr),
                       static_cast<const int32_t*>(src),
                       static_cast<const float*>(vals),
                       static_cast<const float*>(X), static_cast<float*>(W),
                       nstrip, r_pad, static_cast<cudaStream_t>(stream));
}

int dcora_spmm_sym_f64(const void* ptr, const void* src, const void* vals,
                       const void* X, void* W, int nstrip, int r_pad,
                       void* stream) {
  return launch<double>(static_cast<const int32_t*>(ptr),
                        static_cast<const int32_t*>(src),
                        static_cast<const double*>(vals),
                        static_cast<const double*>(X),
                        static_cast<double*>(W), nstrip, r_pad,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
