// Grouped symmetric sparse SpMM  W = X Q  for Hopper (sm_90a), over the
// non-empty B x B sub-blocks of the row-group packs, all buckets in one
// launch.
//
// Replaces dcora_tpu/core/pallas_spmm.py:_paired_kernel (via spmm_paired,
// two RCM tile-rows (r_1, r_2) fused along the contraction axis) and the
// wide-layout instance of _grouped_kernel (one tile-row per group: the
// paired pack's leftover buckets).  The pack keeps its meaning: group g has
// rows r_h (h < R, R = 1 or 2), slot j has column c_j, and its sub-tile
// A_hj contributes
//     W[:, c_j] += sum_h X[:, r_h] A_hj            (forward, K-fused over h)
//     W[:, r_h] += X[:, c_j] A_hj^T    unless c_j == r_1   (transposed).
// The mask is c_j == r_1 only: that slot is the r_1 diagonal tile (its r_2
// half is strictly lower, hence empty) or a pad slot.  A slot with
// c_j == r_2 is the off-diagonal tile (r_1, r_2), applied both ways.
//
// Layout (core/spmm_pack.compact_buckets).  Only the non-empty sub-blocks
// of each slot are stored, grouped into runs: a run is one slot's
// sub-column b, i.e. B output columns of W[:, c_j], and lists the
// sub-blocks of both rows h that feed it, each as the scalar column
// r_h T + a B of its sub-row (values contiguous in entry order,
// [kk][jj] = A_hj[aB + kk, bB + jj]).  run_col holds c_j T + b B, with bit
// 0 set when the slot is masked.
//
// Design.  On the TPU a group's [2T, G*T] buffer went through the matrix
// unit; here no matrix unit is used, 98.6 % of those bytes are zero, and
// the earlier CUDA version that streamed them (one block per slot, one
// launch per bucket) moved 154.5 MB per f32 product on the 10,648-pose
// grid.  Now one warp owns one run and RB rows: the forward products of
// the run's sub-blocks (both rows: the K-fusion, now per sub-block) are
// summed in registers and added into W once; each transposed product is
// added as it is done.  Many runs write the same columns of W, so the adds
// are atomicAdd (native for float and double on sm_90) into a W that the
// launcher zeroes once on the stream; the summation order is not fixed and
// the result is not bitwise repeatable.  One launch covers every bucket.
//
// What bounds it: 1.89 MB of f32 sub-blocks and indices at B = 4, held in
// L2; the atomics (one per output of each of the 20,496 runs and of each
// of the 14,424 unmasked entries on the 10,648-pose grid) and the
// dependent loads (run -> entry column -> X strip).  Device time per
// product at r_pad 8 on that grid, memset included, one H100 80GB HBM3 at
// 700 W (tools/spmm_bench.py, PERF.md section 6): wide-buffer design (four
// launches) 0.1249 ms f32 / 0.2340-0.2351 ms f64; this design 0.0125 /
// 0.0201 ms at B = 4 (0.0126 / 0.0236 at B = 8); bound 0.0012 / 0.0025 ms;
// torch.sparse.mm (cuSPARSE) 0.0390 / 0.0394 ms.

#include "blocks.cuh"

namespace {

using namespace dcora_blocks;

template <typename scalar_t, int RB>
__global__ void __launch_bounds__(WARP * WARPS)
spmm_grouped_kernel(const int32_t* __restrict__ run_ptr,
                    const int32_t* __restrict__ run_col,
                    const int32_t* __restrict__ ent_col,
                    const scalar_t* __restrict__ vals,
                    const scalar_t* __restrict__ X,
                    scalar_t* __restrict__ W, int nrun, int r_pad,
                    int64_t kpad) {
  constexpr int RPL = RB / LR;  // rows per lane
  constexpr int U = unroll<RPL>();
  const int run = blockIdx.x * WARPS + threadIdx.y;
  if (run >= nrun) return;
  const int q = threadIdx.x % B;
  const int row0 = blockIdx.y * RB + threadIdx.x / B;
  const int rc = run_col[run];
  const int col = rc & ~1;
  const bool masked = rc & 1;

  // X[:, c_j T + b B .. + B), the operand of every transposed product
  scalar_t xc[RPL][B];
#pragma unroll
  for (int p = 0; p < RPL; ++p) {
    const int row = row0 + p * LR;
    if (!masked && row < r_pad) {
      load_b(X + (int64_t)row * kpad + col, xc[p]);
    } else {
#pragma unroll
      for (int k = 0; k < B; ++k) xc[p][k] = scalar_t(0);
    }
  }
  scalar_t accf[RPL];
#pragma unroll
  for (int p = 0; p < RPL; ++p) accf[p] = scalar_t(0);

  const int e1 = run_ptr[run + 1];
  for (int e = run_ptr[run]; e < e1; e += U) {
    int ec[U];
#pragma unroll
    for (int u = 0; u < U; ++u) ec[u] = (e + u < e1) ? ent_col[e + u] : -1;
    scalar_t acol[U][B];      // A[kk][q]: the forward product's column
    scalar_t arow[U][B];      // A[q][jj]: the transposed product's row
    scalar_t xr[U][RPL][B];   // X[:, r_h T + a B .. + B)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ec[u] < 0) continue;
      const scalar_t* A = vals + (int64_t)(e + u) * (B * B);
#pragma unroll
      for (int k = 0; k < B; ++k) acol[u][k] = __ldg(A + k * B + q);
      load_b(A + q * B, arow[u]);
#pragma unroll
      for (int p = 0; p < RPL; ++p) {
        const int row = row0 + p * LR;
        if (row < r_pad) {
          load_b(X + (int64_t)row * kpad + ec[u], xr[u][p]);
        } else {
#pragma unroll
          for (int k = 0; k < B; ++k) xr[u][p][k] = scalar_t(0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ec[u] < 0) continue;
#pragma unroll
      for (int p = 0; p < RPL; ++p) {
        const int row = row0 + p * LR;
#pragma unroll
        for (int k = 0; k < B; ++k)
          accf[p] = fma(xr[u][p][k], acol[u][k], accf[p]);
        if (!masked && row < r_pad) {
          scalar_t t = scalar_t(0);
#pragma unroll
          for (int k = 0; k < B; ++k) t = fma(xc[p][k], arow[u][k], t);
          atomicAdd(W + (int64_t)row * kpad + ec[u] + q, t);
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < RPL; ++p) {
    const int row = row0 + p * LR;
    if (row < r_pad) atomicAdd(W + (int64_t)row * kpad + col + q, accf[p]);
  }
}

template <typename scalar_t, int RB>
cudaError_t launch_rb(const int32_t* run_ptr, const int32_t* run_col,
                      const int32_t* ent_col, const scalar_t* vals,
                      const scalar_t* X, scalar_t* W, int nrun, int r_pad,
                      int64_t kpad, cudaStream_t stream) {
  const dim3 grid((nrun + WARPS - 1) / WARPS, (r_pad + RB - 1) / RB);
  spmm_grouped_kernel<scalar_t, RB><<<grid, dim3(WARP, WARPS), 0, stream>>>(
      run_ptr, run_col, ent_col, vals, X, W, nrun, r_pad, kpad);
  return cudaGetLastError();
}

template <typename scalar_t>
int launch(const int32_t* run_ptr, const int32_t* run_col,
           const int32_t* ent_col, const scalar_t* vals, const scalar_t* X,
           scalar_t* W, int nrun, int kpad, int r_pad, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      W, 0, sizeof(scalar_t) * (size_t)r_pad * (size_t)kpad, stream);
  if (err != cudaSuccess) return (int)err;
  if (nrun == 0 || r_pad == 0) return 0;
  err = (r_pad <= 8)
            ? launch_rb<scalar_t, 8>(run_ptr, run_col, ent_col, vals, X, W,
                                     nrun, r_pad, kpad, stream)
            : launch_rb<scalar_t, 16>(run_ptr, run_col, ent_col, vals, X, W,
                                      nrun, r_pad, kpad, stream);
  return (int)err;
}

}  // namespace

extern "C" {

int dcora_spmm_grouped_f32(const void* run_ptr, const void* run_col,
                           const void* ent_col, const void* vals,
                           const void* X, void* W, int nrun, int kpad,
                           int r_pad, void* stream) {
  return launch<float>(static_cast<const int32_t*>(run_ptr),
                       static_cast<const int32_t*>(run_col),
                       static_cast<const int32_t*>(ent_col),
                       static_cast<const float*>(vals),
                       static_cast<const float*>(X), static_cast<float*>(W),
                       nrun, kpad, r_pad, static_cast<cudaStream_t>(stream));
}

int dcora_spmm_grouped_f64(const void* run_ptr, const void* run_col,
                           const void* ent_col, const void* vals,
                           const void* X, void* W, int nrun, int kpad,
                           int r_pad, void* stream) {
  return launch<double>(static_cast<const int32_t*>(run_ptr),
                        static_cast<const int32_t*>(run_col),
                        static_cast<const int32_t*>(ent_col),
                        static_cast<const double*>(vals),
                        static_cast<const double*>(X),
                        static_cast<double*>(W), nrun, kpad, r_pad,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
