// Grouped symmetric block-sparse SpMM  W = X Q  over wide row-group buffers,
// for Hopper (sm_90a).  One kernel body, templated on rows per group R:
//
//   R = 2  replaces dcora_tpu/core/pallas_spmm.py:_paired_kernel (via
//          spmm_paired): two RCM tile-rows (r1, r2) fused along the
//          contraction axis, wide [ng, 2T, G*T];
//   R = 1  is the wide-layout instance of _grouped_kernel (via
//          spmm_grouped), wide [ng, T, G*T]: the paired packing's leftover
//          buckets and the fixed-G / bucketed layouts.
//
// For group g with rows r_h = grows[g, h] and slot columns c_j = gcols[g, j],
// the sub-tile A_hj = wide[g, h*T:(h+1)*T, j*T:(j+1)*T] contributes
//     W[:, c_j] += sum_h X[:, r_h] A_hj            (forward, K-fused over h)
//     W[:, r_h] += X[:, c_j] A_hj^T    unless c_j == r_1   (transposed)
// The mask is c_j == r_1 only, as in the TPU kernel: that slot is the r_1
// diagonal tile (its r_2 half is strictly lower, hence zero) or a zero pad
// slot.  A slot with c_j == r_2 is the off-diagonal tile (r_1, r_2) and is
// applied both ways; the (r_2, r_2) diagonal never rides a pair (the packer
// routes it to an R = 1 leftover bucket).
//
// Design: atomics, tiles read once.  Many groups write the same output
// columns, and several groups can share one row pair when the union of its
// columns exceeds the width, so the outputs need a cross-block reduction.
// Each block takes one slot (g, j) and one slab of RB operand rows and
// streams the slot's R sub-tiles through shared memory one at a time (a
// 2T x 16T group is 2 MB in f32: it is never staged whole).  The forward
// product accumulates over h in registers and is added into W[:, c_j] once;
// each transposed product is added into W[:, r_h] as its sub-tile is done.
// The adds are atomicAdd (native for float and double on sm_90) into a W
// that the launcher zeroes on the stream unless told to accumulate (the
// buckets of one product share one W).  Summation order is not fixed, so
// the result is not bitwise deterministic.  The alternative, per-group
// partials reduced in a fixed order, costs a second pass and scratch of
// ng x G x r_pad x T; atomics are the simple choice and enough here.
//
// What bounds it: the streamed wide bytes (pad slots and the non-overlap of
// paired rows' column sets included) and the shared-memory reads of the two
// passes; see tile_apply.cuh.  Plain FMA in the working type: no TF32, no
// bf16.  A wgmma/TMA pipeline is later work.

#include "tile_apply.cuh"

namespace {

using namespace dcora;

template <typename scalar_t, int R, int RB>
__global__ void __launch_bounds__(NTHREADS)
spmm_grouped_kernel(const int32_t* __restrict__ grows,
                    const int32_t* __restrict__ gcols,
                    const scalar_t* __restrict__ wide,
                    const scalar_t* __restrict__ X,
                    scalar_t* __restrict__ W, int G, int r_pad,
                    int64_t kpad) {
  constexpr int RPT = RB / RG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* xr = reinterpret_cast<scalar_t*>(smem_raw);  // [RB][T]
  scalar_t* xc = xr + RB * T;                             // [RB][T]
  scalar_t* As = xc + RB * T;                             // [T][TS]

  const int64_t slot = blockIdx.x;  // g * G + jslot
  const int64_t g = slot / G;
  const int jslot = (int)(slot % G);
  const int c = gcols[slot];
  const bool masked = (c == grows[g * R]);
  const int row0 = blockIdx.y * RB;
  const int nrow = min(RB, r_pad - row0);
  const int j = threadIdx.x;
  const int i0 = threadIdx.y * RPT;
  const int64_t ld = (int64_t)G * T;
  const scalar_t* Ag = wide + g * (R * T) * ld + (int64_t)jslot * T;

  if (!masked) stage_x<scalar_t, RB>(xc, X, kpad, c, row0, nrow);

  scalar_t accf[RPT];
#pragma unroll
  for (int t = 0; t < RPT; ++t) accf[t] = scalar_t(0);
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int rh = grows[g * R + h];
    if (h) __syncthreads();  // every thread is done with As and xr
    stage_tile(As, Ag + (int64_t)h * T * ld, ld);
    stage_x<scalar_t, RB>(xr, X, kpad, rh, row0, nrow);
    __syncthreads();
    apply_tile<scalar_t, RPT, false>(accf, As, xr, i0, j);
    if (!masked) {
      scalar_t acct[RPT];
#pragma unroll
      for (int t = 0; t < RPT; ++t) acct[t] = scalar_t(0);
      apply_tile<scalar_t, RPT, true>(acct, As, xc, i0, j);
      add_out<scalar_t, RPT>(W, acct, kpad, rh, row0, nrow, i0, j);
    }
  }
  add_out<scalar_t, RPT>(W, accf, kpad, c, row0, nrow, i0, j);
}

template <typename scalar_t, int R, int RB>
cudaError_t launch_rb(const int32_t* grows, const int32_t* gcols,
                      const scalar_t* wide, const scalar_t* X, scalar_t* W,
                      int ng, int G, int r_pad, int64_t kpad,
                      cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<scalar_t, RB>();
  auto kern = spmm_grouped_kernel<scalar_t, R, RB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((unsigned)((int64_t)ng * G), (r_pad + RB - 1) / RB),
         dim3(T, RG), smem, stream>>>(grows, gcols, wide, X, W, G, r_pad,
                                      kpad);
  return cudaGetLastError();
}

template <typename scalar_t, int R>
cudaError_t launch_r(const int32_t* grows, const int32_t* gcols,
                     const scalar_t* wide, const scalar_t* X, scalar_t* W,
                     int ng, int G, int r_pad, int64_t kpad,
                     cudaStream_t stream) {
  return (r_pad <= 8)
             ? launch_rb<scalar_t, R, 8>(grows, gcols, wide, X, W, ng, G,
                                         r_pad, kpad, stream)
             : launch_rb<scalar_t, R, 16>(grows, gcols, wide, X, W, ng, G,
                                          r_pad, kpad, stream);
}

template <typename scalar_t>
int launch(const int32_t* grows, const int32_t* gcols, const scalar_t* wide,
           const scalar_t* X, scalar_t* W, int ng, int R, int G, int nt,
           int r_pad, int zero_w, cudaStream_t stream) {
  if (R != 1 && R != 2) return (int)cudaErrorInvalidValue;
  const int64_t kpad = (int64_t)nt * T;
  cudaError_t err = cudaSuccess;
  if (zero_w) {
    err = cudaMemsetAsync(
        W, 0, sizeof(scalar_t) * (size_t)r_pad * (size_t)kpad, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (ng == 0 || G == 0) return 0;
  err = (R == 1) ? launch_r<scalar_t, 1>(grows, gcols, wide, X, W, ng, G,
                                         r_pad, kpad, stream)
                 : launch_r<scalar_t, 2>(grows, gcols, wide, X, W, ng, G,
                                         r_pad, kpad, stream);
  return (int)err;
}

}  // namespace

extern "C" {

int dcora_spmm_grouped_f32(const void* grows, const void* gcols,
                           const void* wide, const void* X, void* W, int ng,
                           int R, int G, int nt, int r_pad, int zero_w,
                           void* stream) {
  return launch<float>(static_cast<const int32_t*>(grows),
                       static_cast<const int32_t*>(gcols),
                       static_cast<const float*>(wide),
                       static_cast<const float*>(X), static_cast<float*>(W),
                       ng, R, G, nt, r_pad, zero_w,
                       static_cast<cudaStream_t>(stream));
}

int dcora_spmm_grouped_f64(const void* grows, const void* gcols,
                           const void* wide, const void* X, void* W, int ng,
                           int R, int G, int nt, int r_pad, int zero_w,
                           void* stream) {
  return launch<double>(static_cast<const int32_t*>(grows),
                        static_cast<const int32_t*>(gcols),
                        static_cast<const double*>(wide),
                        static_cast<const double*>(X),
                        static_cast<double*>(W), ng, R, G, nt, r_pad, zero_w,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
