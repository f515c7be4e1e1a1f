// Per-tile symmetric block-sparse SpMM  W = X Q  for Hopper (sm_90a).
//
// Replaces the TPU kernel dcora_tpu/core/pallas_spmm.py:_spmm_kernel (via
// spmm_symmetric).  Q is symmetric and only its upper-triangular T x T tiles
// are stored, as a plain list (rows[e] <= cols[e], tiles[e]); a stored tile
// A at (r, c) adds X[:, r] A into W[:, c], and X[:, c] A^T into W[:, r] when
// r != c.  X and W are [r_pad, nt*T] row-major, T = 128.  Chunk-padding
// tiles sit at (0, 0) and are zero, so they add nothing.
//
// Design: atomics.  The TPU kernel walks the list in one sequential loop
// with W resident in VMEM and `+=` into it.  Here each block takes one
// stored tile (and one slab of RB operand rows), reads it from device memory
// exactly once into shared memory, applies it both ways from there, and adds
// both products into W with atomicAdd (native for float and double on
// sm_90).  W is zeroed on the stream first.  No host index is needed beyond
// the tile list itself.  The price: the summation order into a W column is
// whatever order the blocks reach the atomics in, so the result is not
// bitwise deterministic from launch to launch, and every output element
// takes one atomic per tile that touches it.  Its counterpart,
// spmm_sym.cu, is owner-computes: deterministic, but it reads every
// off-diagonal tile twice.  Timing the two on the same tiles measures that
// trade.
//
// What bounds it.  Tile bytes, as for spmm_sym.cu (about 4 flop per byte in
// f32 at r_pad 8), plus the shared-memory reads of the two passes: each
// tile element is read once per row group (RG = 2) and pass.  The tile is
// staged whole (66 KB in f32, 132 KB in f64, with a padded row stride that
// keeps both passes free of bank conflicts), so in f64 one block fills an
// SM and its loads do not overlap another block's arithmetic.  A wgmma/TMA
// pipeline is later work.

#include "tile_apply.cuh"

namespace {

using namespace dcora;

template <typename scalar_t, int RB>
__global__ void __launch_bounds__(NTHREADS)
spmm_tile_kernel(const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ cols,
                 const scalar_t* __restrict__ tiles,
                 const scalar_t* __restrict__ X,
                 scalar_t* __restrict__ W, int r_pad, int64_t kpad) {
  constexpr int RPT = RB / RG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* xr = reinterpret_cast<scalar_t*>(smem_raw);  // [RB][T]
  scalar_t* xc = xr + RB * T;                             // [RB][T]
  scalar_t* As = xc + RB * T;                             // [T][TS]

  const int64_t e = blockIdx.x;
  const int r = rows[e];
  const int c = cols[e];
  const int row0 = blockIdx.y * RB;
  const int nrow = min(RB, r_pad - row0);
  const int j = threadIdx.x;
  const int i0 = threadIdx.y * RPT;

  stage_tile(As, tiles + e * (T * T), T);
  stage_x<scalar_t, RB>(xr, X, kpad, r, row0, nrow);
  if (r != c) stage_x<scalar_t, RB>(xc, X, kpad, c, row0, nrow);
  __syncthreads();

  scalar_t acc[RPT];
#pragma unroll
  for (int t = 0; t < RPT; ++t) acc[t] = scalar_t(0);
  apply_tile<scalar_t, RPT, false>(acc, As, xr, i0, j);
  add_out<scalar_t, RPT>(W, acc, kpad, c, row0, nrow, i0, j);
  if (r != c) {
#pragma unroll
    for (int t = 0; t < RPT; ++t) acc[t] = scalar_t(0);
    apply_tile<scalar_t, RPT, true>(acc, As, xc, i0, j);
    add_out<scalar_t, RPT>(W, acc, kpad, r, row0, nrow, i0, j);
  }
}

template <typename scalar_t, int RB>
cudaError_t launch_rb(const int32_t* rows, const int32_t* cols,
                      const scalar_t* tiles, const scalar_t* X, scalar_t* W,
                      int m, int r_pad, int64_t kpad, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<scalar_t, RB>();
  auto kern = spmm_tile_kernel<scalar_t, RB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(m, (r_pad + RB - 1) / RB), dim3(T, RG), smem, stream>>>(
      rows, cols, tiles, X, W, r_pad, kpad);
  return cudaGetLastError();
}

template <typename scalar_t>
int launch(const int32_t* rows, const int32_t* cols, const scalar_t* tiles,
           const scalar_t* X, scalar_t* W, int m, int nt, int r_pad,
           cudaStream_t stream) {
  const int64_t kpad = (int64_t)nt * T;
  cudaError_t err = cudaMemsetAsync(
      W, 0, sizeof(scalar_t) * (size_t)r_pad * (size_t)kpad, stream);
  if (err != cudaSuccess) return (int)err;
  if (m == 0) return 0;
  err = (r_pad <= 8)
            ? launch_rb<scalar_t, 8>(rows, cols, tiles, X, W, m, r_pad, kpad,
                                     stream)
            : launch_rb<scalar_t, 16>(rows, cols, tiles, X, W, m, r_pad,
                                      kpad, stream);
  return (int)err;
}

}  // namespace

extern "C" {

int dcora_spmm_tile_f32(const void* rows, const void* cols, const void* tiles,
                        const void* X, void* W, int m, int nt, int r_pad,
                        void* stream) {
  return launch<float>(static_cast<const int32_t*>(rows),
                       static_cast<const int32_t*>(cols),
                       static_cast<const float*>(tiles),
                       static_cast<const float*>(X), static_cast<float*>(W),
                       m, nt, r_pad, static_cast<cudaStream_t>(stream));
}

int dcora_spmm_tile_f64(const void* rows, const void* cols, const void* tiles,
                        const void* X, void* W, int m, int nt, int r_pad,
                        void* stream) {
  return launch<double>(static_cast<const int32_t*>(rows),
                        static_cast<const int32_t*>(cols),
                        static_cast<const double*>(tiles),
                        static_cast<const double*>(X),
                        static_cast<double*>(W), m, nt, r_pad,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
