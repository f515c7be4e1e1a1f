// Per-tile symmetric block-sparse SpMM  W = X Q  for Hopper (sm_90a), over
// the non-empty B x B sub-blocks of each stored tile.
//
// Replaces the TPU kernel dcora_tpu/core/pallas_spmm.py:_spmm_kernel (via
// spmm_symmetric).  Q is symmetric and only its upper-triangular T x T tiles
// are stored, as a plain list; a stored tile A at (r, c) adds X[:, r] A into
// W[:, c], and X[:, c] A^T into W[:, r] when r != c.  X and W are
// [r_pad, kpad] row-major, T = 128.
//
// Layout (core/spmm.compact_tiles, TileBlocks).  Each tile keeps only its
// non-empty sub-blocks: tile t at (tile_row[t], tile_col[t]) owns the
// entries tile_ptr[t] .. tile_ptr[t+1]; entry e is sub-block (a, b),
// ent_blk[e] = a * TB + b, its values [kk][jj] = A[aB + kk, bB + jj].  A
// diagonal tile (r == c) is applied forward only.  Zero tiles (the chunk
// pads of the TPU kernel's list) and empty sub-blocks are not stored.
//
// Design: atomics, per tile.  The TPU kernel walks the list in one
// sequential loop with W resident in VMEM.  The earlier CUDA version took
// one block per tile and staged the whole dense tile in shared memory:
// 103.3 MB per f32 product on the 10,648-pose grid, of which 98.6 % zeros.
// Here one block of WARPS warps takes one stored tile and RB rows of X; its
// warps share out the tile's entries, U at a time.  Each sub-block is read
// from device memory once and applied both ways; a lane owns one column q of
// the block and RB / LR rows.  The products are summed per output strip in
// shared memory (forward into the tile column's strip b, transposed into
// the tile row's strip a), and each strip the tile touched is added into W
// once with atomicAdd (native for float and double on sm_90), into a W that
// the launcher zeroes once on the stream.  The summation order is not fixed
// and the result is not bitwise repeatable.
//
// What it reads on the 10,648-pose grid (1,572 stored tiles, counted with
// compact_tiles on the CPU): 25,418 sub-blocks, 1.63 MB of f32 values (3.25
// MB f64) and 0.12 MB of indices; no dense tile.  Its atomics: one per live
// row and column of each (tile, strip) sum, 20,718 forward and 12,208
// transposed, so 1,053,632 per product at r_pad 8 (1,274,944 with one per
// block and direction).  What bounds it: not bytes (the bound, bytes at
// the 3.35 TB/s data-sheet rate of an NVIDIA H100 80GB HBM3 at 700 W, is
// 1.2 us f32 at r_pad 8) but those atomics and each warp's dependent loads
// (tile -> entry -> X strip), as for spmm_grouped.cu, plus the imbalance
// of one block per tile (1 to 90 sub-blocks a tile, median 13).  Device
// time per product at r_pad 8 on that grid, memset included, on that card
// (tools/spmm_bench.py, PERF.md section 6): dense-tile design 0.0679 /
// 0.1406 ms f32 / f64; this design 0.0138-0.0139 / 0.0188-0.0192 ms;
// bound 0.0012 / 0.0025 ms; torch.sparse.mm (cuSPARSE) 0.0389 / 0.0395 ms.

#include "blocks.cuh"

namespace {

using namespace dcora_blocks;

constexpr int T = 128;     // tile edge (core/spmm.py: T_TILE)
constexpr int TB = T / B;  // sub-block strips per tile edge
static_assert(TB <= 32, "one bit per strip of a tile");

template <typename scalar_t, int RB>
__global__ void __launch_bounds__(WARP * WARPS)
spmm_tile_kernel(const int32_t* __restrict__ tile_ptr,
                 const int32_t* __restrict__ tile_row,
                 const int32_t* __restrict__ tile_col,
                 const int32_t* __restrict__ ent_blk,
                 const scalar_t* __restrict__ vals,
                 const scalar_t* __restrict__ X,
                 scalar_t* __restrict__ W, int r_pad, int64_t kpad) {
  constexpr int RPL = RB / LR;  // rows per lane
  // entries in flight: 2 / RPL (4 at f32, RB 8 took 122 registers and
  // was 25 % slower on the H100, PERF.md section 6)
  constexpr int U = unroll<2 * RPL>();
  constexpr int N = TB * RB * B;
  // the tile's sums, [strip][row][q]: forward into the strips b of tile
  // column c, transposed into the strips a of tile row r
  __shared__ scalar_t fwd[N];
  __shared__ scalar_t trn[N];
  __shared__ unsigned used_fwd, used_trn;

  const int tile = blockIdx.x;
  const int r = tile_row[tile];
  const int c = tile_col[tile];
  const bool diag = r == c;
  const int tid = threadIdx.y * WARP + threadIdx.x;
  for (int k = tid; k < N; k += WARP * WARPS) {
    fwd[k] = scalar_t(0);
    trn[k] = scalar_t(0);
  }
  if (tid == 0) used_fwd = used_trn = 0u;
  __syncthreads();

  const int q = threadIdx.x % B;
  const int i = threadIdx.x / B;  // the lane's first row in the slab
  const int row0 = blockIdx.y * RB;
  const scalar_t* Xr = X + (int64_t)r * T;
  const scalar_t* Xc = X + (int64_t)c * T;
  unsigned mf = 0u, mt = 0u;  // strips this warp touched (warp-uniform)
  const int e1 = tile_ptr[tile + 1];
  for (int e = tile_ptr[tile] + threadIdx.y * U; e < e1; e += WARPS * U) {
    int blk[U];
#pragma unroll
    for (int u = 0; u < U; ++u) blk[u] = (e + u < e1) ? ent_blk[e + u] : -1;
    scalar_t acol[U][B];     // A[kk][q]: the forward product's column
    scalar_t arow[U][B];     // A[q][jj]: the transposed product's row
    scalar_t xr[U][RPL][B];  // X[:, rT + aB .. + B)
    scalar_t xc[U][RPL][B];  // X[:, cT + bB .. + B)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (blk[u] < 0) continue;
      const int a = blk[u] / TB, b = blk[u] % TB;
      const scalar_t* A = vals + (int64_t)(e + u) * (B * B);
#pragma unroll
      for (int k = 0; k < B; ++k) acol[u][k] = __ldg(A + k * B + q);
      if (!diag) load_b(A + q * B, arow[u]);
#pragma unroll
      for (int p = 0; p < RPL; ++p) {
        const int row = row0 + i + p * LR;
        if (row < r_pad) {
          load_b(Xr + (int64_t)row * kpad + a * B, xr[u][p]);
          if (!diag) load_b(Xc + (int64_t)row * kpad + b * B, xc[u][p]);
        } else {
#pragma unroll
          for (int k = 0; k < B; ++k) {
            xr[u][p][k] = scalar_t(0);
            xc[u][p][k] = scalar_t(0);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (blk[u] < 0) continue;
      const int a = blk[u] / TB, b = blk[u] % TB;
      mf |= 1u << b;
      if (!diag) mt |= 1u << a;
#pragma unroll
      for (int p = 0; p < RPL; ++p) {
        const int row = i + p * LR;
        if (row0 + row >= r_pad) continue;
        scalar_t f = scalar_t(0);
#pragma unroll
        for (int k = 0; k < B; ++k) f = fma(xr[u][p][k], acol[u][k], f);
        atomicAdd(fwd + (b * RB + row) * B + q, f);
        if (!diag) {
          scalar_t t = scalar_t(0);
#pragma unroll
          for (int k = 0; k < B; ++k) t = fma(xc[u][p][k], arow[u][k], t);
          atomicAdd(trn + (a * RB + row) * B + q, t);
        }
      }
    }
  }
  if (threadIdx.x == 0) {
    atomicOr(&used_fwd, mf);
    atomicOr(&used_trn, mt);
  }
  __syncthreads();

  // each strip the tile touched goes into W once; one warp per strip
  const unsigned uf = used_fwd, ut = used_trn;
  for (int s = threadIdx.y; s < TB; s += WARPS) {
#pragma unroll
    for (int p = 0; p < RPL; ++p) {
      const int row = i + p * LR;
      if (row0 + row >= r_pad) continue;
      scalar_t* Wrow = W + (int64_t)(row0 + row) * kpad + s * B + q;
      const int at = (s * RB + row) * B + q;
      if (uf >> s & 1u) atomicAdd(Wrow + (int64_t)c * T, fwd[at]);
      if (ut >> s & 1u) atomicAdd(Wrow + (int64_t)r * T, trn[at]);
    }
  }
}

template <typename scalar_t, int RB>
cudaError_t launch_rb(const int32_t* tile_ptr, const int32_t* tile_row,
                      const int32_t* tile_col, const int32_t* ent_blk,
                      const scalar_t* vals, const scalar_t* X, scalar_t* W,
                      int ntile, int r_pad, int64_t kpad,
                      cudaStream_t stream) {
  const dim3 grid(ntile, (r_pad + RB - 1) / RB);
  spmm_tile_kernel<scalar_t, RB><<<grid, dim3(WARP, WARPS), 0, stream>>>(
      tile_ptr, tile_row, tile_col, ent_blk, vals, X, W, r_pad, kpad);
  return cudaGetLastError();
}

template <typename scalar_t>
int launch(const int32_t* tile_ptr, const int32_t* tile_row,
           const int32_t* tile_col, const int32_t* ent_blk,
           const scalar_t* vals, const scalar_t* X, scalar_t* W, int ntile,
           int kpad, int r_pad, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      W, 0, sizeof(scalar_t) * (size_t)r_pad * (size_t)kpad, stream);
  if (err != cudaSuccess) return (int)err;
  if (ntile == 0 || r_pad == 0) return 0;
  err = (r_pad <= 8)
            ? launch_rb<scalar_t, 8>(tile_ptr, tile_row, tile_col, ent_blk,
                                     vals, X, W, ntile, r_pad, kpad, stream)
            : launch_rb<scalar_t, 16>(tile_ptr, tile_row, tile_col, ent_blk,
                                      vals, X, W, ntile, r_pad, kpad,
                                      stream);
  return (int)err;
}

}  // namespace

extern "C" {

int dcora_spmm_tile_f32(const void* tile_ptr, const void* tile_row,
                        const void* tile_col, const void* ent_blk,
                        const void* vals, const void* X, void* W, int ntile,
                        int kpad, int r_pad, void* stream) {
  return launch<float>(static_cast<const int32_t*>(tile_ptr),
                       static_cast<const int32_t*>(tile_row),
                       static_cast<const int32_t*>(tile_col),
                       static_cast<const int32_t*>(ent_blk),
                       static_cast<const float*>(vals),
                       static_cast<const float*>(X), static_cast<float*>(W),
                       ntile, kpad, r_pad, static_cast<cudaStream_t>(stream));
}

int dcora_spmm_tile_f64(const void* tile_ptr, const void* tile_row,
                        const void* tile_col, const void* ent_blk,
                        const void* vals, const void* X, void* W, int ntile,
                        int kpad, int r_pad, void* stream) {
  return launch<double>(static_cast<const int32_t*>(tile_ptr),
                        static_cast<const int32_t*>(tile_row),
                        static_cast<const int32_t*>(tile_col),
                        static_cast<const int32_t*>(ent_blk),
                        static_cast<const double*>(vals),
                        static_cast<const double*>(X),
                        static_cast<double*>(W), ntile, kpad, r_pad,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
