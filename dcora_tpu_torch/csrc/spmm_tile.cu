// Per-tile symmetric block-sparse SpMM  W = X Q  for Hopper (sm_90a), over
// the non-empty B x B sub-blocks of each stored tile, owner-computes over
// output strips of B columns.
//
// Replaces the TPU kernel dcora_tpu/core/pallas_spmm.py:_spmm_kernel (via
// spmm_symmetric).  Q is symmetric and only its upper-triangular T x T tiles
// are stored, as a plain list; a stored tile A at (r, c) adds X[:, r] A into
// W[:, c], and X[:, c] A^T into W[:, r] when r != c.  X and W are
// [r_pad, kpad] row-major, T = 128.
//
// Layout (core/spmm.compact_tiles, TileBlocks).  Each tile keeps only its
// non-empty sub-blocks, stored once each in tile order, a tile's entries
// sorted by b, then a; entry e is sub-block (a, b) of its tile, values
// [kk][jj] = A[aB + kk, bB + jj].  Zero tiles (the chunk pads of the TPU
// kernel's list) and empty sub-blocks are not stored.  The kernel walks the
// output CSR the host builds from them: strip s's items out_ptr[s] ..
// out_ptr[s + 1], item i naming the entry out_ent[i] and the scalar column
// out_src[i] & ~1 of X it multiplies.  First the forward items (bit 0 of
// out_src clear: the entries whose sub-column cT + bB is strip s, in tile
// order and, inside a tile, by a; X at rT + aB), the lane taking column q
// of the block; then the transposed items (bit 0 set: the entries of
// off-diagonal tiles whose sub-row rT + aB is strip s, in tile order and,
// inside a tile, by b; X at cT + bB), the lane taking row q.
//
// Design.  The TPU kernel walks the list in one sequential loop with W
// resident in VMEM, so its sums have one order.  Here blocks run in any
// order and many tiles feed one strip of W, so one warp owns one output
// strip and RB rows (blocks.cuh: strip_items_kernel, the walk kernel 3 runs
// over its packs): each sum is one lane's fma chain in the CSR's order,
// written once, zeros where no item lands, so W needs no memset and the
// result is bitwise repeatable.  One launch, no scratch.  Each block is
// still stored once and read for both of its products; the per-tile
// identity of _spmm_kernel survives in the item order, not in the grid:
// one thread block per tile with a second pass over per-tile sums measured
// 2.2-2.6x slower (PERF.md section 6).
//
// What it reads on the 10,648-pose grid (1,572 stored tiles): 25,418
// sub-blocks (1.63 MB f32, 3.25 MB f64) and the CSR's 8 bytes per item
// (25,418 forward, 14,424 transposed).  Its bound is Q's stored non-zeros,
// X and W at the 3.35 TB/s data-sheet rate (tools/common.spmm_bound_ms);
// each warp waits on dependent loads (strip pointer -> item -> block and X
// strip), so latency and the launch bound it, as for kernels 1 and 3.
// Device time per product at r_pad 8 on that grid, one H100 80GB HBM3 at
// 700 W (tools/spmm_ab.py, PERF.md section 6): 0.0074-0.0075 /
// 0.0109-0.0110 ms f32 / f64; torch.sparse.mm (cuSPARSE) 0.0390 / 0.0396.

#include "blocks.cuh"

namespace {

struct tile {};  // names this file's instance of strip_items_kernel

}  // namespace

extern "C" {

#define DCORA_SPMM_TILE(suffix, scalar_t)                                    \
  int dcora_spmm_tile_##suffix(const void* out_ptr, const void* out_ent,     \
                               const void* out_src, const void* vals,        \
                               const void* X, void* W, int nlisted,          \
                               int kpad, int r_pad, void* stream) {          \
    return dcora_blocks::launch_strip_items<tile, scalar_t>(                 \
        static_cast<const int32_t*>(out_ptr),                                \
        static_cast<const int32_t*>(out_ent),                                \
        static_cast<const int32_t*>(out_src),                                \
        static_cast<const scalar_t*>(vals), static_cast<const scalar_t*>(X), \
        static_cast<scalar_t*>(W), nlisted, kpad, r_pad,                     \
        static_cast<cudaStream_t>(stream));                                  \
  }

DCORA_SPMM_TILE(f32, float)
DCORA_SPMM_TILE(f64, double)

#undef DCORA_SPMM_TILE

}  // extern "C"
