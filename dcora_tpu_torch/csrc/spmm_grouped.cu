// Grouped symmetric sparse SpMM  W = X Q  for Hopper (sm_90a), over the
// non-empty B x B sub-blocks of the row-group packs, all buckets in one
// launch, owner-computes over output strips of B columns.
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
// Layout (core/spmm_pack.compact_buckets, PairBlocks).  Only the non-empty
// sub-blocks of each slot are stored, once each, values contiguous in
// entry order, [kk][jj] = A_hj[aB + kk, bB + jj].  The kernel walks the
// output CSR: strip s's items out_ptr[s] .. out_ptr[s + 1], item i naming
// the block out_ent[i] and the scalar column out_src[i] & ~1 of X it
// multiplies.  First the forward items (bit 0 of out_src clear: the
// entries of every run whose output strip is s, run by run, each run's
// entries in its (h, a) order: the K-fusion over the group's two rows),
// the lane taking column q of the block; then the transposed items (bit 0
// set: the entries of the unmasked runs whose sub-row strip is s, in (run,
// entry) order), the lane taking row q.  Each block is read from the one
// copy for both of its products: what distinguishes this kernel from
// kernel 1 (csrc/spmm_sym.cu), which stores an off-diagonal block twice,
// once per owning strip, already oriented.
//
// Design.  On the TPU a group's [2T, G*T] buffer went through the matrix
// unit; here no matrix unit is used, 98.6 % of those bytes are zero, and
// the earlier CUDA version that streamed them (one block per slot, one
// launch per bucket) moved 154.5 MB per f32 product on the 10,648-pose
// grid.  Many runs feed one strip of W, and blocks run in any order, so
// one warp owns one output strip and RB rows, as in kernel 1
// (blocks.cuh: strip_items_kernel, which kernel 2 runs over its own
// layout): a lane sums its items in the CSR's order and writes its output
// once.  Every strip of W is written, with zeros where no item lands, so W
// needs no memset; the order of every sum is the layout's, so the result
// is bitwise repeatable.
//
// What it reads on the 10,648-pose grid: 1.63 MB of f32 sub-blocks at
// B = 4 and the CSR's 8 bytes per item (20,496 runs' 25,418 entries
// forward, 14,424 unmasked entries transposed), held in L2.  Its bound is
// Q's stored non-zeros, X and W at the 3.35 TB/s data-sheet rate
// (tools/common.spmm_bound_ms); each warp waits on dependent loads
// (strip pointer -> item -> block and X strip), so latency and the launch
// bound it, as for kernel 1.  The column-q read of a forward item is B
// scalar loads (a transposed item's row q and kernel 1's pre-oriented rows
// are one 16-byte vector).  Device times per product
// at r_pad 8 on that grid, one H100 80GB HBM3 at 700 W (tools/spmm_bench.py,
// PERF.md section 6): 0.0074 / 0.0110 ms f32 / f64; torch.sparse.mm
// (cuSPARSE) 0.0389 / 0.0396 ms.

#include "blocks.cuh"

namespace {

struct grouped {};  // names this file's instance of strip_items_kernel

}  // namespace

extern "C" {

#define DCORA_SPMM_GROUPED(suffix, scalar_t)                                 \
  int dcora_spmm_grouped_##suffix(const void* out_ptr, const void* out_ent,  \
                                  const void* out_src, const void* vals,     \
                                  const void* X, void* W, int nlisted,       \
                                  int kpad, int r_pad, void* stream) {       \
    return dcora_blocks::launch_strip_items<grouped, scalar_t>(              \
        static_cast<const int32_t*>(out_ptr),                                \
        static_cast<const int32_t*>(out_ent),                                \
        static_cast<const int32_t*>(out_src),                                \
        static_cast<const scalar_t*>(vals), static_cast<const scalar_t*>(X), \
        static_cast<scalar_t*>(W), nlisted, kpad, r_pad,                     \
        static_cast<cudaStream_t>(stream));                                  \
  }

DCORA_SPMM_GROUPED(f32, float)
DCORA_SPMM_GROUPED(f64, double)

#undef DCORA_SPMM_GROUPED

}  // extern "C"
