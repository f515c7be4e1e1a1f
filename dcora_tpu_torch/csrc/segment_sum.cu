// Deterministic segment sum  out[row, :] = sum of contrib[k, :] over the
// contributions k whose index is row, for Hopper (sm_90a).
//
// Replaces XLA's segment_sum of the edge path (jax.ops.segment_sum,
// dcora_tpu/core/problem.py:318, and its uses in core/init.py and the
// DC2-PGO driver): not a Pallas kernel, but the sum under every cost,
// gradient and Hessian-vector product of the edge path, which the port first
// took with CUDA's index_add_.  index_add_ adds with float atomics, so its
// order, and the bits of every edge-path product, changed from run to run,
// and the RA staircase landed in another place on every run.
//
// Layout (core/segment.py: build_map, once per index structure, on the
// host): perm is a stable argsort of the index array, ptr[row] ..
// ptr[row + 1] the row's entries of perm, in ascending position.  The
// contributions come in up to three parts (the edge kinds: pose-pose,
// pose-landmark, range); part1 and part2 are the positions where parts 1
// and 2 begin.  Every row is written: rows at or past nseg, or with no
// entry, get zeros, so the output needs no memset.  No atomics: the order
// of every sum is fixed by the layout, never by the schedule.
//
// One launch sums up to three such blocks (apply_Q's rotations,
// translations and spheres; each block its own contributions, map, output,
// rows and width), described by a Launch passed by value: the grid spans
// the blocks' elements back to back, block i's from element begin[i].  A
// thread finds its block from the two element offsets begin[1] and
// begin[2] (an absent block begins at the total).
//
// Design.  One thread per output element (row, column) sums the row's
// entries in ascending CSR order, each part from zero, and adds the parts'
// sums in order: the order and grouping of the CPU's index_add_ per part
// (sequential in position) followed by the sum of the parts, so on every
// row the card gives the CPU's bits, whether a block is summed alone or
// beside others.  The loads of a row do not depend on the sum, only the
// adds do, so a long row costs a chain of dependent adds; the edge path's
// rows are short (no row of ra10k's edge blocks holds more than 32
// entries), and the longest rows the port sums (a robot's poses in
// DC2-PGO's per-robot gradient norms) come once per round.
//
// What bounds it: the edge path's blocks are small (ra10k at rank 3, f64:
// ~2 MB read for the rotations, ~4 MB for apply_Q's three blocks), so the
// launch and the dependent loads perm -> contrib bound it, not HBM.  One
// launch per apply_Q, not one per block, saves two launches' ramp and
// host issue per product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 3;

// One block of a launch; pointers as 64-bit integers (core/segment.py
// packs the Launch as 31 int64 values).
struct Block {
  int64_t contrib;  // const scalar_t* [K, w]
  int64_t perm;     // const int32_t* [K]
  int64_t ptr;      // const int32_t* [nseg + 1]
  int64_t out;      // scalar_t* [num, w]
  int64_t begin;    // the block's first element in the launch's grid
  int64_t num, nseg, w, part1, part2;
};

struct Launch {
  Block blk[kMaxBlocks];
  int64_t total;  // elements of every block together
};

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const Launch L) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= L.total) return;
  const int b = (e >= L.blk[1].begin) + (e >= L.blk[2].begin);
  // selects, not an indexed read of the parameter space
#define PICK(f) (b == 0 ? L.blk[0].f : b == 1 ? L.blk[1].f : L.blk[2].f)
  const scalar_t* __restrict__ contrib =
      reinterpret_cast<const scalar_t*>(PICK(contrib));
  const int32_t* __restrict__ perm =
      reinterpret_cast<const int32_t*>(PICK(perm));
  const int32_t* __restrict__ ptr =
      reinterpret_cast<const int32_t*>(PICK(ptr));
  scalar_t* __restrict__ out = reinterpret_cast<scalar_t*>(PICK(out));
  const int64_t local = e - PICK(begin);
  const int w = (int)PICK(w);
  const int nseg = (int)PICK(nseg);
  const int part1 = (int)PICK(part1), part2 = (int)PICK(part2);
#undef PICK
  const int row = (int)(local / w);
  const int col = (int)(local - (int64_t)row * w);
  scalar_t acc = scalar_t(0);
  if (row < nseg) {
    const int hi = ptr[row + 1];
    scalar_t part = scalar_t(0);
    int cur = 0;
    for (int k = ptr[row]; k < hi; ++k) {
      const int src = perm[k];
      const int p = (src >= part1) + (src >= part2);
      if (p != cur) {
        acc += part;
        part = scalar_t(0);
        cur = p;
      }
      part += contrib[(int64_t)src * w + col];
    }
    acc += part;
  }
  out[local] = acc;
}

template <typename scalar_t>
int run(const void* desc, cudaStream_t stream) {
  const Launch L = *static_cast<const Launch*>(desc);
  const int64_t blocks = (L.total + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  segment_sum_kernel<scalar_t><<<(unsigned)blocks, kThreads, 0, stream>>>(L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// desc: a host pointer to the Launch above (read before this returns).
int dcora_segment_sum_f32(const void* desc, void* stream) {
  return run<float>(desc, static_cast<cudaStream_t>(stream));
}

int dcora_segment_sum_f64(const void* desc, void* stream) {
  return run<double>(desc, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
