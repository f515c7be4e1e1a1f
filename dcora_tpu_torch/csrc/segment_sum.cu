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
// Design.  One thread per output element (row, column) sums the row's
// entries in ascending CSR order, each part from zero, and adds the parts'
// sums in order: the order and grouping of the CPU's index_add_ per part
// (sequential in position) followed by the sum of the parts, so on every
// row the card gives the CPU's bits.  The loads of a row do not depend on
// the sum, only the adds do, so a long row costs a chain of dependent adds;
// the edge path's rows are short (no row of ra10k's edge blocks holds more
// than 32 entries), and the longest rows the port sums (a robot's poses in
// DC2-PGO's per-robot gradient norms) come once per round.
//
// What bounds it: the edge path's blocks are small (ra10k at rank 3, f64:
// ~2 MB read for the rotations), so the launch and the dependent loads
// perm -> contrib bound it, not HBM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const scalar_t* __restrict__ contrib,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ ptr,
                   scalar_t* __restrict__ out, int num, int nseg, int w,
                   int part1, int part2) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (int64_t)num * w) return;
  const int row = (int)(e / w);
  const int col = (int)(e - (int64_t)row * w);
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
  out[e] = acc;
}

template <typename scalar_t>
int launch(const void* contrib, const void* perm, const void* ptr, void* out,
           int num, int nseg, int w, int part1, int part2,
           cudaStream_t stream) {
  const int64_t blocks = ((int64_t)num * w + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  segment_sum_kernel<scalar_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const scalar_t*>(contrib),
      static_cast<const int32_t*>(perm), static_cast<const int32_t*>(ptr),
      static_cast<scalar_t*>(out), num, nseg, w, part1, part2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dcora_segment_sum_f32(const void* contrib, const void* perm,
                          const void* ptr, void* out, int num, int nseg,
                          int w, int part1, int part2, void* stream) {
  return launch<float>(contrib, perm, ptr, out, num, nseg, w, part1, part2,
                       static_cast<cudaStream_t>(stream));
}

int dcora_segment_sum_f64(const void* contrib, const void* perm,
                          const void* ptr, void* out, int num, int nseg,
                          int w, int part1, int part2, void* stream) {
  return launch<double>(contrib, perm, ptr, out, num, nseg, w, part1, part2,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
