// Supernodal multifrontal LDL^T of S + tI for Hopper (sm_90a), f64: the
// certificate's inertia proof on the card.
//
// Replaces no TPU kernel: the JAX package proves the certificate with
// scipy's SuperLU on the host (dcora_tpu/core/certify.py, ldl_psd_proof),
// which the port ran too: 9 s of a 13.6 s certified solve at SE-Sync's
// grid3D (k = 32,000), on the host of an H100; this kernel takes 14 ms
// there on the H100.  Its plain version is core/ldlt.py:factor_plain,
// over the same analysis (core/ldlt.py:analyse, native/src/ldlt_analyse.cpp:
// ordering, supernodes, fronts, scatter maps and the schedule below).
//
// What it computes.  Supernodes in postorder; supernode s owns w columns
// and a front F_s, an f x f column-major matrix (f = w + rows below), of
// which only the lower triangle is read.  Per front:
//   assemble  F = S's entries of the w columns (+ t on their diagonal),
//             then the update matrix U_c = F_c[w_c:, w_c:] of each child c
//             added in child order (extend-add through c's rel map);
//   factor    per panel of NB columns [p0, p0 + pb): the unblocked LDL^T of
//             its diagonal block with diagonal pivots only (no pivot
//             search: SuperLU's diag_pivot_thresh=0), the rows below solved
//             L21 = A21 L11^-T D^-1, then the trailing lower triangle
//             updated C -= L21 D L21^T (U_s is what is left of F[w:, w:]).
// The pivots D go to piv[position]; nothing else of L is kept.
//
// What bounds it.  At grid3D the factorization is 2.3e10 f64 operations
// (sum over columns of c_j (c_j + 1), c_j the entries below the diagonal;
// nnz(L) 15.7M): 0.34 ms at the 67 TFLOP/s of f64 DMMA, 0.67 ms at 34
// TFLOP/s without; L's 126 MB would take 38 us at 3.35 TB/s.  Most of the
// operations are in a few fronts of 1,500-2,944 columns at the top of the
// tree; most fronts are small (1,889 of 2,848 leaves, f <= 88).  The tree's
// 17 levels are a chain of dependent steps, and the top front's 92 panels
// are a chain inside it.
//
// Design.  The schedule walks the tree a level at a time from the leaves
// (fronts of one level are independent), three kernels per level, each over
// every front of the level at once: ldlt_assemble (a CTA per 32 columns of a
// front), then per panel ldlt_panel (a CTA per 128 rows below the panel;
// each CTA factors the <= 32 x 32 diagonal block itself in shared memory,
// so no launch is spent on it, and the first writes the pivots) and
// ldlt_update (a CTA per 64 x 64 tile of the trailing lower triangle; the
// rank-pb product on f64 tensor cores, mma.sync m8n8k4, A scaled by D as it
// is staged).  A launch's CTAs find their job (front, panel) by a binary
// search over the job table's first tiles.  One C call issues the whole
// schedule (382 launches at grid3D) on the caller's stream.  No atomics:
// every sum has a fixed order (S's entry, the shift, the children in
// order; the products in k order), so two factorizations give the same
// bits.  A zero pivot gives inf or NaN downstream, which the verdict reads
// as inconclusive.

#include <cuda_runtime.h>
#include <stdint.h>

#define NB 32     // panel width (core/ldlt.py NB)
#define TILE 64   // update tile edge (TILE)
#define ROWS 128  // panel rows per CTA (ROWS)
#define ACOLS 32  // assembly columns per CTA (ACOLS)
#define ATHREADS 256

namespace {

struct Plan {
  const double* vals;  // S's CSR values
  double* fronts;
  double* piv;
  const int64_t* off;  // [ns] front offsets
  const int* first;    // [ns] first position
  const int* width;    // [ns]
  const int* size;     // [ns] front edge f
  const int* child_ptr;
  const int* child;
  const int* rel_ptr;  // [ns + 1] into rel
  const int* rel;      // each front's rows in its parent's front
  const int* amap_ptr;  // [k + 1] per position
  const int* amap_src;
  const int* amap_dst;
  const int* jobs;  // [J][4]: front, p0, pb, first tile
};

// the job of this CTA among jobs [j0, j0 + nj) of the launch
__device__ __forceinline__ int find_job(const int* jobs, int j0, int nj) {
  int lo = j0, hi = j0 + nj - 1;
  const int t = blockIdx.x;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (jobs[4 * mid + 3] <= t)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// first index of the ascending rel[0..m) with rel[i] >= v
__device__ __forceinline__ int lower_bound(const int* rel, int m, int v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (rel[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(ATHREADS)
    ldlt_assemble(Plan p, int j0, int nj, double shift) {
  const int j = find_job(p.jobs, j0, nj);
  const int s = p.jobs[4 * j], tile = blockIdx.x - p.jobs[4 * j + 3];
  const int f = p.size[s], w = p.width[s], pos0 = p.first[s];
  double* F = p.fronts + p.off[s];
  const int c0 = tile * ACOLS, c1 = min(f, c0 + ACOLS);
  const int64_t n0 = (int64_t)(c1 - c0) * f;
  for (int64_t e = threadIdx.x; e < n0; e += ATHREADS)
    F[(int64_t)c0 * f + e] = 0.0;
  __syncthreads();
  const int a0 = p.amap_ptr[pos0 + min(c0, w)];
  const int a1 = p.amap_ptr[pos0 + min(c1, w)];
  for (int e = a0 + threadIdx.x; e < a1; e += ATHREADS)
    F[p.amap_dst[e]] = p.vals[p.amap_src[e]];
  __syncthreads();
  for (int c = c0 + threadIdx.x; c < min(c1, w); c += ATHREADS)
    F[(int64_t)c * f + c] += shift;
  for (int q = p.child_ptr[s]; q < p.child_ptr[s + 1]; q++) {
    __syncthreads();  // the child before has landed
    const int ch = p.child[q];
    const int fc = p.size[ch], wc = p.width[ch], mc = fc - wc;
    const int* rel = p.rel + p.rel_ptr[ch];
    const int jlo = lower_bound(rel, mc, c0), jhi = lower_bound(rel, mc, c1);
    const double* U = p.fronts + p.off[ch] + (int64_t)wc * fc + wc;
    const int n = (jhi - jlo) * mc;
    for (int e = threadIdx.x; e < n; e += ATHREADS) {
      const int jc = jlo + e / mc, ic = e - (e / mc) * mc;
      if (ic >= jc)
        F[(int64_t)rel[jc] * f + rel[ic]] += U[(int64_t)jc * fc + ic];
    }
  }
}

__global__ void __launch_bounds__(ROWS) ldlt_panel(Plan p, int j0, int nj) {
  __shared__ double Ls[NB][NB + 1];  // [row][col] of the diagonal block
  const int j = find_job(p.jobs, j0, nj);
  const int s = p.jobs[4 * j], p0 = p.jobs[4 * j + 1], pb = p.jobs[4 * j + 2];
  const int tile = blockIdx.x - p.jobs[4 * j + 3];
  const int f = p.size[s];
  double* F = p.fronts + p.off[s];
  for (int e = threadIdx.x; e < pb * pb; e += ROWS) {
    const int r = e % pb, c = e / pb;
    if (r >= c) Ls[r][c] = F[(int64_t)(p0 + c) * f + p0 + r];
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // right-looking, lane i owns row i
    const int i = threadIdx.x;
    for (int c = 0; c < pb; c++) {
      double l = 0.0;
      if (i > c && i < pb) {
        l = Ls[i][c] / Ls[c][c];
        for (int q = c + 1; q <= i; q++) Ls[i][q] -= l * Ls[q][c];
      }
      __syncwarp();
      if (i > c && i < pb) Ls[i][c] = l;
      __syncwarp();
    }
  }
  __syncthreads();
  if (tile == 0 && threadIdx.x < pb)
    p.piv[p.first[s] + p0 + threadIdx.x] = Ls[threadIdx.x][threadIdx.x];
  const int i = p0 + pb + tile * ROWS + threadIdx.x;
  if (i >= f) return;
  double x[NB];
#pragma unroll
  for (int q = 0; q < NB; q++)
    x[q] = q < pb ? F[(int64_t)(p0 + q) * f + i] : 0.0;
#pragma unroll
  for (int q = 1; q < NB; q++) {
    if (q < pb) {
      double v = x[q];
#pragma unroll
      for (int t = 0; t < q; t++) v -= Ls[q][t] * x[t];
      x[q] = v;
    }
  }
#pragma unroll
  for (int q = 0; q < NB; q++)
    if (q < pb) F[(int64_t)(p0 + q) * f + i] = x[q] / Ls[q][q];
}

// acc(8x8) += a(8x4, row) b(4x8, col): lane (g = lane / 4, t = lane % 4)
// holds a[g][t], b[t][g] and acc[g][2t], acc[g][2t + 1]
__device__ __forceinline__ void dmma(double& c0, double& c1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

__global__ void __launch_bounds__(128) ldlt_update(Plan p, int j0, int nj) {
  __shared__ double As[NB][TILE + 4];  // [k][row], rows i: L21 * D
  __shared__ double Bs[NB][TILE + 4];  // [k][row], rows j: L21
  const int j = find_job(p.jobs, j0, nj);
  const int s = p.jobs[4 * j], p0 = p.jobs[4 * j + 1], pb = p.jobs[4 * j + 2];
  const int tile = blockIdx.x - p.jobs[4 * j + 3];
  const int f = p.size[s];
  double* F = p.fronts + p.off[s];
  const double* D = p.piv + p.first[s] + p0;
  int ti = (int)((sqrt(8.0 * tile + 1.0) - 1.0) * 0.5);
  while ((ti + 1) * (ti + 2) / 2 <= tile) ti++;
  while (ti * (ti + 1) / 2 > tile) ti--;
  const int tj = tile - ti * (ti + 1) / 2;
  const int i0 = p0 + pb + ti * TILE, jj0 = p0 + pb + tj * TILE;
  for (int e = threadIdx.x; e < NB * TILE; e += 128) {
    const int r = e % TILE, q = e / TILE;
    double a = 0.0, b = 0.0;
    if (q < pb) {
      const double* col = F + (int64_t)(p0 + q) * f;
      if (i0 + r < f) a = col[i0 + r] * D[q];
      if (jj0 + r < f) b = col[jj0 + r];
    }
    As[q][r] = a;
    Bs[q][r] = b;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  double acc[4][4][2];
#pragma unroll
  for (int a = 0; a < 4; a++)
#pragma unroll
    for (int b = 0; b < 4; b++) acc[a][b][0] = acc[a][b][1] = 0.0;
  const int kend = (pb + 3) & ~3;
  for (int kk = 0; kk < kend; kk += 4) {
    double af[4], bf[4];
#pragma unroll
    for (int m = 0; m < 4; m++) af[m] = As[kk + t][wr + 8 * m + g];
#pragma unroll
    for (int n = 0; n < 4; n++) bf[n] = Bs[kk + t][wc + 8 * n + g];
#pragma unroll
    for (int m = 0; m < 4; m++)
#pragma unroll
      for (int n = 0; n < 4; n++)
        dmma(acc[m][n][0], acc[m][n][1], af[m], bf[n]);
  }
#pragma unroll
  for (int m = 0; m < 4; m++) {
    const int row = i0 + wr + 8 * m + g;
    if (row >= f) continue;
#pragma unroll
    for (int n = 0; n < 4; n++)
#pragma unroll
      for (int v = 0; v < 2; v++) {
        const int col = jj0 + wc + 8 * n + 2 * t + v;
        if (col <= row) F[(int64_t)col * f + row] -= acc[m][n][v];
      }
  }
}

}  // namespace

extern "C" {

// ptrs: a host array of the device pointers in Plan's order; launches: a
// host array [n_launches][4] of (kind 0 assemble / 1 panel / 2 update,
// first job, jobs, CTAs).  Returns the first launch error, else 0.
int dcora_ldlt_factor_f64(const int64_t* ptrs, const int64_t* launches,
                          int n_launches, double shift, void* stream) {
  Plan p;
  p.vals = reinterpret_cast<const double*>(ptrs[0]);
  p.fronts = reinterpret_cast<double*>(ptrs[1]);
  p.piv = reinterpret_cast<double*>(ptrs[2]);
  p.off = reinterpret_cast<const int64_t*>(ptrs[3]);
  p.first = reinterpret_cast<const int*>(ptrs[4]);
  p.width = reinterpret_cast<const int*>(ptrs[5]);
  p.size = reinterpret_cast<const int*>(ptrs[6]);
  p.child_ptr = reinterpret_cast<const int*>(ptrs[7]);
  p.child = reinterpret_cast<const int*>(ptrs[8]);
  p.rel_ptr = reinterpret_cast<const int*>(ptrs[9]);
  p.rel = reinterpret_cast<const int*>(ptrs[10]);
  p.amap_ptr = reinterpret_cast<const int*>(ptrs[11]);
  p.amap_src = reinterpret_cast<const int*>(ptrs[12]);
  p.amap_dst = reinterpret_cast<const int*>(ptrs[13]);
  p.jobs = reinterpret_cast<const int*>(ptrs[14]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < n_launches; l++) {
    const int64_t* L = launches + 4 * l;
    const int jb = (int)L[1], nj = (int)L[2];
    const unsigned grid = (unsigned)L[3];
    switch (L[0]) {
      case 0:
        ldlt_assemble<<<grid, ATHREADS, 0, st>>>(p, jb, nj, shift);
        break;
      case 1:
        ldlt_panel<<<grid, ROWS, 0, st>>>(p, jb, nj);
        break;
      default:
        ldlt_update<<<grid, 128, 0, st>>>(p, jb, nj);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
