// Symmetric block-sparse SpMM  W = X Q  for Hopper (sm_90a).
//
// Replaces the TPU kernel dcora_tpu/core/pallas_spmm.py:_grouped_kernel
// (run per width bucket by spmm_bucketed).  Q is symmetric and only its
// upper-triangular T x T tiles (tile row <= tile col) are stored; a stored
// tile A at (r, c) adds X[:, r] A into W[:, c], and X[:, c] A^T into W[:, r]
// when r != c.  X and W are [r_pad, nt*T] row-major, T = 128.
//
// Design.  The TPU kernel is one sequential loop with W resident in VMEM and
// `+=` into it.  Blocks on Hopper run in parallel and in no order, so this
// kernel is owner-computes over output tile-columns: block (c, p) computes
// rows [p*RB, p*RB+RB) of W[:, c], summing over a host-built CSR list of
// (tile, source column) entries for column c:
//   * src <= c: the stored tile (src, c), applied as X[:, src] A;
//   * src >  c: the stored tile (c, src), applied as X[:, src] A^T.
// No atomics, no zero-init pass, and a fixed summation order, so the result
// is deterministic.  The price is that every off-diagonal tile is read
// twice (once per owning column); the two reads of one tile come from
// blocks whose columns are a few RCM band-widths apart, so the second read
// may hit L2.
//
// What bounds it.  Tile bytes: at r_pad 8 each tile element feeds 8 FMAs,
// about 4 flop per byte in f32 and 2 in f64, far below the H100's ridge.
// With one block per column and ~8 tiles per column, a block must keep a
// whole tile's loads in flight to approach the card's bandwidth, so the
// contraction is split over KS thread groups: thread (j, s) owns output
// column j and contraction rows [s*KC, s*KC+KC), and issues all KC of its
// tile loads before it touches any of them.  A is read in row order for
// the forward product (a warp reads 32 neighbouring elements) and as
// 16-byte vectors along row j for the transposed one, so neither needs a
// shared-memory transpose.  The KS partial sums meet in a fixed order at
// the end.  Accumulation is plain FMA in the working type: no TF32, no
// bf16.  A wgmma/TMA pipeline is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;  // tile edge; one thread per output column per group
// Contraction groups per block (512 threads).  On one H100 at the 10,648-pose
// grid's shapes, 4 beat 2 and 8 in both types (8 spills in f64).
constexpr int KS = 4;

template <typename scalar_t>
struct Vec16;  // 16 bytes of scalar_t
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void unpack(const float4& q, float* out) {
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static void unpack(const double2& q, double* out) {
    out[0] = q.x; out[1] = q.y;
  }
};

template <typename scalar_t, int RB>
__global__ void __launch_bounds__(T * KS)
spmm_sym_kernel(const scalar_t* __restrict__ tiles,
                const int32_t* __restrict__ out_ptr,
                const int32_t* __restrict__ ent_tile,
                const int32_t* __restrict__ ent_src,
                const scalar_t* __restrict__ X,
                scalar_t* __restrict__ W,
                int r_pad, int64_t kpad) {
  using V = Vec16<scalar_t>;
  constexpr int KC = T / KS;
  static_assert(KC % V::n == 0, "slice must be whole 16-byte vectors");
  __shared__ scalar_t xs[RB][T];

  const int c = blockIdx.x;
  const int row0 = blockIdx.y * RB;
  const int nrow = min(RB, r_pad - row0);
  const int j = threadIdx.x;
  const int s = threadIdx.y;
  const int k0 = s * KC;
  const int tid = s * T + j;

  scalar_t acc[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) acc[i] = scalar_t(0);

  const int e0 = out_ptr[c];
  const int e1 = out_ptr[c + 1];
  for (int e = e0; e < e1; ++e) {
    const int src = ent_src[e];
    const scalar_t* A = tiles + (int64_t)ent_tile[e] * (T * T);
    scalar_t a[KC];
    if (src <= c) {
      // X[:, src] A: a[kk] = A[k0 + kk][j]
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) a[kk] = __ldg(A + (k0 + kk) * T + j);
    } else {
      // X[:, src] A^T: a[kk] = A[j][k0 + kk], contiguous along row j
      const typename V::type* row =
          reinterpret_cast<const typename V::type*>(A + j * T + k0);
#pragma unroll
      for (int v = 0; v < KC / V::n; ++v) V::unpack(__ldg(row + v), a + v * V::n);
    }
    __syncthreads();  // the previous entry is done with xs
    for (int idx = tid; idx < RB * T; idx += T * KS) {
      const int i = idx / T;
      const int t = idx % T;
      xs[i][t] = (i < nrow)
                     ? X[(int64_t)(row0 + i) * kpad + (int64_t)src * T + t]
                     : scalar_t(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
      for (int i = 0; i < RB; ++i) acc[i] = fma(xs[i][k0 + kk], a[kk], acc[i]);
    }
  }

  // the KS partial sums, added in group order through xs
  for (int q = 1; q < KS; ++q) {
    __syncthreads();
    if (s == q) {
#pragma unroll
      for (int i = 0; i < RB; ++i) xs[i][j] = acc[i];
    }
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < RB; ++i) acc[i] += xs[i][j];
    }
  }
  if (s == 0) {
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      if (i < nrow) W[(int64_t)(row0 + i) * kpad + (int64_t)c * T + j] = acc[i];
    }
  }
}

template <typename scalar_t>
int launch(const scalar_t* tiles, const int32_t* out_ptr,
           const int32_t* ent_tile, const int32_t* ent_src,
           const scalar_t* X, scalar_t* W, int nt, int r_pad,
           cudaStream_t stream) {
  const int64_t kpad = (int64_t)nt * T;
  const dim3 block(T, KS);
  if (r_pad <= 8) {
    spmm_sym_kernel<scalar_t, 8><<<dim3(nt, 1), block, 0, stream>>>(
        tiles, out_ptr, ent_tile, ent_src, X, W, r_pad, kpad);
  } else {
    spmm_sym_kernel<scalar_t, 16>
        <<<dim3(nt, (r_pad + 15) / 16), block, 0, stream>>>(
            tiles, out_ptr, ent_tile, ent_src, X, W, r_pad, kpad);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dcora_spmm_sym_f32(const void* tiles, const void* out_ptr,
                       const void* ent_tile, const void* ent_src,
                       const void* X, void* W, int nt, int r_pad,
                       void* stream) {
  return launch<float>(static_cast<const float*>(tiles),
                       static_cast<const int32_t*>(out_ptr),
                       static_cast<const int32_t*>(ent_tile),
                       static_cast<const int32_t*>(ent_src),
                       static_cast<const float*>(X), static_cast<float*>(W),
                       nt, r_pad, static_cast<cudaStream_t>(stream));
}

int dcora_spmm_sym_f64(const void* tiles, const void* out_ptr,
                       const void* ent_tile, const void* ent_src,
                       const void* X, void* W, int nt, int r_pad,
                       void* stream) {
  return launch<double>(static_cast<const double*>(tiles),
                        static_cast<const int32_t*>(out_ptr),
                        static_cast<const int32_t*>(ent_tile),
                        static_cast<const int32_t*>(ent_src),
                        static_cast<const double*>(X),
                        static_cast<double*>(W), nt, r_pad,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
