// Block-tridiagonal preconditioner solve  Y = M^{-1} V  for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It replaces the two lax.scans of the JAX
// package's _precondition_btd (dcora_tpu/core/tiled.py:822, the scans at
// :846 and :855), which the port first replayed as a CUDA graph of 2 * nt
// dependent cuBLASLt products (732 launches at nt = 366).  Its plain
// version is core/tiled.py:_precondition_btd.
//
// What it computes (row-vector form of the block-LDL^T solve that
// tiled._factor_btd factors on the host; T = 128, nt blocks, V and Y are
// [r_pad, nt * T] row-major, block i is columns [i T, (i + 1) T)):
//   forward   u_0 = v_0,            u_i = v_i - u_{i-1} L~_i^T
//   diagonal  w_i = u_i Sinv_i
//   backward  y_{nt-1} = w_{nt-1},  y_i = w_i - y_{i+1} L~_{i+1}
// Each of the 3 nt - 2 products has the form out[:, c] = sum_k x[:, k] B[k, c]
// with B a [T, T] block: L~_i^T, Sinv_i or L~_{i+1}.  Rows of V are
// independent: each cluster of CTAs solves 8 of them.
//
// What bounds it.  Bytes: the factors (2 nt T^2 values, 48 MB in f32 at
// nt = 366) cross HBM once; at 3.35 TB/s that is ~0.015 ms (f32).  But the
// solve is a chain of 2 nt - 1 dependent steps, each a [8, T] x [T, T]
// product whose input is the step before's output, so the chain's latency
// bounds it long before the bytes do: one SM doing a step's 131k
// multiply-adds alone needs ~1 us in f64, and any split of a step over
// several SMs pays an exchange and a barrier per step.
//
// Design.  A thread-block cluster of C = 8 CTAs walks the chain
// together: CTA j owns the output columns [j W, (j + 1) W), W = T / C = 16,
// so a step's arithmetic splits C ways.  Each CTA keeps the full running
// row block x (8 rows x T, transposed to [k][row]) in shared memory and
// computes its W columns of the next one, which it sends to every CTA's
// copy with st.async: a store into another CTA's shared memory that counts
// its bytes on that CTA's mbarrier.  A CTA waits on its own mbarrier until
// the whole new block has landed, so no step pays a cluster-wide barrier,
// and no sender waits for its stores to complete.  Three x buffers rotate:
// a CTA can run at most one exchange ahead of the slowest, so it never
// writes a buffer that another still reads, and the forward walk runs the
// diagonal product w_{i-1} (off the chain) while the next block is in
// flight.  The factor panels (B[:, cols of CTA j], 128 rows x W) do not
// depend on x: the wrapper lays each factor out panel by panel
// ([nt][C][T][W], once per TiledProblem), so a panel is contiguous and one
// thread streams it with TMA bulk copies (cp.async.bulk, completion on an
// mbarrier) in chunks of <= 16 KB through an 8-slot ring, 8 chunks ahead of
// the chain (a 128 x 128 f64 block is 128 KB: whole blocks would not fit
// twice).  Inside a CTA, thread (c, ks) sums k = ks, ks + KS, ... of column
// c for all 8 rows (one B load per 8 multiply-adds); the KS partial sums of
// each output are then added in ks order through shared memory.  No
// atomics, and every sum has a fixed order, so two applications give the
// same bits.  Zero blocks of L~ (a broken band) are multiplied like any
// other: skipping them could flip the sign of a zero result.  nt is not
// capped.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 128;      // T
constexpr int kCluster = 8;     // CTAs per cluster (tiled.BTD_CLUSTER)
constexpr int kRows = 8;        // rows of V per cluster
constexpr int kThreads = 256;
constexpr int kSlots = 8;       // ring slots
constexpr int kChunkBytes = 16384;

template <typename T>
struct Shape {
  static constexpr int W = kTile / kCluster;   // output columns per CTA
  static constexpr int KS = kThreads / W;      // k-splits per column
  static constexpr int KC0 = kChunkBytes / (W * (int)sizeof(T));
  static constexpr int KC = KC0 < kTile ? KC0 : kTile;  // k rows per chunk
  static constexpr int NCH = kTile / KC;       // chunks per panel
  static constexpr int MPC = KC / KS;          // k values per thread, chunk
  static constexpr int NO = W >= 32 ? W / 32 : 1;  // outputs per thread
  static constexpr size_t chunk = (size_t)KC * W;
  static constexpr size_t xbuf = (size_t)kTile * kRows;
  static constexpr size_t red = (size_t)KS * kRows * W;
  static constexpr size_t smem =
      (kSlots * chunk + 3 * xbuf + 2 * red) * sizeof(T) + (kSlots + 3) * 8;
  static_assert(KC % KS == 0 && kTile % KC == 0 && NCH <= kSlots,
                "chunking");
  static_assert(KS * W == kThreads, "thread split");
  static_assert(chunk * sizeof(T) % 16 == 0, "bulk copy size");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}

// one bulk copy global -> shared, its completion counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// the shared::cluster address of a shared address in CTA `rank`
__device__ __forceinline__ unsigned mapa(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// a store into another CTA's shared memory that counts its bytes on that
// CTA's mbarrier bar
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(unsigned addr, double v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "l"(__double_as_longlong(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

// the 8 rows of x at one k (x is [k][row]), as 16-byte loads
__device__ __forceinline__ void load8(const float* p, float (&o)[kRows]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const double* p, double (&o)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) {
    const double2 a = reinterpret_cast<const double2*>(p)[i];
    o[2 * i] = a.x;
    o[2 * i + 1] = a.y;
  }
}

// bf, bd, bb: the panels of L~_i^T (forward), Sinv_i (diagonal) and L~_i
// (backward), each [nt][C][T][W]: block i's columns [j W, (j + 1) W) as one
// contiguous [T][W] panel per CTA j.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
btd_solve_kernel(const T* __restrict__ bf, const T* __restrict__ bd,
                 const T* __restrict__ bb, const T* __restrict__ v,
                 T* __restrict__ y, int nt) {
  using S = Shape<T>;
  constexpr int C = kCluster, W = S::W, KS = S::KS, NCH = S::NCH;
  constexpr size_t kBlock = (size_t)kTile * kTile;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* xbuf = ring + kSlots * S::chunk;  // [3][kTile][kRows]
  T* red = xbuf + 3 * S::xbuf;         // [2][KS][kRows][W]
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + 2 * S::red);
  uint64_t* xbars = bars + kSlots;  // one per x buffer
  constexpr unsigned kBlockBytes = kRows * kTile * sizeof(T);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c0 = rank * W;
  const int t = threadIdx.x;
  const int col = t % W, ks = t / W;
  const int64_t kpad = (int64_t)nt * kTile;
  const T* vrow = v + (int64_t)blockIdx.y * kRows * kpad;
  T* yrow = y + (int64_t)blockIdx.y * kRows * kpad;
  // panels, in the order the walks use them: forward step s (1..nt-1)
  // takes L~_s^T then Sinv_{s-1}; then Sinv_{nt-1}; then backward step s
  // (nt-2..0) takes L~_{s+1}
  const int64_t fwd = 2 * (int64_t)(nt - 1);
  const int64_t nchunks = (3 * (int64_t)nt - 2) * NCH;

  auto issue = [&](int64_t q) {  // thread 0: chunk q into its slot
    if (q >= nchunks) return;
    const int64_t p = q / NCH;
    const T* base;
    if (p < fwd) {
      const int64_t s = p / 2 + 1;
      base = (p & 1) ? bd + (s - 1) * kBlock : bf + s * kBlock;
    } else if (p == fwd) {
      base = bd + (int64_t)(nt - 1) * kBlock;
    } else {
      base = bb + (int64_t)(nt - 1 - (p - fwd - 1)) * kBlock;
    }
    const T* src = base + rank * (kTile * W) + (q % NCH) * S::chunk;
    // the slot's last reads were generic loads; order them before the
    // async proxy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_load(ring + (q % kSlots) * S::chunk, src,
              (unsigned)(S::chunk * sizeof(T)), &bars[q % kSlots]);
  };

  // one product out[:, c0 + c] = sum_k x[:, k] B[k, c0 + c], B the next
  // panel of the ring; leaves the KS partial sums of each output in red
  int64_t q = 0;
  int nprod = 0;
  auto product = [&](const T* x) {
    T acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = T(0);
#pragma unroll
    for (int h = 0; h < NCH; ++h) {
      mbar_wait(&bars[(q + h) % kSlots], (unsigned)((q + h) / kSlots) & 1u);
      const T* b = ring + ((q + h) % kSlots) * S::chunk + col;
      const T* xk = x + (h * S::KC) * kRows;
#pragma unroll 4
      for (int m = 0; m < S::MPC; ++m) {
        const int k = ks + KS * m;
        const T bv = b[k * W];
        T xv[kRows];
        load8(xk + k * kRows, xv);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmadd(xv[r], bv, acc[r]);
      }
    }
    T* rd = red + (nprod & 1) * S::red;
#pragma unroll
    for (int r = 0; r < kRows; ++r) rd[(ks * kRows + r) * W + col] = acc[r];
    __syncthreads();  // partial sums written; the panel's slots are free
    if (t == 0)
      for (int h = 0; h < NCH; ++h) issue(q + h + kSlots);
    q += NCH;
    ++nprod;
  };
  // output o = (row o / W, column o % W) of the last product
  auto reduced = [&](int o) -> T {
    const T* rd = red + ((nprod - 1) & 1) * S::red;
    const int r = o / W, c = o % W;
    T s = T(0);
#pragma unroll 4
    for (int k = 0; k < KS; ++k) s += rd[(k * kRows + r) * W + c];
    return s;
  };
  // store output o of the row block of exchange e into x buffer e % 3 of
  // every CTA, each store counted on that CTA's mbarrier of the buffer
  auto put = [&](int e, int o, T val) {
    const int b = e % 3;
    const unsigned addr = smem_addr(xbuf + b * S::xbuf +
                                    (c0 + o % W) * kRows + o / W);
    const unsigned bar = smem_addr(&xbars[b]);
#pragma unroll
    for (int d = 0; d < C; ++d) st_async(mapa(addr, d), val, mapa(bar, d));
  };
  // wait until every CTA's part of exchange e has landed, then arm the
  // buffer's mbarrier for exchange e + 3 (no CTA can send that one before
  // this CTA has sent e + 1 and e + 2)
  auto await = [&](int e) {
    mbar_wait(&xbars[e % 3], (unsigned)((e - 1) / 3) & 1u);
    if (t == 0) mbar_expect(&xbars[e % 3], kBlockBytes);
  };
  auto at = [&](int o, int blk) -> int64_t {  // element of V / Y
    return (int64_t)(o / W) * kpad + (int64_t)blk * kTile + c0 + o % W;
  };
  auto mine = [&](int i) { return t + i * kThreads < kRows * W; };

  if (t == 0) {
    for (int i = 0; i < kSlots + 3; ++i) mbar_init(&bars[i]);
    for (int i = 0; i < 3; ++i) mbar_expect(&xbars[i], kBlockBytes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0)
    for (int i = 0; i < kSlots; ++i) issue(i);
  for (int e = t; e < kRows * kTile; e += kThreads) {
    const int r = e / kTile, k = e % kTile;
    xbuf[k * kRows + r] = vrow[r * kpad + k];  // u_0 = v_0
  }
  T pre[S::NO];  // v_{s+1} (forward) or w_s (backward), one step ahead
#pragma unroll
  for (int i = 0; i < S::NO; ++i)
    if (mine(i) && nt > 1) pre[i] = vrow[at(t + i * kThreads, 1)];
  // x written; every CTA's mbarriers are set before any remote store
  cluster.sync();

  // exchange e carries u_e (forward, e = 1 .. nt - 1), then y_{nt-1}
  // (e = nt), then y_{nt-2}, y_{nt-3}, ... (backward)
  for (int s = 1; s < nt; ++s) {
    if (s >= 2) await(s - 1);
    const T* xp = xbuf + ((s - 1) % 3) * S::xbuf;
    product(xp);  // u_{s-1} L~_s^T
#pragma unroll
    for (int i = 0; i < S::NO; ++i)
      if (mine(i)) {
        const int o = t + i * kThreads;
        const T u = pre[i] - reduced(o);
        if (s + 1 < nt) pre[i] = vrow[at(o, s + 1)];
        put(s, o, u);
      }
    product(xp);  // w_{s-1} = u_{s-1} Sinv_{s-1}, off the chain
#pragma unroll
    for (int i = 0; i < S::NO; ++i)
      if (mine(i)) {
        const int o = t + i * kThreads;
        yrow[at(o, s - 1)] = reduced(o);
      }
  }
  if (nt > 1) await(nt - 1);
  product(xbuf + ((nt - 1) % 3) * S::xbuf);  // w_{nt-1} = y_{nt-1}
#pragma unroll
  for (int i = 0; i < S::NO; ++i)
    if (mine(i)) {
      const int o = t + i * kThreads;
      const T w = reduced(o);
      yrow[at(o, nt - 1)] = w;
      if (nt > 1) {
        put(nt, o, w);
        pre[i] = yrow[at(o, nt - 2)];  // w_{nt-2}, this thread's store
      }
    }

  int e = nt;
  for (int s = nt - 2; s >= 0; --s, ++e) {
    await(e);
    product(xbuf + (e % 3) * S::xbuf);  // y_{s+1} L~_{s+1}
#pragma unroll
    for (int i = 0; i < S::NO; ++i)
      if (mine(i)) {
        const int o = t + i * kThreads;
        const T yv = pre[i] - reduced(o);
        if (s > 0) {
          pre[i] = yrow[at(o, s - 1)];
          put(e + 1, o, yv);
        }
        yrow[at(o, s)] = yv;
      }
  }
  cluster.sync();  // no CTA leaves while stores to it may be in flight
}

template <typename T>
int launch(const void* bf, const void* bd, const void* bb, const void* v,
           void* y, int nt, int r_pad, void* stream) {
  if (nt < 1 || r_pad < kRows || r_pad % kRows != 0 ||
      r_pad / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = Shape<T>::smem;
  auto kern = btd_solve_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, r_pad / kRows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(bf),
                           static_cast<const T*>(bd),
                           static_cast<const T*>(bb),
                           static_cast<const T*>(v), static_cast<T*>(y), nt);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf, bd, bb: L~^T, inv(S) and L~ laid out panel by panel, [nt][8][128][16]
// each (tiled._btd_layout); v, y: [r_pad, nt * 128]; every array
// contiguous, on the stream's device.  Returns a cudaError_t.
int dcora_btd_solve_f32(const void* bf, const void* bd, const void* bb,
                        const void* v, void* y, int nt, int r_pad,
                        void* stream) {
  return launch<float>(bf, bd, bb, v, y, nt, r_pad, stream);
}

int dcora_btd_solve_f64(const void* bf, const void* bd, const void* bb,
                        const void* v, void* y, int nt, int r_pad,
                        void* stream) {
  return launch<double>(bf, bd, bb, v, y, nt, r_pad, stream);
}

}  // extern "C"
