// The per-pose Riemannian ops of the flat tCG iteration for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It replaces the XLA fusions of the JAX
// package's flat-layout ops inside truncated_cg's lax.while_loop
// (dcora_tpu/core/rtr.py:304-360): tangent_project_flat
// (dcora_tpu/core/tiled.py:743), weingarten_setup (:772), weingarten_apply
// (:792) and the per-pose branch of precondition_flat (:860), which the
// JAX package writes as unrolled elementwise code over lane-major slices so
// that XLA fuses them.  The port first ran them as torch.einsums over the
// [r, n, dh] view, a few small launches each.  Their plain versions are
// core/tiled.py: _rhess_plain, _tangent_project_plain, _sym_gram,
// weingarten_apply and _precondition_pose_plain.
//
// Layout (core/tiled.py): a flat state is [r_pad, A kpad] row-major, A
// agents side by side (A = 1 for one problem), agent a at columns
// [a kpad, (a + 1) kpad).  Inside an agent: n pose blocks of dh = d + 1
// columns (the Stiefel block Y_i in the first d, the translation last),
// then l sphere columns, b landmark columns, and pad columns up to kpad.
// Per-pose constants are indexed (a n + i), per-sphere (a l + q),
// per-landmark (a b + j).
//
// Kernel 1, flat_rhess:  out = P_X(V - W(eta)).  On the Stiefel columns of
// pose i, H_i = V_i - eta_i Ssym_i and out_i = H_i - Y_i sym(Y_i^T H_i);
// the translation column is V's; a sphere column q gets h - x <x, h>, with
// h = v - eta s_inner_q; landmarks and pads are V's.  With eta absent it is
// tangent_project_flat; with `out` absent and `gram` given it writes
// sym(Y_i^T V_i) and <x_q, v_q> instead (weingarten_setup); with project
// = 0 it writes H itself (the certifier's Hessian operator).
//
// Kernel 2, flat_precond:  out = P_X(M^{-1} V) for the per-pose block-Jacobi
// preconditioner: z_i = V_i pose_inv_i (dh x dh), z_q = v_q sph_inv_q,
// z_j = v_j lmk_inv_j on landmarks, pads as they are; then the projection
// of kernel 1.
//
// What bounds them.  Bytes: each reads X and V (and eta) once and writes
// out once (grid10k, f64, r_pad 8: ~11.7 MB for flat_rhess, ~9.6 MB for
// flat_precond with pose_inv, ~3.5 / ~2.9 us at 3.35 TB/s); the arithmetic
// is ~30 multiply-adds per element.  The first design (one thread per pose
// walking the r_pad rows twice, ~10.7k threads at grid10k: 84 blocks on
// 132 SMs) was bound by latency instead: each thread had about one row's
// loads in flight, so a launch took ~2 r_pad dependent memory round trips
// (twice as long at r_pad 16 as at r_pad 8) and, at 97k poses in f64,
// used under half the memory rate.
//
// Design.  A CTA of kThreads = 64 threads owns a tile of kP = 16 consecutive
// poses of one agent (never two) across all rows, a thread per column, or a
// tail tile of kCols = 64 columns past the poses (spheres, landmarks, pads), a
// thread per column: 666 pose CTAs at 10,648 poses, 6,084 at 97,336.  It first
// stages its tile's rows of X, V and eta into shared memory with every copy in
// flight at once: one cp.async.bulk per row and array, all completing on one
// mbarrier (a tile's row segment is 16-byte aligned when the operands and kpad
// are, kpad being a multiple of 128 on the solver's tiles and a tile starting
// at a multiple of kP poses; else one cp.async per element), and the pose
// constants beside them.  Then each thread makes its column's H = V - W(eta)
// (flat_precond: z = V pose_inv) row by row in place, sums its d Gram entries
// S[p][q] (y[p] h[q] over the rows in ascending order), trades S[q][p] with
// its pose's other columns through shared memory (one barrier) for sym(), and
// writes H - Y sym(Y^T H) straight to its rows (a warp writes contiguous
// columns).  A tail thread copies its landmark or pad column, or sums <x, h>
// over its sphere column's rows and projects it.  Rows go in chunks of at most
// kRows: the Gram sums stay in registers across chunks, and with more than one
// chunk the projection stages the rows again and remakes H.  The tile size, the
// copies and the loop structure were chosen by timing variants on the H100: 16
// poses a tile beat 32 at 97k poses, one bulk copy per row beat 16-byte
// cp.async per thread at 10k, and one mbarrier for the chunk beat one per row.
//
// Every scalar is the same sequence of operations as in the first design,
// which gave the plain version's bits on the pose blocks: each per-pose
// sum is taken as the plain version's batched products take it on the card
// (each product's terms in index order, fused multiply-adds from zero, the
// result subtracted once); the sphere sums are in row order with fused
// multiply-adds, written as the first design wrote them.  So a launch gives
// the first design's bits on every column, and no trajectory moves.  No
// atomics and no sums across threads: the tCG's dot products stay where
// they are, so a CUDA graph of the iteration and the eager loop run the
// same kernels.  d (up to 3) is a template argument, so every per-pose loop
// is unrolled.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 3;
constexpr int kRows = 16;         // rows of a staged chunk
constexpr int kP = 16;            // poses of a tile
constexpr int kCols = 4 * kP;     // a staged row: kP dh <= 4 kP columns
constexpr int kThreads = kCols;   // a thread per column

// One launch: pointers as 64-bit integers (0 when absent), then sizes.
// core/tiled.py packs it as 19 int64 values.
struct FlatArgs {
  int64_t X, V, eta, ssym, sinner;  // inputs; eta, ssym, sinner: flat_rhess
  int64_t pinv, sinv, linv;         // flat_precond: the Jacobi inverses
  int64_t out, gram, gsph;          // outputs
  int64_t n, l, b, d, kpad, agents, r_pad, project;
};

// The tiling run() derives from FlatArgs: per agent, pose_tiles tiles of
// kP poses, then tail tiles of kCols columns from column tail0 (the end of
// the poses rounded down to a whole copy) to kpad.
struct Launch {
  FlatArgs g;
  int64_t tail0;
  int pose_tiles, tiles, rows;  // rows: of a staged chunk
};

template <typename T>
__device__ __forceinline__ const T* in(int64_t p) {
  return reinterpret_cast<const T*>(p);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// one element global -> shared, asynchronously
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

// count elements, one copy each (the per-pose constants)
template <typename T>
__device__ __forceinline__ void stage_elems(T* dst, const T* src, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads)
    copy_async(dst + i, src + i);
}

// The CTA's staging of row chunks: stage() issues the copies of one array
// (rows x w of a row stride ld into rows of kCols), wait() makes
// everything issued since the last wait visible to every thread.  kBulk:
// one cp.async.bulk per row, completing on an mbarrier that counts the
// `arrays` stage() calls before each wait; else (operands not 16-byte
// aligned) one cp.async per element.
template <typename T, bool kBulk>
struct Stager {
  // elements of a whole copy: a staged width is a multiple of it
  static constexpr int width = kBulk ? 16 / (int)sizeof(T) : 1;
  uint64_t* bar;
  unsigned parity;

  __device__ void init(int arrays) {
    parity = 0;
    if (kBulk) {
      if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                         smem_addr(bar)),
                     "r"(arrays));
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      __syncthreads();
    }
  }

  __device__ void stage(T* dst, const T* src, int64_t ld, int rows, int w) {
    if (kBulk) {
      if (threadIdx.x == 0) {
        // the rows' last reads and writes were generic; order them before
        // the async proxy's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const unsigned row = (unsigned)(w * sizeof(T));
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                smem_addr(bar)),
            "r"(row * rows)
            : "memory");
        for (int r = 0; r < rows; ++r)
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
              "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst + r * kCols)),
              "l"(src + r * ld), "r"(row), "r"(smem_addr(bar))
              : "memory");
      }
      return;
    }
    for (int i = threadIdx.x; i < rows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      if (c < w) copy_async(dst + r * kCols + c, src + r * ld + c);
    }
  }

  __device__ void wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (kBulk) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "WAIT:\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
          "@!p bra WAIT;\n"
          "}\n" ::"r"(smem_addr(bar)),
          "r"(parity)
          : "memory");
      parity ^= 1u;
    }
    __syncthreads();
  }
};

// The rows of a sphere column's h that the kernels project, read from the
// staged chunk (row stride ld), written as the first design's functors.

// h = v - eta s_inner (eta absent: v)
template <typename T>
struct RhessSphere {
  const T* V;
  const T* eta;
  int ld;
  T si;
  __device__ __forceinline__ T operator()(int r) const {
    return eta ? V[r * ld] - eta[r * ld] * si : V[r * ld];
  }
};

// z = v sph_inv
template <typename T>
struct JacobiSphere {
  const T* V;
  int ld;
  T si;
  __device__ __forceinline__ T operator()(int r) const {
    return V[r * ld] * si;
  }
};

// Shared memory of a CTA: an mbarrier, the chunk's rows of X, V and eta
// (flat_precond: z in place of eta), the pose constants (Ssym or
// pose_inv) and the Grams.
template <typename T>
struct Smem {
  static constexpr size_t bytes(int rows) {
    return 16 + sizeof(T) * (3 * (size_t)rows * kCols + kP * 16 + kP * 9);
  }
  uint64_t* bar;
  T *X, *V, *E, *C, *S;
  __device__ Smem(unsigned char* raw, int rows) {
    bar = reinterpret_cast<uint64_t*>(raw);
    X = reinterpret_cast<T*>(raw + 16);
    V = X + rows * kCols;
    E = V + rows * kCols;
    C = E + rows * kCols;
    S = C + kP * 16;
  }
};

// a launch's dynamic shared memory needs no opt-in above 48 KB
static_assert(Smem<double>::bytes(kRows) <= 48 * 1024, "shared memory");

// One tile of agent a: poses t kP .. t kP + np - 1, d = D, a thread per
// column (pose, q).
template <typename T, int D, bool kBulk, bool kPrecond>
__device__ __forceinline__ void pose_tile(const Launch& L, int64_t a, int t,
                                          const Smem<T>& sm) {
  constexpr int W = kCols;
  constexpr int DH = D + 1, DD = D * D;
  const FlatArgs& g = L.g;
  const int r_pad = (int)g.r_pad, RC = L.rows;
  const int64_t ld = g.agents * g.kpad;
  const int p0 = t * kP;
  const int np = min(kP, (int)(g.n - p0));
  const int cols = np * DH;
  const bool eta = !kPrecond && g.eta;
  const bool project = kPrecond || g.project;
  Stager<T, kBulk> st{sm.bar};
  st.init(project + 1 + eta);
  const int width = (cols + st.width - 1) / st.width * st.width;
  const int64_t col0 = a * g.kpad + (int64_t)p0 * DH;
  const int64_t pose0 = a * g.n + p0;
  const T* X = in<T>(g.X) + col0;
  const T* V = in<T>(g.V) + col0;
  const T* E = in<T>(g.eta) + col0;
  if (kPrecond)
    stage_elems<T>(sm.C, in<T>(g.pinv) + pose0 * DH * DH, np * DH * DH);
  else if (eta)
    stage_elems<T>(sm.C, in<T>(g.ssym) + pose0 * DD, np * DD);

  // this thread's column: its pose and the column q inside the pose
  const int c = threadIdx.x, pose = c / DH, q = c % DH;
  const bool mine = c < cols;
  const bool stiefel = mine && q < D;
  T* out = g.out ? reinterpret_cast<T*>(g.out) + col0 + c : nullptr;
  // H of this column (flat_rhess: in place of V; flat_precond: z, in E's
  // room), row r of the staged chunk
  T* hs = (kPrecond ? sm.E : sm.V) + c;
  const T* xs = sm.X + pose * DH;  // the pose's Y row r at xs[r W]

  // stage rows [r0, r0 + rc) and make this column's H from them
  auto load = [&](int r0, int rc) {
    const int64_t off = r0 * ld;
    if (project) st.stage(sm.X, X + off, ld, rc, width);
    st.stage(sm.V, V + off, ld, rc, width);
    if (eta) st.stage(sm.E, E + off, ld, rc, width);
    st.wait();
    if (!mine) return;
    if (kPrecond) {
      // z[q] = sum_c v[c] pose_inv[c][q]
      T inv[DH];
#pragma unroll
      for (int k = 0; k <= D; ++k) inv[k] = sm.C[pose * DH * DH + k * DH + q];
      const T* v = sm.V + pose * DH;
      for (int r = 0; r < rc; ++r) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k <= D; ++k) acc += v[r * W + k] * inv[k];
        hs[r * W] = acc;
      }
    } else if (eta && q < D) {
      // h[q] = v[q] - sum_p eta[p] Ssym[q][p]
      T ss[D];
#pragma unroll
      for (int p = 0; p < D; ++p) ss[p] = sm.C[pose * DD + q * D + p];
      const T* e = sm.E + pose * DH;
      for (int r = 0; r < rc; ++r) {
        T w = T(0);
#pragma unroll
        for (int p = 0; p < D; ++p) w += e[r * W + p] * ss[p];
        T h = hs[r * W];
        h -= w;
        hs[r * W] = h;
      }
    }
  };

  const int chunks = (r_pad + RC - 1) / RC;
  T S[D];  // S[p][q] of this column, the rows in ascending order
#pragma unroll
  for (int p = 0; p < D; ++p) S[p] = T(0);
  for (int ch = 0; ch < chunks; ++ch) {
    const int r0 = ch * RC, rc = min(RC, r_pad - r0);
    if (ch) __syncthreads();  // the last chunk's reads are done
    load(r0, rc);
    if (!mine) continue;
    if (!project) {
      for (int r = 0; r < rc; ++r) out[(r0 + r) * ld] = hs[r * W];
      continue;
    }
    if (!stiefel) continue;
    for (int r = 0; r < rc; ++r) {
      const T h = hs[r * W];
#pragma unroll
      for (int p = 0; p < D; ++p) S[p] += xs[r * W + p] * h;
    }
  }
  if (!project) return;
  // sym(): S[q][p] from the thread of column p
  if (stiefel) {
#pragma unroll
    for (int p = 0; p < D; ++p) sm.S[pose * DD + p * D + q] = S[p];
  }
  __syncthreads();
  T Sy[D];
  if (stiefel) {
    T* gram = g.gram ? reinterpret_cast<T*>(g.gram) + (pose0 + pose) * DD
                     : nullptr;
#pragma unroll
    for (int p = 0; p < D; ++p) {
      Sy[p] = T(0.5) * (S[p] + sm.S[pose * DD + q * D + p]);
      if (gram) gram[p * D + q] = Sy[p];
    }
  }
  if (!out) return;
  for (int ch = 0; ch < chunks; ++ch) {
    const int r0 = ch * RC, rc = min(RC, r_pad - r0);
    if (chunks > 1) {
      __syncthreads();
      load(r0, rc);
    }
    if (!mine) continue;
    for (int r = 0; r < rc; ++r) {
      const T h = hs[r * W];
      T o = h;  // the translation
      if (q < D) {
        // (Y sym)[q] from zero, then one subtraction: the plain version's
        // order and grouping
        T tq = T(0);
#pragma unroll
        for (int p = 0; p < D; ++p) tq += xs[r * W + p] * Sy[p];
        o = h - tq;
      }
      out[(r0 + r) * ld] = o;
    }
  }
}

// One tail tile of agent a: columns c0 .. c0 + width - 1 of the agent from
// c0 = tail0 + t kCols; those before the spheres belong to pose tiles.
template <typename T, bool kBulk, bool kPrecond>
__device__ __forceinline__ void tail_tile(const Launch& L, int64_t a, int t,
                                          const Smem<T>& sm) {
  constexpr int W = kCols;
  const FlatArgs& g = L.g;
  const int r_pad = (int)g.r_pad, RC = L.rows;
  const int64_t ld = g.agents * g.kpad;
  const int64_t c0 = L.tail0 + (int64_t)t * W;
  const int width = (int)min((int64_t)W, g.kpad - c0);
  const int64_t pose_end = g.n * (g.d + 1), sph_end = pose_end + g.l;
  const int64_t colg = a * g.kpad + c0;
  const bool eta = !kPrecond && g.eta;
  const bool project = kPrecond || g.project;
  const T* X = in<T>(g.X) + colg;
  const T* V = in<T>(g.V) + colg;
  const T* E = in<T>(g.eta) + colg;
  T* out = reinterpret_cast<T*>(g.out);
  const bool spheres = c0 < sph_end && c0 + width > pose_end;
  Stager<T, kBulk> st{sm.bar};
  st.init((project && spheres) + 1 + (eta && spheres));
  // this thread's column: a landmark or pad, or a sphere
  const int c = threadIdx.x;
  const int64_t j = c0 + c - sph_end;  // landmark j < b, else a pad
  const bool tail = c < width && j >= 0;
  const T li = kPrecond && tail && j < g.b ? in<T>(g.linv)[a * g.b + j]
                                           : T(1);
  const int64_t q = c0 + c - pose_end;
  const bool sphere = c < width && q >= 0 && q < g.l;
  T si = T(0);
  if (sphere && (kPrecond || eta))
    si = in<T>(kPrecond ? g.sinv : g.sinner)[a * g.l + q];
  const RhessSphere<T> rh{sm.V + c, eta ? sm.E + c : nullptr, W, si};
  const JacobiSphere<T> jh{sm.V + c, W, si};
  T* o = out ? out + colg + c : nullptr;

  auto load = [&](int r0, int rc) {
    const int64_t off = r0 * ld;
    if (project && spheres) st.stage(sm.X, X + off, ld, rc, width);
    st.stage(sm.V, V + off, ld, rc, width);
    if (eta && spheres) st.stage(sm.E, E + off, ld, rc, width);
    st.wait();
  };

  const int chunks = (r_pad + RC - 1) / RC;
  T s = T(0);
  for (int ch = 0; ch < chunks; ++ch) {
    const int r0 = ch * RC, rc = min(RC, r_pad - r0);
    if (ch) __syncthreads();
    load(r0, rc);
    if (o && tail) {  // landmarks and pads
      for (int r = 0; r < rc; ++r) {
        const T v = sm.V[r * W + c];
        o[(r0 + r) * ld] = kPrecond && j < g.b ? v * li : v;
      }
    }
    if (!sphere) continue;
    if (!project) {
      for (int r = 0; r < rc; ++r) o[(r0 + r) * ld] = rh(r);
      continue;
    }
    // <x, h> over the rows in ascending order
    const T* x = sm.X + c;
    if (kPrecond)
      for (int r = 0; r < rc; ++r) s += x[r * W] * jh(r);
    else
      for (int r = 0; r < rc; ++r) s += x[r * W] * rh(r);
  }
  if (!project || !spheres) return;
  if (sphere && g.gsph) reinterpret_cast<T*>(g.gsph)[a * g.l + q] = s;
  if (!o) return;
  for (int ch = 0; ch < chunks; ++ch) {
    const int r0 = ch * RC, rc = min(RC, r_pad - r0);
    if (chunks > 1) {
      __syncthreads();
      load(r0, rc);
    }
    if (!sphere) continue;
    const T* x = sm.X + c;
    if (kPrecond)
      for (int r = 0; r < rc; ++r) o[(r0 + r) * ld] = jh(r) - x[r * W] * s;
    else
      for (int r = 0; r < rc; ++r) o[(r0 + r) * ld] = rh(r) - x[r * W] * s;
  }
}

template <typename T, int D, bool kBulk, bool kPrecond>
__device__ __forceinline__ void flat_tile(const Launch& L) {
  extern __shared__ __align__(16) unsigned char raw[];
  const Smem<T> sm(raw, L.rows);
  const int64_t a = blockIdx.x / (unsigned)L.tiles;
  const int t = (int)(blockIdx.x - a * L.tiles);
  if (t < L.pose_tiles)
    pose_tile<T, D, kBulk, kPrecond>(L, a, t, sm);
  else
    tail_tile<T, kBulk, kPrecond>(L, a, t - L.pose_tiles, sm);
}

template <typename T, int D, bool kBulk>
__global__ void __launch_bounds__(kThreads) flat_rhess(const Launch L) {
  flat_tile<T, D, kBulk, false>(L);
}

template <typename T, int D, bool kBulk>
__global__ void __launch_bounds__(kThreads) flat_precond(const Launch L) {
  flat_tile<T, D, kBulk, true>(L);
}

template <typename T, int D, bool kBulk>
int launch(const FlatArgs& g, cudaStream_t stream, bool precond) {
  constexpr int VW = kBulk ? 16 / (int)sizeof(T) : 1;
  Launch L{g, 0, 0, 0, 0};
  L.pose_tiles = (int)((g.n + kP - 1) / kP);
  L.tail0 = g.n * (D + 1) / VW * VW;
  int64_t tail = (g.kpad - L.tail0 + kCols - 1) / kCols;
  if (!g.out && !(g.gsph && g.l)) tail = 0;  // the Grams alone
  const int64_t tiles = L.pose_tiles + tail;
  const int64_t blocks = g.agents * tiles;
  if (blocks == 0) return 0;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  L.tiles = (int)tiles;
  L.rows = (int)(g.r_pad < kRows ? g.r_pad : kRows);
  void (*kernel)(const Launch) =
      precond ? flat_precond<T, D, kBulk> : flat_rhess<T, D, kBulk>;
  kernel<<<(unsigned)blocks, kThreads, Smem<T>::bytes(L.rows), stream>>>(L);
  return (int)cudaGetLastError();
}

template <typename T, bool kBulk>
int run_d(const FlatArgs& g, cudaStream_t stream, bool precond) {
  if (g.d == 1) return launch<T, 1, kBulk>(g, stream, precond);
  if (g.d == 2) return launch<T, 2, kBulk>(g, stream, precond);
  return launch<T, 3, kBulk>(g, stream, precond);
}

bool aligned16(int64_t p) { return p % 16 == 0; }

template <typename T>
int run(const void* desc, cudaStream_t stream, bool precond) {
  const FlatArgs g = *static_cast<const FlatArgs*>(desc);
  if (g.d < 1 || g.d > kMaxD || g.r_pad < 1 || g.n < 0 || g.agents < 1)
    return (int)cudaErrorInvalidValue;
  // bulk copies where every staged operand and the row stride allow
  const bool bulk = (g.kpad * (int64_t)sizeof(T)) % 16 == 0 &&
                    aligned16(g.X) && aligned16(g.V) && aligned16(g.eta);
  return bulk ? run_d<T, true>(g, stream, precond)
              : run_d<T, false>(g, stream, precond);
}

}  // namespace

extern "C" {

// desc: a host pointer to the FlatArgs above (read before this returns).
int dcora_flat_rhess_f32(const void* desc, void* stream) {
  return run<float>(desc, static_cast<cudaStream_t>(stream), false);
}

int dcora_flat_rhess_f64(const void* desc, void* stream) {
  return run<double>(desc, static_cast<cudaStream_t>(stream), false);
}

int dcora_flat_precond_f32(const void* desc, void* stream) {
  return run<float>(desc, static_cast<cudaStream_t>(stream), true);
}

int dcora_flat_precond_f64(const void* desc, void* stream) {
  return run<double>(desc, static_cast<cudaStream_t>(stream), true);
}

}  // extern "C"
