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
// What bounds them: bytes.  Each reads X and V (and eta) once and writes
// out once (grid10k, f64, r_pad 8: ~11.7 MB for flat_rhess, ~9.6 MB for
// flat_precond with pose_inv, ~3.5 / ~2.9 us at 3.35 TB/s); the arithmetic
// is ~30 multiply-adds per element.
//
// Design.  One thread per pose, sphere column or tail column of one agent,
// so a warp of pose threads reads 32 dh contiguous values of a row.  A pose
// thread walks the r_pad rows twice: first it sums the d x d Gram Y_i^T H_i
// in ascending row order (so two launches give the same bits), then it
// reads the rows again (from L1 / L2) and writes the projection; H is
// recomputed from V in the second pass rather than held in registers.
// Every per-pose sum is taken as the plain version's batched products take
// it on the card (each product's terms in index order, fused multiply-adds
// from zero, the result subtracted once), so on the pose blocks a launch
// gives the plain version's bits there, and a solve through the kernels
// lands where the einsum code landed.  (The sphere sums are left in row
// order with fused multiply-adds.)  No
// atomics and no sums across threads: the tCG's dot products stay where
// they are, so a CUDA graph of the iteration and the eager loop run the
// same kernels.  d is a run-time value up to 3, every per-pose loop is
// unrolled to 3 and guarded, and the rows of H come from inlined functors,
// so the small arrays stay in registers (no spills, -Xptxas -v).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxD = 3;

// Blocks per SM that __launch_bounds__ asks room for: a register budget of
// 64 (f32) or 128 (f64) a thread.  With no budget ptxas spilled a few bytes
// of the f32 flat_rhess at 40 registers; 64 holds it, and the f64 kernels
// take 70-80.
template <typename T>
struct MinBlocks {
  static constexpr int value = sizeof(T) == 4 ? 8 : 4;
};

// One launch: pointers as 64-bit integers (0 when absent), then sizes.
// core/tiled.py packs it as 19 int64 values.
struct FlatArgs {
  int64_t X, V, eta, ssym, sinner;  // inputs; eta, ssym, sinner: flat_rhess
  int64_t pinv, sinv, linv;         // flat_precond: the Jacobi inverses
  int64_t out, gram, gsph;          // outputs
  int64_t n, l, b, d, kpad, agents, r_pad, project;
};

template <typename T>
__device__ __forceinline__ const T* in(int64_t p) {
  return reinterpret_cast<const T*>(p);
}

// sym(Y^T H) of one pose over the rows (ascending), then, when `out` is
// set, H - Y sym(Y^T H) on the Stiefel columns and H's translation.  hrow(r,
// h) fills h[0..d] (the dh values of H's row r).
template <typename T, typename HRow>
__device__ __forceinline__ void pose_project(const T* __restrict__ X,
                                             int64_t col, int64_t ld,
                                             int r_pad, int d,
                                             const HRow hrow,
                                             T* __restrict__ out,
                                             T* __restrict__ gram) {
  T S[kMaxD][kMaxD];
#pragma unroll
  for (int p = 0; p < kMaxD; ++p)
#pragma unroll
    for (int q = 0; q < kMaxD; ++q) S[p][q] = T(0);
  for (int r = 0; r < r_pad; ++r) {
    const T* x = X + r * ld + col;
    T y[kMaxD], h[kMaxD + 1];
#pragma unroll
    for (int p = 0; p < kMaxD; ++p) y[p] = p < d ? x[p] : T(0);
    hrow(r, h);
#pragma unroll
    for (int p = 0; p < kMaxD; ++p)
#pragma unroll
      for (int q = 0; q < kMaxD; ++q)
        if (p < d && q < d) S[p][q] += y[p] * h[q];
  }
  T Sy[kMaxD][kMaxD];
#pragma unroll
  for (int p = 0; p < kMaxD; ++p)
#pragma unroll
    for (int q = 0; q < kMaxD; ++q)
      Sy[p][q] = T(0.5) * (S[p][q] + S[q][p]);
  if (gram) {
#pragma unroll
    for (int p = 0; p < kMaxD; ++p)
#pragma unroll
      for (int q = 0; q < kMaxD; ++q)
        if (p < d && q < d) gram[p * d + q] = Sy[p][q];
  }
  if (!out) return;
  for (int r = 0; r < r_pad; ++r) {
    const T* x = X + r * ld + col;
    T* o = out + r * ld + col;
    T y[kMaxD], h[kMaxD + 1];
#pragma unroll
    for (int p = 0; p < kMaxD; ++p) y[p] = p < d ? x[p] : T(0);
    hrow(r, h);
#pragma unroll
    for (int q = 0; q <= kMaxD; ++q) {
      if (q < d) {
        // (Y sym)[q] from zero, then one subtraction: the plain version's
        // order and grouping
        T t = T(0);
#pragma unroll
        for (int p = 0; p < kMaxD; ++p)
          if (p < d) t += y[p] * Sy[p][q];
        o[q] = h[q] - t;
      } else if (q == d) {
        o[q] = h[q];  // the translation
      }
    }
  }
}

// h - x <x, h> of one sphere column (when `out` is set); <x, h> summed over
// the rows in ascending order, written to `inner` when set.
template <typename T, typename HRow>
__device__ __forceinline__ void sphere_project(const T* __restrict__ X,
                                               int64_t col, int64_t ld,
                                               int r_pad, const HRow hrow,
                                               T* __restrict__ out,
                                               T* __restrict__ inner) {
  T s = T(0);
  for (int r = 0; r < r_pad; ++r) s += X[r * ld + col] * hrow(r);
  if (inner) *inner = s;
  if (!out) return;
  for (int r = 0; r < r_pad; ++r)
    out[r * ld + col] = hrow(r) - X[r * ld + col] * s;
}

// Which item thread e owns: agent a, and j < n a pose, j < n + l a sphere
// column, else a tail column (landmarks, then pads).
struct Item {
  int64_t a, j;
};

// 32-bit unsigned index arithmetic (run() caps the grid below 2^31
// threads): a 64-bit division is a called subroutine on the card.
__device__ __forceinline__ bool item_of(const FlatArgs& g, Item& it) {
  const uint32_t items = (uint32_t)(g.kpad - g.d * g.n);  // n + l + tail
  const uint32_t e = blockIdx.x * (uint32_t)kThreads + threadIdx.x;
  if (e >= (uint32_t)g.agents * items) return false;
  const uint32_t a = e / items;
  it.a = a;
  it.j = e - a * items;
  return true;
}

// The rows of H that the kernels project, one functor per kind of column
// (functors, not lambdas, so that every call is inlined and the small
// arrays stay in registers).

// A pose's H = V - eta Ssym (eta absent: V), all dh columns.
template <typename T>
struct RhessPose {
  const T* V;
  const T* eta;
  int64_t col, ld;
  int d;
  T Ss[kMaxD][kMaxD];
  __device__ __forceinline__ void operator()(int r, T* h) const {
    const T* v = V + r * ld + col;
#pragma unroll
    for (int q = 0; q <= kMaxD; ++q) h[q] = q <= d ? v[q] : T(0);
    if (!eta) return;
    const T* e = eta + r * ld + col;
    T ev[kMaxD];
#pragma unroll
    for (int p = 0; p < kMaxD; ++p) ev[p] = p < d ? e[p] : T(0);
#pragma unroll
    for (int q = 0; q < kMaxD; ++q) {
      if (q < d) {
        T w = T(0);
#pragma unroll
        for (int p = 0; p < kMaxD; ++p)
          if (p < d) w += ev[p] * Ss[q][p];
        h[q] -= w;
      }
    }
  }
};

// A sphere column's h = v - eta s_inner (eta absent: v).
template <typename T>
struct RhessSphere {
  const T* V;
  const T* eta;
  int64_t col, ld;
  T si;
  __device__ __forceinline__ T operator()(int r) const {
    return eta ? V[r * ld + col] - eta[r * ld + col] * si : V[r * ld + col];
  }
};

// A pose's z = V pose_inv (dh x dh).
template <typename T>
struct JacobiPose {
  const T* V;
  int64_t col, ld;
  int d;
  T inv[kMaxD + 1][kMaxD + 1];
  __device__ __forceinline__ void operator()(int r, T* h) const {
    const T* v = V + r * ld + col;
    T vv[kMaxD + 1];
#pragma unroll
    for (int c = 0; c <= kMaxD; ++c) vv[c] = c <= d ? v[c] : T(0);
#pragma unroll
    for (int e = 0; e <= kMaxD; ++e) {
      T acc = T(0);
#pragma unroll
      for (int c = 0; c <= kMaxD; ++c)
        if (c <= d) acc += vv[c] * inv[c][e];
      h[e] = acc;
    }
  }
};

// A sphere column's z = v sph_inv.
template <typename T>
struct JacobiSphere {
  const T* V;
  int64_t col, ld;
  T si;
  __device__ __forceinline__ T operator()(int r) const {
    return V[r * ld + col] * si;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, MinBlocks<T>::value)
    flat_rhess(const FlatArgs g) {
  Item it;
  if (!item_of(g, it)) return;
  const int d = (int)g.d, dh = d + 1, r_pad = (int)g.r_pad;
  const int64_t n = g.n, l = g.l, ld = g.agents * g.kpad;
  const int64_t base = it.a * g.kpad;
  const T* __restrict__ X = in<T>(g.X);
  const T* __restrict__ V = in<T>(g.V);
  const T* __restrict__ eta = in<T>(g.eta);
  T* __restrict__ out = reinterpret_cast<T*>(g.out);
  if (it.j < n) {
    const int64_t pose = it.a * n + it.j;
    const int64_t col = base + it.j * dh;
    RhessPose<T> hrow{V, eta, col, ld, d, {}};
    const T* ss = in<T>(g.ssym) + pose * d * d;
#pragma unroll
    for (int p = 0; p < kMaxD; ++p)
#pragma unroll
      for (int q = 0; q < kMaxD; ++q)
        hrow.Ss[p][q] = (eta && p < d && q < d) ? ss[p * d + q] : T(0);
    if (!g.project) {
      for (int r = 0; r < r_pad; ++r) {
        T h[kMaxD + 1];
        hrow(r, h);
        T* o = out + r * ld + col;
#pragma unroll
        for (int q = 0; q <= kMaxD; ++q)
          if (q <= d) o[q] = h[q];
      }
      return;
    }
    T* gram = g.gram ? reinterpret_cast<T*>(g.gram) + pose * d * d : nullptr;
    pose_project<T>(X, col, ld, r_pad, d, hrow, out, gram);
  } else if (it.j < n + l) {
    const int64_t q = it.j - n;
    const int64_t col = base + n * dh + q;
    const RhessSphere<T> hrow{
        V, eta, col, ld, eta ? in<T>(g.sinner)[it.a * l + q] : T(0)};
    if (!g.project) {
      for (int r = 0; r < r_pad; ++r) out[r * ld + col] = hrow(r);
      return;
    }
    T* inner = g.gsph ? reinterpret_cast<T*>(g.gsph) + it.a * l + q : nullptr;
    sphere_project<T>(X, col, ld, r_pad, hrow, out, inner);
  } else if (out) {
    const int64_t col = base + n * dh + l + (it.j - n - l);
    for (int r = 0; r < r_pad; ++r) out[r * ld + col] = V[r * ld + col];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, MinBlocks<T>::value)
    flat_precond(const FlatArgs g) {
  Item it;
  if (!item_of(g, it)) return;
  const int d = (int)g.d, dh = d + 1, r_pad = (int)g.r_pad;
  const int64_t n = g.n, l = g.l, ld = g.agents * g.kpad;
  const int64_t base = it.a * g.kpad;
  const T* __restrict__ X = in<T>(g.X);
  const T* __restrict__ V = in<T>(g.V);
  T* __restrict__ out = reinterpret_cast<T*>(g.out);
  if (it.j < n) {
    const int64_t pose = it.a * n + it.j;
    const int64_t col = base + it.j * dh;
    const T* pi = in<T>(g.pinv) + pose * dh * dh;
    JacobiPose<T> hrow{V, col, ld, d, {}};
#pragma unroll
    for (int c = 0; c <= kMaxD; ++c)
#pragma unroll
      for (int e = 0; e <= kMaxD; ++e)
        hrow.inv[c][e] = (c <= d && e <= d) ? pi[c * dh + e] : T(0);
    pose_project<T>(X, col, ld, r_pad, d, hrow, out, nullptr);
  } else if (it.j < n + l) {
    const int64_t q = it.j - n;
    const int64_t col = base + n * dh + q;
    const JacobiSphere<T> hrow{V, col, ld, in<T>(g.sinv)[it.a * l + q]};
    sphere_project<T>(X, col, ld, r_pad, hrow, out, nullptr);
  } else {
    const int64_t t = it.j - n - l;
    const int64_t col = base + n * dh + l + t;
    const T li = t < g.b ? in<T>(g.linv)[it.a * g.b + t] : T(1);
    for (int r = 0; r < r_pad; ++r)
      out[r * ld + col] = t < g.b ? V[r * ld + col] * li : V[r * ld + col];
  }
}

template <typename T>
int run(const void* desc, cudaStream_t stream, bool precond) {
  const FlatArgs g = *static_cast<const FlatArgs*>(desc);
  if (g.d < 1 || g.d > kMaxD) return (int)cudaErrorInvalidValue;
  const int64_t total = g.agents * (g.kpad - g.d * g.n);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  if (total + kThreads > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  if (precond)
    flat_precond<T><<<(unsigned)blocks, kThreads, 0, stream>>>(g);
  else
    flat_rhess<T><<<(unsigned)blocks, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
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
