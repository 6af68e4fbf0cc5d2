// The ball-constrained least-squares (trust-region) action shared by the
// quadratic game (K8, quad_game_kernel.cu) and the batched solver (K9,
// trs_kernel.cu):
//
//     x = argmin_{||x|| <= 1}  0.5 x^T A x - b^T x,   A PSD.
//
// Counterpart of online_convex_optimization_tpu/ops/pallas_trs.py
// _trs_action with _chol_factor_tiles / _fwd_solve / _bwd_solve.  Plain
// PyTorch version: online_convex_optimization_tpu_torch/ops/trs.py
// (trs_solve_reference), in the same order of operations, so K8's final
// x_c equals K9 on the same statistics bit for bit.
//
// The JAX package has two algorithms: the TPU kernels run a safeguarded
// More-Sorensen Newton on the multiplier (12 iterations, floor
// (1e-6/d)*tr + 1e-6, a final rsqrt scaling), its XLA path a 60-step
// bisection (floor eps_rel*(1 + tr/d), a final x / max(||x||, 1)).  The port
// runs one: the Newton with its bracket safeguard, the XLA floor for the
// working type (eps_rel 1e-6 in f32, 1e-12 in f64), and the correctly
// rounded x / max(sqrt(||x||^2), 1) at the end.  The Newton loop stops
// where the fixed count would add nothing, with the same bits (trs_pass;
// its plain mirror is ops/trs.py trs_action_settled), and K8 and K9 run it
// one pass at a time, so that each of their lanes starts its next round or
// problem as soon as its own solve is done.
//
// Numerical traps, kept as the JAX kernels keep them:
//   - the first rounds of a game have a singular A (t < d), and at t = 0
//     both A and b are 0: the floor keeps every Cholesky SPD, and
//     max(||q||^2, 1e-30) guards the Newton step's divide;
//   - a null-space component of b makes ||x(0+)|| huge: the Newton step
//     from lam = 0 is then nearly exact, and the bracket catches the rest;
//   - the library is built with --fmad=false and no fast math: every sqrt
//     and divide is correctly rounded, no product is fused into an add.
#pragma once

#include "oco_common.cuh"

// Largest d of the generic quadratic instance (A and its factor are
// d(d+1)/2 values each, in local memory); d = 5 has an unrolled instance.
// Above it K8 and K9 run their wide instances (oco::wide below; ops/trs.py
// MAX_D is the same boundary).
#define OCO_QUAD_MAX_D 32

namespace oco {

template <int D>
struct QCap {
  static constexpr int value = D > 0 ? D : OCO_QUAD_MAX_D;
  static constexpr int tri = value * (value + 1) / 2;
};

// Position of (i, j), j <= i, in a packed lower triangle.
__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Ridge floor and Newton iterations by working type: the cap of
// trs_pass's exit.  12 in f32 is the TPU kernels' count; in f64 the answer
// stops moving after 18 iterations on the tests' and a regression stream's
// prefixes (tests/test_torch_quadratic.py, through trs_solve_reference),
// and 20 leaves a margin.
template <typename S>
struct TrsParams;
template <>
struct TrsParams<float> {
  static constexpr float eps_rel = 1e-6f;
  static constexpr int iters = 12;
};
template <>
struct TrsParams<double> {
  static constexpr double eps_rel = 1e-12;
  static constexpr int iters = 20;
};

// L = chol(A + lam I), both packed lower triangles.
template <typename S, int D>
__device__ __forceinline__ void chol_factor(const S* A, S lam, S* L, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      S s = i == j ? A[tri(i, j)] + lam : A[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = i == j ? osqrt(s) : s / L[tri(j, j)];
    }
  }
}

// v = L^{-1} b.
template <typename S, int D>
__device__ __forceinline__ void fwd_solve(const S* L, const S* b, S* v,
                                          int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    S s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * v[k];
    v[i] = s / L[tri(i, i)];
  }
}

// x = L^{-T} v.
template <typename S, int D>
__device__ __forceinline__ void bwd_solve(const S* L, const S* v, S* x,
                                          int n) {
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {
    S s = v[i];
#pragma unroll
    for (int k = i + 1; k < n; ++k) s = s - L[tri(k, i)] * x[k];
    x[i] = s / L[tri(i, i)];
  }
}

// x = (A + lam I)^{-1} b through the factor L (written), v as scratch.
template <typename S, int D>
__device__ __forceinline__ void ridge_solve(const S* A, const S* b, S lam,
                                            S* L, S* v, S* x, int n) {
  chol_factor<S, D>(A, lam, L, n);
  fwd_solve<S, D>(L, b, v, n);
  bwd_solve<S, D>(L, v, x, n);
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}
__device__ __forceinline__ bool same_bits(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}

// One trust-region solve in flight: the floor, the Newton carry (lam, lo,
// hi), the carry one pass back with that pass's x, and the pass count k.
template <typename S, int D>
struct TrsSolve {
  S eps, lam, lo, hi, lam1, lo1, hi1;
  S x1[QCap<D>::value];
  int k;
};

// The floor and the starting carry of the solve of (A, b).
template <typename S, int D>
__device__ __forceinline__ void trs_begin(TrsSolve<S, D>& s, const S* A,
                                          const S* b, int n) {
  S tr = A[0];
#pragma unroll
  for (int i = 1; i < n; ++i) tr = tr + A[tri(i, i)];
  s.eps = TrsParams<S>::eps_rel * (S(1) + tr / S(n));
  s.lam = s.lo = S(0);
  s.hi = osqrt(dot<S, D>(b, b, n));
  s.k = 0;
}

// One Newton pass: x = (A + (lam + eps) I)^{-1} b, then the safeguarded
// step of the carry.  Returns true once x is the fixed count's final ridge
// solution (the action before its scaling into the ball), with the same
// bits as running all TrsParams<S>::iters iterations:
//   - at pass iters, the solve at the last multiplier;
//   - when the step leaves the carry unchanged in every bit: a pass reads
//     only A, b, eps and the carry, so every later pass repeats it, and
//     this pass's x is the final solve;
//   - when the step returns the carry of two passes back: the carries
//     then alternate, and the parity of the passes left picks this
//     pass's x or the one before.
// A comparison that never holds (a NaN carry, say) runs the full count.
template <typename S, int D>
__device__ __forceinline__ bool trs_pass(TrsSolve<S, D>& s, const S* A,
                                         const S* b, S* x, int n) {
  constexpr int iters = TrsParams<S>::iters;
  S L[QCap<D>::tri], v[QCap<D>::value];
  ridge_solve<S, D>(A, b, s.lam + s.eps, L, v, x, n);
  if (s.k == iters) return true;
  const S n2 = dot<S, D>(x, x, n);
  fwd_solve<S, D>(L, x, v, n);               // q = L^{-1} x
  const S nq2 = dot<S, D>(v, v, n);
  const bool outside = n2 > S(1);
  const S lo = outside ? s.lam : s.lo;
  const S hi = outside ? s.hi : s.lam;
  const S step = (n2 / omax(nq2, S(1e-30))) * (osqrt(n2) - S(1));
  const S lam_n = s.lam + step;
  // Newton from below converges monotonically; a step that leaves the
  // bracket strictly (also the interior case, lam -> lo = 0) takes the
  // midpoint instead.
  const S lam = (lam_n < lo || lam_n > hi) ? S(0.5) * (lo + hi) : lam_n;
  if (same_bits(lam, s.lam) && same_bits(lo, s.lo) && same_bits(hi, s.hi))
    return true;
  if (s.k > 0 && same_bits(lam, s.lam1) && same_bits(lo, s.lo1) &&
      same_bits(hi, s.hi1)) {
    if (((iters - s.k + 1) & 1) == 0) {
#pragma unroll
      for (int i = 0; i < n; ++i) x[i] = s.x1[i];
    }
    return true;
  }
#pragma unroll
  for (int i = 0; i < n; ++i) s.x1[i] = x[i];
  s.lam1 = s.lam;
  s.lo1 = s.lo;
  s.hi1 = s.hi;
  s.lam = lam;
  s.lo = lo;
  s.hi = hi;
  ++s.k;
  return false;
}

// x / max(sqrt(||x||^2), 1), correctly rounded.
template <typename S, int D>
__device__ __forceinline__ void to_ball(S* x, int n) {
  const S den = omax(osqrt(dot<S, D>(x, x, n)), S(1));
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = x[i] / den;
}

// The trust-region action of (A packed lower triangle, b) into x.
template <typename S, int D>
__device__ __forceinline__ void trs_action(const S* A, const S* b, S* x,
                                           int n) {
  TrsSolve<S, D> s;
  trs_begin<S, D>(s, A, b, n);
  while (!trs_pass<S, D>(s, A, b, x, n)) {
  }
  to_ball<S, D>(x, n);
}

// ------------------------------------------------------------ wide solve
// The trust-region action for d > OCO_QUAD_MAX_D, one warp a problem (the
// wide instances of K9 and K8).  The same function as trs_action above,
// operation for operation: every value the lanes compute is rounded as the
// plain version's (ops/trs.py _chol_factor, _fwd_solve, _bwd_solve) rounds
// it, so K8's x_c equals K9 and both equal the plain version bit for bit.
// Which lane computes a value, and where it is kept, changes no bit; only
// each value's own order of operations does, and that is the plain one.
//
// What bounds a Newton pass on an H100 is a warp's serial chain, most of
// it correctly rounded divides and sqrts (each in its own basic block, so a
// warp overlaps none of them with other work) and the loads and shuffles
// between them (scripts/wide_probe.py --split times the phases); the SM
// hides one warp's chain behind the others', as many as its shared memory
// holds.  The design:
//   - Only the factor lives in the warp's workspace: A stays in device
//     memory (K9w: the caller's (N, d, d); K8w: the statistics, a slice a
//     warp in a buffer the wrapper allocates) and is copied into the
//     factor's triangle at the start of each pass, asynchronously
//     (cp.async), issued as soon as the last pass no longer reads L, so the
//     copy overlaps that pass's Newton step.  The lanes add lam on the
//     diagonal: A_ii + lam, as the plain version does.  A workspace is one
//     triangle and five vectors, so about twice the warps fit an SM as
//     would with A's triangle beside the factor's.
//   - The triangle is augmented by b as its row n, and the Cholesky takes
//     that row as a row of A: its divides and updates are the forward
//     substitution's own order (v_m = (b_m - v_0 L_m0 - ...) / L_mm), so
//     row n ends as v = L^{-1} b with no substitution of its own.
//   - Offsets are 32-bit, from row starts r_i = i (i + 1) / 2 that are
//     walked (r_{i+1} = r_i + i + 1) or computed with one multiply.
//   - Cholesky, right-looking by panels of kPanel columns.  A panel's
//     columns are factored one after the other: the pivot's sqrt on every
//     lane, the rows below divided by the lanes (ceil((n - j) / 32)
//     divides a lane), then their entries of the panel's later columns
//     updated.  Then the trailing triangle takes the panel's kPanel
//     columns at once, the lanes over its columns, kRows rows loaded
//     before they are stored: entry (i, m) loads once and subtracts L_ij
//     L_mj for the panel's j in increasing order, after the earlier
//     panels' j.  Every entry so subtracts in
//     increasing j, the plain version's order, with a quarter of the loads
//     and stores and of the loop's integer work.
//   - Forward substitution of x (q = L^{-1} x), column by column: lane
//     i mod 32 owns v_i's running value (no other lane touches it, so no
//     barrier); at step k the owner's quotient by L_kk is shuffled to the
//     warp, then each lane subtracts L_ik v_k from its rows, the next pivot
//     row's first, kept in a register: a divide, a shuffle, a multiply and
//     a subtract a step.
//   - Backward substitution: x_i = (v_i - L_{i+1,i} x_{i+1} - ...) / L_ii
//     subtracts in increasing k, so x_i waits on x_{i+1} and its chain of
//     subtractions cannot be split without changing its rounding.  The
//     lanes form the products L_ki x_k off the chain (lane t takes k = i +
//     1 + t, 32 at a time, x_{i+1} from the register that holds it; each
//     product rounded on its own), and every lane runs the chain, reading
//     them by shuffles in increasing k, 16 shuffled before they are
//     subtracted (a product past d is +0, and s - 0 is s in every bit).
//     Every lane stores x_i, so x needs no barrier.
//   - The loops have no divergent branch: every lane loads (a lane with no
//     entry reads a slot of its workspace it does not use), computes, and
//     stores under a predicate; a divide whose quotient one lane needs
//     runs on every lane, and a shuffle takes that lane's.
//   - Sums over the index (traces, squared norms, dots) run on every lane
//     in index order, so every lane holds the Newton carry and the exit is
//     the warp's.
// The factor and vectors live in shared memory where they fit (d <= 334 in
// float32, 234 in float64 on an H100), in a slice of a device scratch
// buffer read through L2 above that (plan below chooses); d <= kMaxD, so
// that every offset fits 32 bits.
namespace wide {

constexpr unsigned kWarp = 0xffffffffu;

// A probe build (scripts/wide_probe.py --split, -DOCO_WIDE_SPLIT) splits
// each warp's clocks by phase: OCO_SPLIT(phase) adds the clock64 span since
// the warp's last mark to that phase's total (lane 0, one-warp blocks).
// The library's build compiles the marks to nothing.
enum SplitPhase {
  kSplitSeed,      // L from A (+ lam on the diagonal)
  kSplitPivot,     // the Cholesky's pivots, column divides, panel updates
  kSplitTrailing,  // the Cholesky's trailing updates
  kSplitFwd,       // the forward substitution of x (b's is the Cholesky's)
  kSplitBwd,       // the backward substitution
  kSplitStep,      // the norms, the Newton step and the exit
  kSplitProblem,   // claim, load, trs_begin, to_ball, store
  kSplitPhases
};
#ifdef OCO_WIDE_SPLIT
constexpr int kSplitWarps = 8192;
__device__ unsigned long long split_clocks[kSplitPhases];
__device__ long long split_last[kSplitWarps];
__device__ __forceinline__ void split(int phase) {
  if (threadIdx.x == 0 && blockIdx.x < kSplitWarps) {
    const long long now = clock64();
    if (phase >= 0)
      atomicAdd(&split_clocks[phase],
                static_cast<unsigned long long>(now - split_last[blockIdx.x]));
    split_last[blockIdx.x] = now;
  }
}
#define OCO_SPLIT(phase) ::oco::wide::split(phase)
#else
#define OCO_SPLIT(phase) ((void)0)
#endif

// Largest d: a workspace's offsets are unsigned 32-bit (ops/trs.py
// WIDE_MAX_D).
constexpr int kMaxD = 65535;

// Elements of n values of type S rounded up to 16 bytes, so that every
// part of a workspace and every statistics slice starts 16-byte aligned.
template <typename S>
__host__ __device__ constexpr unsigned long long pad16(unsigned long long n) {
  return (n + 16 / sizeof(S) - 1) / (16 / sizeof(S)) * (16 / sizeof(S));
}

// Elements of the packed lower triangle of order d + 1 (padded) that
// holds A's rows and b as row d (its diagonal slot unused): the factor's
// part of a workspace.  The Cholesky of that augmented triangle leaves
// v = L^{-1} b in row d, by the forward substitution's own order.
template <typename S>
__host__ __device__ constexpr unsigned long long tri_elems(int d) {
  return pad16<S>((static_cast<unsigned long long>(d) + 1) * (d + 2) / 2);
}

// Elements of K8w's statistics slice: A's packed rows, then b (padded).
template <typename S>
__host__ __device__ constexpr unsigned long long stats_elems(int d) {
  return pad16<S>(static_cast<unsigned long long>(d) * (d + 3) / 2);
}

// Elements of a warp's workspace: the augmented triangle and five vectors
// (x, v, x1; K8w's theta and z row).
template <typename S>
__host__ __device__ constexpr unsigned long long work_elems(int d) {
  return tri_elems<S>(d) + pad16<S>(5ull * d);
}

// Start of row i of a packed lower triangle: entry (i, j) is r_i + j.
__device__ __forceinline__ unsigned rs(unsigned i) { return i * (i + 1) / 2; }

// The dynamic shared memory of a wide kernel's block: its warp's workspace.
extern __shared__ __align__(16) unsigned char wide_smem[];

// A warp's workspace: the augmented triangle at offset 0 (b, then v, in
// its row n at offset rb), then the vectors at the offsets below; in
// shared memory (kShared) or at `base` in device memory.
template <typename S, bool kShared>
struct Ws {
  S* base;
  int n;
  unsigned rb, x, v, x1, th, zr;
  __device__ __forceinline__ S* p() const {
    return kShared ? reinterpret_cast<S*>(wide_smem) : base;
  }
};

template <typename S, bool kShared>
__device__ __forceinline__ Ws<S, kShared> workspace(S* base, int d) {
  Ws<S, kShared> w;
  w.base = base;
  w.n = d;
  const unsigned t = static_cast<unsigned>(tri_elems<S>(d));
  const unsigned ud = static_cast<unsigned>(d);
  w.rb = rs(ud);
  w.x = t;
  w.v = t + ud;
  w.x1 = t + 2 * ud;
  w.th = t + 3 * ud;
  w.zr = t + 4 * ud;
  return w;
}

// cp.async of one element, and of 16 bytes past L1.
template <typename S>
__device__ __forceinline__ void cp_async(S* dst, const S* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(a),
               "l"(src), "n"(static_cast<int>(sizeof(S)))
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src)
               : "memory");
}

// The source of (A, b), copied into the augmented triangle (seed_issue):
// the lower triangle of a (d, d) row-major matrix and a vector (K9w), or a
// statistics slice of stats_elems(d) elements, 16-byte aligned, that holds
// the rows in the triangle's order (K8w).
template <typename S>
struct RowSeed {
  const S* A;
  const S* b;
};
template <typename S>
struct PackedSeed {
  const S* A;
};

// Lane k copies elements k, k + 32, ... of the packed rows, walking its
// (row, column) from one to the next, then its entries of b.
template <typename S, bool kShared>
__device__ __forceinline__ void seed_issue(const Ws<S, kShared>& w,
                                           const RowSeed<S>& sd, int lane) {
  S* const L = w.p();
  const unsigned n = static_cast<unsigned>(w.n);
  unsigned i = 0, j = lane;
  while (j > i) j -= ++i;
  for (unsigned e = lane; e < w.rb; e += 32) {
    const S* src = sd.A + static_cast<unsigned long long>(i) * n + j;
    if (kShared)
      cp_async(L + e, src);
    else
      L[e] = *src;
    j += 32;
    while (j > i) j -= ++i;
  }
  for (unsigned k = lane; k < n; k += 32) {
    if (kShared)
      cp_async(L + w.rb + k, sd.b + k);
    else
      L[w.rb + k] = sd.b[k];
  }
}

template <typename S, bool kShared>
__device__ __forceinline__ void seed_issue(const Ws<S, kShared>& w,
                                           const PackedSeed<S>& sd, int lane) {
  using V = typename std::conditional<sizeof(S) == 4, float4, double2>::type;
  constexpr unsigned kV = 16 / sizeof(S);
  S* const L = w.p();
  const unsigned t = static_cast<unsigned>(stats_elems<S>(w.n));
  for (unsigned e = lane * kV; e < t; e += 32 * kV) {
    if (kShared)
      cp_async16(L + e, sd.A + e);
    else
      *reinterpret_cast<V*>(L + e) = *reinterpret_cast<const V*>(sd.A + e);
  }
}

// Waits for this warp's copies; the warp then reads the triangle.
template <bool kShared>
__device__ __forceinline__ void seed_wait() {
  if (kShared) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// <a, b> in index order, on every lane.
template <typename S>
__device__ __forceinline__ S wdot(const S* a, const S* b, int n) {
  S acc = a[0] * b[0];
  for (int i = 1; i < n; ++i) acc = acc + a[i] * b[i];
  return acc;
}

// dst = src, lanes over the index.
template <typename S>
__device__ __forceinline__ void wcopy(S* dst, const S* src, int n,
                                      int lane) {
  for (int i = lane; i < n; i += 32) dst[i] = src[i];
  __syncwarp();
}

// Columns of a Cholesky panel, rows of the trailing update a lane loads
// before it stores, and products the backward chain shuffles in before it
// subtracts them.
constexpr int kPanel = 4;
constexpr int kRows = 4;
constexpr int kGather = 16;

// Trailing update of the columns m >= j0 + kPanel (m < n) by the panel's
// columns j0 .. j0 + kPanel - 1: lane k takes column m = c0 + k of each row
// i >= m, the augmented row n included, kRows rows loaded before they are
// stored.  Every lane loads (a lane right of its row's diagonal, or past
// the last column, reads a later entry of the workspace, unused) and only
// the entries m <= i are stored, so the loop has no divergent branch.
template <typename S>
__device__ __forceinline__ void trailing(S* L, int n, int j0, int lane) {
  for (int c0 = j0 + kPanel; c0 < n; c0 += 32) {
    const int m = c0 + lane;
    const unsigned rm = rs(m < n ? m : n - 1) + j0;
    S lm[kPanel];
#pragma unroll
    for (int t = 0; t < kPanel; ++t) lm[t] = L[rm + t];
    unsigned ri = rs(c0);
    int i = c0;
    for (; i + kRows <= n + 1; i += kRows) {
      unsigned r[kRows];
      S cur[kRows], li[kRows][kPanel];
      r[0] = ri;
#pragma unroll
      for (int q = 1; q < kRows; ++q) r[q] = r[q - 1] + (i + q);
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        cur[q] = L[r[q] + m];
#pragma unroll
        for (int t = 0; t < kPanel; ++t) li[q][t] = L[r[q] + j0 + t];
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
#pragma unroll
        for (int t = 0; t < kPanel; ++t) cur[q] = cur[q] - li[q][t] * lm[t];
        if (m <= i + q) L[r[q] + m] = cur[q];
      }
      ri = r[kRows - 1] + (i + kRows);
    }
    for (; i <= n; ++i) {
      S c = L[ri + m];
#pragma unroll
      for (int t = 0; t < kPanel; ++t) c = c - L[ri + j0 + t] * lm[t];
      if (m <= i) L[ri + m] = c;
      ri += i + 1;
    }
  }
}

// L = chol(A + mu I) in place, and v = L^{-1} b in row n: the augmented
// triangle holds A and b (their copy landed).  Row n takes each column's
// divide and updates as a row of A does, which is the forward
// substitution's order (v_m = (b_m - v_0 L_m0 - ...) / L_mm).  At column j
// every lane takes the pivot's sqrt, lane k divides the rows j + 1 + k,
// j + 33 + k, ... and then updates their entries of the panel's later
// columns (each lane reading the quotients it wrote), a barrier after
// each, so a lane divides at most ceil((n - j) / 32) entries a column.
template <typename S, bool kShared>
__device__ __forceinline__ void chol(const Ws<S, kShared>& w, S mu,
                                     int lane) {
  S* const L = w.p();
  const int n = w.n;
  for (int i = lane; i < n; i += 32) {
    const unsigned a = rs(i) + i;
    L[a] = L[a] + mu;
  }
  __syncwarp();
  OCO_SPLIT(kSplitSeed);
  for (int j0 = 0; j0 < n; j0 += kPanel) {
    const int jn = j0 + kPanel < n ? j0 + kPanel : n;
    for (int j = j0; j < jn; ++j) {
      const unsigned rj = rs(j);
      const S piv = osqrt(L[rj + j]);
      // Rows j + 1 .. n, lane k the rows j + 1 + k + 32 c.
      for (int i0 = j + 1; i0 <= n; i0 += 32) {
        const int i = i0 + lane;
        const bool live = i <= n;
        const unsigned a = rs(live ? i : n) + j;
        const S v = L[a] / piv;
        if (live) L[a] = v;
      }
      __syncwarp();
      if (lane == 0) L[rj + j] = piv;
      if (j + 1 == jn) continue;
      S lmj[kPanel - 1];
#pragma unroll
      for (int u = 0; u < kPanel - 1; ++u)
        lmj[u] = L[rs(j + 1 + u < jn ? j + 1 + u : j + 1) + j];
      for (int i0 = j + 1; i0 <= n; i0 += 32) {
        const int i = i0 + lane;
        const bool live = i <= n;
        const unsigned ri = rs(live ? i : n);
        const S lij = L[ri + j];
#pragma unroll
        for (int u = 0; u < kPanel - 1; ++u) {
          const int m = j + 1 + u;
          if (m < jn) {
            const S v = L[ri + m] - lij * lmj[u];
            if (live && m <= i) L[ri + m] = v;
          }
        }
      }
      __syncwarp();
    }
    OCO_SPLIT(kSplitPivot);
    if (jn < n) {
      trailing(L, n, j0, lane);
      __syncwarp();
    }
    OCO_SPLIT(kSplitTrailing);
  }
}

// v = L^{-1} b for the vectors at offsets ob and ov (distinct).  Lane
// i mod 32 owns v_i's running value: no other lane touches it, so no
// barrier.  At step k every lane divides its copy of the pivot row's value
// by L_kk and the owner's quotient is shuffled to the warp; then each lane
// subtracts L_ik v_k from its rows below k, the next pivot row's first.
template <typename S, bool kShared>
__device__ __forceinline__ void fwd(const Ws<S, kShared>& w, unsigned ob,
                                    unsigned ov, int lane) {
  S* const ws = w.p();
  const S* const L = ws;
  const int n = w.n;
  const int chunks = (n + 31) >> 5;
  for (int i = lane; i < n; i += 32) ws[ov + i] = ws[ob + i];
  S nxt = ws[ob + (lane < n ? lane : 0)];   // this lane's first row, row 0
  for (int k = 0; k < n; ++k) {
    // The chunk that holds row k + 1: its loads come before v_k.
    const int c1 = (k + 1) >> 5;
    const int i1 = lane + 32 * c1;
    const bool live1 = i1 > k && i1 < n;
    const int ii1 = live1 ? i1 : n - 1;
    const S lik1 = L[rs(ii1) + k];
    const S acc1 = ws[ov + ii1];
    const S vk = __shfl_sync(kWarp, nxt / L[rs(k) + k], k & 31);
    if (lane == (k & 31)) ws[ov + k] = vk;
    const S a1 = acc1 - lik1 * vk;
    if (live1) ws[ov + i1] = a1;
    nxt = a1;              // the owner of row k + 1 divides it next
    for (int c = c1 + 1; c < chunks; ++c) {
      const int i = lane + 32 * c;
      const bool live = i < n;
      const int ii = live ? i : n - 1;
      const S a = ws[ov + ii] - L[rs(ii) + k] * vk;
      if (live) ws[ov + i] = a;
    }
  }
  __syncwarp();
}

// x = L^{-T} v for the vectors at offsets ov and ox.
template <typename S, bool kShared>
__device__ __forceinline__ void bwd(const Ws<S, kShared>& w, unsigned ov,
                                    unsigned ox, int lane) {
  S* const ws = w.p();
  const S* const L = ws;
  const int n = w.n;
  S xprev = S(0);        // x_{i+1}, on every lane
  for (int i = n - 1; i >= 0; --i) {
    const S lii = L[rs(i) + i];
    S s = ws[ov + i];
    for (int k0 = i + 1; k0 < n; k0 += 32) {
      const int k = k0 + lane;
      const int kk = k < n ? k : n - 1;
      const S xk = k == i + 1 ? xprev : ws[ox + kk];
      const S prod = L[rs(kk) + i] * xk;
      const S p = k < n ? prod : S(0);
      const int cnt = n - k0 < 32 ? n - k0 : 32;
      for (int t0 = 0; t0 < cnt; t0 += kGather) {
        S q[kGather];
#pragma unroll
        for (int u = 0; u < kGather; ++u)
          q[u] = __shfl_sync(kWarp, p, t0 + u);
#pragma unroll
        for (int u = 0; u < kGather; ++u) s = s - q[u];
      }
    }
    xprev = s / lii;
    ws[ox + i] = xprev;
  }
  __syncwarp();
}

// The solve in flight: the floor and the Newton carry, as TrsSolve (the
// x of one pass back is the workspace's x1).
template <typename S>
struct Solve {
  S eps, lam, lo, hi, lam1, lo1, hi1;
  int k;
};

// The floor and the starting carry, from the triangle (holding A and b).
template <typename S, bool kShared>
__device__ __forceinline__ void trs_begin(Solve<S>& s,
                                          const Ws<S, kShared>& w) {
  const S* const ws = w.p();
  const int n = w.n;
  S tr = ws[0];
  for (int i = 1; i < n; ++i) tr = tr + ws[rs(i) + i];
  s.eps = TrsParams<S>::eps_rel * (S(1) + tr / S(n));
  s.lam = s.lo = S(0);
  s.hi = osqrt(wdot(ws + w.rb, ws + w.rb, n));
  s.k = 0;
}

// One Newton pass into x, as oco::trs_pass (same exits, same bits).  On
// entry the triangle holds A or its copy is in flight; a pass that goes on
// (and the exits after the step) leaves the next copy in flight.
template <typename S, bool kShared, class Seed>
__device__ __forceinline__ bool trs_pass(Solve<S>& s,
                                         const Ws<S, kShared>& w,
                                         const Seed& sd, int lane) {
  constexpr int iters = TrsParams<S>::iters;
  S* const ws = w.p();
  const int n = w.n;
  seed_wait<kShared>();
  OCO_SPLIT(kSplitSeed);
  chol(w, s.lam + s.eps, lane);                // and v = L^{-1} b in row n
  bwd(w, w.rb, w.x, lane);
  OCO_SPLIT(kSplitBwd);
  if (s.k == iters) return true;
  const S n2 = wdot(ws + w.x, ws + w.x, n);
  OCO_SPLIT(kSplitStep);
  fwd(w, w.x, w.v, lane);                     // q = L^{-1} x
  OCO_SPLIT(kSplitFwd);
  seed_issue(w, sd, lane);                    // the next pass's A
  OCO_SPLIT(kSplitSeed);
  const S nq2 = wdot(ws + w.v, ws + w.v, n);
  const bool outside = n2 > S(1);
  const S lo = outside ? s.lam : s.lo;
  const S hi = outside ? s.hi : s.lam;
  const S step = (n2 / omax(nq2, S(1e-30))) * (osqrt(n2) - S(1));
  const S lam_n = s.lam + step;
  const S lam = (lam_n < lo || lam_n > hi) ? S(0.5) * (lo + hi) : lam_n;
  if (same_bits(lam, s.lam) && same_bits(lo, s.lo) && same_bits(hi, s.hi))
    return true;
  if (s.k > 0 && same_bits(lam, s.lam1) && same_bits(lo, s.lo1) &&
      same_bits(hi, s.hi1)) {
    if (((iters - s.k + 1) & 1) == 0) wcopy(ws + w.x, ws + w.x1, n, lane);
    return true;
  }
  wcopy(ws + w.x1, ws + w.x, n, lane);
  s.lam1 = s.lam;
  s.lo1 = s.lo;
  s.hi1 = s.hi;
  s.lam = lam;
  s.lo = lo;
  s.hi = hi;
  ++s.k;
  return false;
}

// x / max(sqrt(||x||^2), 1).
template <typename S>
__device__ __forceinline__ void to_ball(S* x, int n, int lane) {
  const S den = omax(osqrt(wdot(x, x, n)), S(1));
  __syncwarp();
  for (int i = lane; i < n; i += 32) x[i] = x[i] / den;
  __syncwarp();
}

// The trust-region action of (A, b) into x; returns its ridge solves
// (ops/trs.py trs_action_settled counts them the same way).  On entry the
// triangle holds A (its copy landed and the warp synced); on exit it holds
// A again where `keep` (K8w reads it on), and no copy is in flight.
template <typename S, bool kShared, class Seed>
__device__ __forceinline__ int trs_action(const Ws<S, kShared>& w,
                                          const Seed& sd, bool keep,
                                          int lane) {
  Solve<S> s;
  trs_begin(s, w);
  while (!trs_pass(s, w, sd, lane)) {
  }
  // The exit at the pass cap left the factor in the triangle.
  if (keep && s.k == TrsParams<S>::iters) seed_issue(w, sd, lane);
  seed_wait<kShared>();
  OCO_SPLIT(kSplitStep);
  to_ball(w.p() + w.x, w.n, lane);
  return s.k + 1;
}

// Blocks an SM is to hold, which caps the registers a thread: 20 one-warp
// blocks in float32 (96 registers), 10 in float64 (204), at least what the
// workspace allows at d = 64 (21 and 11 on an H100).
template <typename S>
constexpr int kMinBlocks = sizeof(S) == 4 ? 20 : 10;

// The launch plan of a wide kernel over `items` problems or sequences, d
// at a time, on the current card, given its instance with the workspace
// in shared memory and the one with it in scratch, and `stats` elements of
// device memory a warp (K8w's statistics; 0 for K9w): out[0] the persistent
// grid's warps (one-warp blocks, as many as the SMs hold, at most items),
// out[1] the scratch elements of type S it needs (a warp's stats, and its
// workspace where that does not fit a block's shared memory), out[2] the
// shared bytes a warp (opted in; 0 on the scratch route), out[3] the
// registers a thread, out[4] the resident warps an SM of the instance it
// takes.  Returns the cudaError_t.
template <typename S, typename K>
inline int plan(K shared_kernel, K scratch_kernel, int d, long long items,
                unsigned long long stats, long long* out) {
  if (items < 1 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const unsigned long long work = work_elems<S>(d);
  const size_t bytes = static_cast<size_t>(work) * sizeof(S);
  const bool fits = bytes <= static_cast<size_t>(optin);
  const K kernel = fits ? shared_kernel : scratch_kernel;
  const size_t smem = fits ? bytes : 0;
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32,
                                                        smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  const long long full = static_cast<long long>(sms) * per_sm;
  out[0] = items < full ? items : full;
  out[1] = out[0] * static_cast<long long>(stats + (fits ? 0 : work));
  out[2] = static_cast<long long>(smem);
  out[3] = err == cudaSuccess ? attr.numRegs : 0;
  out[4] = per_sm;
  return static_cast<int>(err);
}

// A wide launch's set-up: its plan (as plan), a check that the caller gave
// the scratch it needs, and the claim counter zeroed on the stream.
template <typename S, typename K>
inline int prepare(K shared_kernel, K scratch_kernel, int d, long long items,
                   unsigned long long stats, const void* scratch,
                   unsigned long long* counter, cudaStream_t stream,
                   long long* out) {
  int err = plan<S>(shared_kernel, scratch_kernel, d, items, stats, out);
  if (err != cudaSuccess) return err;
  if (out[1] > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  return static_cast<int>(
      cudaMemsetAsync(counter, 0, sizeof(*counter), stream));
}

}  // namespace wide

}  // namespace oco
