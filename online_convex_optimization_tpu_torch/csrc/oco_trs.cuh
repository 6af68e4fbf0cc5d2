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
// The Python wrappers raise above it (ops/trs.py MAX_D).
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

}  // namespace oco
