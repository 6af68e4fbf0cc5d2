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
// rounded x / max(sqrt(||x||^2), 1) at the end.
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

// Ridge floor and Newton iterations by working type.  12 in f32 is the TPU
// kernels' count; in f64 the answer stops moving after 18 iterations on the
// tests' and a regression stream's prefixes (tests/test_torch_quadratic.py,
// through trs_solve_reference), and 20 leaves a margin.
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

// The trust-region action of (A packed lower triangle, b) into x.
template <typename S, int D>
__device__ __forceinline__ void trs_action(const S* A, const S* b, S* x,
                                           int n) {
  constexpr int C = QCap<D>::value;
  S L[QCap<D>::tri], v[C];
  S tr = A[0];
#pragma unroll
  for (int i = 1; i < n; ++i) tr = tr + A[tri(i, i)];
  const S eps = TrsParams<S>::eps_rel * (S(1) + tr / S(n));
  S lam = S(0), lo = S(0), hi = osqrt(dot<S, D>(b, b, n));
  for (int it = 0; it < TrsParams<S>::iters; ++it) {
    ridge_solve<S, D>(A, b, lam + eps, L, v, x, n);
    const S n2 = dot<S, D>(x, x, n);
    fwd_solve<S, D>(L, x, v, n);               // q = L^{-1} x
    const S nq2 = dot<S, D>(v, v, n);
    const bool outside = n2 > S(1);
    lo = outside ? lam : lo;
    hi = outside ? hi : lam;
    const S step = (n2 / omax(nq2, S(1e-30))) * (osqrt(n2) - S(1));
    const S lam_n = lam + step;
    // Newton from below converges monotonically; a step that leaves the
    // bracket strictly (also the interior case, lam -> lo = 0) takes the
    // midpoint instead.
    lam = (lam_n < lo || lam_n > hi) ? S(0.5) * (lo + hi) : lam_n;
  }
  ridge_solve<S, D>(A, b, lam + eps, L, v, x, n);
  const S den = omax(osqrt(dot<S, D>(x, x, n)), S(1));
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = x[i] / den;
}

}  // namespace oco
