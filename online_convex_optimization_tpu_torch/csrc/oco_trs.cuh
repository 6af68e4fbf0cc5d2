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
//   - Cholesky, right-looking: at step j every lane computes sqrt(L_jj)
//     (the same bits), the lanes divide column j below it, then update the
//     trailing triangle, lane k taking the entries (i, j + 1 + 32 c + k)
//     of each row i (contiguous addresses).  Entry (i, m) so starts at A_im
//     (+ lam on the diagonal) and subtracts L_ij L_mj for j = 0, 1, ... in
//     turn, the plain version's order.
//   - Forward substitution, column by column: lane i mod 32 keeps v_i's
//     running value, divides it by L_ii at step i and hands it to the warp
//     (a shuffle); every lane then subtracts L_ki v_i from its v_k, k > i,
//     again in increasing i.
//   - Backward substitution: x_i = (v_i - L_{i+1,i} x_{i+1} - ...) / L_ii
//     subtracts in increasing k, so x_i can start only once x_{i+1} is
//     known, and its chain of subtractions cannot be split without
//     changing its rounding; every lane runs the whole serial chain (the
//     loads are broadcasts), one lane stores x_i.
//   - Sums over the index (traces, squared norms, dots) run on every lane
//     in index order, so every lane holds the Newton carry and the exit is
//     the warp's.
// The triangles and vectors live in a warp's workspace: shared memory
// where it fits, a slice of a device scratch buffer otherwise (plan below
// chooses).  The loops take any d; the triangles' offsets are 64-bit, and
// the Cholesky's trailing update walks its rows by pointer.
namespace wide {

constexpr unsigned kWarp = 0xffffffffu;

// Offset of (i, j), j <= i, in a packed lower triangle.
__device__ __forceinline__ long long wtri(long long i, long long j) {
  return i * (i + 1) / 2 + j;
}

// Elements of a warp's workspace: the triangles A and L, and six vectors
// (b, x, v, x1; K8's theta and z row).
__host__ __device__ inline long long work_elems(int d) {
  return 2 * (static_cast<long long>(d) * (d + 1) / 2) + 6LL * d;
}

template <typename S>
struct Work {
  S* A;    // packed lower triangle of the problem (K8: the statistics)
  S* L;    // its factor
  S* b;
  S* x;
  S* v;
  S* x1;   // the x of one pass back
  S* th;   // K8: theta
  S* zr;   // K8: the round's row; the comparator's action at the end
};

template <typename S>
__device__ __forceinline__ Work<S> carve(S* base, int d) {
  const long long t = static_cast<long long>(d) * (d + 1) / 2;
  Work<S> w;
  w.A = base;
  w.L = base + t;
  S* vec = base + 2 * t;
  w.b = vec;
  w.x = vec + d;
  w.v = vec + 2 * d;
  w.x1 = vec + 3 * d;
  w.th = vec + 4 * d;
  w.zr = vec + 5 * d;
  return w;
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

// Rows of the trailing update a lane loads before it stores.
constexpr int kRows = 8;

// L = chol(A + lam I).
template <typename S>
__device__ void chol_factor(const S* A, S lam, S* L, int n, int lane) {
  for (int i = 0; i < n; ++i) {
    const long long ri = wtri(i, 0);
    for (int j = lane; j <= i; j += 32)
      L[ri + j] = j == i ? A[ri + j] + lam : A[ri + j];
  }
  __syncwarp();
  for (int j = 0; j < n; ++j) {
    const long long rj = wtri(j, 0);
    const S piv = osqrt(L[rj + j]);
    for (int i = j + 1 + lane; i < n; i += 32) {
      const long long at = wtri(i, j);
      L[at] = L[at] / piv;
    }
    __syncwarp();
    if (lane == 0) L[rj + j] = piv;
    for (int c0 = j + 1; c0 < n; c0 += 32) {
      const int m = c0 + lane;                  // this lane's column
      const S lmj = m < n ? L[wtri(m, j)] : S(0);
      S* row = L + wtri(c0, 0);                 // row i, walked by pointer
      int i = c0;
      // kRows rows' loads before their stores.
      for (; i + kRows <= n; i += kRows) {
        S* r[kRows];
        S lij[kRows], cur[kRows];
        r[0] = row;
#pragma unroll
        for (int q = 1; q < kRows; ++q) r[q] = r[q - 1] + (i + q);
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          lij[q] = r[q][j];
          cur[q] = m <= i + q ? r[q][m] : S(0);
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (m <= i + q) r[q][m] = cur[q] - lij[q] * lmj;
        row = r[kRows - 1] + (i + kRows);
      }
      for (; i < n; ++i) {
        if (m <= i) row[m] = row[m] - row[j] * lmj;
        row += i + 1;
      }
    }
    __syncwarp();
  }
}

// v = L^{-1} b (v and b distinct).
template <typename S>
__device__ void fwd_solve(const S* L, const S* b, S* v, int n, int lane) {
  for (int i = lane; i < n; i += 32) v[i] = b[i];
  for (int k = 0; k < n; ++k) {
    S vk = S(0);
    if ((k & 31) == lane) {
      vk = v[k] / L[wtri(k, k)];
      v[k] = vk;
    }
    vk = __shfl_sync(kWarp, vk, k & 31);
    for (int i = k + 1 + ((lane - k - 1) & 31); i < n; i += 32)
      v[i] = v[i] - L[wtri(i, k)] * vk;
  }
  __syncwarp();
}

// x = L^{-T} v.
template <typename S>
__device__ void bwd_solve(const S* L, const S* v, S* x, int n, int lane) {
  for (int i = n - 1; i >= 0; --i) {
    S s = v[i];
    long long at = wtri(i + 1, i);
#pragma unroll 4
    for (int k = i + 1; k < n; ++k) {
      s = s - L[at] * x[k];
      at += k + 1;                              // wtri(k + 1, i)
    }
    s = s / L[wtri(i, i)];
    if (lane == 0) x[i] = s;
    __syncwarp();
  }
}

// The solve in flight: the floor and the Newton carry, as TrsSolve (the
// x of one pass back is the workspace's x1).
template <typename S>
struct Solve {
  S eps, lam, lo, hi, lam1, lo1, hi1;
  int k;
};

template <typename S>
__device__ __forceinline__ void trs_begin(Solve<S>& s, const Work<S>& w,
                                          int n) {
  S tr = w.A[0];
  for (int i = 1; i < n; ++i) tr = tr + w.A[wtri(i, i)];
  s.eps = TrsParams<S>::eps_rel * (S(1) + tr / S(n));
  s.lam = s.lo = S(0);
  s.hi = osqrt(wdot(w.b, w.b, n));
  s.k = 0;
}

// One Newton pass into w.x, as oco::trs_pass (same exits, same bits).
template <typename S>
__device__ bool trs_pass(Solve<S>& s, const Work<S>& w, int n, int lane) {
  constexpr int iters = TrsParams<S>::iters;
  chol_factor(w.A, s.lam + s.eps, w.L, n, lane);
  fwd_solve(w.L, w.b, w.v, n, lane);
  bwd_solve(w.L, w.v, w.x, n, lane);
  if (s.k == iters) return true;
  const S n2 = wdot(w.x, w.x, n);
  fwd_solve(w.L, w.x, w.v, n, lane);          // q = L^{-1} x
  const S nq2 = wdot(w.v, w.v, n);
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
    if (((iters - s.k + 1) & 1) == 0) wcopy(w.x, w.x1, n, lane);
    return true;
  }
  wcopy(w.x1, w.x, n, lane);
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

// The trust-region action of (w.A, w.b) into w.x; returns its ridge
// solves (ops/trs.py trs_action_settled counts them the same way).
template <typename S>
__device__ __forceinline__ int trs_action(const Work<S>& w, int n,
                                          int lane) {
  Solve<S> s;
  trs_begin(s, w, n);
  while (!trs_pass(s, w, n, lane)) {
  }
  to_ball(w.x, n, lane);
  return s.k + 1;
}

// The launch plan of a wide kernel over `items` problems or sequences, d
// at a time, on the current card, given its instance with the workspace
// in shared memory and the one with it in scratch: out[0] the persistent
// grid's warps (one-warp blocks, as many as the SMs hold, at most items),
// out[1] the scratch elements of type S it needs (0 where a warp's
// workspace fits a block's shared memory), out[2] the shared bytes a warp
// (opted in), out[3] the registers a thread, out[4] the resident warps an
// SM of the instance it takes.  Returns the cudaError_t.
template <typename S, typename K>
inline int plan(K shared_kernel, K scratch_kernel, int d, long long items,
                long long* out) {
  if (items < 1 || d < 1) return cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t bytes = static_cast<size_t>(work_elems(d)) * sizeof(S);
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
  out[1] = fits ? 0 : out[0] * work_elems(d);
  out[2] = static_cast<long long>(smem);
  out[3] = err == cudaSuccess ? attr.numRegs : 0;
  out[4] = per_sm;
  return static_cast<int>(err);
}

// A wide launch's set-up: its plan (as plan), a check that the caller gave
// the scratch it needs, and the claim counter zeroed on the stream.
template <typename S, typename K>
inline int prepare(K shared_kernel, K scratch_kernel, int d, long long items,
                   const void* scratch, unsigned long long* counter,
                   cudaStream_t stream, long long* out) {
  int err = plan<S>(shared_kernel, scratch_kernel, d, items, out);
  if (err != cudaSuccess) return err;
  if (out[1] > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  return static_cast<int>(
      cudaMemsetAsync(counter, 0, sizeof(*counter), stream));
}

}  // namespace wide

}  // namespace oco
