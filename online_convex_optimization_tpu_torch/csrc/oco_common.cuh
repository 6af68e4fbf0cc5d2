// Device helpers shared by the port's kernels: the regret game (K1), SMART
// (K2), the packed game (K3, K3e), the carried stream (K4), the eta sweep
// (K5), the SMART threshold sweep (K6) and the generation-fused game (K7).
// K1, K4, K5 and K7 play the same game_round, K3 and K3e its action and
// hinge step; K2 and K6 the same smart_round, so a sweep column, a chunked
// stream, a packed game or a generated game reproduces the one-shot kernel
// bit for bit.
//
// Every helper follows the order of operations of ops/actions.py and
// ops/hinge.py (and of the reference's fast_algorithms.py:19-66): a true
// division by a correctly rounded sqrt, sums over the feature axis in index
// order.  The library is built with --fmad=false and never with
// --use_fast_math, so no product is fused into an add and no sqrt or divide
// is approximated: the f64 instances reproduce the exact ties q == y that
// the z = e1 families reach.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

// Instances by feature dimension: d = 5, the main path's, is fully
// unrolled in registers; the generic instance (D == 0) takes d <= 64 and
// the large-d instance (D == -1) 64 < d <= 512, the JAX package's
// _D_KERNEL_MAX.  The Python wrappers raise above OCO_LARGE_D
// (utils/cuda_build.py MAX_D).
//
// The state of the runtime-d instances (theta, w, x, the row) is indexed by
// a runtime j, so it lives in local memory, not in registers: the hardware
// interleaves local memory by thread, so a warp's access to element j is
// one coalesced transaction, and L1 caches it.  That needs no scratch
// buffer and no change of signature.  Its cost is the reservation: the
// driver sets aside the largest frame (up to ~28 KB per thread for the
// large f64 SMART instance) for every thread the card can hold, about 7 GB
// of the 80, from the first launch of a large instance on.
#define OCO_MAX_D 64
#define OCO_LARGE_D 512
#define OCO_THREADS 128

namespace oco {

// Array capacity of an instance: D > 0 is a compile-time d, D == 0 the
// generic instance, D == -1 the large-d one.
template <int D>
struct Cap {
  static constexpr int value = D > 0 ? D : (D == 0 ? OCO_MAX_D : OCO_LARGE_D);
};

// Calls launch(std::integral_constant<int, D>()) with the instance that
// takes d; returns the launch's cudaError_t, cudaErrorInvalidValue for d
// outside [1, OCO_LARGE_D].
template <typename F>
inline int launch_for_d(int d, F&& launch) {
  if (d < 1 || d > OCO_LARGE_D) return cudaErrorInvalidValue;
  if (d == 5)
    launch(std::integral_constant<int, 5>());
  else if (d <= OCO_MAX_D)
    launch(std::integral_constant<int, 0>());
  else
    launch(std::integral_constant<int, -1>());
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ double osqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float osqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double oabs(double v) { return fabs(v); }
__device__ __forceinline__ float oabs(float v) { return fabsf(v); }
__device__ __forceinline__ double omax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float omax(float a, float b) { return fmaxf(a, b); }

// 0.5 * sign(diff), exactly 0 at the tie.
template <typename S>
__device__ __forceinline__ S half_sign(S diff) {
  return diff > S(0) ? S(0.5) : (diff < S(0) ? S(-0.5) : S(0));
}

// <a, b> summed in index order.
template <typename S, int D>
__device__ __forceinline__ S dot(const S* a, const S* b, int n) {
  S acc = a[0] * b[0];
#pragma unroll
  for (int j = 1; j < n; ++j) acc = acc + a[j] * b[j];
  return acc;
}

// x = -theta / ||theta||, the zero vector at theta == 0 (ftl_action).
template <typename S, int D>
__device__ __forceinline__ void ftl_action(const S* th, S* x, int n) {
  const S nsq = dot<S, D>(th, th, n);
  const S scale = nsq > S(0) ? -(S(1) / osqrt(nsq)) : S(0);
#pragma unroll
  for (int j = 0; j < n; ++j)
    x[j] = scale * th[j];
}

// x = scale * theta, rescaled by 1/sqrt(||x||^2) iff ||x||^2 > 1: the FTRL
// action for a given round scale (K3 reads it from a table).
template <typename S, int D>
__device__ __forceinline__ void ftrl_action_scaled(const S* th, S* x, int n,
                                                   S scale) {
#pragma unroll
  for (int j = 0; j < n; ++j)
    x[j] = scale * th[j];
  const S nsq = dot<S, D>(x, x, n);
  if (nsq > S(1)) {
    const S f = S(1) / osqrt(nsq);
#pragma unroll
    for (int j = 0; j < n; ++j)
      x[j] = x[j] * f;
  }
}

// x = -(eta / sqrt(t)) * theta, projected as above (ftrl_action); t >= 1 is
// the 1-based round index.
template <typename S, int D>
__device__ __forceinline__ void ftrl_action(const S* th, S* x, int n, S eta,
                                            S t) {
  ftrl_action_scaled<S, D>(th, x, n, -(eta / osqrt(t)));
}

// The hinge step once the action x is chosen: cum += 0.5 * |<z_t, x> - y_t|;
// returns the tie-exact subgradient coefficient 0.5 * sign.
template <typename S, int D>
__device__ __forceinline__ S hinge_step(const S* x, const S* zr, S yt, int n,
                                        S& cum) {
  const S diff = dot<S, D>(zr, x, n) - yt;
  cum = cum + S(0.5) * oabs(diff);
  return half_sign(diff);
}

// Loads row t of one sequence from the time-major (T, d, B) layout:
// neighbouring threads read neighbouring addresses.
template <typename S, int D>
__device__ __forceinline__ void load_row(const S* __restrict__ z, long long t,
                                         long long b, long long B, int n,
                                         S* zr) {
  const S* row = z + t * n * B + b;
#pragma unroll
  for (int j = 0; j < n; ++j)
    zr[j] = row[j * B];
}

// Final comparator loss 0.5 * sum_{t < len} |<z_t, x> - y_t|, replayed over
// the thread's own rows (the mode for data outside the identity contract).
template <typename S, int D>
__device__ __forceinline__ S replay_comparator(const S* __restrict__ z,
                                               const S* __restrict__ y,
                                               long long b, long long B,
                                               int n, int len, const S* x) {
  S zr[Cap<D>::value];
  S comp = S(0);
  for (int t = 0; t < len; ++t) {
    load_row<S, D>(z, t, b, B, n, zr);
    const S q = dot<S, D>(zr, x, n);
    comp = comp + S(0.5) * oabs(q - y[t * B + b]);
  }
  return comp;
}

// One round of the FTRL (ftrl) or FTL game: the action x from the
// pre-update theta (FTRL with the 1-based round index t1), the hinge loss
// of q = <z_t, x> added to cum, the tie-exact subgradient update of theta,
// and the identity statistic w += y_t z_t.
template <typename S, int D>
__device__ __forceinline__ void game_round(S* th, S* w, S* x, const S* zr,
                                           S yt, bool ftrl, S eta, S t1,
                                           int n, S& cum) {
  if (ftrl)
    ftrl_action<S, D>(th, x, n, eta, t1);
  else
    ftl_action<S, D>(th, x, n);
  const S g = hinge_step<S, D>(x, zr, yt, n, cum);
#pragma unroll
  for (int j = 0; j < n; ++j) {
    th[j] = th[j] + g * zr[j];
    w[j] = w[j] + yt * zr[j];
  }
}

// Loss of the final FTL action x_c = ftl_action(theta) (written to x) over
// cnt contract rows, by the hinge identity 0.5 * (cnt - <x_c, w>).
template <typename S, int D>
__device__ __forceinline__ S identity_comparator(const S* th, const S* w,
                                                 S* x, int n, S cnt) {
  ftl_action<S, D>(th, x, n);
  return S(0.5) * (cnt - dot<S, D>(x, w, n));
}

// State of one single-switch SMART run (models/smart.py semantics).
template <typename S, int D>
struct SmartState {
  S th[Cap<D>::value];   // always-on FTL track
  S w[Cap<D>::value];    // identity statistic sum y_t z_t
  S thr[Cap<D>::value];  // FTRL track, fresh at the switch
  S xr[Cap<D>::value];   // the FTRL track's last action
  S F, total, cnt;       // FTL losses, played losses, rounds
  bool switched;
  long long tau;         // switch round, T when it never fires
};

template <typename S, int D>
__device__ __forceinline__ void smart_begin(SmartState<S, D>& st, int n,
                                            long long T) {
#pragma unroll
  for (int j = 0; j < n; ++j) st.th[j] = st.w[j] = st.thr[j] = st.xr[j] = S(0);
  st.F = st.total = st.cnt = S(0);
  st.switched = false;
  st.tau = T;
}

// One SMART round t (0-based), shared by K2 and K6:
//   1. the always-on FTL track plays its pre-update action and updates;
//      F accumulates its losses, (w, cnt) the identity statistics;
//   2. once switched (the round AFTER the test first passed), the FTRL
//      track plays with the GLOBAL round index t+1 and its losses count;
//      before that the FTL loss counts;
//   3. before the switch, the post-update FTL action s is scored on the
//      prefix by the hinge identity L = 0.5 * (cnt - <s, w>), and the
//      switch fires at the first round with F - L >= thresh.
template <typename S, int D>
__device__ __forceinline__ void smart_round(SmartState<S, D>& st,
                                            const S* zr, S yt, int t, int n,
                                            S thresh, S eta) {
  S x[Cap<D>::value];
  ftl_action<S, D>(st.th, x, n);
  const S diffF = dot<S, D>(zr, x, n) - yt;
  const S lossF = S(0.5) * oabs(diffF);
  const S gF = half_sign(diffF);
#pragma unroll
  for (int j = 0; j < n; ++j) {
    st.th[j] = st.th[j] + gF * zr[j];
    st.w[j] = st.w[j] + yt * zr[j];
  }
  st.F = st.F + lossF;
  st.cnt = st.cnt + S(1);

  if (st.switched) {
    ftrl_action<S, D>(st.thr, x, n, eta, S(t + 1));
    const S diffR = dot<S, D>(zr, x, n) - yt;
    st.total = st.total + S(0.5) * oabs(diffR);
    const S gR = half_sign(diffR);
#pragma unroll
    for (int j = 0; j < n; ++j) {
      st.thr[j] = st.thr[j] + gR * zr[j];
      st.xr[j] = x[j];
    }
  } else {
    st.total = st.total + lossF;
    ftl_action<S, D>(st.th, x, n);  // post-update action s_t
    const S L = S(0.5) * (st.cnt - dot<S, D>(x, st.w, n));
    if (st.F - L >= thresh) {
      st.switched = true;
      st.tau = t;
    }
  }
}

inline unsigned int grid_for(long long B) {
  return static_cast<unsigned int>((B + OCO_THREADS - 1) / OCO_THREADS);
}

// Sweep grids (K5, K6): block k serves setting k % n_settings of sequence
// block k / n_settings, so the settings of one block of sequences are
// launched next to each other and read the same z rows while they are
// still in L2.
__device__ __forceinline__ void sweep_coords(long long n_settings,
                                             long long* b, long long* e) {
  const long long k = blockIdx.x;
  *e = k % n_settings;
  *b = (k / n_settings) * blockDim.x + threadIdx.x;
}

}  // namespace oco
