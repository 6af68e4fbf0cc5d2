// Device helpers shared by the port's kernels: the regret game (K1), SMART
// (K2), the packed game (K3, K3e), the carried stream (K4), the eta sweep
// (K5), the SMART threshold sweep (K6) and the generation-fused game (K7).
// K4 plays game_round; K1, K5 and K7 its actions (the FTRL scale read from
// a table) and hinge step (play_action), K3 and K3e its action and hinge
// step; K2 and K6 play SMART's two tracks with the same helpers in the
// same order (K2's FTL warp and K6a the FTL track, K2's tail warps and K6b
// the FTRL track), so a sweep column, a chunked stream, a packed game or a
// generated game reproduces the one-shot kernel bit for bit.
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

#include <cstddef>
#include <type_traits>

// Instances by feature dimension: d = 5, the main path's, is fully
// unrolled in registers; the generic instance (D == 0) takes d <= 64 and
// the large-d instance (D == -1) 64 < d <= 512, the JAX package's
// _D_KERNEL_MAX.  Past OCO_LARGE_D every hinge kernel (K1-K7) has a wide
// instance (D == kWideD), so each takes any d >= 1 (launch_for_any_d).
//
// The state of the large-d instance (theta, w, x, the row) is indexed by a
// runtime j, so it lives in local memory, not in registers: the hardware
// interleaves local memory by thread, so a warp's access to element j is
// one coalesced transaction, and L1 caches it.  Its cost is the
// reservation: the driver sets aside the largest frame (up to ~28 KB per
// thread for the large f64 SMART instance) for every thread the card can
// hold, about 7 GB of the 80, from the first launch of a large instance
// on.  A frame sized for d = 4,096 would take eight times that, so the
// wide instance keeps no array in its frame: each thread's vectors lie in
// a device buffer that the wrapper allocates, laid out (d, slots), element
// j of slot i at j * slots + i (Strided), so that the 32 lanes of a warp
// touch 32 neighbouring words as the local frame's interleaving does.  Its
// frame does not grow with d and adds nothing to the large instance's
// reservation.  K5w keeps that design; K1w, K2w (K6aw's and K6bw's
// kernels), K3w, K3ew, K4w, K6aw, K6bw and K7w play a sequence (K1w a
// play, K6bw a tail) on a warp with its vectors in shared memory
// (oco_warp.cuh).
#define OCO_MAX_D 64
#define OCO_LARGE_D 512
#define OCO_THREADS 128

namespace oco {

// The instance marker of the wide instance (d > OCO_LARGE_D).
constexpr int kWideD = -2;

// Storage types.  z and y may be stored narrower than the compute type, as
// the JAX package stores them (ops/pallas_game.py: bf16 z, int8 or bf16 y):
// every element is converted to the compute type on read, which is exact,
// so a narrow run equals the float32 run on the upcast values in every
// bit.  bf16 is carried as its bits: the float32 with the same high 16
// bits and zero low ones.
struct bf16 {
  unsigned short bits;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(bf16 v) {
  return __uint_as_float(static_cast<unsigned>(v.bits) << 16);
}
__device__ __forceinline__ float widen(signed char v) {
  return static_cast<float>(v);
}

// The compute type of a z storage type: float64 for float64, float32 for
// float32 and bf16.
template <typename Z>
struct Compute {
  using type = float;
};
template <>
struct Compute<double> {
  using type = double;
};

template <typename Z>
using compute_t = typename Compute<Z>::type;

// Whether a storage type is narrower than its compute type.
template <typename T>
constexpr bool kNarrow = sizeof(T) < 4;

// Whether a (z, y) storage pair holds a narrow type: its rows cannot be
// copied an element at a time with cp.async (4, 8 or 16 bytes), so the
// staged kernels copy 4-byte windows and the time-major ones the 4-byte
// word that holds each element (oco_tiles.cuh).
template <typename Z, typename Y>
constexpr bool kWindowed = kNarrow<Z> || kNarrow<Y>;

// Array capacity of an instance: D > 0 is a compile-time d, D == 0 the
// generic instance, D == -1 the large-d one; the wide instance keeps no
// array (a placeholder of one element, never indexed).
template <int D>
struct Cap {
  static constexpr int value =
      D > 0 ? D
            : (D == 0 ? OCO_MAX_D : (D == -1 ? OCO_LARGE_D : 1));
};

// Element j of a vector stored with a stride: a wide thread's state, slot
// i of a (d, slots) buffer (p = buffer + i, stride = slots), or a row of
// the time-major (T, d, B) layout.  Indexed in 64 bits: slots * d may pass
// 2^31.
template <typename T>
struct Strided {
  T* p;
  long long stride;
  __device__ __forceinline__ T& operator[](int j) const {
    return p[j * stride];
  }
};

// Calls launch(std::integral_constant<int, D>()) with the instance that
// takes d >= 1: d = 5, the generic, the large-d or (past OCO_LARGE_D) the
// wide instance; returns the launch's cudaError_t, cudaErrorInvalidValue
// for d < 1.
template <typename F>
inline int launch_for_any_d(int d, F&& launch) {
  if (d < 1) return cudaErrorInvalidValue;
  if (d == 5)
    launch(std::integral_constant<int, 5>());
  else if (d <= OCO_MAX_D)
    launch(std::integral_constant<int, 0>());
  else if (d <= OCO_LARGE_D)
    launch(std::integral_constant<int, -1>());
  else
    launch(std::integral_constant<int, kWideD>());
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

// The helpers below take a thread's vectors as arrays (pointers) or, in
// K5w's wide instance (dot and scaled, through its comparators), as
// Strided views, with the same arithmetic in the same order.  A wide
// vector lies in device memory, so a loop that
// loads an element and then uses it would wait a memory latency an
// element: the wide instance's loops go kWideBlock elements at a time, the
// block's loads first (ahead of any store), then its arithmetic in index
// order, then its stores.
constexpr int kWideBlock = 8;

// <a, b> summed in index order, each element widened to S on read.
template <typename S, int D, typename A, typename B>
__device__ __forceinline__ S dot(A a, B b, int n) {
  S acc = S(widen(a[0])) * S(widen(b[0]));
  if constexpr (D == kWideD) {
    for (int j0 = 1; j0 < n; j0 += kWideBlock) {
      S u[kWideBlock], v[kWideBlock];
#pragma unroll
      for (int k = 0; k < kWideBlock; ++k) {
        if (j0 + k < n) {
          u[k] = S(widen(a[j0 + k]));
          v[k] = S(widen(b[j0 + k]));
        }
      }
#pragma unroll
      for (int k = 0; k < kWideBlock; ++k)
        if (j0 + k < n) acc = acc + u[k] * v[k];
    }
  } else {
#pragma unroll
    for (int j = 1; j < n; ++j) acc = acc + S(widen(a[j])) * S(widen(b[j]));
  }
  return acc;
}

// x = f * v elementwise (x may be v; the product is the same either way
// round): a block's loads of v, then its stores to x, in the wide
// instance.
template <typename S, int D, typename V, typename X>
__device__ __forceinline__ void scaled(V v, X x, int n, S f) {
  if constexpr (D == kWideD) {
    for (int j0 = 0; j0 < n; j0 += kWideBlock) {
      S u[kWideBlock];
#pragma unroll
      for (int k = 0; k < kWideBlock; ++k)
        if (j0 + k < n) u[k] = v[j0 + k];
#pragma unroll
      for (int k = 0; k < kWideBlock; ++k)
        if (j0 + k < n) x[j0 + k] = f * u[k];
    }
  } else {
#pragma unroll
    for (int j = 0; j < n; ++j)
      x[j] = f * v[j];
  }
}

// x = -theta / ||theta||, the zero vector at theta == 0 (ftl_action).
template <typename S, int D, typename TH, typename X>
__device__ __forceinline__ void ftl_action(TH th, X x, int n) {
  const S nsq = dot<S, D>(th, th, n);
  const S scale = nsq > S(0) ? -(S(1) / osqrt(nsq)) : S(0);
  scaled<S, D>(th, x, n, scale);
}

// x = scale * theta, rescaled by 1/sqrt(||x||^2) iff ||x||^2 > 1: the FTRL
// action for a given round scale (K3 reads it from a table).
template <typename S, int D, typename TH, typename X>
__device__ __forceinline__ void ftrl_action_scaled(TH th, X x, int n,
                                                   S scale) {
  scaled<S, D>(th, x, n, scale);
  const S nsq = dot<S, D>(x, x, n);
  if (nsq > S(1)) scaled<S, D>(x, x, n, S(1) / osqrt(nsq));
}

// x = -(eta / sqrt(t)) * theta, projected as above (ftrl_action); t >= 1 is
// the 1-based round index.
template <typename S, int D, typename TH, typename X>
__device__ __forceinline__ void ftrl_action(TH th, X x, int n, S eta, S t) {
  ftrl_action_scaled<S, D>(th, x, n, -(eta / osqrt(t)));
}

// The hinge step once the action x is chosen: cum += 0.5 * |<z_t, x> - y_t|;
// returns the tie-exact subgradient coefficient 0.5 * sign.
template <typename S, int D, typename X, typename ZR>
__device__ __forceinline__ S hinge_step(X x, ZR zr, S yt, int n, S& cum) {
  const S diff = dot<S, D>(zr, x, n) - yt;
  cum = cum + S(0.5) * oabs(diff);
  return half_sign(diff);
}

// The subgradient update theta += g * z_t and, unless w is null (K2's
// FTRL tails), the identity statistic w += y_t * z_t.  No wide instance
// calls it (K5w updates in passes of its own).
template <typename S, int D, typename TH, typename W, typename ZR>
__device__ __forceinline__ void update(TH th, W w, ZR zr, S g, S yt, int n) {
  static_assert(D != kWideD, "no wide instance updates through update");
  constexpr bool kW = !std::is_same<W, std::nullptr_t>::value;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    th[j] = th[j] + g * zr[j];
    if constexpr (kW) w[j] = w[j] + yt * zr[j];
  }
}

// Loads row t of one sequence from the time-major (T, d, B) layout:
// neighbouring threads read neighbouring addresses.
template <typename S, int D, typename Z>
__device__ __forceinline__ void load_row(const Z* __restrict__ z, long long t,
                                         long long b, long long B, int n,
                                         S* zr) {
  const Z* row = z + t * n * B + b;
#pragma unroll
  for (int j = 0; j < n; ++j)
    zr[j] = S(widen(row[j * B]));
}

// The round once the action x is chosen: the hinge loss of q = <z_t, x>
// added to cum, the tie-exact subgradient update of theta, and the
// identity statistic w += y_t z_t.
template <typename S, int D, typename TH, typename W, typename X,
          typename ZR>
__device__ __forceinline__ void play_action(TH th, W w, X x, ZR zr, S yt,
                                            int n, S& cum) {
  update<S, D>(th, w, zr, hinge_step<S, D>(x, zr, yt, n, cum), yt, n);
}

// One round of the FTRL (ftrl) or FTL game: the action x from the
// pre-update theta (FTRL with the 1-based round index t1), the hinge loss
// of q = <z_t, x> added to cum, the tie-exact subgradient update of theta,
// and the identity statistic w += y_t z_t.
template <typename S, int D, typename TH, typename W, typename X,
          typename ZR>
__device__ __forceinline__ void game_round(TH th, W w, X x, ZR zr, S yt,
                                           bool ftrl, S eta, S t1, int n,
                                           S& cum) {
  if (ftrl)
    ftrl_action<S, D>(th, x, n, eta, t1);
  else
    ftl_action<S, D>(th, x, n);
  play_action<S, D>(th, w, x, zr, yt, n, cum);
}

// Loss of the final FTL action x_c = ftl_action(theta) (written to x) over
// cnt contract rows, by the hinge identity 0.5 * (cnt - <x_c, w>).
template <typename S, int D, typename TH, typename W, typename X>
__device__ __forceinline__ S identity_comparator(TH th, W w, X x, int n,
                                                 S cnt) {
  ftl_action<S, D>(th, x, n);
  return S(0.5) * (cnt - dot<S, D>(x, w, n));
}

// The storage pairs (z, y) of the hinge-game kernels K1-K6 and the suffix
// of their extern "C" entries: X(suffix, Z, Y) for each.  f64 and f32 keep
// z and y in the compute type; bf16 z with bf16 or int8 y, and f32 z with
// int8 y, compute in float32 (ops/game.py STORAGE).
#define OCO_STORAGE_PAIRS(X)        \
  X(f64, double, double)             \
  X(f32, float, float)               \
  X(bf16, oco::bf16, oco::bf16)      \
  X(bf16i8, oco::bf16, signed char)  \
  X(f32i8, float, signed char)

inline unsigned int grid_for(long long B) {
  return static_cast<unsigned int>((B + OCO_THREADS - 1) / OCO_THREADS);
}

}  // namespace oco
