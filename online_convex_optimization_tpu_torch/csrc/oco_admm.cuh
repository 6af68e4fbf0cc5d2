// K10's shared parts: the constants, the per-entry and d x d arithmetic
// (the register instances' and the long-row instance's, in one place so
// that both compute a row's steps alike) and the launch arguments.  The
// register instances are in admm_kernel.cu, the long-row instance K10l in
// admm_long_kernel.cu; ops/admm.py is their wrapper and plain version.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#define OCO_ADMM_MAX_D 8
#define OCO_ADMM_WARPS 8

namespace oco_admm {

// Rows up to this length take the register instances (8 warps x 32 lanes x
// 16 entries), longer rows the long-row instance (ops/admm.py LONG_ROWS).
constexpr int kLongRows = 32 * OCO_ADMM_WARPS * 16;

struct Args {
  const float *z, *y, *Lpk, *s0, *u0, *x0, *w0, *v0;
  int B, T, d, iters, check_every;
  float tol, kappa, alpha, beta;
  float *s, *u, *x, *w, *v, *res;
};

// K10l on the rows longer than kLongRows (admm_long_kernel.cu): launches
// its streaming instance on the rows past the resident instance's
// capacity, then the resident instance on the others, where T has such
// rows, adding each launch to launched[0] and to launched[1] and the
// resident one also to launched[2] (the C entry's counts), and returns the
// cudaError_t; occupancy_long sets the registers a thread and resident
// warps an SM of the streaming instance (out[0], out[1]) and of the
// resident one (out[2], out[3]) at T (0 warps where T has no such rows).
int launch_long(const Args& a, cudaStream_t stream, int* launched);
int occupancy_long(int d, int T, int* out);

}  // namespace oco_admm

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 32 * OCO_ADMM_WARPS;

__device__ __forceinline__ int tri(int j, int k) { return j * (j + 1) / 2 + k; }

// max that propagates NaN from either side (torch.maximum).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// torch.clamp(a, min=0): NaN stays NaN.
__device__ __forceinline__ float relu(float a) {
  return (a > 0.f || a != a) ? a : 0.f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Sums v[j], j < 8, over the warp; lanes 4 j .. 4 j + 3 return the sum of
// v[j] (the same bits on the four: a + b == b + a in IEEE arithmetic).
// Each level halves the sums a lane keeps and sends the other half across.
__device__ __forceinline__ float reduce_scatter8(const float (&v)[8],
                                                 int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (h16 ? v[i + 4] : v[i]) +
           __shfl_xor_sync(kFull, h16 ? v[i] : v[i + 4], 16);
  float c[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (h8 ? a[i + 2] : a[i]) +
           __shfl_xor_sync(kFull, h8 ? a[i] : a[i + 2], 8);
  float e = (h4 ? c[1] : c[0]) + __shfl_xor_sync(kFull, h4 ? c[0] : c[1], 4);
  e = e + __shfl_xor_sync(kFull, e, 2);
  return e + __shfl_xor_sync(kFull, e, 1);
}

// A probe build of K10l (scripts/wide_probe.py --k10l-split,
// -DOCO_ADMM_SPLIT) splits each warp's clocks by phase: mark(p) adds the
// clock64 span since the warp's last mark to phase p's total, span(p, t0)
// the span since t0 without moving the last mark (lane 0 of each warp;
// flush() adds them to admm_split_clocks[instance] at the end of the
// block, instance 0 the streaming kernel, 1 the resident one).  The
// library's build compiles the marks to nothing.
enum AdmmPhase {
  kAdmmStep,      // waiting for the d x d steps and their barrier
  kAdmmLoad,      // a pass waiting on its loads of z, y, s and u
  kAdmmArith,     // a pass's arithmetic (and its shared-memory state)
  kAdmmPublish,   // the reduce-scatter, its barrier, the residual's maxima
  kAdmmOther,     // the prologue, the residual decision and the epilogue
  kAdmmChain,     // the d x d steps alone (warp 0, inside kAdmmStep)
  kAdmmPhases
};
#ifdef OCO_ADMM_SPLIT
__device__ unsigned long long admm_split_clocks[2][kAdmmPhases];
__device__ int admm_split_sink;
struct SplitClock {
  int inst;
  long long last;
  unsigned long long c[kAdmmPhases];
  __device__ explicit SplitClock(int instance) {
    inst = instance;
    last = clock64();
#pragma unroll
    for (int p = 0; p < kAdmmPhases; ++p) c[p] = 0;
  }
  __device__ __forceinline__ long long now() const { return clock64(); }
  __device__ __forceinline__ void mark(int p) {
    const long long t = clock64();
    c[p] += static_cast<unsigned long long>(t - last);
    last = t;
  }
  __device__ __forceinline__ void span(int p, long long t0) {
    c[p] += static_cast<unsigned long long>(clock64() - t0);
  }
  // Makes the mark that follows wait for v (a loaded value) to arrive.
  __device__ __forceinline__ void wait_for(float v) {
    if (v == 1.2345e-38f) admm_split_sink = 1;
  }
  __device__ __forceinline__ void flush() {
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int p = 0; p < kAdmmPhases; ++p)
        atomicAdd(&admm_split_clocks[inst][p], c[p]);
    }
  }
};
#else
struct SplitClock {
  __device__ explicit SplitClock(int) {}
  __device__ __forceinline__ long long now() const { return 0; }
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void span(int, long long) {}
  __device__ __forceinline__ void wait_for(float) {}
  __device__ __forceinline__ void flush() {}
};
#endif

template <int D>
struct Dim {
  static constexpr int cap = D > 0 ? D : OCO_ADMM_MAX_D;
  static constexpr int ntri = cap * (cap + 1) / 2;
};

// <x, z_t> summed in index order.
template <int D>
__device__ __forceinline__ float predict(const float* x, const float* zt,
                                         int n) {
  float q = x[0] * zt[0];
#pragma unroll
  for (int j = 1; j < Dim<D>::cap; ++j)
    if (j < n) q = q + x[j] * zt[j];
  return q;
}

// The soft threshold sign(sp) max(|sp| - kappa, 0) as one copysign: the
// same value (max propagates NaN, and sign(NaN) = 0 times NaN is NaN), with
// the sign of a zero taken from sp.
__device__ __forceinline__ float shrink(float sp, float kappa) {
  return copysignf(relu(fabsf(sp) - kappa), sp);
}

// A block's rows in shared memory, row slot r for the row of length top - r:
// Slots rows, and Parts slots of a warp's partial sums (row r's W warps
// at r W .. r W + W - 1).
template <int D, int Slots = OCO_ADMM_WARPS, int Parts = OCO_ADMM_WARPS>
struct Rows {
  float L[Slots][Dim<D>::ntri];  // packed factor, inverted diagonal
  float x[Slots][Dim<D>::cap];
  float w[Slots][Dim<D>::cap];
  float v[Slots][Dim<D>::cap];
  float part[Parts][8];          // each warp's sums of the next rhs
  float pri[Parts];              // each warp's residual maximum
  float res[Slots];
  int live[Slots];               // the row still iterates
};

// Row r's d x d step on one lane: rhs from its W warps' sums in warp order,
// x by the two substitutions, then the over-relaxed ball projection.  Its
// inputs are loaded from shared memory up front, in unrolled loops, so the
// loads overlap and the serial chain runs in registers.
template <int D, typename RowsT>
__device__ __forceinline__ void row_step(RowsT& S, int r, int W, int n,
                                         float alpha, float beta) {
  constexpr int C = Dim<D>::cap;
  float rhs[C], w[C], v[C], Lf[Dim<D>::ntri];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    rhs[j] = S.part[r * W][j];
    w[j] = S.w[r][j];
    v[j] = S.v[r][j];
  }
#pragma unroll
  for (int i = 1; i < OCO_ADMM_WARPS; ++i) {
    if (i < W) {
#pragma unroll
      for (int j = 0; j < C; ++j) rhs[j] = rhs[j] + S.part[r * W + i][j];
    }
  }
#pragma unroll
  for (int k = 0; k < Dim<D>::ntri; ++k) Lf[k] = S.L[r][k];
  float a[C], x[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (j < n) {
      float sj = rhs[j] + (w[j] - v[j]);
#pragma unroll
      for (int k = 0; k < j; ++k) sj = sj - Lf[tri(j, k)] * a[k];
      a[j] = sj * Lf[tri(j, j)];
    }
  }
#pragma unroll
  for (int j = C - 1; j >= 0; --j) {
    if (j < n) {
      float sj = a[j];
#pragma unroll
      for (int k = j + 1; k < C; ++k)
        if (k < n) sj = sj - Lf[tri(k, j)] * x[k];
      x[j] = sj * Lf[tri(j, j)];
    }
  }
  float xh[C], tv[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (j < n) {
      xh[j] = alpha * x[j] + beta * w[j];
      tv[j] = xh[j] + v[j];
    }
  }
  float n2 = tv[0] * tv[0];
#pragma unroll
  for (int j = 1; j < C; ++j)
    if (j < n) n2 = n2 + tv[j] * tv[j];
  const float nrm = sqrtf(nan_max(n2, 1.f));
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (j < n) {
      const float wj = tv[j] / nrm;
      S.x[r][j] = x[j];
      S.v[r][j] = (v[j] + xh[j]) - wj;
      S.w[r][j] = wj;
    }
  }
}

}  // namespace
