// K10's shared parts: the constants, the per-entry and d x d arithmetic
// (the register instances' and the long-row instances', in one place so
// that all compute a row's steps alike), the ring's copy helpers and the
// launch arguments.  The register instances are in admm_kernel.cu, the
// long-row instance K10l in admm_long_kernel.cu (its shapes of up to two
// rows a block) and admm_row_kernel.cu (its one-row block and its cluster
// of blocks); ops/admm.py is their wrapper and plain version.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#define OCO_ADMM_MAX_D 8
#define OCO_ADMM_WARPS 8
// A build with the clock marks is a probe build (see SplitClock below).
#if defined(OCO_ADMM_SPLIT) && !defined(OCO_ADMM_ROUTES)
#define OCO_ADMM_ROUTES
#endif

namespace oco_admm {

// Rows up to this length take the register instances (8 warps x 32 lanes x
// 16 entries), longer rows the long-row instance (ops/admm.py LONG_ROWS).
constexpr int kLongRows = 32 * OCO_ADMM_WARPS * 16;

// K10l's one-row block (admm_row_kernel.cu): a thread's entries of s and
// u in registers and in the block's shared memory, kRowEntries in all, so
// the block takes rows of up to kResidentOneRows entries.  Longer rows take
// the streaming instance (admm_long_kernel.cu; measured faster there than
// the cluster of blocks, which probe builds keep, PERF.md).
constexpr int kRowQR = 64;
constexpr int kRowMS = 88;
constexpr int kRowEntries = kRowQR + kRowMS;
constexpr int kResidentOneRows = kRowEntries * 32 * OCO_ADMM_WARPS;

struct Args {
  const float *z, *y, *Lpk, *s0, *u0, *x0, *w0, *v0;
  int B, T, d, iters, check_every;
  float tol, kappa, alpha, beta;
  float *s, *u, *x, *w, *v, *res;
};

// K10l on the rows longer than kLongRows (admm_long_kernel.cu): launches
// the streaming instance on the rows past kResidentOneRows entries, the
// one-row block on the rows past 16,384 (launch_past, admm_row_kernel.cu),
// then the resident instance's two shapes (rows up to 16,384 entries, then
// up to 8,192), where T has such rows, adding each launch to launched[0]
// and to launched[1], the shapes of up to two rows a block also to
// launched[2] and the two-row shape's to launched[3], the one-row block's
// to launched[4] and a probe build's clusters' to launched[5] (the C
// entry's counts), and returns the cudaError_t;
// occupancy_long sets the registers a thread and resident warps an SM of
// the resident shapes (out[0], out[1] for rows up to 8,192; out[2],
// out[3] up to 16,384), of the one-row block (out[4], out[5]) and of the
// streaming instance (out[6], out[7]) at T (0 warps where T has no such
// rows).
int launch_long(const Args& a, cudaStream_t stream, int* launched);
int occupancy_long(int d, int T, int* out);

// K10l's rows of lo + 1 .. kResidentOneRows entries on the one-row block
// (admm_row_kernel.cu); counts as launch_long.  row_occupancy: the
// registers a thread and resident warps an SM of the one-row block
// (out[0], out[1]) for a launch at T.  row_plan: the block's shape (see
// oco_admm_row_plan), cudaErrorInvalidValue unless lo < L <=
// kResidentOneRows.
int launch_past(const Args& a, int lo, cudaStream_t stream, int* launched);
int row_occupancy(int d, int T, int lo, int* out);
int row_plan(int d, int lo, int L, int* out);
#ifdef OCO_ADMM_ROUTES
// Probe builds only: the rows past kResidentOneRows entries on a cluster
// of blocks a row, in design (a) (spread false) or (b), clusters of the
// most blocks first; counts as launch_long, the clusters' launches also
// in launched[5].
int launch_clusters(const Args& a, bool spread, cudaStream_t stream,
                    int* launched);
#endif
// The probe build's clocks of the one-row block and of the cluster, added
// into out[kInstOne .. kInstCluster][kAdmmPhases] and zeroed; returns a
// cudaError_t.
int row_split(unsigned long long* out);

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

// A probe build of K10l (scripts/wide_probe.py, -DOCO_ADMM_ROUTES) keeps
// the instances the library no longer routes rows to and lets the caller
// choose the route (oco_admm_split_route); -DOCO_ADMM_SPLIT adds clock
// marks: each warp's clocks by phase, mark(p) adding the clock64 span
// since the warp's last mark to phase p's total, span(p, t0) the span
// since t0 without moving the last mark (lane 0 of each warp; flush() adds
// them to admm_split_clocks[instance] at the end of the block, instances
// as AdmmInstance names them).  The library's build compiles the marks to
// nothing.
enum AdmmInstance {
  kInstStream,    // the streaming kernel (probe builds only)
  kInstFour,      // the resident shape of four rows a block
  kInstTwo,       // of two rows a block
  kInstOne,       // the one-row block
  kInstCluster,   // the cluster of blocks a row (probe builds only)
  kAdmmInstances
};
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
__device__ unsigned long long admm_split_clocks[kAdmmInstances][kAdmmPhases];
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

// cp.async of one float into shared memory (the resident instances'
// rings of y and z entries).
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int K>
using Int = std::integral_constant<int, K>;

// Calls f(Int<m>()) for m = K .. M - 1 while m < mt, in order (a
// compile-time m, so a register row's s[m] stays in registers).
template <int K, int M, typename F>
__device__ __forceinline__ void each_entry(int mt, F&& f) {
  if constexpr (K < M) {
    if (K < mt) {
      f(Int<K>());
      each_entry<K + 1, M>(mt, f);
    }
  }
}

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
