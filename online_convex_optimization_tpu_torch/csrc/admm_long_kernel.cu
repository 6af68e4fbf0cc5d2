// K10l: K10's long-row instance, for the (replicate, prefix) rows longer
// than kLongRows entries.  Replaces the TPU kernel
// online_convex_optimization_tpu/ops/pallas_admm.py _admm_kernel on those
// rows (entry admm_all_prefixes_l2); the register instances of
// admm_kernel.cu take the shorter rows, and its C entry launches this one
// first.  Python wrapper and plain version:
// online_convex_optimization_tpu_torch/ops/admm.py.
//
// Long rows (K10l).  A row of the two register instances holds at most
// 8 warps x 32 lanes x 16 entries of s and u (kLongRows = 4,096), and its
// replicate's z and y are staged in shared memory (147 KB at d = 8).  The
// TPU kernel has no such limit (it pads T to 128 and takes any T), so rows
// longer than kLongRows take admm_long_kernel: one block of 8 warps a row,
// the longest rows first.  Its s and u stay in the (B*T, T) state arrays
// the launch reads and writes: each iteration streams the row's entries
// once, thread i taking t = i, i + 256, i + 512, ... (kLongUnroll of them
// loaded before any is stored), reading s, u, z_t and y_t and writing s
// and u.  z and y come through L2 (a replicate's at T = 16,384, d = 8 is
// 590 KB), and the d x d step, the reduce-scatter of the rhs partial sums
// and the residual exit are the register instances' (row_step, publish,
// the same barriers), for the one row of the block.  A row's arithmetic
// depends on its length alone, the partial sums are fused into the pass in
// the order a fresh pass takes, and entries past the row's length are
// never read, as in the register instances; its thread-to-entry map is its
// own, so a long row's bits are its own instance's.
//
// What bounds K10l on an H100: bytes.  An entry moves 16 bytes an
// iteration (s and u read and written) against about 4d + 13 operations,
// so the state's stream limits it, not the 67 TFLOP/s; the serial d x d
// step of a block is hidden by the SM's other blocks.  The resident
// blocks' rows (4 blocks an SM: ~34 MB of s and u at T = 8,192) fit the
// 50 MB L2, so the stream runs mostly from L2 and beats the HBM rate
// (PERF.md gives the times).
#include "oco_admm.cuh"

namespace {

using oco_admm::Args;
using oco_admm::kLongRows;

// Entries a thread of the long-row instance loads before it stores any.
constexpr int kLongUnroll = 4;

// One pass of a long-row thread over its entries t = threadIdx.x + kThreads
// m < L in increasing order: kLongUnroll entries' s, u, y and z are loaded,
// then f(t, s, u, zt, yt) runs on each in turn.  A null s_src or u_src
// reads zeros.
template <int D, typename F>
__device__ __forceinline__ void long_pass(const float* zb, const float* yb,
                                          const float* s_src,
                                          const float* u_src, int L, int n,
                                          F&& f) {
  constexpr int C = Dim<D>::cap;
  constexpr int U = kLongUnroll;
  for (int t0 = threadIdx.x; t0 < L; t0 += U * kThreads) {
    float s[U], u[U], yt[U], zt[U][C];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int t = t0 + k * kThreads;
      if (t < L) {
        s[k] = s_src != nullptr ? s_src[t] : 0.f;
        u[k] = u_src != nullptr ? u_src[t] : 0.f;
        yt[k] = yb[t];
#pragma unroll
        for (int j = 0; j < C; ++j)
          if (j < n) zt[k][j] = zb[static_cast<long long>(t) * n + j];
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int t = t0 + k * kThreads;
      if (t < L) f(t, s[k], u[k], zt[k], yt[k]);
    }
  }
}

// K10l: one row of length L > kLongRows a block, longest first (block g of
// replicate g % B has L = T - g / B).  Its s and u live in s_out and u_out,
// which the first pass fills from s0 and u0 (zeros without them).
template <int D>
__global__ void __launch_bounds__(kThreads, D > 0 ? 4 : 2)
admm_long_kernel(const float* __restrict__ z, const float* __restrict__ y,
                 const float* __restrict__ Lpk, const float* __restrict__ s0,
                 const float* __restrict__ u0, const float* __restrict__ x0,
                 const float* __restrict__ w0, const float* __restrict__ v0,
                 int B, int T, int d, int iters, int check_every, float tol,
                 float kappa, float alpha, float beta, float* s_out,
                 float* u_out, float* __restrict__ x_out,
                 float* __restrict__ w_out, float* __restrict__ v_out,
                 float* __restrict__ res_out) {
  constexpr int C = Dim<D>::cap;
  __shared__ Rows<D> S;             // the block's row in slot 0
  const int n = D > 0 ? D : d;
  const int ntri = n * (n + 1) / 2;
  const int b = blockIdx.x % B;
  const int L = T - static_cast<int>(blockIdx.x / B);
  const long long row = static_cast<long long>(b) * T + L - 1;
  const float* zb = z + static_cast<long long>(b) * T * n;
  const float* yb = y + static_cast<long long>(b) * T;
  float* srow = s_out + row * T;
  float* urow = u_out + row * T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < ntri; i += kThreads)
    S.L[0][i] = Lpk[row * ntri + i];
  for (int j = threadIdx.x; j < n; j += kThreads) {
    S.x[0][j] = x0 != nullptr ? x0[row * n + j] : 0.f;
    S.w[0][j] = x0 != nullptr ? w0[row * n + j] : 0.f;
    S.v[0][j] = x0 != nullptr ? v0[row * n + j] : 0.f;
  }
  if (threadIdx.x == 0) S.live[0] = 1;

  const auto publish = [&](const float (&acc)[C]) {
    float p8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p8[j] = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) p8[j] = acc[j];   // 0 past n
    const float e = reduce_scatter8(p8, lane);
    if ((lane & 3) == 0 && (lane >> 2) < n) S.part[warp][lane >> 2] = e;
  };

  // The rhs partial sums of the initial state, copied into s_out, u_out.
  {
    float acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = 0.f;
    long_pass<D>(zb, yb, s0 != nullptr ? s0 + row * T : nullptr,
                 u0 != nullptr ? u0 + row * T : nullptr, L, n,
                 [&](int t, float s, float u, const float* zt, float yt) {
                   srow[t] = s;
                   urow[t] = u;
                   const float ysu = (yt + s) - u;
#pragma unroll
                   for (int j = 0; j < C; ++j)
                     if (j < n) acc[j] = acc[j] + ysu * zt[j];
                 });
    publish(acc);
  }
  __syncthreads();

  // The row's residual max(max_t |r_t - s_t|, max_j |x_j - w_j|) into
  // S.res[0]; with `stop`, the row stops once it is not above tol.
  // Returns whether the row still iterates.
  const auto residuals = [&](bool stop) {
    if (S.live[0]) {
      float x[C];
#pragma unroll
      for (int j = 0; j < C; ++j) x[j] = j < n ? S.x[0][j] : 0.f;
      float pri = 0.f;
      long_pass<D>(zb, yb, srow, nullptr, L, n,
                   [&](int, float s, float, const float* zt, float yt) {
                     pri = nan_max(pri,
                                   fabsf((predict<D>(x, zt, n) - yt) - s));
                   });
      pri = warp_max(pri);
      if (lane == 0) S.pri[warp] = pri;
    }
    __syncthreads();
    if (threadIdx.x == 0 && S.live[0]) {
      float res = S.pri[0];
      for (int i = 1; i < OCO_ADMM_WARPS; ++i) res = nan_max(res, S.pri[i]);
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (j < n) res = nan_max(res, fabsf(S.x[0][j] - S.w[0][j]));
      S.res[0] = res;
      if (stop && !(res > tol)) S.live[0] = 0;
    }
    __syncthreads();
    return S.live[0] != 0;
  };

  const bool checked = tol > 0.f;
  const int n_blocks = checked ? (iters + check_every - 1) / check_every
                               : (iters > 0 ? 1 : 0);
  const int per_block = checked ? check_every : iters;
  bool fresh = false;   // S.res holds the residual of the current state
  for (int blk = 0; blk < n_blocks; ++blk) {
    for (int it = 0; it < per_block; ++it) {
      if (threadIdx.x == 0)
        row_step<D>(S, 0, OCO_ADMM_WARPS, n, alpha, beta);
      __syncthreads();
      float x[C], acc[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        x[j] = j < n ? S.x[0][j] : 0.f;
        acc[j] = 0.f;
      }
      long_pass<D>(zb, yb, srow, urow, L, n,
                   [&](int t, float s, float u, const float* zt, float yt) {
                     const float r = predict<D>(x, zt, n) - yt;
                     const float rh = alpha * r + beta * s;
                     const float sp = rh + u;
                     const float sn = shrink(sp, kappa);
                     const float un = (u + rh) - sn;
                     srow[t] = sn;
                     urow[t] = un;
                     const float ysu = (yt + sn) - un;
#pragma unroll
                     for (int j = 0; j < C; ++j)
                       if (j < n) acc[j] = acc[j] + ysu * zt[j];
                   });
      publish(acc);
      __syncthreads();
    }
    if (checked) {
      fresh = true;
      if (!residuals(true)) break;
    }
  }
  if (!fresh) residuals(false);

  for (int t = L + threadIdx.x; t < T; t += kThreads) {
    srow[t] = 0.f;
    urow[t] = 0.f;
  }
  for (int j = threadIdx.x; j < n; j += kThreads) {
    x_out[row * n + j] = S.x[0][j];
    w_out[row * n + j] = S.w[0][j];
    v_out[row * n + j] = S.v[0][j];
  }
  if (threadIdx.x == 0) res_out[row] = S.res[0];
}

// Launches K10l on the rows longer than kLongRows (none where T has none);
// adds its launch to launched[0] (all of K10's) and to launched[1] (K10l's).
template <int D>
int launch_d(const Args& a, cudaStream_t stream, int* launched) {
  if (a.T <= kLongRows) return cudaSuccess;
  const long long blocks = static_cast<long long>(a.T - kLongRows) * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  admm_long_kernel<D><<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(
      a.z, a.y, a.Lpk, a.s0, a.u0, a.x0, a.w0, a.v0, a.B, a.T, a.d, a.iters,
      a.check_every, a.tol, a.kappa, a.alpha, a.beta, a.s, a.u, a.x, a.w,
      a.v, a.res);
  const int err = static_cast<int>(cudaGetLastError());
  if (err == cudaSuccess) {
    ++launched[0];
    ++launched[1];
  }
  return err;
}

template <int D>
int occupancy_d(int* out) {
  cudaFuncAttributes attr;
  int err = static_cast<int>(
      cudaFuncGetAttributes(&attr, admm_long_kernel<D>));
  int blocks = 0;
  if (err == cudaSuccess)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, admm_long_kernel<D>, kThreads, 0));
  out[0] = err == cudaSuccess ? attr.numRegs : 0;
  out[1] = blocks * OCO_ADMM_WARPS;
  return err;
}

}  // namespace

namespace oco_admm {

int launch_long(const Args& a, cudaStream_t stream, int* launched) {
  return a.d == 5 ? launch_d<5>(a, stream, launched)
                  : launch_d<0>(a, stream, launched);
}

int occupancy_long(int d, int* out) {
  return d == 5 ? occupancy_d<5>(out) : occupancy_d<0>(out);
}

}  // namespace oco_admm
