// K10: all-prefix exact-FTL hinge ADMM on the l2 ball; each (replicate,
// prefix) row's entries are split across 1-8 warps by the row's own length,
// and each row's d x d step runs on one lane.  Rows longer than kLongRows
// take K10l (admm_long_kernel.cu, admm_row_kernel.cu): its resident
// shapes, s and u on the chip for the whole launch, up to two rows a block
// to 16,384 entries and a block a row to 38,912, and past that its
// streaming instance, s and u in device memory; the arithmetic they share
// is in oco_admm.cuh.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_admm.py
// _admm_kernel, entry admm_all_prefixes_l2.  Python wrapper, prologue and
// plain PyTorch version: online_convex_optimization_tpu_torch/ops/admm.py
// (admm_all_prefixes_l2, admm_prologue, admm_all_prefixes_l2_reference).
//
// Row (b, p) solves the length-(p + 1) prefix of replicate b:
//   minimize_{||x|| <= 1}  0.5 * sum_{t <= p} |<z_t, x> - y_t|
// by the TPU kernel's splitting (s = Z x - y with a soft threshold, w = x
// with the ball projection), over-relaxed by alpha.  Per iteration:
//   rhs_j = sum_t ((y_t + s_t) - u_t) z_tj + (w_j - v_j)
//   x     = (Gram_p + I)^{-1} rhs, by multiply-only substitutions through
//           the packed Cholesky factor with inverted diagonal (the prologue,
//           ops/admm.py::admm_prologue, forms it outside the kernel)
//   r_t = <x, z_t> - y_t, r^_t = alpha r_t + (1 - alpha) s_t
//   s_t = sign(r^_t + u_t) max(|r^_t + u_t| - kappa, 0), u_t += r^_t - s_t
//   x^ = alpha x + (1 - alpha) w, w = (x^ + v) / sqrt(max(||x^ + v||^2, 1)),
//   v = (v + x^) - w.
// Every check_every iterations (tol > 0) the row computes its residual
// max(max_t |r_t - s_t|, max_j |x_j - w_j|) and stops once it is not above
// tol (a NaN residual stops it too and is reported), after at most
// ceil(iters / check_every) blocks; tol = 0 runs exactly iters iterations.
// The TPU kernel exits per 256-row VMEM block; here each row exits on its
// own residual, and the plain version applies the same per-row rule.
//
// Design.  The work of an iteration has two parts: the pass over a row's
// entries (about 4d + 13 operations each, parallel over t) and the row's
// d x d step (the rhs sum, two substitutions and the projection with its
// sqrt and d true divides: about 200 instructions, serial).  A row of
// length L keeps its entries of s and u in registers, NT a lane: NT = 8 for
// L <= kSplit and NT = 16 above, two template instances with their
// own register counts, launched one after the other (the long rows first).
// Its entries take W warps, the least power of two with W * 32 * NT >= L
// (W <= 8); chunk c of 32 entries (t = 32 c + lane) belongs to warp c % W,
// so the row's warps differ by at most one chunk.  Rows of one W form a
// class: a block of 8 warps holds 8 / W rows of one class and one replicate
// (the blocks of the longest rows first in the grid), and stages that
// replicate's y and z up to its longest row in shared memory, chunk by
// chunk (y[32], z_0[32], ..., z_{d-1}[32]), so an entry's d + 1 loads share
// one address with constant offsets.  The rows' factors and (x, w, v) live
// in shared memory too.  A warp passes over its full chunks two at a time,
// in one basic block each, so the two entries' dependency chains
// interleave; only the row's last chunk tests each lane against L.
//
// An iteration of a block: lane r of warp 0 takes row r's d x d step (the
// rows side by side in its lanes, where a warp a row would repeat it on 32
// lanes and W warps), writes x, and a barrier later every warp of the row
// reads x and passes over its entries; each warp then reduces its d
// partial sums of the next rhs by a reduce-scatter butterfly (9 shuffles
// for up to 8 sums) into the block's slots, and a second barrier hands them
// to the d x d step, which adds a row's W warp sums in warp order.  A row
// that has stopped keeps its state; its warps wait at the barriers until
// the block's last row stops.  A row's arithmetic depends on L alone, so
// its result does not depend on T, on B or on the other rows of its launch:
// a launch on z[:, :T] gives rows p < T of a launch on longer z bit for
// bit.  The pass over the entries also accumulates the next iteration's
// rhs partial sums in the order a fresh pass would, so a continued solve
// equals a longer one bit for bit.  The entries of a row past its length
// are never touched (they stay 0, as in the TPU kernel, where the mask
// keeps them so).
//
// Numerics: exact sqrt and a true divide in the projection, never rsqrt
// (pallas_admm.py:112-116: a ~1e-6 projection bias broke the polish's
// active-set identification); no tensor cores (bf16/TF32 dots stalled the
// TPU's residual at ~8e-2); --fmad=false.  Maxima propagate NaN and
// sign(NaN) = 0, as torch.maximum, amax, clamp and sign do in the plain
// version; the soft threshold is one copysign (shrink), equal in value to
// the sign times the max.
//
// What bounds it on an H100: operations.  About 4d + 13 float operations
// per active (row, t) entry per iteration; under --fmad=false each multiply
// and add issues alone, so the issue floor is the operation count over 132
// SMs x 128 lanes x 1.98 GHz, twice the bound's time at 67 TFLOP/s.  The
// state never leaves the chip while the row iterates (s and u are read and
// written once per launch).  What keeps it above that floor is the block's
// serial part of an iteration (the d x d step on one warp, the two
// barriers, the butterfly), during which the block's other warps wait.
#include "oco_admm.cuh"

namespace {

using oco_admm::Args;
using oco_admm::kLongRows;

// Rows up to this length take the NT = 8 instance, longer rows NT = 16.
// On an H100 at T = 1000, NT = 8 for every row (64 registers, 32 warps an
// SM) measured faster than NT = 16 (96 registers, 16 warps an SM); 2,048
// is the longest row NT = 8 covers with 8 warps.  A row's arithmetic
// depends on its NT, so this constant is part of what a row computes.
constexpr int kSplit = 2048;

// Resident blocks an SM that each instance asks ptxas to fit.
constexpr int min_blocks(int D, int NT) {
  return D > 0 ? (NT == 8 ? 4 : 2) : (NT == 8 ? 2 : 1);
}

// Row groups of a launch over the rows with L_lo < L <= L_hi, longest
// first: class W = 8, 4, 2, 1 holds the rows whose length needs W warps of
// 32 NT entries, 8 / W rows a group.  Sets group g's W and the lengths
// (bot, top] of its rows; returns the number of groups.
__host__ __device__ inline int row_groups(int g, int L_lo, int L_hi, int NT,
                                          int* W_out, int* top, int* bot) {
  int count = 0;
  for (int W = OCO_ADMM_WARPS; W >= 1; W >>= 1) {
    const int hi = L_hi < 32 * NT * W ? L_hi : 32 * NT * W;
    const int lo_w = W == 1 ? 0 : 16 * NT * W;
    const int lo = L_lo > lo_w ? L_lo : lo_w;
    if (hi <= lo) continue;
    const int R = OCO_ADMM_WARPS / W;
    const int n = (hi - lo + R - 1) / R;
    if (g >= count && g < count + n) {
      *W_out = W;
      *top = hi - (g - count) * R;
      *bot = *top - R > lo ? *top - R : lo;
    }
    count += n;
  }
  return count;
}

// An entry of the staged replicate: y at e[0], z_j at e[32 (j + 1)].
template <int D>
__device__ __forceinline__ void load_entry(const float* e, int n, float* zt) {
#pragma unroll
  for (int j = 0; j < Dim<D>::cap; ++j)
    if (j < n) zt[j] = e[32 * (j + 1)];
}

template <int K>
using Chunk = std::integral_constant<int, K>;

// Calls f(Chunk<k>(), full) for this warp's chunks k in order: the nfull
// full ones two to a basic block (so their dependency chains interleave),
// then the row's partial last chunk with full = false when the warp holds
// it.  k is a compile-time constant, so s[k] and u[k] stay in registers.
template <int K, int NT, typename F>
__device__ __forceinline__ void each_chunk(int nfull, bool partial, F&& f) {
  if constexpr (K < NT) {
    if (K + 2 <= nfull) {
      f(Chunk<K>(), true);
      f(Chunk<K + 1>(), true);
      each_chunk<K + 2, NT>(nfull, partial, f);
    } else if (K < nfull) {
      f(Chunk<K>(), true);
      if (partial) f(Chunk<K + 1>(), false);
    } else if (partial) {
      f(Chunk<K>(), false);
    }
  }
}

template <int D, int NT>
__global__ void __launch_bounds__(kThreads, min_blocks(D, NT))
admm_kernel(const float* __restrict__ z, const float* __restrict__ y,
            const float* __restrict__ Lpk, const float* __restrict__ s0,
            const float* __restrict__ u0, const float* __restrict__ x0,
            const float* __restrict__ w0, const float* __restrict__ v0,
            int B, int T, int d, int L_lo, int L_hi, int iters,
            int check_every, float tol, float kappa, float alpha, float beta,
            float* __restrict__ s_out, float* __restrict__ u_out,
            float* __restrict__ x_out, float* __restrict__ w_out,
            float* __restrict__ v_out, float* __restrict__ res_out) {
  constexpr int C = Dim<D>::cap;
  extern __shared__ float zs[];   // y and z chunk by chunk (load_entry)
  __shared__ Rows<D> S;
  const int n = D > 0 ? D : d;
  const int ntri = n * (n + 1) / 2;
  const int b = blockIdx.x % B;
  int W = 1, top = 0, bot = 0;
  row_groups(blockIdx.x / B, L_lo, L_hi, NT, &W, &top, &bot);
  const int rows = top - bot;
  // Row slot r is prefix p = top - 1 - r of replicate b.
  const long long row0 = static_cast<long long>(b) * T + top - 1;

  const float* zb = z + static_cast<long long>(b) * T * n;
  for (int i = threadIdx.x; i < top * n; i += kThreads) {
    const int t = i / n;
    zs[(t >> 5) * ((n + 1) * 32) + 32 * (i - t * n + 1) + (t & 31)] = zb[i];
  }
  for (int t = threadIdx.x; t < top; t += kThreads)
    zs[(t >> 5) * ((n + 1) * 32) + (t & 31)] =
        y[static_cast<long long>(b) * T + t];
  for (int i = threadIdx.x; i < rows * ntri; i += kThreads) {
    const int r = i / ntri;
    S.L[r][i - r * ntri] = Lpk[(row0 - r) * ntri + i - r * ntri];
  }
  for (int i = threadIdx.x; i < rows * n; i += kThreads) {
    const int r = i / n, j = i - r * n;
    const long long at = (row0 - r) * n + j;
    S.x[r][j] = x0 != nullptr ? x0[at] : 0.f;
    S.w[r][j] = x0 != nullptr ? w0[at] : 0.f;
    S.v[r][j] = x0 != nullptr ? v0[at] : 0.f;
  }
  if (threadIdx.x < OCO_ADMM_WARPS) S.live[threadIdx.x] = threadIdx.x < rows;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = warp / W;        // the warp's row in the block
  const int wr = warp - slot * W;   // the warp's place in its row
  const bool mine = slot < rows;    // the warp has a row
  const int L = top - slot;
  const long long row = row0 - slot;
  // This warp's chunks c = k W + wr: the first nfull are full, the next is
  // the row's partial last chunk when `partial`; chunk k's entry of this
  // lane is at first + k * kstep.
  const int nfull = (L >> 5) > wr ? ((L >> 5) - wr + W - 1) / W : 0;
  const bool partial = (L & 31) != 0 && wr + nfull * W == (L >> 5);
  const float* first = zs + wr * ((n + 1) * 32) + lane;
  const int kstep = W * ((n + 1) * 32);

  float s[NT], u[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int t = (k * W + wr) * 32 + lane;
    const bool in = mine && s0 != nullptr && t < L;
    s[k] = in ? s0[row * T + t] : 0.f;
    u[k] = in ? u0[row * T + t] : 0.f;
  }
  __syncthreads();

  // Reduces this warp's partial sums of rhs into its slot.
  const auto publish = [&](const float (&acc)[C]) {
    float p8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p8[j] = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) p8[j] = acc[j];   // 0 past n
    const float e = reduce_scatter8(p8, lane);
    if ((lane & 3) == 0 && (lane >> 2) < n) S.part[warp][lane >> 2] = e;
  };

  // The rhs partial sums of the initial state.
  if (mine) {
    float acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = 0.f;
    each_chunk<0, NT>(nfull, partial, [&](auto kc, bool full) {
      constexpr int k = decltype(kc)::value;
      if (full || (k * W + wr) * 32 + lane < L) {
        const float* e = first + k * kstep;
        float zt[C];
        load_entry<D>(e, n, zt);
        const float ysu = (e[0] + s[k]) - u[k];
#pragma unroll
        for (int j = 0; j < C; ++j)
          if (j < n) acc[j] = acc[j] + ysu * zt[j];
      }
    });
    publish(acc);
  }
  __syncthreads();

  // Every row's residual max(max_t |r_t - s_t|, max_j |x_j - w_j|) into
  // S.res; with `stop`, rows whose residual is not above tol stop.
  // Returns whether a row of the block still iterates.
  const auto residuals = [&](bool stop) {
    if (mine && S.live[slot]) {
      float x[C];
#pragma unroll
      for (int j = 0; j < C; ++j) x[j] = j < n ? S.x[slot][j] : 0.f;
      float pri = 0.f;
      each_chunk<0, NT>(nfull, partial, [&](auto kc, bool full) {
        constexpr int k = decltype(kc)::value;
        if (full || (k * W + wr) * 32 + lane < L) {
          const float* e = first + k * kstep;
          float zt[C];
          load_entry<D>(e, n, zt);
          pri = nan_max(pri, fabsf((predict<D>(x, zt, n) - e[0]) - s[k]));
        }
      });
      pri = warp_max(pri);
      if (lane == 0) S.pri[warp] = pri;
    }
    __syncthreads();
    if (warp == 0 && lane < rows && S.live[lane]) {
      float res = S.pri[lane * W];
      for (int i = 1; i < W; ++i) res = nan_max(res, S.pri[lane * W + i]);
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (j < n) res = nan_max(res, fabsf(S.x[lane][j] - S.w[lane][j]));
      S.res[lane] = res;
      if (stop && !(res > tol)) S.live[lane] = 0;
    }
    __syncthreads();
    int any = 0;
    for (int r = 0; r < rows; ++r) any |= S.live[r];
    return any != 0;
  };

  const bool checked = tol > 0.f;
  const int n_blocks = checked ? (iters + check_every - 1) / check_every
                               : (iters > 0 ? 1 : 0);
  const int per_block = checked ? check_every : iters;
  bool fresh = false;   // S.res holds the residuals of the current state
  for (int blk = 0; blk < n_blocks; ++blk) {
    for (int it = 0; it < per_block; ++it) {
      if (warp == 0 && lane < rows && S.live[lane])
        row_step<D>(S, lane, W, n, alpha, beta);
      __syncthreads();
      // Residual split: soft threshold, dual update, next rhs partials.
      if (mine && S.live[slot]) {
        float x[C], acc[C];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          x[j] = j < n ? S.x[slot][j] : 0.f;
          acc[j] = 0.f;
        }
        each_chunk<0, NT>(nfull, partial, [&](auto kc, bool full) {
          constexpr int k = decltype(kc)::value;
          if (full || (k * W + wr) * 32 + lane < L) {
            const float* e = first + k * kstep;
            float zt[C];
            load_entry<D>(e, n, zt);
            const float yt = e[0];
            const float r = predict<D>(x, zt, n) - yt;
            const float rh = alpha * r + beta * s[k];
            const float sp = rh + u[k];
            const float sn = shrink(sp, kappa);
            u[k] = (u[k] + rh) - sn;
            s[k] = sn;
            const float ysu = (yt + sn) - u[k];
#pragma unroll
            for (int j = 0; j < C; ++j)
              if (j < n) acc[j] = acc[j] + ysu * zt[j];
          }
        });
        publish(acc);
      }
      __syncthreads();
    }
    if (checked) {
      fresh = true;
      if (!residuals(true)) break;
    }
  }
  if (!fresh) residuals(false);

  if (mine) {
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const int t = (k * W + wr) * 32 + lane;
      if (t < L) {
        s_out[row * T + t] = s[k];
        u_out[row * T + t] = u[k];
      }
    }
    for (int t = L + wr * 32 + lane; t < T; t += 32 * W) {
      s_out[row * T + t] = 0.f;
      u_out[row * T + t] = 0.f;
    }
  }
  for (int i = threadIdx.x; i < rows * n; i += kThreads) {
    const int r = i / n, j = i - r * n;
    const long long at = (row0 - r) * n + j;
    x_out[at] = S.x[r][j];
    w_out[at] = S.w[r][j];
    v_out[at] = S.v[r][j];
  }
  if (threadIdx.x < rows) res_out[row0 - threadIdx.x] = S.res[threadIdx.x];
}

// Dynamic shared memory of an instance whose longest row has length L_hi
// (whole chunks of d + 1 floats an entry); opts the instance in to it.
template <int D, int NT>
int prepare(int d, int L_hi, size_t* smem) {
  *smem = static_cast<size_t>(d + 1) * 32 * ((L_hi + 31) / 32) *
          sizeof(float);
  return static_cast<int>(cudaFuncSetAttribute(
      admm_kernel<D, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem)));
}

// Launches the rows with L_lo < L <= L_hi of every replicate (no launch
// where there are none); adds its launch to launched[0].
template <int D, int NT>
int launch_rows(const Args& a, int L_lo, int L_hi, cudaStream_t stream,
                int* launched) {
  if (L_hi <= L_lo) return cudaSuccess;
  int W, top, bot;
  const int groups = row_groups(-1, L_lo, L_hi, NT, &W, &top, &bot);
  if (static_cast<long long>(groups) * a.B > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  size_t smem;
  const int err = prepare<D, NT>(a.d, L_hi, &smem);
  if (err != cudaSuccess) return err;
  admm_kernel<D, NT><<<groups * a.B, kThreads, smem, stream>>>(
      a.z, a.y, a.Lpk, a.s0, a.u0, a.x0, a.w0, a.v0, a.B, a.T, a.d, L_lo,
      L_hi, a.iters, a.check_every, a.tol, a.kappa, a.alpha, a.beta, a.s,
      a.u, a.x, a.w, a.v, a.res);
  const int launch_err = static_cast<int>(cudaGetLastError());
  if (launch_err == cudaSuccess) ++launched[0];
  return launch_err;
}

// The long rows first, then the NT = 16 rows, then the NT = 8 ones.
template <int D>
int launch_d(const Args& a, cudaStream_t stream, int* launched) {
  int err = oco_admm::launch_long(a, stream, launched);
  if (err != cudaSuccess) return err;
  const int hi = a.T < kLongRows ? a.T : kLongRows;
  const int split = hi < kSplit ? hi : kSplit;
  err = launch_rows<D, 16>(a, split, hi, stream, launched);
  if (err != cudaSuccess) return err;
  return launch_rows<D, 8>(a, 0, split, stream, launched);
}

// Registers a thread and resident warps an SM of one instance.
template <int D, int NT>
int occupancy(int d, int L_hi, int* out) {
  size_t smem;
  int err = prepare<D, NT>(d, L_hi, &smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = static_cast<int>(cudaFuncGetAttributes(&attr, admm_kernel<D, NT>));
  int blocks = 0;
  if (err == cudaSuccess)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, admm_kernel<D, NT>, kThreads, smem));
  out[0] = err == cudaSuccess ? attr.numRegs : 0;
  out[1] = blocks * OCO_ADMM_WARPS;
  return err;
}

}  // namespace

// Inputs: z (B, T, d) and y (B, T) float32; Lpk (B*T, d(d+1)/2) the packed
// lower Cholesky factors of Gram_p + I with inverted diagonal, row b*T + p
// for the length-(p+1) prefix; the state s0, u0 (B*T, T) and x0, w0, v0
// (B*T, d), all five null for the zero state.  Outputs: the state after the
// solve, s, u (B*T, T) (zero past each row's length) and x, w, v (B*T, d),
// and res (B*T) the final residuals; launched[0] the number of kernels
// launched (1; 2 for T > 2048: the NT = 16 rows, then the NT = 8 ones; 3
// for T > 4096: the long rows first; 4 for T > 8192: K10l's resident
// shapes; 5 for T > 16384: its one-row block too; 6 for T > 38912: its
// streaming instance too), launched[1] the launches of K10l among them,
// launched[2] those of its shapes of four and two rows a block (0, 1 or
// 2), launched[3] those of its shape for rows of 8,193 to 16,384 entries
// (0 or 1), launched[4] those of its one-row block (rows of 16,385 to
// 38,912; 0 or 1) and launched[5] a probe build's clusters (0 here).  1 <=
// d <= 8, T >= 1, check_every >= 1.  Returns the cudaError_t of the
// launches.
extern "C" int oco_admm_all_prefixes_f32(
    const void* z, const void* y, const void* Lpk, const void* s0,
    const void* u0, const void* x0, const void* w0, const void* v0, int B,
    int T, int d, int iters, int check_every, float tol, float kappa,
    float alpha, float beta, void* s, void* u, void* x, void* w, void* v,
    void* res, void* stream, int* launched) {
  for (int k = 0; k < 6; ++k) launched[k] = 0;
  if (B < 1 || T < 1 || d < 1 || d > OCO_ADMM_MAX_D || iters < 0 ||
      check_every < 1)
    return cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto g = [](void* p) { return static_cast<float*>(p); };
  const Args a{f(z), f(y), f(Lpk), f(s0), f(u0), f(x0), f(w0), f(v0),
               B, T, d, iters, check_every, tol, kappa, alpha, beta,
               g(s), g(u), g(x), g(w), g(v), g(res)};
  const auto st = static_cast<cudaStream_t>(stream);
  return d == 5 ? launch_d<5>(a, st, launched)
                : launch_d<0>(a, st, launched);
}

// For a launch at T with feature dimension d: out[0], out[1] the registers
// a thread and resident warps an SM of the NT = 8 instance (rows up to
// kSplit), out[2], out[3] those of the NT = 16 instance, out[4], out[5]
// those of K10l's resident shape of rows up to 8,192 entries, out[6],
// out[7] of rows up to 16,384, out[8], out[9] of its one-row block (rows
// up to 38,912) and out[10], out[11] of its streaming instance (longer
// rows), 0 warps where T needs none of an instance's rows.  Returns a
// cudaError_t.
extern "C" int oco_admm_occupancy_f32(int d, int T, int* out) {
  if (T < 1 || d < 1 || d > OCO_ADMM_MAX_D) return cudaErrorInvalidValue;
  const int hi = T < kLongRows ? T : kLongRows;
  const int split = hi < kSplit ? hi : kSplit;
  int err = d == 5 ? occupancy<5, 8>(d, split, out)
                   : occupancy<0, 8>(d, split, out);
  if (err != cudaSuccess) return err;
  err = d == 5 ? occupancy<5, 16>(d, hi, out + 2)
               : occupancy<0, 16>(d, hi, out + 2);
  if (hi <= split) out[3] = 0;
  if (err != cudaSuccess) return err;
  return oco_admm::occupancy_long(d, T, out + 4);
}
