// K10l: K10's long-row instances, for the (replicate, prefix) rows longer
// than kLongRows entries.  Replaces the TPU kernel
// online_convex_optimization_tpu/ops/pallas_admm.py _admm_kernel on those
// rows (entry admm_all_prefixes_l2); the register instances of
// admm_kernel.cu take the shorter rows, and its C entry launches these
// first.  Python wrapper and plain version:
// online_convex_optimization_tpu_torch/ops/admm.py.
//
// Long rows.  A row of the two register instances holds at most 8 warps x
// 32 lanes x 16 entries of s and u (kLongRows = 4,096), and its
// replicate's z and y are staged in shared memory (147 KB at d = 8).  The
// TPU kernel has no such limit (it pads T to 128 and takes any T).  Every
// long row is split alike: thread i of 256 takes entries t = i, i + 256,
// i + 512, ... in increasing order, fuses the next rhs partial sums into
// its pass in the order a fresh pass takes, and each warp reduces them by
// the register instances' reduce-scatter (publish), summed in warp order by
// the d x d step (row_step) with the same barriers and residual exit.  So a
// long row's bits depend on its length alone, whichever instance takes it.
//
// The resident instance (admm_resident_kernel), rows of up to
// kResidentRows = 8,192 entries: a block holds R = 4 rows of one replicate
// (lengths top, top - 1, ...; the longest rows' blocks first) and keeps
// their s and u on the chip for the whole launch, read from s0, u0 once
// and written to s, u once.  Its 512 threads are two groups of 256, each
// taking two of the rows, 32 entries a thread a row: of a thread's 64
// entries of s and u, the first 16 live in registers and the other 48 in
// shared memory (192 KB a block).  y_t and z_t come once for all four rows
// from a ring of entries in the remaining shared memory (5 stages at d =
// 5, 3 at d = 8), which thread i of the first group fills by cp.async
// stages - 1 entries ahead in its cyclic order of entries; thread i of the
// second group reads the same stage, the two warps meeting at a named
// barrier once an entry.  So the next pass's first entries are in flight
// during the barriers and the d x d steps.  The four rows' d x d steps
// run side by side on lanes 0-3 of warp 0.  A row that stops (tol > 0)
// keeps its state and waits at the barriers until the block's last row
// stops.
//
// The streaming instance (admm_long_kernel), rows longer than that: a
// block of 8 warps a row, longest first.  Its s and u stay in the (B*T, T)
// state arrays the launch reads and writes: each iteration streams the
// row's entries once (kLongUnroll of a thread's entries loaded before any
// is stored), reading s, u, z_t and y_t and writing s and u.
//
// What bounds K10l on an H100: operations, about 4d + 13 an entry an
// iteration (issued one by one under --fmad=false, so twice their time at
// 67 TFLOP/s).  The streaming instance moves 16 bytes of state an entry an
// iteration besides, which its blocks' rows (~34 MB at T = 8,192) keep
// mostly in L2; the resident instance moves none, and y and z once a block
// of four rows an iteration (6 bytes an entry at d = 5, from L2).  Its
// block is alone on its SM (16 warps), where the issue of the passes'
// arithmetic and shared-memory accesses binds (PERF.md gives the split).
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
                                          SplitClock& clk, F&& f) {
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
    clk.wait_for(s[0] + u[0] + yt[0] + zt[0][0]);
    clk.mark(kAdmmLoad);
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int t = t0 + k * kThreads;
      if (t < L) f(t, s[k], u[k], zt[k], yt[k]);
    }
    clk.mark(kAdmmArith);
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
  SplitClock clk(0);

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
                 u0 != nullptr ? u0 + row * T : nullptr, L, n, clk,
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
  clk.mark(kAdmmOther);

  // The row's residual max(max_t |r_t - s_t|, max_j |x_j - w_j|) into
  // S.res[0]; with `stop`, the row stops once it is not above tol.
  // Returns whether the row still iterates.
  const auto residuals = [&](bool stop) {
    if (S.live[0]) {
      float x[C];
#pragma unroll
      for (int j = 0; j < C; ++j) x[j] = j < n ? S.x[0][j] : 0.f;
      float pri = 0.f;
      long_pass<D>(zb, yb, srow, nullptr, L, n, clk,
                   [&](int, float s, float, const float* zt, float yt) {
                     pri = nan_max(pri,
                                   fabsf((predict<D>(x, zt, n) - yt) - s));
                   });
      pri = warp_max(pri);
      if (lane == 0) S.pri[warp] = pri;
    }
    __syncthreads();
    clk.mark(kAdmmPublish);
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
    clk.mark(kAdmmOther);
    return S.live[0] != 0;
  };

  const bool checked = tol > 0.f;
  const int n_blocks = checked ? (iters + check_every - 1) / check_every
                               : (iters > 0 ? 1 : 0);
  const int per_block = checked ? check_every : iters;
  bool fresh = false;   // S.res holds the residual of the current state
  for (int blk = 0; blk < n_blocks; ++blk) {
    for (int it = 0; it < per_block; ++it) {
      if (threadIdx.x == 0) {
        const long long t0 = clk.now();
        row_step<D>(S, 0, OCO_ADMM_WARPS, n, alpha, beta);
        clk.span(kAdmmChain, t0);
      }
      __syncthreads();
      clk.mark(kAdmmStep);
      float x[C], acc[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        x[j] = j < n ? S.x[0][j] : 0.f;
        acc[j] = 0.f;
      }
      long_pass<D>(zb, yb, srow, urow, L, n, clk,
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
      clk.mark(kAdmmPublish);
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
  clk.mark(kAdmmOther);
  clk.flush();
}

// ----------------------------------------------------- the resident instance
// Rows up to this length take the resident instance: kResidentM entries
// of s and u a thread a row, on the chip for the whole launch.
constexpr int kResidentRows = 8192;
constexpr int kResidentM = kResidentRows / kThreads;

// The resident block's shape.  G = 2 groups of kThreads threads, each
// group holding RG = 2 of the block's R = 4 row slots (group g the slots g
// RG .. g RG + RG - 1); thread i of a group takes entry t = i + kThreads m
// of each of its rows.  Of a thread's RG x kResidentM entries of s and u
// (row-major: its first row's entries, then the next row's), the first QR
// = 16 live in registers and the rest in shared memory
// (oco_admm_resident_plan reports the shape).
template <int D>
struct Resident {
  static constexpr int G = 2;
  static constexpr int RG = 2;
  static constexpr int QR = 16;
  static constexpr int R = G * RG;
  static constexpr int threads = G * kThreads;
  static constexpr int C = Dim<D>::cap;
  using RowsT = Rows<D, R, R * OCO_ADMM_WARPS>;
  // Shared memory a block may take on an H100 (227 KB), less the rows'
  // statics, the s and u entries past QR and a margin; the rest is the
  // ring, whose stage is one entry (y and z) of every thread of a group.
  static constexpr int kBlockSmem = 232448;
  static constexpr int kStateBytes =
      (RG * kResidentM - QR) * 2 * threads * 4;
  static constexpr int kStageBytes = (C + 1) * kThreads * 4;
  static constexpr int kFree =
      kBlockSmem - static_cast<int>(sizeof(RowsT)) - kStateBytes - 256;
  static constexpr int stages = kFree / kStageBytes > 8 ? 8
                                                        : kFree / kStageBytes;
  static_assert(stages >= 2, "the resident rows leave no room for a ring");
  static_assert(QR > 0 && QR <= RG * kResidentM, "QR out of range");
  static constexpr int smem = kStateBytes + stages * kStageBytes;
};

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

// Calls f(Int<r>()) for r = K .. R - 1 in order.
template <int K, int R, typename F>
__device__ __forceinline__ void each_row(F&& f) {
  if constexpr (K < R) {
    f(Int<K>());
    each_row<K + 1, R>(f);
  }
}

// Whether entry m lies inside every row of a resident block: the block's
// rows are longer than kLongRows, so each thread's entries t = i +
// kThreads m < kLongRows, m < kLongRows / kThreads, belong to all of them.
__device__ __forceinline__ constexpr bool inside_every_row(int m) {
  return m < kLongRows / kThreads;
}

// Waits at named barrier id with count threads (a whole number of warps,
// every lane of which arrives).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// K10l's resident instance: R rows of one replicate a block, of lengths
// top, top - 1, ..., down to L_lo + 1 (the blocks of the longest rows
// first, B replicates interleaved).  Thread i of group g takes entries t =
// i + kThreads m of each of the group's rows, in increasing m (the
// streaming instance's map), keeping their s and u in registers (its first
// QR entries) or in shared memory, and reads y_t and z_t once for all of
// them from a ring of entries in shared memory, which thread i of group 0
// fills by cp.async stages - 1 entries ahead; the G threads i of the
// groups (warps w, w + 8) meet at named barrier 1 + w once an entry.
template <int D>
__global__ void __launch_bounds__(Resident<D>::threads, 1)
admm_resident_kernel(const float* __restrict__ z, const float* __restrict__ y,
                     const float* __restrict__ Lpk,
                     const float* __restrict__ s0,
                     const float* __restrict__ u0,
                     const float* __restrict__ x0,
                     const float* __restrict__ w0,
                     const float* __restrict__ v0, int B, int T, int d,
                     int L_lo, int L_hi, int iters, int check_every,
                     float tol, float kappa, float alpha, float beta,
                     float* __restrict__ s_out, float* __restrict__ u_out,
                     float* __restrict__ x_out, float* __restrict__ w_out,
                     float* __restrict__ v_out, float* __restrict__ res_out) {
  using P = Resident<D>;
  constexpr int C = P::C, G = P::G, RG = P::RG, QR = P::QR, M = kResidentM;
  constexpr int NS = P::stages, NT = P::threads;
  extern __shared__ float dyn[];
  float* const ss = dyn;                    // [RG M - QR][NT]
  float* const us = dyn + (RG * M - QR) * NT;
  float* const ring = dyn + 2 * (RG * M - QR) * NT;  // [NS][C + 1][kThreads]
  __shared__ typename P::RowsT S;
  const int n = D > 0 ? D : d;
  const int ntri = n * (n + 1) / 2;
  const int b = blockIdx.x % B;
  const int top = L_hi - static_cast<int>(blockIdx.x / B) * P::R;
  const int rows = top - L_lo < P::R ? top - L_lo : P::R;
  // Row slot r is prefix p = top - 1 - r of replicate b (length top - r).
  const long long row0 = static_cast<long long>(b) * T + top - 1;
  const int tid = threadIdx.x;
  const int i = tid & (kThreads - 1);       // the thread within its group
  const int g = tid / kThreads;             // its group: slots g RG ..
  const int warp = tid >> 5;
  const int wg = warp & (OCO_ADMM_WARPS - 1);   // its warp within the group
  const int lane = tid & 31;
  const float* zb = z + static_cast<long long>(b) * T * n;
  const float* yb = y + static_cast<long long>(b) * T;
  // This thread's entries of the longest row, m < mt (mt >= 16 > NS): those
  // of its warp's lane 0, so that the G warps that share a ring's entries
  // pass the same barriers.
  const int mt = (top - (i - lane) + kThreads - 1) / kThreads;
  SplitClock clk(1);

  for (int k = tid; k < rows * ntri; k += NT) {
    const int r = k / ntri;
    S.L[r][k - r * ntri] = Lpk[(row0 - r) * ntri + k - r * ntri];
  }
  for (int k = tid; k < rows * n; k += NT) {
    const int r = k / n, j = k - r * n;
    const long long at = (row0 - r) * n + j;
    S.x[r][j] = x0 != nullptr ? x0[at] : 0.f;
    S.w[r][j] = x0 != nullptr ? w0[at] : 0.f;
    S.v[r][j] = x0 != nullptr ? v0[at] : 0.f;
  }
  if (tid < P::R) S.live[tid] = tid < rows;

  // The ring: entry m of thread i goes to stage `slot`; the entries are
  // consumed m = 0 .. mt - 1 in every pass, and fetched stages - 1 ahead
  // in that cyclic order (so the next pass's first entries are in flight
  // during the barriers and the d x d steps).  Group 0 copies (an entry
  // past the longest row is not copied, and no row reads it).
  const auto fetch = [&](int m, int slot) {
    const int t = i + kThreads * m;
    float* dst = ring + slot * (C + 1) * kThreads + i;
    if (t < top) {
      copy4_async(dst, yb + t);
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (j < n)
          copy4_async(dst + (j + 1) * kThreads,
                      zb + static_cast<long long>(t) * n + j);
    }
    commit_copies();
  };
  if (g == 0) {
#pragma unroll
    for (int k = 0; k < NS - 1; ++k) fetch(k, k);
  }
  int next_m = NS - 1, next_slot = NS - 1, slot = 0;
  const auto entry = [&](float& yt, float (&zt)[C]) {
    clk.mark(kAdmmArith);
    // Entry m landed (group 0), and every group read entry m - 1's stage,
    // which the fetch after the barrier refills.
    if (g == 0) wait_copies<NS - 2>();
    bar_sync(1 + wg, G * kThreads / OCO_ADMM_WARPS);
    if (g == 0) fetch(next_m, next_slot);
    next_m = next_m + 1 == mt ? 0 : next_m + 1;
    next_slot = next_slot + 1 == NS ? 0 : next_slot + 1;
    clk.mark(kAdmmLoad);
    const float* e = ring + slot * (C + 1) * kThreads + i;
    yt = e[0];
#pragma unroll
    for (int j = 0; j < C; ++j) zt[j] = j < n ? e[(j + 1) * kThreads] : 0.f;
    slot = slot + 1 == NS ? 0 : slot + 1;
  };

  float sreg[QR], ureg[QR];
  // The s_t and u_t of this thread's row k (slot g RG + k), entry m.
  const auto s_at = [&](auto kc, auto mc) -> float& {
    constexpr int q = decltype(kc)::value * M + decltype(mc)::value;
    if constexpr (q < QR) return sreg[q];
    else return ss[(q - QR) * NT + tid];
  };
  const auto u_at = [&](auto kc, auto mc) -> float& {
    constexpr int q = decltype(kc)::value * M + decltype(mc)::value;
    if constexpr (q < QR) return ureg[q];
    else return us[(q - QR) * NT + tid];
  };

  // Reduces this warp's partial sums of row r's rhs into its slot.
  const auto publish = [&](int r, const float (&acc)[C]) {
    float p8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p8[j] = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) p8[j] = acc[j];   // 0 past n
    const float e = reduce_scatter8(p8, lane);
    if ((lane & 3) == 0 && (lane >> 2) < n)
      S.part[r * OCO_ADMM_WARPS + wg][lane >> 2] = e;
  };
  __syncthreads();
  clk.mark(kAdmmOther);

  // The state from s0 and u0 (zeros without them), and the rhs partial
  // sums of the initial state.
  {
    float acc[RG][C];
#pragma unroll
    for (int k = 0; k < RG; ++k)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[k][j] = 0.f;
    each_entry<0, M>(mt, [&](auto mc) {
      const int t = i + kThreads * decltype(mc)::value;
      float yt, zt[C];
      entry(yt, zt);
      each_row<0, RG>([&](auto kc) {
        constexpr int k = decltype(kc)::value;
        const int r = g * RG + k;
        const bool in = r < rows && t < top - r;
        const long long at = (row0 - r) * T + t;
        const float s = in && s0 != nullptr ? s0[at] : 0.f;
        const float u = in && u0 != nullptr ? u0[at] : 0.f;
        s_at(kc, mc) = s;
        u_at(kc, mc) = u;
        if (in) {
          const float ysu = (yt + s) - u;
#pragma unroll
          for (int j = 0; j < C; ++j)
            if (j < n) acc[k][j] = acc[k][j] + ysu * zt[j];
        }
      });
    });
    clk.mark(kAdmmArith);
#pragma unroll
    for (int k = 0; k < RG; ++k)
      if (g * RG + k < rows) publish(g * RG + k, acc[k]);
  }
  __syncthreads();
  clk.mark(kAdmmOther);

  // Each live row's residual max(max_t |r_t - s_t|, max_j |x_j - w_j|)
  // into S.res; with `stop`, rows whose residual is not above tol stop.
  // Returns whether a row of the block still iterates.
  const auto residuals = [&](bool stop) {
    unsigned go = 0;
    float x[RG][C], pri[RG];
#pragma unroll
    for (int k = 0; k < RG; ++k) {
      const int r = g * RG + k;
      if (r < rows && S.live[r]) go |= 1u << k;
      pri[k] = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) x[k][j] = j < n ? S.x[r][j] : 0.f;
    }
    each_entry<0, M>(mt, [&](auto mc) {
      const int t = i + kThreads * decltype(mc)::value;
      float yt, zt[C];
      entry(yt, zt);
      each_row<0, RG>([&](auto kc) {
        constexpr int k = decltype(kc)::value;
        const float e =
            fabsf((predict<D>(x[k], zt, n) - yt) - s_at(kc, mc));
        // A stopped row's maximum is not published.
        if constexpr (inside_every_row(decltype(mc)::value)) {
          pri[k] = nan_max(pri[k], e);
        } else {
          const bool ok = ((go >> k) & 1) && t < top - (g * RG + k);
          pri[k] = ok ? nan_max(pri[k], e) : pri[k];
        }
      });
    });
    clk.mark(kAdmmArith);
#pragma unroll
    for (int k = 0; k < RG; ++k) {
      if ((go >> k) & 1) {
        const float p = warp_max(pri[k]);
        if (lane == 0) S.pri[(g * RG + k) * OCO_ADMM_WARPS + wg] = p;
      }
    }
    __syncthreads();
    clk.mark(kAdmmPublish);
    if (warp == 0 && lane < rows && S.live[lane]) {
      float res = S.pri[lane * OCO_ADMM_WARPS];
      for (int k = 1; k < OCO_ADMM_WARPS; ++k)
        res = nan_max(res, S.pri[lane * OCO_ADMM_WARPS + k]);
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (j < n) res = nan_max(res, fabsf(S.x[lane][j] - S.w[lane][j]));
      S.res[lane] = res;
      if (stop && !(res > tol)) S.live[lane] = 0;
    }
    __syncthreads();
    clk.mark(kAdmmOther);
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
      if (warp == 0 && lane < rows && S.live[lane]) {
        const long long t0 = clk.now();
        row_step<D>(S, lane, OCO_ADMM_WARPS, n, alpha, beta);
        clk.span(kAdmmChain, t0);
      }
      __syncthreads();
      clk.mark(kAdmmStep);
      // Residual split: soft threshold, dual update, next rhs partials.
      unsigned go = 0;
      float x[RG][C], acc[RG][C];
#pragma unroll
      for (int k = 0; k < RG; ++k) {
        const int r = g * RG + k;
        if (r < rows && S.live[r]) go |= 1u << k;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          x[k][j] = j < n ? S.x[r][j] : 0.f;
          acc[k][j] = 0.f;
        }
      }
      each_entry<0, M>(mt, [&](auto mc) {
        const int t = i + kThreads * decltype(mc)::value;
        float yt, zt[C];
        entry(yt, zt);
        each_row<0, RG>([&](auto kc) {
          constexpr int k = decltype(kc)::value;
          // Selects, not a branch, keep the entry's rows in one basic
          // block, so their chains interleave.  Inside every row only a
          // stopped row's state needs one: its sums are not published.
          constexpr bool inside = inside_every_row(decltype(mc)::value);
          const bool ok = ((go >> k) & 1) &&
                          (inside || t < top - (g * RG + k));
          float& s = s_at(kc, mc);
          float& u = u_at(kc, mc);
          const float so = s, uo = u;
          const float rr = predict<D>(x[k], zt, n) - yt;
          const float rh = alpha * rr + beta * so;
          const float sp = rh + uo;
          const float sn = shrink(sp, kappa);
          const float un = (uo + rh) - sn;
          s = ok ? sn : so;
          u = ok ? un : uo;
          const float ysu = (yt + sn) - un;
#pragma unroll
          for (int j = 0; j < C; ++j) {
            if (j < n) {
              const float aj = acc[k][j] + ysu * zt[j];
              acc[k][j] = inside || ok ? aj : acc[k][j];
            }
          }
        });
      });
      clk.mark(kAdmmArith);
#pragma unroll
      for (int k = 0; k < RG; ++k)
        if ((go >> k) & 1) publish(g * RG + k, acc[k]);
      __syncthreads();
      clk.mark(kAdmmPublish);
    }
    if (checked) {
      fresh = true;
      if (!residuals(true)) break;
    }
  }
  if (!fresh) residuals(false);
  wait_copies<0>();   // the ring's fetches for a pass that does not come

  each_entry<0, M>(mt, [&](auto mc) {
    const int t = i + kThreads * decltype(mc)::value;
    each_row<0, RG>([&](auto kc) {
      constexpr int k = decltype(kc)::value;
      const int r = g * RG + k;
      if (r < rows && t < top - r) {
        s_out[(row0 - r) * T + t] = s_at(kc, mc);
        u_out[(row0 - r) * T + t] = u_at(kc, mc);
      }
    });
  });
  for (int r = 0; r < rows; ++r) {
    for (int t = top - r + tid; t < T; t += NT) {
      s_out[(row0 - r) * T + t] = 0.f;
      u_out[(row0 - r) * T + t] = 0.f;
    }
  }
  for (int k = tid; k < rows * n; k += NT) {
    const int r = k / n, j = k - r * n;
    const long long at = (row0 - r) * n + j;
    x_out[at] = S.x[r][j];
    w_out[at] = S.w[r][j];
    v_out[at] = S.v[r][j];
  }
  if (tid < rows) res_out[row0 - tid] = S.res[tid];
  clk.mark(kAdmmOther);
  clk.flush();
}

// The longest row the resident instance takes in this process: a probe
// build told to (oco_admm_split_route) leaves every long row to the
// streaming instance.
#ifdef OCO_ADMM_SPLIT
int g_resident_rows = kResidentRows;
int resident_rows() { return g_resident_rows; }
#else
constexpr int resident_rows() { return kResidentRows; }
#endif

// Launches the streaming instance on the rows longer than cap (none where
// T has none).
template <int D>
int launch_stream(const Args& a, int cap, cudaStream_t stream,
                  int* launched) {
  if (a.T <= cap) return cudaSuccess;
  const long long blocks = static_cast<long long>(a.T - cap) * a.B;
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

// Opts the resident instance in to its shared memory.
template <int D>
int prepare_resident() {
  return static_cast<int>(cudaFuncSetAttribute(
      admm_resident_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Resident<D>::smem));
}

// Launches the resident instance on the rows with kLongRows < L <= hi
// (none where there are none).
template <int D>
int launch_resident(const Args& a, int hi, cudaStream_t stream,
                    int* launched) {
  if (hi <= kLongRows) return cudaSuccess;
  constexpr int R = Resident<D>::R;
  const long long blocks =
      static_cast<long long>((hi - kLongRows + R - 1) / R) * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int err = prepare_resident<D>();
  if (err != cudaSuccess) return err;
  admm_resident_kernel<D><<<static_cast<unsigned>(blocks),
                            Resident<D>::threads, Resident<D>::smem,
                            stream>>>(
      a.z, a.y, a.Lpk, a.s0, a.u0, a.x0, a.w0, a.v0, a.B, a.T, a.d,
      kLongRows, hi, a.iters, a.check_every, a.tol, a.kappa, a.alpha,
      a.beta, a.s, a.u, a.x, a.w, a.v, a.res);
  err = static_cast<int>(cudaGetLastError());
  if (err == cudaSuccess) {
    ++launched[0];
    ++launched[1];
    ++launched[2];
  }
  return err;
}

// The rows longer than the resident instance's capacity first, then the
// resident rows.
template <int D>
int launch_d(const Args& a, cudaStream_t stream, int* launched) {
  const int cap = resident_rows();
  const int err = launch_stream<D>(a, cap, stream, launched);
  if (err != cudaSuccess) return err;
  return launch_resident<D>(a, a.T < cap ? a.T : cap, stream, launched);
}

// Registers a thread and resident warps an SM of the streaming instance
// (out[0], out[1]) and of the resident instance (out[2], out[3]).
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
  if (err != cudaSuccess) return err;
  err = prepare_resident<D>();
  if (err == cudaSuccess)
    err = static_cast<int>(
        cudaFuncGetAttributes(&attr, admm_resident_kernel<D>));
  blocks = 0;
  if (err == cudaSuccess)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, admm_resident_kernel<D>, Resident<D>::threads,
        Resident<D>::smem));
  out[2] = err == cudaSuccess ? attr.numRegs : 0;
  out[3] = blocks * Resident<D>::threads / 32;
  return err;
}

}  // namespace

namespace oco_admm {

int launch_long(const Args& a, cudaStream_t stream, int* launched) {
  return a.d == 5 ? launch_d<5>(a, stream, launched)
                  : launch_d<0>(a, stream, launched);
}

int occupancy_long(int d, int T, int* out) {
  const int err = d == 5 ? occupancy_d<5>(out) : occupancy_d<0>(out);
  if (T <= resident_rows()) out[1] = 0;
  if (T <= kLongRows) out[3] = 0;
  return err;
}

}  // namespace oco_admm

namespace {

template <int D>
int resident_plan(int* out) {
  using P = Resident<D>;
  const int plan[] = {P::R, P::G, P::RG, P::threads, kResidentM, P::QR,
                      P::RG * kResidentM - P::QR, P::stages, P::smem,
                      static_cast<int>(sizeof(typename P::RowsT))};
  for (int k = 0; k < 10; ++k) out[k] = plan[k];
  return 0;
}

}  // namespace

// K10l's resident block at feature dimension d (the d = 5 instance or the
// generic one): rows, groups of kThreads threads, rows a group, threads,
// a thread's entries of a row, of its entries those in registers and those
// in shared memory, the ring's stages, and the dynamic and static shared
// bytes, into out[0..9].  Returns 0.
extern "C" int oco_admm_resident_plan(int d, int* out) {
  return d == 5 ? resident_plan<5>(out) : resident_plan<0>(out);
}

#ifdef OCO_ADMM_SPLIT
// Probe builds only: with stream_all, every long row takes the streaming
// instance (the design before the resident one).
extern "C" void oco_admm_split_route(int stream_all) {
  g_resident_rows = stream_all ? kLongRows : kResidentRows;
}

// Probe builds only: copies K10l's clocks by instance and phase
// (admm_split_clocks) into out and zeroes them.  Returns a cudaError_t.
extern "C" int oco_admm_split(unsigned long long* out) {
  int err = static_cast<int>(cudaMemcpyFromSymbol(
      out, admm_split_clocks, sizeof(admm_split_clocks)));
  unsigned long long zero[2 * kAdmmPhases] = {};
  if (err == cudaSuccess)
    err = static_cast<int>(cudaMemcpyToSymbol(admm_split_clocks, zero,
                                              sizeof(zero)));
  return err;
}
#endif
