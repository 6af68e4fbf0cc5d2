// K10l's rows of 16,385 to kResidentOneRows = 38,912 entries: a block a
// row, its s and u on the chip for the whole launch.  Replaces the TPU
// kernel online_convex_optimization_tpu/ops/pallas_admm.py _admm_kernel on
// those rows (entry admm_all_prefixes_l2); admm_long_kernel.cu routes the
// rows here (launch_past) and holds the other long rows.  Python wrapper
// and plain version: online_convex_optimization_tpu_torch/ops/admm.py.
//
// The map of entries to threads is the other long-row instances': thread
// i of 256 takes entries t = i + 256 m in increasing m and folds the next
// rhs partial sums acc_j = acc_j + ((y_t + s_t) - u_t) z_tj in that order,
// each warp reduces them by the reduce-scatter, and the d x d step
// (row_step) sums the warps in warp order, with the same residual exit.
// So a row's bits depend on its length alone, whichever instance takes it.
//
// Storage.  A row's s and u take 8 L bytes: 128-304 KB for 16,385 to
// 38,912 entries, more than a block's 227 KB of shared memory.  Of a
// thread's entries the first kRowQR = 64 live in registers (245 registers
// a thread in all at d = 5, no spill) and kRowMS = 88 in the block's
// shared memory (176 KB), so a block holds kRowEntries = 152 entries a
// thread (40 in registers reached 32,768 entries, and the rows past that
// were faster on this block than on the streaming instance; PERF.md); y_t
// and z_t come from a ring of entries in the rest of its shared memory (8
// stages at d = 5, 5 at d = 8), which each thread fills by cp.async
// stages - 1 entries ahead in its cyclic order of entries and reads
// itself.  A thread reads kRowGroup = 2 entries before it computes any, so
// their chains interleave.  Every row is read from s0, u0 once and written
// to s, u once.
//
// Rows past the block's reach: probe builds (-DOCO_ADMM_ROUTES) also
// compile the kernel as a thread-block cluster a row (the library's
// instances are the block alone, with none of the cluster's code or
// shared memory), its s and u across the shared memory of its
// blocks (cudaLaunchKernelEx, cudaLaunchAttributeClusterDimension), in two
// designs that keep the bits:
//   (a) the first block's 256 threads compute every entry; its registers
//       and shared memory hold the first 152 entries a thread, block c > 0
//       the next kRowMS each, read and written through distributed shared
//       memory; the other blocks only hold state;
//   (b) block c takes the c-th share of each thread's entries (ceil(mt /
//       cl) of its warp's mt, at most 152: 64 in its registers, the rest in
//       its shared memory) and updates them (predict, shrink, s and u) in
//       parallel with the others; the first block folds its share into acc
//       in the same pass, then each block c > 0 in turn receives the
//       thread's acc from block c - 1 through distributed shared memory
//       (a cluster barrier each hand-over) and folds its share again from
//       its stored s and u, ((y_t + s_t) - u_t), in order; the last block
//       publishes the warps' sums into the first block, which runs the d x
//       d step, and every block reads x back from it after a barrier.
// Both were measured slower than the streaming instance on the rows past
// 32,768 entries when the block held 128 (at B = 1, T = 36,864: (a) 278.7
// ms, (b) 352.3, streaming 227.8; PERF.md), so the library leaves the rows
// past the block's reach to the streaming instance.
//
// What bounds it on an H100: operations, about 4d + 13 an entry an
// iteration (issued one by one under --fmad=false, so twice their time at
// 67 TFLOP/s); the state never leaves the chip.  A block is alone on its
// SM (8 warps) and reads y and z again for its one row every iteration (24
// bytes an entry at d = 5, from L2), where the resident shapes of two and
// four rows a block share a read among their rows: the measured rate
// (PERF.md) is that of L2 at about 5 TB/s.
#include <cooperative_groups.h>

#include <algorithm>

#include "oco_admm.cuh"

namespace cg = cooperative_groups;

namespace {

using oco_admm::Args;

using oco_admm::kResidentOneRows;
using oco_admm::kRowEntries;
using oco_admm::kRowMS;
using oco_admm::kRowQR;
// Entries a thread reads from the ring before it computes any.
constexpr int kRowGroup = 2;
static_assert(kRowQR % kRowGroup == 0, "register entries in whole groups");
// Blocks a cluster at most (the portable maximum).
constexpr int kMaxCluster = 8;

// The kernel's designs: a block alone (the library's), and in probe builds
// a cluster of blocks a row, (a) the first block computing (kHold) or (b)
// every block its share (kSpread).
enum RowDesign { kAlone, kHold, kSpread };

// The block's shared memory: s and u of kRowMS entries a thread, the
// partial sums handed in (design (b)), the ring, and the statics (the
// row's factor, x, w, v, the warps' sums and maxima, the blocks' maxima).
template <int D, int DESIGN>
struct RowShape {
  static constexpr int C = Dim<D>::cap;
  using RowsT = Rows<D, 1, OCO_ADMM_WARPS>;
  static constexpr int kBlockSmem = 232448;
  static constexpr int kBlocks = DESIGN == kAlone ? 1 : kMaxCluster;
  static constexpr int kStatic =
      static_cast<int>(sizeof(RowsT)) + kBlocks * 4;
  static constexpr int kStateBytes = kRowMS * 2 * kThreads * 4;
  static constexpr int kHandBytes = DESIGN == kSpread ? C * kThreads * 4 : 0;
  // A stage: y, then z_0 .. z_{C-1}, a float a thread each.
  static constexpr int kStageBytes = (C + 1) * kThreads * 4;
  static constexpr int kFree =
      kBlockSmem - kStatic - kStateBytes - kHandBytes - 256;
  static constexpr int stages = kFree / kStageBytes > 8 ? 8
                                                        : kFree / kStageBytes;
  static_assert(stages >= 4, "no room for the ring");
  static constexpr int smem = kStateBytes + kHandBytes + stages * kStageBytes;
};

// A thread's ring of y and z entries (the kernel describes it): entry m
// goes to stage `slot`; every pass consumes the entries mb .. me - 1 in
// order, fetched stages - 1 ahead in that cyclic order.  Member
// functions, forced inline, so that every read's values stay in registers
// wherever a pass calls it.
template <int D, int NS>
struct RowRing {
  static constexpr int C = Dim<D>::cap;
  static constexpr int kStage = (C + 1) * kThreads;
  float* mine;            // this thread's float of stage 0
  const float* zb;
  const float* yb;
  int n, L, i, mb, me, next_m, next_slot, slot;

  __device__ __forceinline__ RowRing(float* ring, const float* z_,
                                     const float* y_, int n_, int L_,
                                     int i_, int mb_, int me_)
      : mine(ring + i_), zb(z_), yb(y_), n(n_), L(L_), i(i_), mb(mb_),
        me(me_), next_m(mb_), next_slot(NS - 1), slot(0) {
    if (me > mb) {
#pragma unroll
      for (int k = 0; k < NS - 1; ++k) {
        fetch(next_m, k);
        next_m = next_m + 1 == me ? mb : next_m + 1;
      }
    }
  }

  // Entry m's y_t and z_t into stage s (nothing past L).
  __device__ __forceinline__ void fetch(int m, int s) {
    const int t = i + kThreads * m;
    float* dst = mine + s * kStage;
    if (t < L) {
      copy4_async(dst, yb + t);
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (j < n)
          copy4_async(dst + (j + 1) * kThreads,
                      zb + static_cast<long long>(t) * n + j);
    }
    commit_copies();
  }

  // The next entry's y_t and z_t (0 past n).  Its copies landed, and this
  // thread read entry m - 1's stage, which the fetch refills.
  __device__ __forceinline__ void read(float& yt, float (&zt)[C]) {
    wait_copies<NS - 2>();
    fetch(next_m, next_slot);
    next_m = next_m + 1 == me ? mb : next_m + 1;
    next_slot = next_slot + 1 == NS ? 0 : next_slot + 1;
    const float* e = mine + slot * kStage;
    yt = e[0];
#pragma unroll
    for (int j = 0; j < C; ++j) zt[j] = j < n ? e[(j + 1) * kThreads] : 0.f;
    slot = slot + 1 == NS ? 0 : slot + 1;
  }
};

// K10l past 16,384 entries: one row a block (DESIGN kAlone), or in a probe
// build a cluster of cl >= 2 blocks (kHold, kSpread), of length L_hi - g /
// B for the launch's g-th row (replicate g % B; the longest rows first),
// L_lo < L <= L_hi.  Every warp has at least kRowQR entries in each block
// that computes (mt >= 64 past 16,384 entries, and a share of design (b)
// holds at least 76), so the register entries need no test.
template <int D, int DESIGN>
__global__ void __launch_bounds__(kThreads, 1)
admm_row_kernel(const float* __restrict__ z, const float* __restrict__ y,
                const float* __restrict__ Lpk, const float* __restrict__ s0,
                const float* __restrict__ u0, const float* __restrict__ x0,
                const float* __restrict__ w0, const float* __restrict__ v0,
                int B, int T, int d, int L_lo, int L_hi, int cl, int iters,
                int check_every, float tol, float kappa, float alpha,
                float beta, float* __restrict__ s_out,
                float* __restrict__ u_out, float* __restrict__ x_out,
                float* __restrict__ w_out, float* __restrict__ v_out,
                float* __restrict__ res_out) {
  using P = RowShape<D, DESIGN>;
  constexpr bool kCluster = DESIGN != kAlone;
  // Design (b): every block computes its share, and the row's barrier is
  // the cluster's; else the first block computes every entry.
  constexpr bool kShares = DESIGN == kSpread;
  constexpr int C = P::C, QR = kRowQR, MS = kRowMS, NS = P::stages;
  constexpr int U = kRowGroup;
  extern __shared__ float dyn[];
  float* const ss = dyn;                        // [MS][kThreads], then u
  float* const hand = dyn + 2 * MS * kThreads;  // design (b): [C][kThreads]
  float* const ring = hand + P::kHandBytes / 4; // [NS][C + 1][kThreads]
  __shared__ typename P::RowsT S;
  __shared__ float bpri[P::kBlocks];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = kCluster ? static_cast<int>(blockIdx.x % cl) : 0;
  const int grow = static_cast<int>(kCluster ? blockIdx.x / cl : blockIdx.x);
  const int b = grow % B;
  const int L = L_hi - grow / B;
  const long long row = static_cast<long long>(b) * T + L - 1;
  const int n = D > 0 ? D : d;
  const int ntri = n * (n + 1) / 2;
  const int i = threadIdx.x;
  const int warp = i >> 5;
  const int lane = i & 31;
  const float* zb = z + static_cast<long long>(b) * T * n;
  const float* yb = y + static_cast<long long>(b) * T;
  SplitClock clk(kCluster ? kInstCluster : kInstOne);

  if constexpr (kCluster) {
    // Every block of the cluster runs before any reads another's shared
    // memory; in design (a) the others then hold their state until the
    // first block is done.
    cluster.sync();
    if (!kShares && rank > 0) {
      cluster.sync();
      return;
    }
  }
  // This thread's entries m < mt (its warp's lane 0's count), and of those
  // the ones this block computes, [mb, me).
  const int mt = (L - (i - lane) + kThreads - 1) / kThreads;
  int mb = 0, me = mt;
  if constexpr (kShares) {
    const int share = (mt + cl - 1) / cl;
    mb = min(mt, rank * share);
    me = min(mt, mb + share);
  }
  const int cnt = me - mb;
  // The first block's statics as this block reaches them.
  typename P::RowsT* S0 = &S;
  float* bpri0 = bpri;
  if constexpr (kCluster) {
    if (rank > 0) {
      S0 = cluster.map_shared_rank(&S, 0);
      bpri0 = cluster.map_shared_rank(bpri, 0);
    }
  }

  if (rank == 0) {
    for (int k = i; k < ntri; k += kThreads) S.L[0][k] = Lpk[row * ntri + k];
    for (int j = i; j < n; j += kThreads) {
      S.x[0][j] = x0 != nullptr ? x0[row * n + j] : 0.f;
      S.w[0][j] = x0 != nullptr ? w0[row * n + j] : 0.f;
      S.v[0][j] = x0 != nullptr ? v0[row * n + j] : 0.f;
    }
    if (i == 0) S.live[0] = 1;
  }

  // The ring of this block's entries of this thread.
  RowRing<D, NS> rring(ring, zb, yb, n, L, i, mb, me);

  float sreg[QR], ureg[QR];
  // This thread's s_t of its q-th entry in shared memory (u_t MS kThreads
  // floats on): q < MS in this block, past that (design (a)) in block
  // q / MS, through distributed shared memory.
  const auto local_at = [&](int q) { return ss + q * kThreads + i; };
  const auto remote_at = [&](int q) {
    const int sl = q / MS;
    return cluster.map_shared_rank(ss, sl) + (q - sl * MS) * kThreads + i;
  };
  // Calls f(t, yt, zt, s, u) on this block's entries m = mb .. me - 1 in
  // order (t = i + kThreads m): the first QR in registers, then those in
  // this block's shared memory, then (design (a)) the other blocks'.
  // kRowGroup entries are read, then computed; the loops unroll after f
  // is inlined, so the register entries' indices are constants.
  const auto pass = [&](auto&& f) {
#pragma unroll
    for (int k0 = 0; k0 < QR; k0 += U) {
      float yt[U], zt[U][C];
#pragma unroll
      for (int u = 0; u < U; ++u) rring.read(yt[u], zt[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        f(i + kThreads * (mb + k0 + u), yt[u], zt[u], sreg[k0 + u],
          ureg[k0 + u]);
    }
    const int nsh = cnt - QR;
    const int nloc = nsh < MS ? nsh : MS;
    int q0 = 0;
    for (; q0 + U <= nloc; q0 += U) {
      float yt[U], zt[U][C];
#pragma unroll
      for (int u = 0; u < U; ++u) rring.read(yt[u], zt[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float* p = local_at(q0 + u);
        f(i + kThreads * (mb + QR + q0 + u), yt[u], zt[u], p[0],
          p[MS * kThreads]);
      }
    }
    for (; q0 < nloc; ++q0) {
      float yt, zt[C];
      rring.read(yt, zt);
      float* p = local_at(q0);
      f(i + kThreads * (mb + QR + q0), yt, zt, p[0], p[MS * kThreads]);
    }
    if constexpr (DESIGN == kHold) {
      for (; q0 + U <= nsh; q0 += U) {
        float yt[U], zt[U][C];
#pragma unroll
        for (int u = 0; u < U; ++u) rring.read(yt[u], zt[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float* p = remote_at(q0 + u);
          f(i + kThreads * (mb + QR + q0 + u), yt[u], zt[u], p[0],
            p[MS * kThreads]);
        }
      }
      for (; q0 < nsh; ++q0) {
        float yt, zt[C];
        rring.read(yt, zt);
        float* p = remote_at(q0);
        f(i + kThreads * (mb + QR + q0), yt, zt, p[0], p[MS * kThreads]);
      }
    }
  };

  // The row's barrier: the block's, or the cluster's in design (b).
  const auto sync_row = [&]() {
    if constexpr (kShares) cluster.sync();
    else __syncthreads();
  };
  const bool folds = !kShares || rank == 0;
  const bool checked = tol > 0.f;
  const int n_blocks = checked ? (iters + check_every - 1) / check_every
                               : (iters > 0 ? 1 : 0);
  const int per_block = checked ? check_every : iters;
  const int total = n_blocks * per_block;
  __syncthreads();
  clk.mark(kAdmmOther);

  // Pass k = -1 reads the state from s0 and u0 (zeros without them) and
  // sums the rhs of the initial state; pass k >= 0 is iteration k: the d x
  // d step, then the residual split (soft threshold, dual update, next rhs
  // partials).  Every pass, the hand-overs and the residual have one call
  // site each, so that the compiler inlines them and this thread's entries
  // stay in registers.
  for (int k = -1; k < total; ++k) {
    if (k >= 0) {
      if (rank == 0 && i == 0) {
        const long long t0 = clk.now();
        row_step<D>(S, 0, OCO_ADMM_WARPS, n, alpha, beta);
        clk.span(kAdmmChain, t0);
      }
      sync_row();
      clk.mark(kAdmmStep);
    }
    float x[C], acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      x[j] = j < n ? S0->x[0][j] : 0.f;
      acc[j] = 0.f;
    }
    const auto update = [&](auto fold) {
      return [&](int t, float yt, const float* zt, float& s, float& u) {
        // Selects, not branches, keep a group's entries in one basic
        // block, so their chains interleave.
        const bool ok = t < L;
        const float so = s, uo = u;
        const float rr = predict<D>(x, zt, n) - yt;
        const float rh = alpha * rr + beta * so;
        const float sp = rh + uo;
        const float sn = shrink(sp, kappa);
        const float un = (uo + rh) - sn;
        s = ok ? sn : so;
        u = ok ? un : uo;
        if constexpr (decltype(fold)::value) {
          const float ysu = (yt + sn) - un;
#pragma unroll
          for (int j = 0; j < C; ++j) {
            if (j < n) {
              const float aj = acc[j] + ysu * zt[j];
              acc[j] = ok ? aj : acc[j];
            }
          }
        }
      };
    };
    if (k < 0) {
      pass([&](int t, float yt, const float* zt, float& s, float& u) {
        const bool in = t < L;
        const long long at = row * T + t;
        const float sv = in && s0 != nullptr ? s0[at] : 0.f;
        const float uv = in && u0 != nullptr ? u0[at] : 0.f;
        s = sv;
        u = uv;
        if (folds && in) {
          const float ysu = (yt + sv) - uv;
#pragma unroll
          for (int j = 0; j < C; ++j)
            if (j < n) acc[j] = acc[j] + ysu * zt[j];
        }
      });
    } else if (folds) {
      pass(update(std::true_type()));
    } else {
      pass(update(std::false_type()));
    }
    clk.mark(kAdmmArith);
    // In design (b) each block c > 0 in turn receives acc from block c - 1
    // and folds its share from its stored s and u; the last block (the
    // only one elsewhere) publishes, and a barrier hands the sums to the d
    // x d step.
    if constexpr (kShares) {
      for (int h = 1; h < cl; ++h) {
        if (rank == h - 1) {
          float* to = cluster.map_shared_rank(hand, h) + i;
#pragma unroll
          for (int j = 0; j < C; ++j)
            if (j < n) to[j * kThreads] = acc[j];
        }
        cluster.sync();
        if (rank == h) {
#pragma unroll
          for (int j = 0; j < C; ++j)
            acc[j] = j < n ? hand[j * kThreads + i] : 0.f;
          pass([&](int t, float yt, const float* zt, float& s, float& u) {
            const bool ok = t < L;
            const float ysu = (yt + s) - u;
#pragma unroll
            for (int j = 0; j < C; ++j) {
              if (j < n) {
                const float aj = acc[j] + ysu * zt[j];
                acc[j] = ok ? aj : acc[j];
              }
            }
          });
        }
      }
    }
    if (!kShares || rank == cl - 1) {
      float p8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) p8[j] = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) p8[j] = acc[j];   // 0 past n
      const float e = reduce_scatter8(p8, lane);
      if ((lane & 3) == 0 && (lane >> 2) < n) S0->part[warp][lane >> 2] = e;
    }
    sync_row();
    clk.mark(kAdmmPublish);

    // After each block of check_every iterations (tol > 0), or after the
    // last pass: the row's residual max(max_t |r_t - s_t|, max_j |x_j -
    // w_j|) of the current state into S.res, and with tol > 0 the row
    // stops once it is not above tol.
    const bool block_end = checked && k >= 0 && (k + 1) % per_block == 0;
    if (block_end || k == total - 1) {
      if (k >= 0) {
#pragma unroll
        for (int j = 0; j < C; ++j) x[j] = j < n ? S0->x[0][j] : 0.f;
      }
      float pri = 0.f;
      pass([&](int t, float yt, const float* zt, float& s, float&) {
        const float e = fabsf((predict<D>(x, zt, n) - yt) - s);
        pri = t < L ? nan_max(pri, e) : pri;
      });
      clk.mark(kAdmmArith);
      pri = warp_max(pri);
      if (lane == 0) S.pri[warp] = pri;
      __syncthreads();
      if (i == 0) {
        float bp = S.pri[0];
        for (int w = 1; w < OCO_ADMM_WARPS; ++w) bp = nan_max(bp, S.pri[w]);
        bpri0[rank] = bp;
      }
      sync_row();
      clk.mark(kAdmmPublish);
      if (rank == 0 && i == 0) {
        float res = bpri[0];
        for (int c = 1; c < (kShares ? cl : 1); ++c)
          res = nan_max(res, bpri[c]);
#pragma unroll
        for (int j = 0; j < C; ++j)
          if (j < n) res = nan_max(res, fabsf(S.x[0][j] - S.w[0][j]));
        S.res[0] = res;
        if (block_end && !(res > tol)) S.live[0] = 0;
      }
      sync_row();
      clk.mark(kAdmmOther);
      if (S0->live[0] == 0) break;
    }
  }
  wait_copies<0>();   // the ring's fetches for a pass that does not come

  // This block's entries of s and u into the state.
#pragma unroll
  for (int k = 0; k < QR; ++k) {
    const int t = i + kThreads * (mb + k);
    if (k < cnt && t < L) {
      s_out[row * T + t] = sreg[k];
      u_out[row * T + t] = ureg[k];
    }
  }
  for (int q = 0; q < cnt - QR; ++q) {
    const int t = i + kThreads * (mb + QR + q);
    const float* p = local_at(q);
    if constexpr (DESIGN == kHold) {
      if (q >= MS) p = remote_at(q);
    }
    if (t < L) {
      s_out[row * T + t] = p[0];
      u_out[row * T + t] = p[MS * kThreads];
    }
  }
  if (rank == 0) {
    for (int t = L + i; t < T; t += kThreads) {
      s_out[row * T + t] = 0.f;
      u_out[row * T + t] = 0.f;
    }
    for (int j = i; j < n; j += kThreads) {
      x_out[row * n + j] = S.x[0][j];
      w_out[row * n + j] = S.w[0][j];
      v_out[row * n + j] = S.v[0][j];
    }
    if (i == 0) res_out[row] = S.res[0];
  }
  clk.mark(kAdmmOther);
  clk.flush();
  // No block leaves while another may still read its shared memory.
  if constexpr (kCluster) cluster.sync();
}

template <int D, int DESIGN>
int prepare_row() {
  return static_cast<int>(cudaFuncSetAttribute(
      admm_row_kernel<D, DESIGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      RowShape<D, DESIGN>::smem));
}

// Launches the one-row block on the rows with L_lo < L <= L_hi of every
// replicate (none where there are none).
template <int D>
int launch_rows(const Args& a, int L_lo, int L_hi, cudaStream_t stream,
                int* launched) {
  if (L_hi <= L_lo) return cudaSuccess;
  const long long blocks = static_cast<long long>(L_hi - L_lo) * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int err = prepare_row<D, kAlone>();
  if (err != cudaSuccess) return err;
  admm_row_kernel<D, kAlone><<<static_cast<unsigned>(blocks), kThreads,
                               RowShape<D, kAlone>::smem, stream>>>(
      a.z, a.y, a.Lpk, a.s0, a.u0, a.x0, a.w0, a.v0, a.B, a.T, a.d, L_lo,
      L_hi, 1, a.iters, a.check_every, a.tol, a.kappa, a.alpha, a.beta, a.s,
      a.u, a.x, a.w, a.v, a.res);
  err = static_cast<int>(cudaGetLastError());
  if (err == cudaSuccess) {
    ++launched[0];
    ++launched[1];
    ++launched[4];
  }
  return err;
}

#ifdef OCO_ADMM_ROUTES
// Probe builds only: a thread's entries a cluster of cl blocks holds in
// design (b) (spread) or (a).
constexpr int cluster_entries(int cl, bool spread) {
  return spread ? cl * kRowEntries : kRowQR + cl * kRowMS;
}

// The rows with L_lo < L <= L_hi of every replicate, a cluster of cl >= 2
// blocks a row in design DESIGN (none where there are none).
template <int D, int DESIGN>
int cluster_rows(const Args& a, int L_lo, int L_hi, int cl,
                 cudaStream_t stream, int* launched) {
  if (L_hi <= L_lo) return cudaSuccess;
  const long long blocks =
      static_cast<long long>(L_hi - L_lo) * a.B * cl;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int err = prepare_row<D, DESIGN>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(RowShape<D, DESIGN>::smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cl);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, admm_row_kernel<D, DESIGN>, a.z, a.y, a.Lpk, a.s0, a.u0, a.x0,
      a.w0, a.v0, a.B, a.T, a.d, L_lo, L_hi, cl, a.iters, a.check_every,
      a.tol, a.kappa, a.alpha, a.beta, a.s, a.u, a.x, a.w, a.v, a.res));
  if (err == cudaSuccess) err = static_cast<int>(cudaGetLastError());
  if (err == cudaSuccess) {
    ++launched[0];
    ++launched[1];
    ++launched[5];
  }
  return err;
}

// The rows past the one-row block's reach, clusters of the most blocks
// first.
template <int D, int DESIGN>
int clusters_d(const Args& a, cudaStream_t stream, int* launched) {
  constexpr bool spread = DESIGN == kSpread;
  if (a.T <= kResidentOneRows) return cudaSuccess;
  int top = 0;
  for (int cl = kMaxCluster; cl >= 2; --cl)
    if (a.T <= cluster_entries(cl, spread) * kThreads) top = cl;
  if (top == 0) return cudaErrorInvalidValue;
  int err = cudaSuccess;
  for (int cl = top; cl >= 2 && err == cudaSuccess; --cl) {
    const int hi = std::min(a.T, cluster_entries(cl, spread) * kThreads);
    const int below = cluster_entries(cl - 1, spread) * kThreads;
    err = cluster_rows<D, DESIGN>(a, below, hi, cl, stream, launched);
  }
  return err;
}
#endif

// Registers a thread and resident warps an SM of the one-row block
// (out[0], out[1]).
template <int D>
int occupancy_of(int* out) {
  int err = prepare_row<D, kAlone>();
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = static_cast<int>(
        cudaFuncGetAttributes(&attr, admm_row_kernel<D, kAlone>));
  int blocks = 0;
  if (err == cudaSuccess)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, admm_row_kernel<D, kAlone>, kThreads,
        RowShape<D, kAlone>::smem));
  out[0] = err == cudaSuccess ? attr.numRegs : 0;
  out[1] = blocks * OCO_ADMM_WARPS;
  return err;
}

template <int D>
int row_plan_d(int lo, int L, int* out) {
  using P = RowShape<D, kAlone>;
  if (L <= lo || L > kResidentOneRows) return cudaErrorInvalidValue;
  const int plan[] = {1, kThreads, kRowEntries, kRowQR, kRowMS, P::stages,
                      P::smem, P::kStatic, lo, kResidentOneRows};
  for (int k = 0; k < 10; ++k) out[k] = plan[k];
  return cudaSuccess;
}

}  // namespace

namespace oco_admm {

int launch_past(const Args& a, int lo, cudaStream_t stream, int* launched) {
  const int hi = std::min(a.T, kResidentOneRows);
  return a.d == 5 ? launch_rows<5>(a, lo, hi, stream, launched)
                  : launch_rows<0>(a, lo, hi, stream, launched);
}

#ifdef OCO_ADMM_ROUTES
int launch_clusters(const Args& a, bool spread, cudaStream_t stream,
                    int* launched) {
  if (spread)
    return a.d == 5 ? clusters_d<5, kSpread>(a, stream, launched)
                    : clusters_d<0, kSpread>(a, stream, launched);
  return a.d == 5 ? clusters_d<5, kHold>(a, stream, launched)
                  : clusters_d<0, kHold>(a, stream, launched);
}
#endif

int row_occupancy(int d, int T, int lo, int* out) {
  const int err = d == 5 ? occupancy_of<5>(out) : occupancy_of<0>(out);
  if (T <= lo) out[1] = 0;
  return err;
}

int row_plan(int d, int lo, int L, int* out) {
  return d == 5 ? row_plan_d<5>(lo, L, out) : row_plan_d<0>(lo, L, out);
}

#ifdef OCO_ADMM_SPLIT
int row_split(unsigned long long* out) {
  unsigned long long c[kAdmmInstances][kAdmmPhases];
  int err = static_cast<int>(
      cudaMemcpyFromSymbol(c, admm_split_clocks, sizeof(c)));
  if (err != cudaSuccess) return err;
  const int insts[] = {kInstOne, kInstCluster};
  for (int inst : insts)
    for (int p = 0; p < kAdmmPhases; ++p)
      out[inst * kAdmmPhases + p] += c[inst][p];
  unsigned long long zero[kAdmmInstances * kAdmmPhases] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(admm_split_clocks, zero, sizeof(zero)));
}
#endif

}  // namespace oco_admm
