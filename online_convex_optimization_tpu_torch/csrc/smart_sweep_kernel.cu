// K6: the SMART regret and switch round of every (sequence, threshold)
// pair, in two launches: K6a, the threshold-independent prefix, once per
// sequence; K6b, the FTRL tails of the pairs that switched.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_smart.py
// _smart_sweep_kernel, entry smart_sweep_packed.  Python wrapper and plain
// PyTorch versions: online_convex_optimization_tpu_torch/ops/smart.py
// (smart_sweep, smart_sweep_reference; smart_sweep_split_reference mirrors
// the split).
//
// Column g equals K2 run with threshold = thresholds[g], bit for bit, with
// K2's switch test F - L >= threshold (exact at the ties the z = e1 families
// reach).  Before its switch, every pair of a sequence plays the same FTL
// track, adds the same FTL losses to its total and evaluates the same lead
// F - L: only the threshold differs.  So:
//   - K6a, one thread per sequence, plays the FTL track once with the round
//     step of K2's FTL warp (smart_kernel.cu), computing the FTL action once
//     a round (the
//     post-update action of round t, which the switch test scores, is round
//     t + 1's pre-update action: the same function of the same theta).  It
//     walks a pointer over the thresholds sorted ascending: while
//     lead >= sorted[k], pair perm[k] switches at this round.  That is each
//     threshold's first crossing, as K2's test finds it: a threshold not yet
//     passed lies at or above every passed one.  A switched pair's total is
//     the FTL losses so far, F in every bit (the same sums of the same terms
//     from 0).  K6a writes tau and that starting sum, then the comparator
//     (identity or replay) once per sequence, and the final regret of every
//     pair with no tail (never switched, or switched at the last valid
//     round);
//   - K6b, 32 sequences (lane) x 4 thresholds (warp) a block, plays
//     each switched pair's FTRL tail, rounds tau + 1 .. len - 1, with a
//     fresh theta, the global 1-based round index (the scale table's entry)
//     and the scalar eta, from the starting sum, and subtracts the
//     comparator.  Its round is K5's without w, over the same staged rows
//     (oco_tiles.cuh).  A block none of whose pairs switched copies nothing
//     and leaves; a warp with no switched lane plays no round (it stays to
//     copy rows: a barrier with exited warps is undefined); the block
//     starts at its earliest tau + 1.
//
// What bounds it on an H100.  The one-thread-per-pair design played the FTL
// track G times, with two FTL actions a round, and read each pair's rows
// through L2 (~20 GB in f64 at B = 32,768, G = 16).  Here K6a reads every
// row once (8*(d+1) bytes a round in f64) and runs one serial chain a
// sequence, about 12d + 10 flops a round with one sqrt and divide: with
// B = 32,768 that is 1,024 warps, all resident at once, so K6a is bound by
// the chain's latency, not by the card's rates.  Each thread reads its own
// rows from global memory, round t + 1's while it plays round t (staging
// them in shared memory, with a warp a block, left less L1 for the copies
// and fewer warps resident, and was slower).  K6b's work is the ~15% of
// pairs that switch on the phase-6 data, from their switch on: too little
// work to fill the card, so K6b too is bound by the latency of its longest
// chains, the tails of the pairs that switch in the first rounds.  Both
// take the sequences in the wrapper's descending length order.  The
// large-d instance (d > 64) of K6b reads rows from global memory.  Narrow
// storage (OCO_STORAGE_PAIRS) is widened on read: K6a's loads, K6b's
// 4-byte windows (oco_tiles.cuh).
//
// K6aw (K6a past d = 512, smart_prefix_wide_kernel) plays a sequence on a
// warp.  One thread a sequence with theta, w and x in a (d, B) buffer (this
// instance's first design) left the card nearly empty at the path's width
// (B = 1,024: 16 blocks of 2 warps on 132 SMs, each round 6-7 passes over
// 8 KB vectors, a memory round trip per 8 elements, each thread reading
// its own row 8 bytes at a time).  The design:
//   - warp w of a block plays the sequence order[slot], so the longest
//     sequences go first; lane l holds elements j = l + 32 m of theta and
//     w in shared memory; x is never stored: each lane forms x_j = s theta_j
//     from the round's FTL scale s = -(1/sqrt(||theta||^2)) (0 at theta =
//     0) where a product needs it, the product ftl_action forms;
//   - a sequence's row is one contiguous d-vector: the warp copies the
//     16-byte window around row t + 1 into its own stage with cp.async
//     right after round t's update has read row t, and the copy lands while
//     the warp sums ||theta||^2;
//   - each sum is one lane's index-order sum of a product line
//     (oco_warp.cuh), the same bits as the thread-a-sequence helpers.
//     Round t's <x, w> (the switch test's L) and round t + 1's <z_{t+1},
//     x> depend only on s_t and theta_t, so they run side by side on lanes
//     0 and 1: a round has two sums in turn, nsq and that pair, where the
//     first design had three;
//   - the threshold walk and the outputs are lane 0's; the replay
//     comparator re-plays the rows with the final x, one sum a round.
// What bounds it: the two one-lane chains of d dependent adds a round, on
// 1,024 warps in one wave (f64 at d = 1,024: 28,704 bytes of shared memory
// a warp, 8 warps an SM).  Up to the plan's max_shared_d theta, w and the
// stage lie on the chip; past it theta and w lie in the caller's buffer,
// (B, 2 d) contiguous a warp, and the lanes read their rows from global
// memory: the library's plan (oco_smart_prefix_plan) reports the boundary
// and the block, and the wrapper allocates the buffer it asks for.
//
// K6bw (K6b past d = 512, smart_tail_wide_kernel) plays a tail on a warp.
// One thread a pair with theta and x in a (d, G B) buffer (this instance's
// first design) left the card nearly empty (the path's 4,519 tails on
// 1,024 x 16 threads) and read its rows 8 bytes at a time.  The design:
//   - the thresholds that switch at or before a round are a prefix of the
//     sorted ones (K6a's pointer walk), so a sequence's tails are its
//     first sorted thresholds, and the earlier a threshold in sorted order
//     the earlier its switch and the longer its tail.  A block plays
//     kTailGroup consecutive sorted thresholds of one sequence (perm maps
//     them to columns), a warp each; the blocks take the groups in sorted
//     order, each group's sequences in the wrapper's length order, so the
//     longest tails start first.  A block none of whose pairs has a tail
//     leaves at once;
//   - the group's tails read the same sequence-major rows, so the block
//     steps its warps in lockstep from its earliest start, its threads
//     copying row t + 1's 16-byte window into one of two stages with
//     cp.async while the warps play row t (one barrier a round), as K1w's
//     plays share theirs; a warp before its start, or with no tail, stays
//     for the copies and the barriers (a barrier with exited warps is
//     undefined);
//   - a warp's tail is K3w's FTRL round: a fresh theta in shared memory,
//     lane l holding elements j = l + 32 m; x never stored; q from
//     oco::ftrl_q with the table's scale at the global round (||x||^2 and
//     <z_t, x> side by side, <z_t, x> again where it projects); the hinge
//     step, then the update lane-parallel; from K6a's starting sum, less
//     comp at the end, as the thread-a-pair instances do.
// What bounds it: the one-lane chain of d dependent adds a tail round over
// the longest tails, and the tail rounds over the warps the card holds
// (the path's 2.2 million tail rounds in f64 over 8 warps an SM).
// Up to the plan's max_shared_d the thetas and the stages lie on the chip;
// past it theta lies in the caller's buffer, up4(d) elements a (threshold,
// sequence) pair, each warp reading its rows from global memory with no
// barrier: the library's plan (oco_smart_tail_plan) reports the boundary
// and the block, and the wrapper allocates the buffer it asks for.
//
// K2w (K2 past d = 512) is these two wide kernels in their K2 mode
// (kPlays; smart_kernel.cu's note): each sequence's own thresholds, the
// sums without comp, the last actions, one tail a block.
#include "oco_tiles.cuh"
#include "oco_warp.cuh"

namespace {

constexpr int kPrefixThreads = 64;

// Thresholds a K6b block serves from one staged tile, and bytes of rows a
// stage holds: of 4-16 warps and 12-96 KB at the phase-6 cell on an H100,
// 4 warps and 24 KB were about the fastest (PERF.md).  The warps share one
// staged row of scales (a scalar eta).
constexpr int kTailWarps = 4;
constexpr size_t kTailStageBytes = 24 * 1024;

// K6a: one thread per sequence, each reading its own rows.
template <typename Z, typename Y, int D, typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(kPrefixThreads)
smart_prefix_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
                    const S* __restrict__ sorted,
                    const int* __restrict__ perm,
                    const int* __restrict__ order,
                    const int* __restrict__ lengths, long long B, long long G,
                    long long T, int d, int replay, S* __restrict__ regret,
                    long long* __restrict__ switch_t,
                    S* __restrict__ comp_out) {
  constexpr int C = oco::Cap<D>::value;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
  if (slot >= B) return;
  const long long b = order[slot];
  const int len = lengths[b];
  const int n = D > 0 ? D : d;

  S th[C], w[C], x[C];
#pragma unroll
  for (int j = 0; j < n; ++j) th[j] = w[j] = x[j] = S(0);
  S F = S(0), cnt = S(0);
  long long k = 0, k_last = 0;   // thresholds passed; passed before round len-1
  S next = sorted[0];            // the lowest threshold not yet passed
  oco::play_rows_global<S, D>(
      z, y, nullptr, b, T, n, 0, len, [&](int t, auto zr, S yt, S) {
        // x is the pre-update FTL action (the last round's post-update one).
        const S diffF = oco::dot<S, D>(zr, x, n) - yt;
        const S lossF = S(0.5) * oco::oabs(diffF);
        oco::update<S, D>(th, w, zr, oco::half_sign(diffF), yt, n);
        F = F + lossF;
        cnt = cnt + S(1);
        oco::ftl_action<S, D>(th, x, n);
        if (t == len - 1) k_last = k;
        if (k < G) {
          const S L = S(0.5) * (cnt - oco::dot<S, D>(x, w, n));
          const S lead = F - L;
          while (k < G && lead >= next) {
            const long long i = perm[k] * B + b;
            switch_t[i] = t;
            regret[i] = F;
            if (++k < G) next = sorted[k];
          }
        }
      });
  // x is now ftl_action(theta): the comparator's action.
  const S comp =
      replay ? oco::replay_comparator_rows<S, D>(z, y, b, T, n, len, x)
             : S(0.5) * (cnt - oco::dot<S, D>(x, w, n));
  comp_out[b] = comp;
  for (long long m = k_last; m < G; ++m) {
    const long long i = perm[m] * B + b;
    if (m >= k) switch_t[i] = T;
    regret[i] = F - comp;
  }
}

// ------------------------------------------------------------------ K6aw

// Products a warp's line holds (oco_warp.cuh); warps a block at most.
constexpr int kPrefixLine = 512;
constexpr int kPrefixWarps = 8;
// Each lane forms a chunk's products before it stores any (oco_warp.cuh
// put_products, kBatch), and updates kPrefixUnroll elements of theta and
// w at a time (with launch bounds of one block an SM, as K3w's).
constexpr int kPrefixUnroll = 4;

using oco::up4;

// A warp's shared memory, each part a multiple of 16 bytes: theta and w
// (shared), the product line, and (shared) the stage, which holds the
// 16-byte window around a row: its bytes rounded up to 16, and 16 more.
template <typename Z, typename S = oco::compute_t<Z>>
__host__ __device__ inline long long prefix_vec_bytes(int d) {
  return up4(d) * static_cast<long long>(sizeof(S));
}
template <typename Z>
__host__ __device__ inline long long prefix_stage_bytes(int d) {
  return ((d * static_cast<long long>(sizeof(Z)) + 15) & ~15LL) + 16;
}
template <typename Z, typename S = oco::compute_t<Z>>
__host__ __device__ inline long long prefix_warp_bytes(int d, bool shared) {
  return (shared ? 2 * prefix_vec_bytes<Z>(d) + prefix_stage_bytes<Z>(d)
                 : 0) +
         oco::line_elems<S, kPrefixLine>() * static_cast<long long>(sizeof(S));
}

// kPlays: K2w's FTL launch (see the source note of smart_kernel.cu's
// entry), with each sequence's own thresholds and the raw sums.
template <typename Z, typename Y, bool kShared, bool kPlays,
          typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(kPrefixWarps * 32, 1)
smart_prefix_wide_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
                         const S* __restrict__ sorted,
                         const int* __restrict__ perm,
                         const int* __restrict__ order,
                         const int* __restrict__ lengths, long long B,
                         long long G, long long T, int d, int replay,
                         S* __restrict__ regret,
                         long long* __restrict__ switch_t,
                         S* __restrict__ comp_out, S* __restrict__ x_last,
                         S* state) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long slot =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  // No barrier spans the block's warps.
  if (slot >= B) return;
  const long long b = order[slot];
  const int len = lengths[b];
  const int n = d;
  unsigned char* own = smem + warp * prefix_warp_bytes<Z>(n, kShared);
  S* th = kShared ? reinterpret_cast<S*>(own) : state + slot * 2 * up4(n);
  S* w = th + up4(n);
  S* line =
      reinterpret_cast<S*>(own + (kShared ? 2 * prefix_vec_bytes<Z>(n) : 0));
  unsigned char* stage = reinterpret_cast<unsigned char*>(
      line + oco::line_elems<S, kPrefixLine>());
  const Z* rows = z + b * T * n;
  const Y* labels = y + b * T;
  // The k-th lowest threshold's place in sorted and perm: one list for
  // every sequence (K6), or the sequence's own column of the (G, B) lists
  // (K2).
  const auto at = [&](long long k) { return kPlays ? k * B + b : k; };

  // Row t into the stage: the 16-byte chunks around it (each holds an
  // element of the row, so it lies in that element's page), the row at
  // byte `off` of the stage.
  int off = 0;
  const auto fetch = [&](int t) {
    if constexpr (kShared) {
      const auto a = reinterpret_cast<unsigned long long>(
          rows + static_cast<long long>(t) * n);
      const auto* src = reinterpret_cast<const uint4*>(a & ~15ull);
      off = static_cast<int>(a & 15);
      const long long chunks =
          (off + n * static_cast<long long>(sizeof(Z)) + 15) / 16;
      for (long long c = lane; c < chunks; c += 32)
        oco::copy_async(reinterpret_cast<uint4*>(stage) + c, src + c);
      oco::commit_copies();
    }
  };
  const auto landed = [&] {
    if constexpr (kShared) {
      oco::wait_copies<0>();
      __syncwarp();
    }
  };
  // Element j of row t: staged, or (past the boundary) from the rows.
  const auto z_at = [&](int t, int j) -> S {
    if constexpr (kShared)
      return S(oco::widen(reinterpret_cast<const Z*>(stage + off)[j]));
    else
      return S(oco::widen(rows[static_cast<long long>(t) * n + j]));
  };

  for (int j = lane; j < n; j += 32) th[j] = w[j] = S(0);
  S F = S(0), cnt = S(0);
  S s = S(0);                  // x = s theta, the pre-update FTL action
  long long k = 0, k_last = 0;   // thresholds passed; passed before round len-1
  S next = sorted[at(0)];        // the lowest threshold not yet passed
  S q = S(0), xw = S(0), yt = S(0);
  bool xw_final = false;         // xw is <x, w> of the final x and w
  if (len > 0) {
    fetch(0);
    yt = S(oco::widen(labels[0]));
    landed();
    q = oco::warp_dot<kPrefixLine, true>(line, n, lane, [&](int j) {
      return z_at(0, j) * (s * th[j]);
    });
  }
  for (int t = 0; t < len; ++t) {
    // q = <z_t, x> with x the pre-update FTL action; the update.
    const S diffF = q - yt;
    const S lossF = S(0.5) * oco::oabs(diffF);
    const S g = oco::half_sign(diffF);
    for (int j0 = lane; j0 < n; j0 += 32 * kPrefixUnroll) {
      S zj[kPrefixUnroll], tj[kPrefixUnroll], wj[kPrefixUnroll];
#pragma unroll
      for (int k = 0; k < kPrefixUnroll; ++k) {
        const int j = j0 + 32 * k;
        if (j < n) {
          zj[k] = z_at(t, j);
          tj[k] = th[j];
          wj[k] = w[j];
        }
      }
#pragma unroll
      for (int k = 0; k < kPrefixUnroll; ++k) {
        const int j = j0 + 32 * k;
        if (j < n) {
          th[j] = tj[k] + g * zj[k];
          w[j] = wj[k] + yt * zj[k];
        }
      }
    }
    __syncwarp();  // row t is read: the stage is free
    F = F + lossF;
    cnt = cnt + S(1);
    const bool more = t + 1 < len;
    if (more) {
      fetch(t + 1);
      yt = S(oco::widen(labels[t + 1]));
    }
    // ftl_action(theta): the post-update action, round t + 1's x.
    const S nsq = oco::warp_dot<kPrefixLine, true>(
        line, n, lane, [&](int j) { return th[j] * th[j]; });
    s = nsq > S(0) ? -(S(1) / oco::osqrt(nsq)) : S(0);
    if (t == len - 1) k_last = k;
    const bool walk = k < G;
    if (more) landed();
    const auto pxw = [&](int j) { return (s * th[j]) * w[j]; };
    const auto pq = [&](int j) { return z_at(t + 1, j) * (s * th[j]); };
    if (walk && more) {
      const auto sums =
          oco::warp_dot2<kPrefixLine, true>(line, n, lane, pxw, pq);
      xw = sums.x;
      q = sums.y;
    } else if (walk) {
      xw = oco::warp_dot<kPrefixLine, true>(line, n, lane, pxw);
    } else if (more) {
      q = oco::warp_dot<kPrefixLine, true>(line, n, lane, pq);
    }
    if (walk) {
      const S L = S(0.5) * (cnt - xw);
      const S lead = F - L;
      while (k < G && lead >= next) {
        if (lane == 0) {
          const long long i = perm[at(k)] * B + b;
          switch_t[i] = t;
          regret[i] = F;
        }
        if (++k < G) next = sorted[at(k)];
      }
    }
    xw_final = walk && !more;
  }
  // x = s theta is now ftl_action(theta): the comparator's action.
  S comp = S(0);
  if (replay) {
    for (int t = 0; t < len; ++t) {
      fetch(t);
      landed();
      const S qc = oco::warp_dot<kPrefixLine, true>(line, n, lane, [&](int j) {
        return z_at(t, j) * (s * th[j]);
      });
      comp = comp + S(0.5) * oco::oabs(qc - S(oco::widen(labels[t])));
    }
  } else {
    if (!xw_final)
      xw = oco::warp_dot<kPrefixLine, true>(line, n, lane, [&](int j) {
        return (s * th[j]) * w[j];
      });
    comp = S(0.5) * (cnt - xw);
  }
  if constexpr (kPlays) {
    // The pairs with no tail: one that never switched keeps the final FTL
    // action, one that switched at its last valid round played no FTRL
    // action.
    for (long long m = k_last; m < G; ++m) {
      S* xs = x_last + (perm[at(m)] * B + b) * n;
      for (int j = lane; j < n; j += 32) xs[j] = m >= k ? s * th[j] : S(0);
    }
  }
  if (lane != 0) return;
  comp_out[b] = comp;
  for (long long m = k_last; m < G; ++m) {
    const long long i = perm[at(m)] * B + b;
    if (m >= k) switch_t[i] = T;
    regret[i] = kPlays ? F : F - comp;
  }
}

// The largest d whose warp fits a block's shared memory with theta, w and
// the stage.
template <typename Z>
int prefix_max_shared_d() {
  return oco::max_shared_d(
      [](int d) { return prefix_warp_bytes<Z>(d, true); });
}

// K6aw's (or K2w's FTL launch's) kernel, with theta, w and the stage in
// shared memory or not.
template <typename Z, typename Y, bool kPlays>
auto prefix_wide(bool shared) {
  return shared ? &smart_prefix_wide_kernel<Z, Y, true, kPlays>
                : &smart_prefix_wide_kernel<Z, Y, false, kPlays>;
}

// K6aw's plan at d: theta, w and the stage in shared memory up to
// prefix_max_shared_d(), and the warps a block that keep the most warps
// resident an SM (oco::best_block).
template <typename Z, typename Y, bool kPlays = false>
int prefix_plan(int d, oco::WarpPlan* p) {
  if (d <= OCO_LARGE_D) return cudaErrorInvalidValue;
  p->shared = d <= prefix_max_shared_d<Z>();
  p->state = p->shared ? 0 : 2 * up4(d);
  return oco::best_block(prefix_wide<Z, Y, kPlays>(p->shared), kPrefixWarps,
                         prefix_warp_bytes<Z>(d, p->shared), p);
}

template <typename Z, typename Y, typename S, bool kPlays = false>
int launch_prefix_wide(const Z* z, const Y* y, const S* sorted,
                       const int* perm, const int* order, const int* lengths,
                       long long B, long long G, long long T, int d,
                       int replay, S* regret, long long* switch_t, S* comp,
                       S* x_last, S* state, cudaStream_t s) {
  oco::WarpPlan p{};
  const int err = prefix_plan<Z, Y, kPlays>(d, &p);
  if (err != cudaSuccess) return err;
  if (!p.shared && state == nullptr) return cudaErrorInvalidValue;
  const long long grid = (B + p.warps - 1) / p.warps;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  return oco::launch_with_smem(
      prefix_wide<Z, Y, kPlays>(p.shared), static_cast<unsigned int>(grid),
      p.warps * 32, static_cast<size_t>(p.smem), s, z, y, sorted, perm,
      order, lengths, B, G, T, d, replay, regret, switch_t, comp, x_last,
      state);
}

// K6b: 32 sequences (lane) x kTailWarps thresholds (warp) a block.
template <typename Z, typename Y, int D, typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(kTailWarps * 32)
smart_tail_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
                  const S* __restrict__ scales,
                  const int* __restrict__ order,
                  const int* __restrict__ lengths,
                  const long long* __restrict__ switch_t,
                  const S* __restrict__ comp, long long B, long long G,
                  long long T, oco::TileShape ts, S* __restrict__ regret) {
  static_assert(D != oco::kWideD, "K6bw is smart_tail_wide_kernel");
  constexpr int C = oco::Cap<D>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long thresh_blocks = (G + kTailWarps - 1) / kTailWarps;
  const long long slot = (blockIdx.x / thresh_blocks) * 32 + lane;
  const long long g = (blockIdx.x % thresh_blocks) * kTailWarps + warp;
  const long long b = slot < B ? order[slot] : -1;
  const bool on = b >= 0 && g < G;
  const long long i = g * B + b;
  const int len = on ? lengths[b] : 0;
  const long long tau = on ? switch_t[i] : T;
  // The tail is rounds tau + 1 .. len - 1; empty unless tau + 1 < len.
  const int start = tau + 1 < len ? static_cast<int>(tau) + 1 : len;
  const int n = D > 0 ? D : ts.n;

  S th[C], x[C];
  const bool tail = start < len;
#pragma unroll
  for (int j = 0; j < n; ++j) th[j] = S(0);
  S cum = tail ? regret[i] : S(0);
  oco::play_rows<S, D>(
      z, y, scales, b, T, ts, start, len, smem,
      [&](int, auto zr, S yt, S scale) {
        oco::ftrl_action_scaled<S, D>(th, x, n, scale);
        oco::update<S, D>(th, nullptr, zr,
                          oco::hinge_step<S, D>(x, zr, yt, n, cum), yt, n);
      },
      oco::NoChunkPass());
  if (tail) regret[i] = cum - comp[b];
}

// ------------------------------------------------------------------ K6bw

// Tails (warps) a K6bw block plays over one sequence's staged rows: of 1,
// 2, 4 and 8 at the path's shape on an H100, 1 and 2 were the fastest,
// within 1-2% of each other (PERF.md; scripts/wide_d_probe.py builds the
// others with -DOCO_TAIL_GROUP=P to time them).  What bounds the f64
// launch is the warps an SM, not the rows' traffic: at 205 registers 8
// fit whatever the group (launch bounds asking for 10 took 168 registers
// and 15.1 ms, but spilled 16 bytes a thread in one instance and not the
// other).
#ifndef OCO_TAIL_GROUP
#define OCO_TAIL_GROUP 2
#endif
constexpr int kTailGroup = OCO_TAIL_GROUP;
static_assert(kTailGroup >= 1 && kTailGroup <= 32, "1 to 32 warps a block");
// Products a warp's line holds (oco_warp.cuh); each lane updates
// kTailUnroll elements of theta at a time (launch bounds of one block an
// SM, as K3w's).
constexpr int kTailLine = 512;
constexpr int kTailUnroll = 4;
// K2w's tail launch plays one tail a block (its sequences' tails share no
// rounds on the main path, where one threshold a sequence switches) with
// lines of kPlaysTailLine products: a block of 26,672 bytes at d = 1,024
// in f64, so that its 8 warps an SM (by registers) fit shared memory too
// and the path's 1,024 tails run in one wave (lines of 512 would hold 7).
constexpr int kPlaysTailLine = 256;
template <bool kPlays>
constexpr int kTailP = kPlays ? 1 : kTailGroup;
template <bool kPlays>
constexpr int kTailL = kPlays ? kPlaysTailLine : kTailLine;

// A block's shared memory, each part a multiple of 16 bytes: the group's
// thetas and two stages of a row's 16-byte window (shared), then the
// group's product lines.
template <typename Z, bool kPlays = false, typename S = oco::compute_t<Z>>
__host__ __device__ inline long long tail_block_bytes(int d, bool shared) {
  return (shared ? kTailP<kPlays> * prefix_vec_bytes<Z>(d) +
                       2 * prefix_stage_bytes<Z>(d)
                 : 0) +
         kTailP<kPlays> * oco::line_elems<S, kTailL<kPlays>>() *
             static_cast<long long>(sizeof(S));
}

// kPlays: K2w's tail launch (see the source note of smart_kernel.cu's
// entry): each sequence's own sorted thresholds and row of the (E, T)
// scale table (eidx), the raw sum and the last action.
template <typename Z, typename Y, bool kShared, bool kPlays,
          typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(kTailP<kPlays> * 32, 1)
smart_tail_wide_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
                       const S* __restrict__ scales,
                       const int* __restrict__ eidx,
                       const int* __restrict__ perm,
                       const int* __restrict__ order,
                       const int* __restrict__ lengths,
                       const long long* __restrict__ switch_t,
                       const S* __restrict__ comp, long long B, long long G,
                       long long T, int d, S* __restrict__ regret,
                       S* __restrict__ x_last, S* state) {
  constexpr int P = kTailP<kPlays>, kLine = kTailL<kPlays>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Group grp's sorted thresholds k0 .. k0 + P - 1 of the sequence in the
  // order's place `slot` (their place in perm as prefix_wide's `at`).
  const long long grp = blockIdx.x / B, slot = blockIdx.x % B;
  const long long k0 = grp * P;
  const long long b = order[slot];
  const int len = lengths[b];
  const auto at = [&](long long k) { return kPlays ? k * B + b : k; };
  // Each thread reads the group's switch rounds: the block's first round
  // and its warp's; a tail is rounds tau + 1 .. len - 1, empty unless
  // tau + 1 < len.
  int first = len, start = len;
  long long i = 0;
  for (int w = 0; w < P && k0 + w < G; ++w) {
    const long long iw = perm[at(k0 + w)] * B + b;
    const long long tau = switch_t[iw];
    const int s = tau + 1 < len ? static_cast<int>(tau) + 1 : len;
    first = min(first, s);
    if (w == warp) {
      start = s;
      i = iw;
    }
  }
  // A block with no tail leaves whole, before any barrier; past the
  // shared boundary no barrier spans the block's warps.
  if (first == len || (!kShared && start == len)) return;
  const bool tail = start < len;
  const int n = d;
  const long long v = up4(n);
  S* th = kShared ? reinterpret_cast<S*>(smem) + warp * v
                  : state + ((k0 + warp) * B + slot) * v;
  unsigned char* stages =
      smem + (kShared ? P * v * static_cast<long long>(sizeof(S)) : 0);
  const long long stage_bytes = prefix_stage_bytes<Z>(n);
  S* line = reinterpret_cast<S*>(stages + (kShared ? 2 * stage_bytes : 0)) +
            warp * oco::line_elems<S, kLine>();
  const Z* rows = z + b * T * n;
  const Y* labels = y + b * T;
  const S* sc_row = kPlays ? scales + eidx[b] * T : scales;

  // Row t into stage t & 1: the 16-byte chunks around it (each holds an
  // element of the row, so it lies in that element's page), split over
  // the block's threads; the row lies at byte (its address & 15) of the
  // stage.
  const auto fetch = [&](int t) {
    const auto a = reinterpret_cast<unsigned long long>(
        rows + static_cast<long long>(t) * n);
    const auto* src = reinterpret_cast<const uint4*>(a & ~15ull);
    auto* dst = reinterpret_cast<uint4*>(stages + (t & 1) * stage_bytes);
    const long long chunks =
        ((a & 15) + n * static_cast<long long>(sizeof(Z)) + 15) / 16;
    for (long long c = threadIdx.x; c < chunks; c += blockDim.x)
      oco::copy_async(dst + c, src + c);
  };
  // Row t as the lanes read it: staged, or (past the boundary) the rows.
  const auto row = [&](int t) -> const Z* {
    const Z* r = rows + static_cast<long long>(t) * n;
    if constexpr (kShared)
      return reinterpret_cast<const Z*>(
          stages + (t & 1) * stage_bytes +
          (reinterpret_cast<unsigned long long>(r) & 15));
    else
      return r;
  };

  for (int j = lane; j < n; j += 32) th[j] = S(0);
  S cum = tail ? regret[i] : S(0);
  S y_next = tail ? S(oco::widen(labels[start])) : S(0);
  S sc_next = tail ? sc_row[start] : S(0);
  const int t_lo = kShared ? first : start;
  if constexpr (kShared) {
    fetch(t_lo);
    oco::commit_copies();
  }
  for (int t = t_lo; t < len; ++t) {
    if constexpr (kShared) {
      oco::wait_copies<0>();
      __syncthreads();  // row t landed; row t - 1's stage is free
      if (t + 1 < len) fetch(t + 1);
      oco::commit_copies();
      if (t < start) continue;
    }
    const Z* zr = row(t);
    const auto z_at = [&](int j) { return S(oco::widen(zr[j])); };
    const S yt = y_next, sc = sc_next;
    if (t + 1 < len) {
      y_next = S(oco::widen(labels[t + 1]));
      sc_next = sc_row[t + 1];
    }
    // The action x = sc theta, times f where it projects: ftrl_action_scaled
    // and hinge_step's dot; then update.
    S f;
    bool proj;
    const S q = oco::ftrl_q<kLine>(line, n, lane, sc, th, z_at, f, proj);
    const S diff = q - yt;
    cum = cum + S(0.5) * oco::oabs(diff);
    const S g = oco::half_sign(diff);
    // K2w writes the action of the tail's last round, formed from theta
    // before its update as the round formed it.
    S* xs = kPlays && t + 1 == len ? x_last + i * n : nullptr;
    for (int j0 = lane; j0 < n; j0 += 32 * kTailUnroll) {
      S zj[kTailUnroll], tj[kTailUnroll];
#pragma unroll
      for (int u = 0; u < kTailUnroll; ++u) {
        const int j = j0 + 32 * u;
        if (j < n) {
          zj[u] = z_at(j);
          tj[u] = th[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kTailUnroll; ++u) {
        const int j = j0 + 32 * u;
        if (j < n) {
          th[j] = tj[u] + g * zj[u];
          if constexpr (kPlays) {
            if (xs != nullptr) {
              const S x = sc * tj[u];
              xs[j] = proj ? f * x : x;
            }
          }
        }
      }
    }
    __syncwarp();
  }
  if (tail && lane == 0) {
    if constexpr (kPlays)
      regret[i] = cum;
    else
      regret[i] = cum - comp[b];
  }
}

// The largest d whose block fits shared memory with the thetas and the
// stages.
template <typename Z, bool kPlays = false>
int tail_max_shared_d() {
  return oco::max_shared_d(
      [](int d) { return tail_block_bytes<Z, kPlays>(d, true); });
}

// K6bw's (or K2w's tail launch's) block at d: kTailP warps, the thetas and
// the stages in shared memory up to tail_max_shared_d(); past it up4(d)
// elements of the state buffer a (threshold, sequence) pair.
template <typename Z, bool kPlays = false>
oco::WarpPlan tail_plan(int d) {
  oco::WarpPlan p{};
  p.warps = kTailP<kPlays>;
  p.shared = d <= tail_max_shared_d<Z, kPlays>();
  p.smem = tail_block_bytes<Z, kPlays>(d, p.shared);
  p.state = p.shared ? 0 : up4(d);
  return p;
}

// K6bw's (or K2w's tail launch's) kernel for a plan.
template <typename Z, typename Y, bool kPlays = false>
auto tail_wide(const oco::WarpPlan& p) {
  return p.shared ? &smart_tail_wide_kernel<Z, Y, true, kPlays>
                  : &smart_tail_wide_kernel<Z, Y, false, kPlays>;
}

template <typename Z, typename Y, typename S, bool kPlays = false>
int launch_tails_wide(const Z* z, const Y* y, const S* scales,
                      const int* eidx, const int* perm, const int* order,
                      const int* lengths, const long long* switch_t,
                      const S* comp, long long B, long long G, long long T,
                      int d, S* regret, S* x_last, S* state,
                      cudaStream_t s) {
  const oco::WarpPlan p = tail_plan<Z, kPlays>(d);
  if (!p.shared && state == nullptr) return cudaErrorInvalidValue;
  const long long grid = (G + p.warps - 1) / p.warps * B;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  return oco::launch_with_smem(
      tail_wide<Z, Y, kPlays>(p), static_cast<unsigned int>(grid),
      p.warps * 32, static_cast<size_t>(p.smem), s, z, y, scales, eidx, perm,
      order, lengths, switch_t, comp, B, G, T, d, regret, x_last, state);
}

// K6a.  Inputs: z (B, T, d) and y (B, T) contiguous, sorted (G,) the
// thresholds ascending and perm (G,) int32 their columns (sorted[k] is
// column perm[k]'s threshold), order (B,) int32 a permutation of the
// sequences, lengths (B,) int32 with 0 <= len <= T.  Outputs: switch_t
// (G, B) int64 (T where a pair never switches); regret (G, B), final for
// every pair without a tail and the tail's starting sum F for the others;
// comp (B,) the comparator.  Returns the cudaError_t of the launch.
template <typename Z, typename Y>
int launch_prefix(const void* z, const void* y, const void* sorted,
                  const void* perm, const void* order, const void* lengths,
                  long long B, long long G, long long T, int d, int replay,
                  void* regret, void* switch_t, void* comp, void* state,
                  void* stream) {
  using S = oco::compute_t<Z>;
  if (B < 1 || G < 1 || T < 1) return cudaErrorInvalidValue;
  const long long blocks = (B + kPrefixThreads - 1) / kPrefixThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* zp = static_cast<const Z*>(z);
  const auto* yp = static_cast<const Y*>(y);
  const auto* sp = static_cast<const S*>(sorted);
  const auto* pp = static_cast<const int*>(perm);
  const auto* op = static_cast<const int*>(order);
  const auto* lp = static_cast<const int*>(lengths);
  auto* rp = static_cast<S*>(regret);
  auto* tp = static_cast<long long*>(switch_t);
  auto* cp = static_cast<S*>(comp);
  auto* st = static_cast<S*>(state);
  int err = cudaSuccess;
  const int launched = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if constexpr (D == oco::kWideD)
      err = launch_prefix_wide<Z, Y, S>(zp, yp, sp, pp, op, lp, B, G, T, d,
                                        replay, rp, tp, cp, nullptr, st, s);
    else
      err = oco::launch_with_smem(smart_prefix_kernel<Z, Y, D>,
                                  static_cast<unsigned int>(blocks),
                                  kPrefixThreads, 0, s, zp, yp, sp, pp, op,
                                  lp, B, G, T, d, replay, rp, tp, cp);
  });
  return err != cudaSuccess ? err : launched;
}

// K6b.  Inputs: z, y, perm, order, lengths as K6a's; scales (T,) the
// per-round FTRL scales -(eta / sqrt(t)); switch_t and comp from K6a.  In
// and out: regret (G, B), K6a's on entry, with every tail played on
// return.  Returns the cudaError_t of the launch.
template <typename Z, typename Y>
int launch_tails(const void* z, const void* y, const void* scales,
                 const void* perm, const void* order, const void* lengths,
                 const void* switch_t, const void* comp, long long B,
                 long long G, long long T, int d, void* regret, void* state,
                 void* stream) {
  using S = oco::compute_t<Z>;
  if (B < 1 || G < 1 || T < 1) return cudaErrorInvalidValue;
  const long long blocks = (B + 31) / 32 * ((G + kTailWarps - 1) / kTailWarps);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* zp = static_cast<const Z*>(z);
  const auto* yp = static_cast<const Y*>(y);
  const auto* sp = static_cast<const S*>(scales);
  const auto* op = static_cast<const int*>(order);
  const auto* lp = static_cast<const int*>(lengths);
  const auto* tp = static_cast<const long long*>(switch_t);
  const auto* cp = static_cast<const S*>(comp);
  auto* rp = static_cast<S*>(regret);
  int err = cudaSuccess;
  const int launched = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if constexpr (D == oco::kWideD) {
      err = launch_tails_wide<Z, Y, S>(
          zp, yp, sp, nullptr, static_cast<const int*>(perm), op, lp, tp, cp,
          B, G, T, d, rp, nullptr, static_cast<S*>(state), s);
    } else {
      const oco::TileShape ts =
          oco::tile_shape<Z, Y>(d, kTailWarps, kTailStageBytes, 1);
      err = oco::launch_with_smem(
          smart_tail_kernel<Z, Y, D>, static_cast<unsigned int>(blocks),
          kTailWarps * 32, oco::ring_bytes<D>(ts), s, zp, yp, sp, op, lp, tp,
          cp, B, G, T, ts, rp);
    }
  });
  return err != cudaSuccess ? err : launched;
}

template <typename Z, typename Y>
int occupancy(int tails, int d, int* out) {
  using S = oco::compute_t<Z>;
  int err = cudaSuccess;
  const int checked = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const auto measure = [&](auto kernel, int threads, size_t smem) {
      err = oco::occupancy(kernel, threads, smem, out);
      if (err == cudaSuccess) err = oco::local_bytes(kernel, out + 2, smem);
    };
    if (tails) {
      if constexpr (D == oco::kWideD) {
        const oco::WarpPlan p = tail_plan<Z>(d);
        measure(tail_wide<Z, Y>(p), p.warps * 32,
                static_cast<size_t>(p.smem));
      } else {
        const oco::TileShape ts =
            oco::tile_shape<S, S>(d, kTailWarps, kTailStageBytes, 1);
        measure(smart_tail_kernel<S, S, D>, kTailWarps * 32,
                oco::ring_bytes<D>(ts));
      }
      return;
    }
    if constexpr (D != oco::kWideD) {
      err = oco::occupancy(smart_prefix_kernel<S, S, D>, kPrefixThreads, 0,
                           out);
      if (err == cudaSuccess)
        err = oco::local_bytes(smart_prefix_kernel<S, S, D>, out + 2);
    } else {
      oco::WarpPlan p{};
      err = prefix_plan<Z, Y>(d, &p);
      const auto kernel = prefix_wide<Z, Y, false>(p.shared);
      const auto smem = static_cast<size_t>(p.smem);
      if (err == cudaSuccess)
        err = oco::occupancy(kernel, p.warps * 32, smem, out);
      if (err == cudaSuccess) err = oco::local_bytes(kernel, out + 2, smem);
    }
  });
  return err != cudaSuccess ? err : checked;
}

}  // namespace

// The entries of both launches, for each storage pair of OCO_STORAGE_PAIRS
// (the suffix): z and y in the pair; sorted, scales, comp and regret in
// the compute type; any d >= 1.  state: a scratch buffer of the compute
// type (ops/game.py::wide_state_elems), else unused (may be null): for
// K6a where oco_smart_prefix_plan asks for one (d past its max_shared_d),
// `state` * B elements; for K6b where oco_smart_tail_plan asks for one,
// `state` * G * B.  K6b takes K6a's perm (K6bw plays its tails by sorted
// threshold).
#define OCO_SMART_SWEEP_ENTRIES(SUFFIX, Z, Y)                               \
  extern "C" int oco_smart_prefix_##SUFFIX(                                 \
      const void* z, const void* y, const void* sorted, const void* perm,   \
      const void* order, const void* lengths, long long B, long long G,     \
      long long T, int d, int replay, void* regret, void* switch_t,         \
      void* comp, void* state, void* stream) {                              \
    return launch_prefix<Z, Y>(z, y, sorted, perm, order, lengths, B, G, T, \
                               d, replay, regret, switch_t, comp, state,    \
                               stream);                                     \
  }                                                                         \
  extern "C" int oco_smart_tails_##SUFFIX(                                  \
      const void* z, const void* y, const void* scales, const void* perm,   \
      const void* order, const void* lengths, const void* switch_t,         \
      const void* comp, long long B, long long G, long long T, int d,       \
      void* regret, void* state, void* stream) {                            \
    return launch_tails<Z, Y>(z, y, scales, perm, order, lengths, switch_t, \
                              comp, B, G, T, d, regret, state, stream);     \
  }
OCO_STORAGE_PAIRS(OCO_SMART_SWEEP_ENTRIES)

// K2w's two launches, z and y as K6's, d > 512 (smart_kernel.cu's source
// note).  The FTL launch: sorted (G, B) each sequence's thresholds sorted
// ascending along G (stable) and perm (G, B) int32 their columns, order
// and lengths as K6a's; it writes comp (B,), switch_t (G, B) (T where a
// pair never switches), and cum (G, B): F for a pair that never switched,
// the FTL losses at the switch for the others; and x_last (G, B, d) of
// every pair without a tail.  The tail launch, on its outputs with scales
// (E, T) and eidx (B,) int32 each sequence's row, plays every tail and
// writes its pair's cum (the start sum plus the tail's losses) and x_last
// (the tail's last action).  state: where the plans (oco_smart_plays_plan)
// ask for one, `state` * B elements for the FTL launch and `state` * G * B
// for the tails, else unused (may be null).  Each returns the cudaError_t
// of its launch.
#define OCO_SMART_PLAYS_ENTRIES(SUFFIX, Z, Y)                               \
  extern "C" int oco_smart_plays_ftl_##SUFFIX(                              \
      const void* z, const void* y, const void* sorted, const void* perm,   \
      const void* order, const void* lengths, long long B, long long G,     \
      long long T, int d, int replay, void* cum, void* switch_t,            \
      void* comp, void* x_last, void* state, void* stream) {                \
    using S = oco::compute_t<Z>;                                            \
    if (B < 1 || G < 1 || T < 1 || T >= INT_MAX) return cudaErrorInvalidValue; \
    return launch_prefix_wide<Z, Y, S, true>(                               \
        static_cast<const Z*>(z), static_cast<const Y*>(y),                 \
        static_cast<const S*>(sorted), static_cast<const int*>(perm),       \
        static_cast<const int*>(order), static_cast<const int*>(lengths),   \
        B, G, T, d, replay, static_cast<S*>(cum),                           \
        static_cast<long long*>(switch_t), static_cast<S*>(comp),           \
        static_cast<S*>(x_last), static_cast<S*>(state),                    \
        static_cast<cudaStream_t>(stream));                                 \
  }                                                                         \
  extern "C" int oco_smart_plays_tails_##SUFFIX(                            \
      const void* z, const void* y, const void* scales, const void* eidx,   \
      const void* perm, const void* order, const void* lengths,             \
      const void* switch_t, long long B, long long G, long long T, int d,   \
      void* cum, void* x_last, void* state, void* stream) {                 \
    using S = oco::compute_t<Z>;                                            \
    if (B < 1 || G < 1 || T < 1 || T >= INT_MAX || d <= OCO_LARGE_D)        \
      return cudaErrorInvalidValue;                                         \
    return launch_tails_wide<Z, Y, S, true>(                                \
        static_cast<const Z*>(z), static_cast<const Y*>(y),                 \
        static_cast<const S*>(scales), static_cast<const int*>(eidx),       \
        static_cast<const int*>(perm), static_cast<const int*>(order),      \
        static_cast<const int*>(lengths),                                   \
        static_cast<const long long*>(switch_t), nullptr, B, G, T, d,       \
        static_cast<S*>(cum), static_cast<S*>(x_last),                      \
        static_cast<S*>(state), static_cast<cudaStream_t>(stream));         \
  }
OCO_STORAGE_PAIRS(OCO_SMART_PLAYS_ENTRIES)

// The storage of an occupancy or plan query: 0 float32, 1 float64, 2 bf16
// z (with int8 y).

// Registers a thread (out[0]), resident warps an SM (out[1]), bytes of a
// thread's local frame (out[2]) and of a block's shared memory (out[3]) of a
// K6a (tails 0; K6aw at its plan's block) or K6b (tails 1; K6bw at its
// plan's block) launch at feature dimension d on the current card with z
// in `storage`.  Returns
// the cudaError_t.
extern "C" int oco_smart_sweep_occupancy(int storage, int tails, int d,
                                         int* out) {
  switch (storage) {
    case 0:
      return occupancy<float, float>(tails, d, out);
    case 1:
      return occupancy<double, double>(tails, d, out);
    case 2:
      return occupancy<oco::bf16, signed char>(tails, d, out);
    default:
      return cudaErrorInvalidValue;
  }
}

// K6aw's plan at d > 512 with z in `storage` on the current card: warps a
// block (out[0]), bytes of dynamic shared memory a block (out[1]), 1 if
// theta, w and the stage lie in shared memory (out[2]), elements of the
// state buffer a sequence, 0 where shared (out[3]), and the largest d
// whose warp fits a block's shared memory (out[4]).  Returns the
// cudaError_t (cudaErrorInvalidValue for d <= 512 or an unknown storage).
extern "C" int oco_smart_prefix_plan(int storage, int d, long long* out) {
  oco::WarpPlan p{};
  int err = cudaErrorInvalidValue;
  int max_d = 0;
  if (storage == 0) {
    err = prefix_plan<float, float>(d, &p);
    max_d = prefix_max_shared_d<float>();
  } else if (storage == 1) {
    err = prefix_plan<double, double>(d, &p);
    max_d = prefix_max_shared_d<double>();
  } else if (storage == 2) {
    err = prefix_plan<oco::bf16, signed char>(d, &p);
    max_d = prefix_max_shared_d<oco::bf16>();
  }
  out[0] = p.warps;
  out[1] = p.smem;
  out[2] = p.shared ? 1 : 0;
  out[3] = p.state;
  out[4] = max_d;
  return err;
}

// K2w's FTL launch's plan (tails 0; K6aw's, with K2w's kernel) or its
// tail launch's (tails 1; one tail a block) at d > 512 with z in `storage`
// on the current card, as oco_smart_prefix_plan and oco_smart_tail_plan
// report theirs.  Returns the cudaError_t (cudaErrorInvalidValue for d <=
// 512 or an unknown storage).
extern "C" int oco_smart_plays_plan(int storage, int tails, int d,
                                    long long* out) {
  if (d <= OCO_LARGE_D || storage < 0 || storage > 2)
    return cudaErrorInvalidValue;
  oco::WarpPlan p{};
  int err = cudaSuccess, max_d = 0;
  if (tails) {
    p = storage == 0   ? tail_plan<float, true>(d)
        : storage == 1 ? tail_plan<double, true>(d)
                       : tail_plan<oco::bf16, true>(d);
    max_d = storage == 0   ? tail_max_shared_d<float, true>()
            : storage == 1 ? tail_max_shared_d<double, true>()
                           : tail_max_shared_d<oco::bf16, true>();
  } else {
    err = storage == 0   ? prefix_plan<float, float, true>(d, &p)
          : storage == 1 ? prefix_plan<double, double, true>(d, &p)
                         : prefix_plan<oco::bf16, signed char, true>(d, &p);
    max_d = storage == 0   ? prefix_max_shared_d<float>()
            : storage == 1 ? prefix_max_shared_d<double>()
                           : prefix_max_shared_d<oco::bf16>();
  }
  out[0] = p.warps;
  out[1] = p.smem;
  out[2] = p.shared ? 1 : 0;
  out[3] = p.state;
  out[4] = max_d;
  return err;
}

// Registers a thread (out[0]), resident warps an SM (out[1]), bytes of a
// thread's local frame (out[2]) and of a block's shared memory (out[3]) of
// K2w's FTL launch (tails 0) or tail launch (tails 1) at its plan's block,
// d > 512, z in `storage`.  Returns the cudaError_t.
extern "C" int oco_smart_plays_occupancy(int storage, int tails, int d,
                                         int* out) {
  long long plan[5];
  int err = oco_smart_plays_plan(storage, tails, d, plan);
  if (err != cudaSuccess) return err;
  const bool shared = plan[2] != 0;
  const auto smem = static_cast<size_t>(plan[1]);
  const int threads = static_cast<int>(plan[0]) * 32;
  const auto measure = [&](auto kernel) {
    err = oco::occupancy(kernel, threads, smem, out);
    if (err == cudaSuccess) err = oco::local_bytes(kernel, out + 2, smem);
  };
  oco::WarpPlan p{};
  p.shared = shared;
  if (storage == 0)
    tails ? measure(tail_wide<float, float, true>(p))
          : measure(prefix_wide<float, float, true>(shared));
  else if (storage == 1)
    tails ? measure(tail_wide<double, double, true>(p))
          : measure(prefix_wide<double, double, true>(shared));
  else
    tails ? measure(tail_wide<oco::bf16, signed char, true>(p))
          : measure(prefix_wide<oco::bf16, signed char, true>(shared));
  return err;
}

// K6bw's plan at d > 512 with z in `storage` on the current card: warps
// (tails) a block (out[0]), bytes of dynamic shared memory a block
// (out[1]), 1 if the thetas and the stages lie in shared memory (out[2]),
// elements of the state buffer a (threshold, sequence) pair, 0 where
// shared (out[3]), and the largest d whose block fits shared memory
// (out[4]).  Returns cudaErrorInvalidValue for d <= 512 or an unknown
// storage, else cudaSuccess.
extern "C" int oco_smart_tail_plan(int storage, int d, long long* out) {
  if (d <= OCO_LARGE_D || storage < 0 || storage > 2)
    return cudaErrorInvalidValue;
  const oco::WarpPlan p = storage == 0   ? tail_plan<float>(d)
                          : storage == 1 ? tail_plan<double>(d)
                                         : tail_plan<oco::bf16>(d);
  out[0] = p.warps;
  out[1] = p.smem;
  out[2] = p.shared ? 1 : 0;
  out[3] = p.state;
  out[4] = storage == 0   ? tail_max_shared_d<float>()
           : storage == 1 ? tail_max_shared_d<double>()
                          : tail_max_shared_d<oco::bf16>();
  return cudaSuccess;
}
