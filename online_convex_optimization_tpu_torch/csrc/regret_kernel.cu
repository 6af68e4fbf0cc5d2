// K1: the FTRL/FTL regret game and its final-FTL comparator in one pass.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_game.py
// _regret_kernel (and its VMEM-state twin _regret_kernel_dloop), entry
// regrets_fused.  Python wrapper and plain PyTorch version:
// online_convex_optimization_tpu_torch/ops/game.py (regrets_fused and
// regret_plays; regrets_fused_reference and regret_plays_reference).
//
// A launch plays P "plays" of every sequence: play p of sequence b is the
// game with alg_flag flags[p, b] (0 = FTRL, 1 = FTL) and the FTRL scales of
// row eidx[b] of an (E, T) table.  The main path's evaluation plays FTRL
// and FTL of each sequence from one copy of its rows (P = 2); the g(T)
// table and regrets_fused play once (P = 1).  Each play runs over the
// sequence's own rounds (ragged horizons share a launch).  Per round, in
// the reference's order of operations: the action (FTRL with the ball
// projection, or FTL), q = <z_t, x>, the hinge loss, the tie-exact
// subgradient update, and the identity statistic w += y_t z_t.  The final
// comparator is the final FTL action x_c of the play's theta, scored by the
// hinge identity comp = 0.5 * (len - <x_c, w>), exact when every row has
// ||z_t|| <= 1 and y_t = +-1; for other data the wrapper picks the replay
// mode, which scores x_c by a second pass over the sequence's own rows.
//
// What bounds it on an H100: each round reads 8*(d+1) bytes of f64 input
// once (48 bytes at d = 5) against a serial chain of about 3d + 10 flops
// and, for FTL every round and for FTRL when it projects, a correctly
// rounded sqrt and divide; each of those sits in its own basic block, so
// the chain's latency, not the card's rates, sets a launch's time, and a
// launch costs its longest sequence.  The design:
//   - a block holds 32 sequences (lane) x P play-warps, so the main path's
//     FTRL and FTL plays read one copy of z, in the caller's (B, T, d)
//     layout (no time-major copy);
//   - a producer warp stages the sequences' rows chunk by chunk in shared
//     memory (oco_tiles.cuh play_chunks: each of its lanes bulk-copies its
//     own sequence's chunk with the TMA, completing on the stage's
//     mbarrier), so no load and no copy sits in a play's round, and the
//     play-warps meet it only at mbarriers, never at a block barrier;
//   - the FTRL scale -(eta / sqrt(t)) comes from the table
//     (ops/game.py::sweep_scales, the same tensor/tensor expression),
//     loaded a round ahead: FTRL pays the sqrt and divide only when it
//     projects;
//   - the main path launches K1 once for the whole g(T) table and once a
//     case, each launch as wide as the case (experiments/), where the
//     parent launched 17 times with at most 8,192 threads.
// z and y may be stored narrower than the arithmetic (OCO_STORAGE_PAIRS:
// bf16 z, int8 or bf16 y): the producer bulk-copies the narrow windows
// (a z and a y window of their own element sizes) and the players widen
// each element on read, so a narrow launch equals the f32 launch on the
// upcast values in every bit, on fewer bytes.
//
// K1w (K1 past d = 512, regret_wide_kernel) plays each play of a sequence
// on a warp.  One thread a play with theta, w and x in a (d, P B) buffer
// (this instance's first design) left the card nearly empty at the path's
// width (B = 1,024 x 2 plays: 64 warps on 132 SMs, each round 4-6 passes
// over 8 KB vectors, a memory round trip per 8 elements).  The design:
//   - a block plays one sequence, warp p its play p, as K6aw plays a
//     sequence's FTL track (smart_sweep_kernel.cu); the P play-warps
//     share one staged copy of the sequence's rows: the block copies the
//     16-byte window around row t + 1 into a shared stage with cp.async
//     while it plays round t (two stages, one barrier a round), so each
//     row crosses L2 once a sequence, as K1's shared copy of z does;
//   - lane l holds elements j = l + 32 m of its play's theta in shared
//     memory; x is never stored: each lane forms x_j from theta_j and the
//     round's scale where a product needs it (the FTRL scale read a round
//     ahead from the (E, T) table, oco::ScaleAhead, times 1/sqrt(nsq)
//     again in a round that projects; FTL's -(1/sqrt(||theta||^2))), and
//     each sum is one lane's index-order sum of a product line
//     (oco_warp.cuh), the same bits as the thread-a-play helpers.  An FTRL
//     round sums ||x||^2 and <z_t, x> side by side on lanes 0 and 1 and
//     <z_t, x> again only where it projects; FTL sums ||theta||^2, then q;
//     a play's lanes write x_last in its last round;
//   - w = sum y_t z_t is the same for every play of a sequence (the same
//     rows, the same len, the same order), so the block keeps one, in
//     shared memory, warp p adding y_t z_t to its elements j with
//     floor(j / 32) mod P = p; the identity comparator sums <x_c, w> once
//     the block's barrier has seen every warp's last round, and the
//     replay comparator sums <z_t, x_c> over the sequence's own rows, two
//     rows side by side, each in index order;
//   - a block's plays may have different flags (the path plays FTRL and
//     FTL), so its round barrier paces FTRL's one chain at FTL's two.
// What bounds it: FTL's two one-lane chains of d dependent adds a round
// over the sequence's rounds, times the waves of blocks the card needs
// (f64 at d = 1,024: 49,216 bytes of shared memory a block of two warps,
// four blocks an SM, the path's 1,024 sequences in two waves; f32 nine
// blocks an SM, its 2,048 in two).  Up to the plan's max_shared_d the
// thetas, w and the stages lie on the chip; past it the thetas and w lie
// in the caller's buffer, (B, (P + 1) d) contiguous a sequence, and the
// lanes read their rows from global memory: the library's plan
// (oco_regret_plan) reports the boundary and the block, and the wrapper
// allocates the buffer it asks for.
#include "oco_warp.cuh"

namespace {

// Plays a block serves at most, and bytes of rows a stage holds: two stages
// of 24 KB let four blocks share an SM (f64, d = 5: 16 rounds a chunk).
constexpr int kMaxPlays = 8;
constexpr int kStages = 2;
constexpr size_t kStageBytes = 24 * 1024;

template <typename Z, typename Y, int D>
__global__ void __launch_bounds__((kMaxPlays + 1) * 32)
regret_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
              const int* __restrict__ flags,
              const oco::compute_t<Z>* __restrict__ scales,
              const int* __restrict__ eidx, const int* __restrict__ lengths,
              long long B, long long T, int P, oco::ChunkShape ts,
              int replay, oco::compute_t<Z>* __restrict__ cum_out,
              oco::compute_t<Z>* __restrict__ comp_out,
              oco::compute_t<Z>* __restrict__ x_last) {
  static_assert(D != oco::kWideD, "K1w is regret_wide_kernel");
  using S = oco::compute_t<Z>;
  constexpr int C = oco::Cap<D>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  // Warp p < P plays play p; warp P fills the stages.
  const int lane = threadIdx.x & 31, p = threadIdx.x >> 5;
  const long long slot = static_cast<long long>(blockIdx.x) * 32 + lane;
  const long long b = slot < B ? slot : -1;
  const int n = D > 0 ? D : ts.n;
  const int len = b >= 0 ? lengths[b] : 0;
  const long long i = p * B + b;
  const bool player = p < P;
  const bool ftrl = player && b >= 0 && flags[i] == 0;
  oco::ScaleAhead<S> scale{scales + (b >= 0 ? eidx[b] * T : 0), T, S(0)};
  if (ftrl) scale.start(0);

  S th[C], w[C], x[C];
#pragma unroll
  for (int j = 0; j < n; ++j) th[j] = w[j] = x[j] = S(0);
  S cum = S(0);
  oco::play_chunks<S, D, kStages>(
      z, y, b, B, T, ts, len,
      player ? oco::ChunkRole::kLead : oco::ChunkRole::kProducer, P, P, smem,
      [](int) { return 0; },
      [&](int t, auto zr, S yt) {
        if (ftrl)
          oco::ftrl_action_scaled<S, D>(th, x, n, scale.take(t));
        else
          oco::ftl_action<S, D>(th, x, n);
        oco::play_action<S, D>(th, w, x, zr, yt, n, cum);
      });
  if (!player || b < 0) return;
  // x is the last action played (zero if none); then the comparator's.
#pragma unroll
  for (int j = 0; j < n; ++j) x_last[i * n + j] = x[j];
  S comp = oco::identity_comparator<S, D>(th, w, x, n, S(len));
  if (replay)
    comp = oco::replay_comparator_rows<S, D>(z, y, b, T, n, len, x);
  cum_out[i] = cum;
  comp_out[i] = comp;
}

// ------------------------------------------------------------------- K1w

// Products a warp's line holds (oco_warp.cuh): 512 in float64, 256 in
// float32, whose smaller lines and batches take 92 registers where 512
// took 128, so that 9 blocks of two plays share an SM where 8 did (on an
// H100 at the path's f32 shape, 6% faster; in f64, 256 was 1.5% slower).
template <typename S>
constexpr int kPlayLine = sizeof(S) == 4 ? 256 : 512;
// Each lane forms a chunk's products before it stores any (oco_warp.cuh
// put_products, kBatch) and updates kPlayUnroll elements of theta, and of
// w, at a time, so that their shared-memory loads are in flight together.
constexpr int kPlayUnroll = 4;

using oco::up4;

// A block's shared memory, each part a multiple of 16 bytes: the P
// thetas and w, and the two stages (shared), then the P product lines.  A
// stage holds the 16-byte window around a row: its bytes rounded up to 16,
// and 16 more.
template <typename Z>
__host__ __device__ inline long long play_stage_bytes(int d) {
  return ((d * static_cast<long long>(sizeof(Z)) + 15) & ~15LL) + 16;
}
template <typename Z, typename S = oco::compute_t<Z>>
__host__ __device__ inline long long play_state_bytes(int d, int P,
                                                      bool shared) {
  return shared ? (P + 1) * up4(d) * static_cast<long long>(sizeof(S)) +
                      2 * play_stage_bytes<Z>(d)
                : 0;
}
template <typename Z, typename S = oco::compute_t<Z>>
__host__ __device__ inline long long play_block_bytes(int d, int P,
                                                      bool shared) {
  return play_state_bytes<Z>(d, P, shared) +
         P * oco::line_elems<S, kPlayLine<S>>() *
             static_cast<long long>(sizeof(S));
}

// The launch bounds name two blocks of kMaxPlays warps an SM in float32
// (128 registers, what its lines and batches take, as K3w's), one in
// float64.
template <typename Z, typename Y, bool kShared,
          typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(kMaxPlays * 32, sizeof(S) == 4 ? 2 : 1)
regret_wide_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
                   const int* __restrict__ flags,
                   const S* __restrict__ scales, const int* __restrict__ eidx,
                   const int* __restrict__ lengths, long long B, long long T,
                   int P, int d, int replay, S* __restrict__ cum_out,
                   S* __restrict__ comp_out, S* __restrict__ x_last,
                   S* state) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, p = threadIdx.x >> 5;
  const long long b = blockIdx.x;
  const int n = d;
  const int len = lengths[b];
  const long long i = p * B + b;
  const bool ftrl = flags[i] == 0;
  oco::ScaleAhead<S> scale{scales + eidx[b] * T, T, S(0)};
  if (ftrl) scale.start(0);
  const long long v = up4(n);
  S* vecs = kShared ? reinterpret_cast<S*>(smem) : state + b * (P + 1) * v;
  S* th = vecs + p * v;
  S* w = vecs + P * v;
  unsigned char* stages = smem + (kShared ? (P + 1) * v * sizeof(S) : 0);
  const long long stage_bytes = play_stage_bytes<Z>(n);
  S* line = reinterpret_cast<S*>(stages + (kShared ? 2 * stage_bytes : 0)) +
            p * oco::line_elems<S, kPlayLine<S>>();
  const Z* rows = z + b * T * n;
  const Y* labels = y + b * T;

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
  for (int j = threadIdx.x; j < n; j += blockDim.x) w[j] = S(0);
  S cum = S(0);
  S y_next = len > 0 ? S(oco::widen(labels[0])) : S(0);
  if constexpr (kShared) {
    if (len > 0) fetch(0);
    oco::commit_copies();
  }
  __syncthreads();
  for (int t = 0; t < len; ++t) {
    if constexpr (kShared) {
      oco::wait_copies<0>();
      __syncthreads();  // row t landed; row t - 1's stage is free
      if (t + 1 < len) fetch(t + 1);
      oco::commit_copies();
    }
    const Z* zr = row(t);
    const auto z_at = [&](int j) { return S(oco::widen(zr[j])); };
    const S yt = y_next;
    if (t + 1 < len) y_next = S(oco::widen(labels[t + 1]));
    // The action x = a theta, times f where FTRL projects.
    S q, a, f = S(1);
    bool proj = false;
    if (ftrl) {
      a = scale.take(t);
      q = oco::ftrl_q<kPlayLine<S>>(line, n, lane, a, th, z_at, f, proj);
    } else {
      a = oco::ftl_scale<kPlayLine<S>>(line, n, lane, th);
      q = oco::warp_dot<kPlayLine<S>, true>(
          line, n, lane, [&](int j) { return z_at(j) * (a * th[j]); });
    }
    if (t == len - 1) {
      S* out = x_last + i * n;
      for (int j = lane; j < n; j += 32)
        out[j] = proj ? f * (a * th[j]) : a * th[j];
    }
    // hinge_step, then update: theta, and w on this warp's elements.
    const S diff = q - yt;
    cum = cum + S(0.5) * oco::oabs(diff);
    const S g = oco::half_sign(diff);
    for (int j0 = lane; j0 < n; j0 += 32 * kPlayUnroll) {
      S zj[kPlayUnroll], tj[kPlayUnroll];
#pragma unroll
      for (int u = 0; u < kPlayUnroll; ++u) {
        const int j = j0 + 32 * u;
        if (j < n) {
          zj[u] = z_at(j);
          tj[u] = th[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kPlayUnroll; ++u)
        if (j0 + 32 * u < n) th[j0 + 32 * u] = tj[u] + g * zj[u];
    }
    for (int j0 = lane + 32 * p; j0 < n; j0 += 32 * P * kPlayUnroll) {
      S zj[kPlayUnroll], wj[kPlayUnroll];
#pragma unroll
      for (int u = 0; u < kPlayUnroll; ++u) {
        const int j = j0 + 32 * P * u;
        if (j < n) {
          zj[u] = z_at(j);
          wj[u] = w[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kPlayUnroll; ++u) {
        const int j = j0 + 32 * P * u;
        if (j < n) w[j] = wj[u] + yt * zj[u];
      }
    }
    __syncwarp();
  }
  __syncthreads();  // every warp's w elements are final
  if (len == 0) {
    for (int j = lane; j < n; j += 32) x_last[i * n + j] = S(0);
  }
  // The comparator's action x_c = ftl_action(theta) = s theta.
  const S s = oco::ftl_scale<kPlayLine<S>>(line, n, lane, th);
  S comp = S(0);
  if (replay) {
    // 0.5 sum_t |<z_t, x_c> - y_t|, rows t and t + 1 side by side.
    for (int t = 0; t < len; t += 2) {
      const Z* r0 = rows + static_cast<long long>(t) * n;
      const Z* r1 = t + 1 < len ? r0 + n : r0;
      const auto sums = oco::warp_dot2<kPlayLine<S>, true>(
          line, n, lane,
          [&](int j) { return S(oco::widen(r0[j])) * (s * th[j]); },
          [&](int j) { return S(oco::widen(r1[j])) * (s * th[j]); });
      comp = comp + S(0.5) * oco::oabs(sums.x - S(oco::widen(labels[t])));
      if (t + 1 < len)
        comp = comp +
               S(0.5) * oco::oabs(sums.y - S(oco::widen(labels[t + 1])));
    }
  } else {
    const S xw = oco::warp_dot<kPlayLine<S>, true>(
        line, n, lane, [&](int j) { return (s * th[j]) * w[j]; });
    comp = S(0.5) * (S(len) - xw);
  }
  if (lane == 0) {
    cum_out[i] = cum;
    comp_out[i] = comp;
  }
}

// The largest d whose block of P play-warps fits shared memory with the
// thetas, w and the stages.
template <typename Z>
int play_max_shared_d(int P) {
  return oco::max_shared_d(
      [P](int d) { return play_block_bytes<Z>(d, P, true); });
}

// K1w's block at d with P plays: P warps, the thetas, w and the stages in
// shared memory up to play_max_shared_d(P).
template <typename Z>
oco::WarpPlan play_plan(int d, int P) {
  oco::WarpPlan p{};
  p.warps = P;
  p.shared = d <= play_max_shared_d<Z>(P);
  p.smem = play_block_bytes<Z>(d, P, p.shared);
  p.state = p.shared ? 0 : (P + 1) * up4(d);
  return p;
}

// K1w's kernel for a plan.
template <typename Z, typename Y>
auto regret_wide(const oco::WarpPlan& p) {
  return p.shared ? &regret_wide_kernel<Z, Y, true>
                  : &regret_wide_kernel<Z, Y, false>;
}

template <typename Z, typename Y>
int launch(const void* z, const void* y, const void* flags,
           const void* scales, const void* eidx, const void* lengths,
           long long B, long long T, int P, int d, int replay, void* cum,
           void* comp, void* x_last, void* state, void* stream) {
  using S = oco::compute_t<Z>;
  if (B < 1 || T < 1 || P < 1 || P > kMaxPlays) return cudaErrorInvalidValue;
  const long long blocks = (B + 31) / 32;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* zp = static_cast<const Z*>(z);
  const auto* yp = static_cast<const Y*>(y);
  const auto* fp = static_cast<const int*>(flags);
  const auto* sp = static_cast<const S*>(scales);
  const auto* ep = static_cast<const int*>(eidx);
  const auto* lp = static_cast<const int*>(lengths);
  auto* cp = static_cast<S*>(cum);
  auto* op = static_cast<S*>(comp);
  auto* xp = static_cast<S*>(x_last);
  int err = cudaSuccess;
  const int launched = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if constexpr (D == oco::kWideD) {
      const oco::WarpPlan p = play_plan<Z>(d, P);
      if ((!p.shared && state == nullptr) || B > 0x7fffffffLL) {
        err = cudaErrorInvalidValue;
        return;
      }
      err = oco::launch_with_smem(
          regret_wide<Z, Y>(p), static_cast<unsigned int>(B), p.warps * 32,
          static_cast<size_t>(p.smem), s, zp, yp, fp, sp, ep, lp, B, T, P, d,
          replay, cp, op, xp, static_cast<S*>(state));
    } else {
      // A narrow stage holds the rounds a float32 one holds, in fewer
      // bytes, so that more blocks share an SM.
      const size_t stage_bytes =
          oco::kWindowed<Z, Y>
              ? kStageBytes * (d * sizeof(Z) + sizeof(Y)) /
                    ((d + 1) * sizeof(S))
              : kStageBytes;
      const oco::ChunkShape ts = oco::chunk_shape<Z, Y, D>(d, stage_bytes);
      err = oco::launch_with_smem(
          regret_kernel<Z, Y, D>, static_cast<unsigned int>(blocks),
          (P + 1) * 32, oco::chunk_ring_bytes<D>(ts, kStages), s, zp, yp, fp,
          sp, ep, lp, B, T, P, ts, replay, cp, op, xp);
    }
  });
  return err != cudaSuccess ? err : launched;
}

template <typename S>
int occupancy(int P, int d, int* out) {
  if (P < 1 || P > kMaxPlays) return cudaErrorInvalidValue;
  int err = cudaSuccess;
  const int checked = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const auto measure = [&](auto kernel, int threads, size_t smem) {
      err = oco::occupancy(kernel, threads, smem, out);
      if (err == cudaSuccess) err = oco::local_bytes(kernel, out + 2, smem);
    };
    if constexpr (D == oco::kWideD) {
      const oco::WarpPlan p = play_plan<S>(d, P);
      measure(regret_wide<S, S>(p), p.warps * 32,
              static_cast<size_t>(p.smem));
    } else {
      const oco::ChunkShape ts = oco::chunk_shape<S, S, D>(d, kStageBytes);
      measure(regret_kernel<S, S, D>, (P + 1) * 32,
              oco::chunk_ring_bytes<D>(ts, kStages));
    }
  });
  return err != cudaSuccess ? err : checked;
}

}  // namespace

// Inputs: z (B, T, d) and y (B, T) contiguous in a storage pair of
// OCO_STORAGE_PAIRS (the suffix), flags (P, B) int32 (0 = FTRL, 1 = FTL),
// scales (E, T) the FTRL scales -(eta_e / sqrt(t)) in the compute type,
// eidx (B,) int32 each sequence's row of scales, lengths (B,) int32 with
// 0 <= len <= T; 1 <= P <= 8; any d >= 1.  Outputs, in the compute type:
// cum_loss (P, B), comp_loss (P, B), x_last (P, B, d).  state: where
// oco_regret_plan asks for one (d past its max_shared_d), a scratch buffer
// of `state` * B elements of the compute type
// (ops/game.py::wide_state_elems), else unused (may be null).  Returns the
// cudaError_t of the launch.
#define OCO_REGRETS_ENTRY(SUFFIX, Z, Y)                                      \
  extern "C" int oco_regrets_fused_##SUFFIX(                                 \
      const void* z, const void* y, const void* flags, const void* scales,   \
      const void* eidx, const void* lengths, long long B, long long T, int P, \
      int d, int replay, void* cum, void* comp, void* x_last, void* state,   \
      void* stream) {                                                        \
    return launch<Z, Y>(z, y, flags, scales, eidx, lengths, B, T, P, d,      \
                        replay, cum, comp, x_last, state, stream);           \
  }
OCO_STORAGE_PAIRS(OCO_REGRETS_ENTRY)

// Registers a thread (out[0]), resident warps an SM (out[1]), bytes of a
// thread's local frame (out[2], cudaFuncAttributes.localSizeBytes) and of a
// block's shared memory (out[3]) of a launch with P plays at feature
// dimension d on the current card (K1w at its plan's block); f64 nonzero
// for the float64 instance.  Returns the cudaError_t.
extern "C" int oco_regrets_occupancy(int f64, int P, int d, int* out) {
  return f64 ? occupancy<double>(P, d, out) : occupancy<float>(P, d, out);
}

// K1w's plan at d > 512 with P plays and z in `storage` (0 float32, 1
// float64, 2 bf16) on the current card: warps a block (out[0]), bytes of
// dynamic shared memory a block (out[1]), 1 if the thetas, w and the
// stages lie in shared memory (out[2]), elements of the state buffer a
// sequence, 0 where shared (out[3]), and the largest d whose block fits
// shared memory (out[4]).  Returns cudaErrorInvalidValue for d <= 512, P
// outside 1 .. 8 or an unknown storage, else cudaSuccess.
extern "C" int oco_regret_plan(int storage, int P, int d, long long* out) {
  if (d <= OCO_LARGE_D || P < 1 || P > kMaxPlays || storage < 0 ||
      storage > 2)
    return cudaErrorInvalidValue;
  const oco::WarpPlan p = storage == 0   ? play_plan<float>(d, P)
                          : storage == 1 ? play_plan<double>(d, P)
                                         : play_plan<oco::bf16>(d, P);
  out[0] = p.warps;
  out[1] = p.smem;
  out[2] = p.shared ? 1 : 0;
  out[3] = p.state;
  out[4] = storage == 0   ? play_max_shared_d<float>(P)
           : storage == 1 ? play_max_shared_d<double>(P)
                          : play_max_shared_d<oco::bf16>(P);
  return cudaSuccess;
}
