// K2: the whole single-switch SMART algorithm in one pass, for one or more
// thresholds of each sequence.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_smart.py
// _smart_kernel (round step _smart_round), entry smart_regrets_packed.
// Python wrapper and plain PyTorch versions:
// online_convex_optimization_tpu_torch/ops/smart.py (smart_regrets and
// smart_plays; smart_regrets_reference, and smart_plays_reference, the
// plain mirror of this design).
//
// Semantics (models/smart.py): an always-on FTL track plays its pre-update
// action and updates; F accumulates its losses, (w, cnt) the identity
// statistics.  Before the switch the FTL loss counts, and the post-update
// FTL action s is scored on the prefix by the hinge identity
// L = 0.5 * (cnt - <s, w>); the switch fires at the first round with
// F - L >= threshold (tau, T when it never fires) and takes effect the
// round AFTER: a fresh FTRL track then plays with the GLOBAL round index
// and its losses count.  The final comparator (the final FTL action) is
// scored by the identity on contract data and by a replay of the
// sequence's rows otherwise; the wrapper chooses before the launch.
//
// What bounds it on an H100: 8*(d+1) bytes of f64 input a round against
// serial chains, each with a correctly rounded sqrt and divide a round in
// its own basic block: the chains' latency sets the launch's time.  The
// parent ran the FTL track and, once switched, the FTRL track in one
// thread, with two FTL actions a round before the switch, so an early
// switcher paid about two actions a round for ~1,000 rounds.  The design:
//   - one FTL action a round: the post-update action that the switch test
//     scores is the next round's pre-update action (the same function of
//     the same theta), carried in registers, as K6a does;
//   - a block holds 32 sequences (lane) and 2 + G warps, specialised: warp
//     0 plays the FTL track once for all G thresholds of its sequences (the
//     main path has two, sqrt(2T) and g(T)) and publishes each switch round
//     and the FTL losses at it in shared memory; warp 1 + g plays the FTRL
//     tails of threshold g on the same staged rows, each chunk once warp 0
//     has played it, starting each tail once its switch round is known, so
//     the tails run beside the FTL track instead of after it in the same
//     thread; warp 1 + G, the producer, bulk-copies each lane's sequence's
//     chunk of the caller's (B, T, d) rows with the TMA (oco_tiles.cuh
//     play_chunks, kStages stages, mbarriers and no block barrier), so no
//     load and no copy sits in a round;
//   - the FTRL scale -(eta / sqrt(t)) comes from the (E, T) table
//     (ops/game.py::sweep_scales), loaded a round ahead.
// A switched pair's total is the FTL losses at the switch, F in every bit
// (the same sums of the same terms), then the tail's losses: column g
// equals the parent, and the plain version, bit for bit.  Narrow storage
// (OCO_STORAGE_PAIRS) goes through the same bulk-copied windows as K1's
// and is widened on read: a narrow launch equals the f32 launch on the
// upcast values in every bit.
//
// Past d = 512 K2 is K2w: K6's two wide kernels in a K2 mode
// (smart_sweep_kernel.cu, entries oco_smart_plays_ftl_* and
// oco_smart_plays_tails_*; the wrapper ops/smart.py::launch_smart launches
// both), since column g of K6 is K2 run with threshold g, bit for bit.  A
// block of this kernel (a sequence a lane, 1 + G warps of it, each thread
// holding its vectors in a (d, slots) device buffer) left the card nearly
// empty at the path's width (B = 1,024: 32 blocks of 4 warps on 132 SMs,
// a memory round trip per 8 elements of each sum).  The design:
//   - the FTL launch is K6aw's kernel (smart_prefix_wide_kernel, kPlays):
//     a warp a sequence, theta and w in shared memory, x never stored, the
//     switch test's <x, w> beside the next round's <z, x>; each sequence's
//     thresholds sorted on the device (a stable sort along G, as K6a's
//     list), walked by the same pointer: each threshold's first crossing,
//     the tie lead >= threshold kept.  It writes comp, the switch rounds
//     and F at each switch, and for the pairs with no tail their sum (F)
//     and action (the final FTL action s theta, or zeros where the switch
//     came at the last valid round);
//   - the tail launch is K6bw's kernel (smart_tail_wide_kernel, kPlays), a
//     tail a block with shorter product lines, so that the path's 1,024
//     tails fill one wave of 8 warps an SM: each switched pair's FTRL tail
//     from F at its switch with its sequence's row of the scale table,
//     writing the raw sum and the tail's last action (the scale, then the
//     projection where ||x||^2 > 1).
// Both launches take the sequences longest first (game.length_order, on
// the device).  At the path's shape (f64, B = 1,024, T = 1,000, d =
// 1,024) the FTL launch's two one-lane chains of d adds a round and the
// longest tail's one chain bound the pair of launches (PERF.md).
#include <climits>

#include "oco_tiles.cuh"

namespace {

// Thresholds a sequence has at most (warps a block: 2 + G), and bytes of
// rows a stage holds: three stages of 12 KB (f64, d = 5: 8 rounds a chunk)
// let the FTL warp run two chunks ahead of the tails; registers, not the
// ring, then keep four blocks of the main path's G = 2 on an SM.
constexpr int kMaxThresholds = 4;
constexpr int kStages = 3;
constexpr size_t kStageBytes = 12 * 1024;

template <typename Z, typename Y, int D,
          typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__((2 + kMaxThresholds) * 32)
smart_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
             const S* __restrict__ thresholds, const S* __restrict__ scales,
             const int* __restrict__ eidx, const int* __restrict__ lengths,
             long long B, long long T, int G, oco::ChunkShape ts, int replay,
             S* __restrict__ cum_out, S* __restrict__ comp_out,
             S* __restrict__ x_last, long long* __restrict__ switch_t) {
  static_assert(D != oco::kWideD, "K2w is K6's wide kernels in K2 mode");
  constexpr int C = oco::Cap<D>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  // Warp 0's switch rounds (INT_MAX until a threshold is passed) and the
  // FTL losses F at them, for the tails.
  __shared__ int tau_sh[kMaxThresholds][32];
  __shared__ S fsw_sh[kMaxThresholds][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long slot = static_cast<long long>(blockIdx.x) * 32 + lane;
  const long long b = slot < B ? slot : -1;
  const int n = D > 0 ? D : ts.n;
  const int len = b >= 0 ? lengths[b] : 0;
  if (warp == 0) {
#pragma unroll
    for (int g = 0; g < kMaxThresholds; ++g) tau_sh[g][lane] = INT_MAX;
  }
  // (play_chunks opens with a block barrier, which publishes the INT_MAX.)
  volatile int* tau_pub = &tau_sh[0][0];

  // Warp 0 plays the FTL track once for every threshold: th, w, F, cnt,
  // and x, the pre-update action of the next round (the post-update action
  // of the last).  Warp 1 + g plays threshold g's FTRL tail, rounds
  // tau + 1 .. len - 1, with a fresh theta (th), the table's scale of the
  // global round and its total in cum, from the sum F at tau.  Warp 1 + G
  // fills the stages.
  const bool ftl = warp == 0;
  const int g_tail = warp - 1;
  const oco::ChunkRole role =
      ftl ? oco::ChunkRole::kLead
          : (g_tail < G ? oco::ChunkRole::kTrail : oco::ChunkRole::kProducer);
  S th[C], w[C], x[C];
#pragma unroll
  for (int j = 0; j < n; ++j) th[j] = x[j] = w[j] = S(0);
  S F = S(0), cnt = S(0), cum = S(0);
  S thr[kMaxThresholds];
  long long tau[kMaxThresholds];
  int open = 0;
#pragma unroll
  for (int g = 0; g < kMaxThresholds; ++g) {
    tau[g] = T;
    thr[g] = S(0);
    if (ftl && b >= 0 && g < G) {
      thr[g] = thresholds[g * B + b];
      ++open;
    }
  }
  int start = INT_MAX;
  oco::ScaleAhead<S> scale{scales + (b >= 0 ? eidx[b] * T : 0), T, S(0)};
  oco::play_chunks<S, D, kStages>(
      z, y, b, B, T, ts, len, role, 1, 1 + G, smem,
      [&](int t1) {
        if (ftl) return 0;
        // A switch round below t1 was published, with its F, before warp 0
        // marked the chunk done; a later one (warp 0 may be a chunk or two
        // ahead) is taken with its own chunk.
        if (start == INT_MAX && b >= 0) {
          const int t_sw = tau_pub[g_tail * 32 + lane];
          if (t_sw < t1) {
            start = t_sw + 1;
            cum = fsw_sh[g_tail][lane];
            scale.start(start);
          }
        }
        return start;
      },
      [&](int t, auto zr, S yt) {
        if (ftl) {
          const S diffF = oco::dot<S, D>(zr, x, n) - yt;
          const S lossF = S(0.5) * oco::oabs(diffF);
          oco::update<S, D>(th, w, zr, oco::half_sign(diffF), yt, n);
          F = F + lossF;
          cnt = cnt + S(1);
          oco::ftl_action<S, D>(th, x, n);
          if (open > 0) {
            const S L = S(0.5) * (cnt - oco::dot<S, D>(x, w, n));
            const S lead = F - L;
#pragma unroll
            for (int g = 0; g < kMaxThresholds; ++g) {
              if (g < G && tau[g] == T && lead >= thr[g]) {
                tau[g] = t;
                fsw_sh[g][lane] = F;
                tau_pub[g * 32 + lane] = t;
                --open;
              }
            }
          }
        } else {
          oco::ftrl_action_scaled<S, D>(th, x, n, scale.take(t));
          oco::update<S, D>(th, nullptr, zr,
                            oco::hinge_step<S, D>(x, zr, yt, n, cum), yt, n);
        }
      });
  if (b < 0 || role == oco::ChunkRole::kProducer) return;
  if (ftl) {
    // x is now ftl_action(theta): the comparator's action.
    const S comp =
        replay ? oco::replay_comparator_rows<S, D>(z, y, b, T, n, len, x)
               : S(0.5) * (cnt - oco::dot<S, D>(x, w, n));
    comp_out[b] = comp;
    for (int g = 0; g < G; ++g) {
      const long long i = g * B + b;
      switch_t[i] = tau[g];
      if (tau[g] == T) {  // never switched: the FTL track's result
        cum_out[i] = F;
#pragma unroll
        for (int j = 0; j < n; ++j) x_last[i * n + j] = x[j];
      }
    }
  } else if (start != INT_MAX) {
    // Switched: the FTRL track's total and last action (zero if the switch
    // came at the last round and the track never played).
    const long long i = g_tail * B + b;
    cum_out[i] = cum;
#pragma unroll
    for (int j = 0; j < n; ++j) x_last[i * n + j] = x[j];
  }
}

template <typename Z, typename Y>
int launch(const void* z, const void* y, const void* thresholds,
           const void* scales, const void* eidx, const void* lengths,
           long long B, long long T, int G, int d, int replay, void* cum,
           void* comp, void* x_last, void* switch_t, void* stream) {
  using S = oco::compute_t<Z>;
  if (B < 1 || T < 1 || T >= INT_MAX || G < 1 || G > kMaxThresholds ||
      d > OCO_LARGE_D)
    return cudaErrorInvalidValue;
  const long long blocks = (B + 31) / 32;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int err = cudaSuccess;
  const int launched = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if constexpr (D != oco::kWideD) {
      const oco::ChunkShape ts = oco::chunk_shape<Z, Y, D>(d, kStageBytes);
      err = oco::launch_with_smem(
          smart_kernel<Z, Y, D>, static_cast<unsigned int>(blocks),
          (2 + G) * 32, oco::chunk_ring_bytes<D>(ts, kStages),
          static_cast<cudaStream_t>(stream), static_cast<const Z*>(z),
          static_cast<const Y*>(y), static_cast<const S*>(thresholds),
          static_cast<const S*>(scales), static_cast<const int*>(eidx),
          static_cast<const int*>(lengths), B, T, G, ts, replay,
          static_cast<S*>(cum), static_cast<S*>(comp),
          static_cast<S*>(x_last), static_cast<long long*>(switch_t));
    }
  });
  return err != cudaSuccess ? err : launched;
}

template <typename S>
int occupancy(int G, int d, int* out) {
  if (G < 1 || G > kMaxThresholds || d > OCO_LARGE_D)
    return cudaErrorInvalidValue;
  int err = cudaSuccess;
  const int checked = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if constexpr (D != oco::kWideD) {
      const oco::ChunkShape ts = oco::chunk_shape<S, S, D>(d, kStageBytes);
      const size_t smem = oco::chunk_ring_bytes<D>(ts, kStages);
      err = oco::occupancy(smart_kernel<S, S, D>, (2 + G) * 32, smem, out);
      if (err == cudaSuccess)
        err = oco::local_bytes(smart_kernel<S, S, D>, out + 2, smem);
    }
  });
  return err != cudaSuccess ? err : checked;
}

}  // namespace

// Inputs: z (B, T, d) and y (B, T) contiguous in a storage pair of
// OCO_STORAGE_PAIRS (the suffix); in the compute type thresholds (G, B)
// and scales (E, T) the FTRL scales -(eta_e / sqrt(t)); eidx (B,) int32
// each sequence's row of scales, lengths (B,) int32 with 0 <= len <= T;
// 1 <= G <= 4; 1 <= d <= 512 (past it K2w's two launches,
// smart_sweep_kernel.cu).  Outputs: cum_loss (G, B), comp_loss (B,), x_last
// (G, B, d) in the compute type, switch_t (G, B) int64 (T where a pair
// never switches).  Returns the cudaError_t of the launch.
#define OCO_SMART_ENTRY(SUFFIX, Z, Y)                                        \
  extern "C" int oco_smart_regrets_##SUFFIX(                                 \
      const void* z, const void* y, const void* thresholds,                  \
      const void* scales, const void* eidx, const void* lengths, long long B, \
      long long T, int G, int d, int replay, void* cum, void* comp,          \
      void* x_last, void* switch_t, void* stream) {                          \
    return launch<Z, Y>(z, y, thresholds, scales, eidx, lengths, B, T, G, d, \
                        replay, cum, comp, x_last, switch_t, stream);        \
  }
OCO_STORAGE_PAIRS(OCO_SMART_ENTRY)

extern "C" int oco_smart_plays_occupancy(int storage, int tails, int d,
                                         int* out);

// Registers a thread (out[0]), resident warps an SM (out[1]), bytes of a
// thread's local frame (out[2]) and of a block's shared memory (out[3]) of a
// launch with G thresholds a sequence at feature dimension d on the current
// card (past d = 512 K2w's FTL launch at its plan's block); f64 nonzero for
// the float64 instance.  Returns the cudaError_t.
extern "C" int oco_smart_occupancy(int f64, int G, int d, int* out) {
  if (d > OCO_LARGE_D)
    return G < 1 || G > kMaxThresholds
               ? cudaErrorInvalidValue
               : oco_smart_plays_occupancy(f64 ? 1 : 0, 0, d, out);
  return f64 ? occupancy<double>(G, d, out) : occupancy<float>(G, d, out);
}
