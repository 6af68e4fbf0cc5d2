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
// Past d = 512 (the wide instances K6aw and K6bw, D == oco::kWideD) a
// thread keeps no vector in its frame.  K6aw's theta, w and x (K2w's FTL
// warp) are vectors 0, 1 and 2 of slot s (the sequence's place in the
// order) of the caller's state buffer, laid out (d, B); K6bw's theta and
// x (K2w's tails) are vectors 0 and 1 of slot g * B + s, laid out
// (d, G * B), every (sequence, threshold) pair having a slot whether it
// switched or not.  Both read their rows from global memory where they
// use them and widen on read (oco::Widened, as the large-d instance
// does), so K6bw has no barrier to keep.  Same helpers, same order: both
// equal their plain versions bit for bit at any d, with local frames that
// do not grow with d.
#include "oco_tiles.cuh"

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
                    S* __restrict__ comp_out, S* state) {
  constexpr int C = oco::Cap<D>::value;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
  if (slot >= B) return;
  const long long b = order[slot];
  const int len = lengths[b];
  const int n = D > 0 ? D : d;

  // The sequence's vectors: arrays, or (wide) its slot of the state buffer.
  S th_a[C], w_a[C], x_a[C];
  const auto th = oco::state_vec<D>(th_a, state, 0, slot, B, n);
  const auto w = oco::state_vec<D>(w_a, state, 1, slot, B, n);
  const auto x = oco::state_vec<D>(x_a, state, 2, slot, B, n);
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

// K6b: 32 sequences (lane) x kTailWarps thresholds (warp) a block.
template <typename Z, typename Y, int D, typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(kTailWarps * 32)
smart_tail_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
                  const S* __restrict__ scales,
                  const int* __restrict__ order,
                  const int* __restrict__ lengths,
                  const long long* __restrict__ switch_t,
                  const S* __restrict__ comp, long long B, long long G,
                  long long T, oco::TileShape ts, S* __restrict__ regret,
                  S* state) {
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

  // The pair's vectors: arrays, or (wide) its slot of the state buffer,
  // which only a pair with a tail touches.
  S th_a[C], x_a[C];
  const bool tail = start < len;
  const long long own = tail ? g * B + slot : 0;
  const auto th = oco::state_vec<D>(th_a, state, 0, own, G * B, n);
  const auto x = oco::state_vec<D>(x_a, state, 1, own, G * B, n);
  if (D != oco::kWideD || tail) {
#pragma unroll
    for (int j = 0; j < n; ++j) th[j] = S(0);
  }
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
  if (d > OCO_LARGE_D && state == nullptr) return cudaErrorInvalidValue;
  const long long blocks = (B + kPrefixThreads - 1) / kPrefixThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int err = cudaSuccess;
  const int launched = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    err = oco::launch_with_smem(
        smart_prefix_kernel<Z, Y, D>, static_cast<unsigned int>(blocks),
        kPrefixThreads, 0, static_cast<cudaStream_t>(stream),
        static_cast<const Z*>(z), static_cast<const Y*>(y),
        static_cast<const S*>(sorted), static_cast<const int*>(perm),
        static_cast<const int*>(order), static_cast<const int*>(lengths), B,
        G, T, d, replay, static_cast<S*>(regret),
        static_cast<long long*>(switch_t), static_cast<S*>(comp),
        static_cast<S*>(state));
  });
  return err != cudaSuccess ? err : launched;
}

// K6b.  Inputs: z, y, order, lengths as K6a's; scales (T,) the per-round
// FTRL scales -(eta / sqrt(t)); switch_t and comp from K6a.  In and out:
// regret (G, B), K6a's on entry, with every tail played on return.
// Returns the cudaError_t of the launch.
template <typename Z, typename Y>
int launch_tails(const void* z, const void* y, const void* scales,
                 const void* order, const void* lengths, const void* switch_t,
                 const void* comp, long long B, long long G, long long T,
                 int d, void* regret, void* state, void* stream) {
  using S = oco::compute_t<Z>;
  if (B < 1 || G < 1 || T < 1) return cudaErrorInvalidValue;
  if (d > OCO_LARGE_D && state == nullptr) return cudaErrorInvalidValue;
  const long long blocks = (B + 31) / 32 * ((G + kTailWarps - 1) / kTailWarps);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const oco::TileShape ts =
      oco::tile_shape<Z, Y>(d, kTailWarps, kTailStageBytes, 1);
  int err = cudaSuccess;
  const int launched = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    err = oco::launch_with_smem(
        smart_tail_kernel<Z, Y, D>, static_cast<unsigned int>(blocks),
        kTailWarps * 32, oco::ring_bytes<D>(ts),
        static_cast<cudaStream_t>(stream), static_cast<const Z*>(z),
        static_cast<const Y*>(y), static_cast<const S*>(scales),
        static_cast<const int*>(order), static_cast<const int*>(lengths),
        static_cast<const long long*>(switch_t),
        static_cast<const S*>(comp), B, G, T, ts, static_cast<S*>(regret),
        static_cast<S*>(state));
  });
  return err != cudaSuccess ? err : launched;
}

template <typename S>
int occupancy(int tails, int d, int* out) {
  int err = cudaSuccess;
  const int checked = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if (tails) {
      const oco::TileShape ts =
          oco::tile_shape<S, S>(d, kTailWarps, kTailStageBytes, 1);
      const size_t smem = oco::ring_bytes<D>(ts);
      err = oco::occupancy(smart_tail_kernel<S, S, D>, kTailWarps * 32, smem,
                           out);
      if (err == cudaSuccess)
        err = oco::local_bytes(smart_tail_kernel<S, S, D>, out + 2, smem);
    } else {
      err = oco::occupancy(smart_prefix_kernel<S, S, D>, kPrefixThreads, 0,
                           out);
      if (err == cudaSuccess)
        err = oco::local_bytes(smart_prefix_kernel<S, S, D>, out + 2);
    }
  });
  return err != cudaSuccess ? err : checked;
}

}  // namespace

// The entries of both launches, for each storage pair of OCO_STORAGE_PAIRS
// (the suffix): z and y in the pair; sorted, scales, comp and regret in
// the compute type; any d >= 1.  state: past d = 512 a scratch buffer of
// the compute type, 3 * d * B elements for K6a and 2 * d * G * B for K6b
// (ops/game.py::wide_state_elems), else unused (may be null).
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
      const void* z, const void* y, const void* scales, const void* order,  \
      const void* lengths, const void* switch_t, const void* comp,          \
      long long B, long long G, long long T, int d, void* regret,           \
      void* state, void* stream) {                                          \
    return launch_tails<Z, Y>(z, y, scales, order, lengths, switch_t, comp, \
                              B, G, T, d, regret, state, stream);           \
  }
OCO_STORAGE_PAIRS(OCO_SMART_SWEEP_ENTRIES)

// Registers a thread (out[0]), resident warps an SM (out[1]), bytes of a
// thread's local frame (out[2]) and of a block's shared memory (out[3]) of a
// K6a (tails 0) or K6b (tails 1) launch at feature dimension d on the
// current card; f64 nonzero for the float64 instance.  Returns the
// cudaError_t.
extern "C" int oco_smart_sweep_occupancy(int f64, int tails, int d,
                                         int* out) {
  return f64 ? occupancy<double>(tails, d, out)
             : occupancy<float>(tails, d, out);
}
