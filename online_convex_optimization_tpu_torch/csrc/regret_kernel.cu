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
// Past d = 512 (K1w, the wide instance, D == oco::kWideD) a play's theta,
// w and x are vectors 0, 1 and 2 of slot p * B + b in the caller's state
// buffer, laid out (d, P * B) (oco::state_vec: element j of a slot at
// j * slots + slot, so a warp's lanes touch neighbouring words), and each
// row is read from the caller's (B, T, d) z where it is used and widened
// on read, as the large-d instance reads it: the same helpers in the same
// order, so K1w equals its plain version bit for bit at any d, and its
// local frame does not grow with d.  What bounds it: each round reads and
// writes a play's three vectors (about 9d words) against its two or three
// index-order dot products of d terms, so at B = 1,024 (64 warps, under
// one an SM) the chains' latency, not the bytes, sets the time.
#include "oco_tiles.cuh"

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
              oco::compute_t<Z>* __restrict__ x_last,
              oco::compute_t<Z>* state) {
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

  // The play's vectors: arrays, or (wide) its slot of the state buffer.
  S th_a[C], w_a[C], x_a[C];
  const long long slots = static_cast<long long>(P) * B;
  const long long own = player && b >= 0 ? i : 0;
  const auto th = oco::state_vec<D>(th_a, state, 0, own, slots, n);
  const auto w = oco::state_vec<D>(w_a, state, 1, own, slots, n);
  const auto x = oco::state_vec<D>(x_a, state, 2, own, slots, n);
  if (D != oco::kWideD || (player && b >= 0)) {
#pragma unroll
    for (int j = 0; j < n; ++j) th[j] = w[j] = x[j] = S(0);
  }
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

template <typename Z, typename Y>
int launch(const void* z, const void* y, const void* flags,
           const void* scales, const void* eidx, const void* lengths,
           long long B, long long T, int P, int d, int replay, void* cum,
           void* comp, void* x_last, void* state, void* stream) {
  using S = oco::compute_t<Z>;
  if (B < 1 || T < 1 || P < 1 || P > kMaxPlays) return cudaErrorInvalidValue;
  if (d > OCO_LARGE_D && state == nullptr) return cudaErrorInvalidValue;
  const long long blocks = (B + 31) / 32;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int err = cudaSuccess;
  const int launched = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    // A narrow stage holds the rounds a float32 one holds, in fewer bytes,
    // so that more blocks share an SM.
    const size_t stage_bytes =
        oco::kWindowed<Z, Y>
            ? kStageBytes * (d * sizeof(Z) + sizeof(Y)) / ((d + 1) * sizeof(S))
            : kStageBytes;
    const oco::ChunkShape ts = oco::chunk_shape<Z, Y, D>(d, stage_bytes);
    err = oco::launch_with_smem(
        regret_kernel<Z, Y, D>, static_cast<unsigned int>(blocks),
        (P + 1) * 32, oco::chunk_ring_bytes<D>(ts, kStages),
        static_cast<cudaStream_t>(stream),
        static_cast<const Z*>(z), static_cast<const Y*>(y),
        static_cast<const int*>(flags), static_cast<const S*>(scales),
        static_cast<const int*>(eidx), static_cast<const int*>(lengths), B,
        T, P, ts, replay, static_cast<S*>(cum), static_cast<S*>(comp),
        static_cast<S*>(x_last), static_cast<S*>(state));
  });
  return err != cudaSuccess ? err : launched;
}

template <typename S>
int occupancy(int P, int d, int* out) {
  if (P < 1 || P > kMaxPlays) return cudaErrorInvalidValue;
  int err = cudaSuccess;
  const int checked = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const oco::ChunkShape ts = oco::chunk_shape<S, S, D>(d, kStageBytes);
    const size_t smem = oco::chunk_ring_bytes<D>(ts, kStages);
    err = oco::occupancy(regret_kernel<S, S, D>, (P + 1) * 32, smem, out);
    if (err == cudaSuccess) err = oco::local_bytes(regret_kernel<S, S, D>,
                                                   out + 2, smem);
  });
  return err != cudaSuccess ? err : checked;
}

}  // namespace

// Inputs: z (B, T, d) and y (B, T) contiguous in a storage pair of
// OCO_STORAGE_PAIRS (the suffix), flags (P, B) int32 (0 = FTRL, 1 = FTL),
// scales (E, T) the FTRL scales -(eta_e / sqrt(t)) in the compute type,
// eidx (B,) int32 each sequence's row of scales, lengths (B,) int32 with
// 0 <= len <= T; 1 <= P <= 8; any d >= 1.  Outputs, in the compute type:
// cum_loss (P, B), comp_loss (P, B), x_last (P, B, d).  state: past
// d = 512 a scratch buffer of 3 * d * P * B elements of the compute type
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
// dimension d on the current card; f64 nonzero for the float64 instance.
// Returns the cudaError_t.
extern "C" int oco_regrets_occupancy(int f64, int P, int d, int* out) {
  return f64 ? occupancy<double>(P, d, out) : occupancy<float>(P, d, out);
}
