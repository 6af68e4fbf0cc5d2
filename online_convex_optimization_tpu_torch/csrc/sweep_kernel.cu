// K5: the FTRL regret of every (sequence, eta setting) pair in one launch.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_game.py
// _sweep_kernel, entry eta_sweep_packed.  Python wrapper and plain PyTorch
// version: online_convex_optimization_tpu_torch/ops/game.py (eta_sweep,
// eta_sweep_reference).
//
// Thread (lane, warp) of a block plays sequence order[32 k + lane] at
// setting 16 m + warp, state in registers, over the sequence's own
// rounds.  The round is K1's FTRL round in K1's order of operations (a true
// divide by a correctly rounded sqrt, project iff ||x||^2 > 1), with the
// round's scale -(eta_e / sqrt(t)) read from the wrapper's (E, T) table
// (ops/game.py::sweep_scales, the expression K1 evaluates), so column e of
// the sweep equals K1 run with eta = eta_grid[e], bit for bit.  The
// comparator is the final FTL action scored by the hinge identity on
// contract data and by a replay of the thread's own rows otherwise; the
// wrapper chooses before the launch.
//
// What bounds it on an H100.  One thread per pair reading its own rows
// (this kernel's first design) streamed 8*(d+1) bytes a round per setting
// through L2: ~77 GB at B = 32,768, E = 64, T <= 1,024 in f64, ~5.3 TB/s,
// all that L2 feeds the SMs.  Once the rows cross L2 once per block, the
// bound is the FP64 pipe's issue of the round (--fmad=false: every multiply
// and add its own instruction).  The design:
//   - a block holds 32 sequences (lane) x kSweepWarps = 16 settings (warp)
//     and stages its sequences' rows chunk by chunk in shared memory
//     (oco_tiles.cuh: the caller's (B, T, d) layout, a cp.async ring), so
//     the rows cross L2 once per 16 settings;
//   - the scale table takes the correctly rounded sqrt and the true divide
//     out of every thread's round; the block stages its settings' entries
//     beside the rows;
//   - the identity statistic w is summed once per sequence, not once per
//     setting: over each staged chunk, warp w sums components w, w + 16,
//     ... of its lanes' rows (the same sums in the same order, so the same
//     bits), and the warps exchange them through shared memory at the end;
//   - the wrapper's order lists the sequences by descending length, so the
//     lanes of a warp play about equally many rounds and the longest
//     blocks start first; it changes no pair's arithmetic.
// The large-d instance (d > 64) reads its rows from global memory, each
// thread its own, and keeps its own w.  Narrow storage (OCO_STORAGE_PAIRS)
// is staged as 4-byte windows (oco_tiles.cuh) and widened on read; its
// instances are held to 64 registers (sweep_kernel_narrow), so that two
// blocks share an SM as the float32 instance's do.
//
// Past d = 512 (K5w, the wide instance, D == oco::kWideD) a pair's theta
// and x are vectors 0 and 1 of slot e * B + s (s the sequence's place in
// the order) in the caller's state buffer, laid out (d, E * B), and its
// rows are read from global memory where they are used and widened on
// read (oco::Widened), as the large-d instance reads them.  w is summed
// once a block and sequence, by warp 0 in its rounds (the same sums in the
// same order), into slot (block's setting group) * B + s of a (d, groups
// * B) part after the pairs' vectors; the block's barrier then hands it to
// every warp for the identity comparator.  Same helpers, same order: K5w
// equals its plain version bit for bit at any d, and its local frame does
// not grow with d.
#include "oco_tiles.cuh"

namespace {

// Settings a block serves from one staged tile, and bytes of rows a stage
// holds (64 rounds of d = 5 in f64 and in f32).  On an H100 at the phase-6
// cell, 16 warps and 64-round chunks were the fastest of 4-16 warps and
// 16-64 rounds (PERF.md): a chunk's barrier and copies cost a few rounds'
// time, and more warps share each staged row.
constexpr int kSweepWarps = 16;
constexpr size_t kSweepStageBytes = 96 * 1024;

template <typename Z, typename Y, int D, typename S = oco::compute_t<Z>>
__device__ __forceinline__ void sweep_body(
    const Z* __restrict__ z, const Y* __restrict__ y,
    const S* __restrict__ scales, const int* __restrict__ order,
    const int* __restrict__ lengths, long long B, long long E, long long T,
    const oco::TileShape& ts, int replay, S* __restrict__ regret, S* state) {
  constexpr int C = oco::Cap<D>::value;
  constexpr bool kWide = D == oco::kWideD;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long setting_blocks = (E + kSweepWarps - 1) / kSweepWarps;
  const long long group = blockIdx.x % setting_blocks;
  const long long slot = (blockIdx.x / setting_blocks) * 32 + lane;
  const long long e = group * kSweepWarps + warp;
  const long long b = slot < B ? order[slot] : -1;
  const bool on = b >= 0 && e < E;
  const int len = on ? lengths[b] : 0;
  const int n = D > 0 ? D : ts.n;
  // The sequence's own length, over which w = sum y_t z_t runs (a warp
  // past the last setting still sums its components).
  const int seq_len = b >= 0 ? lengths[b] : 0;

  // The pair's vectors: arrays, or (wide) its slot of the state buffer;
  // w (wide) the block's sequence's, which warp 0 sums.
  S th_a[C], w_a[C], x_a[C];
  const long long slots = E * B;
  const auto th = oco::state_vec<D>(th_a, state, 0, on ? e * B + slot : 0,
                                    slots, n);
  const auto x = oco::state_vec<D>(x_a, state, 1, on ? e * B + slot : 0,
                                   slots, n);
  const auto w = oco::state_vec<D>(
      w_a, kWide ? state + 2 * slots * n : state, 0,
      b >= 0 ? group * B + slot : 0, setting_blocks * B, n);
  const bool sums_w = !kWide || (warp == 0 && b >= 0);
  if (!kWide || on) {
#pragma unroll
    for (int j = 0; j < n; ++j) th[j] = S(0);
  }
  if (sums_w) {
#pragma unroll
    for (int j = 0; j < n; ++j) w[j] = S(0);
  }
  S cum = S(0);
  oco::play_rows<S, D>(
      z, y, e < E ? scales + e * T : nullptr, b, T, ts, 0, len, smem,
      [&](int, auto zr, S yt, S scale) {
        oco::ftrl_action_scaled<S, D>(th, x, n, scale);
        const S g = oco::hinge_step<S, D>(x, zr, yt, n, cum);
        if constexpr (kWide) {
          // Warp 0 plays a setting of every sequence (e < E), so its
          // rounds are the sequence's own.
          if (sums_w)
            oco::update<S, D>(th, w, zr, g, yt, n);
          else
            oco::update<S, D>(th, nullptr, zr, g, yt, n);
        } else {
#pragma unroll
          for (int j = 0; j < n; ++j) {
            th[j] = th[j] + g * zr[j];
            if constexpr (D < 0) w[j] = w[j] + yt * zr[j];
          }
        }
      },
      [&](int t0, const Z* rows, const Y* labels, int R) {
        const int k_hi = min(seq_len - t0, R);
#pragma unroll
        for (int j = 0; j < n; ++j) {
          if (j % kSweepWarps != warp) continue;
          S wj = w[j];
          for (int k = 0; k < k_hi; ++k)
            wj = wj + S(oco::widen(labels[k])) * S(oco::widen(rows[k * n + j]));
          w[j] = wj;
        }
      });
  if constexpr (kWide) {
    // Warp 0's w of the block's sequences, for every warp; then only the
    // pairs play on (an idle thread's slot is another's).
    if (!replay) __syncthreads();
    if (!on) return;
  }
  S comp;
  if (replay) {
    oco::ftl_action<S, D>(th, x, n);
    comp = oco::replay_comparator_rows<S, D>(z, y, b, T, n, len, x);
  } else {
    if constexpr (D >= 0) {
      S* shared_w =
          reinterpret_cast<S*>(smem + oco::kTileStages * ts.stage_bytes());
#pragma unroll
      for (int j = 0; j < n; ++j)
        if (j % kSweepWarps == warp) shared_w[lane * n + j] = w[j];
      __syncthreads();
      for (int j = 0; j < n; ++j) w[j] = shared_w[lane * n + j];
    }
    comp = oco::identity_comparator<S, D>(th, w, x, n, S(len));
  }
  if (on) regret[e * B + b] = cum - comp;
}

template <typename Z, typename Y, int D, typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(kSweepWarps * 32)
sweep_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
             const S* __restrict__ scales, const int* __restrict__ order,
             const int* __restrict__ lengths, long long B, long long E,
             long long T, oco::TileShape ts, int replay,
             S* __restrict__ regret, S* state) {
  sweep_body<Z, Y, D>(z, y, scales, order, lengths, B, E, T, ts, replay,
                      regret, state);
}

// The narrow instances: their staging costs registers, held here to 64 a
// thread so that two blocks share an SM, as the float32 instance's 63 let
// them.
template <typename Z, typename Y, int D, typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(kSweepWarps * 32, 2)
sweep_kernel_narrow(const Z* __restrict__ z, const Y* __restrict__ y,
                    const S* __restrict__ scales,
                    const int* __restrict__ order,
                    const int* __restrict__ lengths, long long B, long long E,
                    long long T, oco::TileShape ts, int replay,
                    S* __restrict__ regret, S* state) {
  sweep_body<Z, Y, D>(z, y, scales, order, lengths, B, E, T, ts, replay,
                      regret, state);
}

// The ring, then the warps' exchange of w (none for the instances that
// read their rows from global memory).
template <typename S, int D>
size_t sweep_smem(const oco::TileShape& ts, int d) {
  return D < 0 ? 0
               : oco::ring_bytes<D>(ts) + static_cast<size_t>(32) * d *
                                              sizeof(S);
}

template <typename Z, typename Y>
int launch(const void* z, const void* y, const void* scales,
           const void* order, const void* lengths, long long B, long long E,
           long long T, int d, int replay, void* regret, void* state,
           void* stream) {
  using S = oco::compute_t<Z>;
  if (B < 1 || E < 1 || T < 1) return cudaErrorInvalidValue;
  if (d > OCO_LARGE_D && state == nullptr) return cudaErrorInvalidValue;
  const long long blocks =
      (B + 31) / 32 * ((E + kSweepWarps - 1) / kSweepWarps);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const oco::TileShape ts =
      oco::tile_shape<Z, Y>(d, kSweepWarps, kSweepStageBytes, kSweepWarps);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned int>(blocks);
  const auto* zp = static_cast<const Z*>(z);
  const auto* yp = static_cast<const Y*>(y);
  const auto* sp = static_cast<const S*>(scales);
  const auto* op = static_cast<const int*>(order);
  const auto* lp = static_cast<const int*>(lengths);
  auto* rp = static_cast<S*>(regret);
  auto* st = static_cast<S*>(state);
  int err = cudaSuccess;
  const int launched = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const auto kernel = [] {
      if constexpr (oco::kWindowed<Z, Y>)
        return sweep_kernel_narrow<Z, Y, D>;
      else
        return sweep_kernel<Z, Y, D>;
    }();
    err = oco::launch_with_smem(kernel, grid, kSweepWarps * 32,
                                sweep_smem<S, D>(ts, d), s, zp, yp, sp, op,
                                lp, B, E, T, ts, replay, rp, st);
  });
  return err != cudaSuccess ? err : launched;
}

template <typename S>
int occupancy(int d, int* out) {
  int err = cudaSuccess;
  const int checked = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const oco::TileShape ts =
        oco::tile_shape<S, S>(d, kSweepWarps, kSweepStageBytes, kSweepWarps);
    err = oco::occupancy(sweep_kernel<S, S, D>, kSweepWarps * 32,
                         sweep_smem<S, D>(ts, d), out);
    if (err == cudaSuccess)
      err = oco::local_bytes(sweep_kernel<S, S, D>, out + 2);
  });
  return err != cudaSuccess ? err : checked;
}

}  // namespace

// Inputs: z (B, T, d) and y (B, T) contiguous in a storage pair of
// OCO_STORAGE_PAIRS (the suffix), scales (E, T) the per-round FTRL scales
// -(eta_e / sqrt(t)) in the compute type, order (B,) int32 a permutation
// of the sequences (blocks take them in this order), lengths (B,) int32
// with 0 <= len <= T; any d >= 1.  Output: regret (E, B) in the compute
// type.  state: past d = 512 a scratch buffer of (2 E + ceil(E / 16)) * d
// * B elements of the compute type (ops/game.py::wide_state_elems), else
// unused (may be null).  Returns the cudaError_t of the launch.
#define OCO_SWEEP_ENTRY(SUFFIX, Z, Y)                                       \
  extern "C" int oco_eta_sweep_##SUFFIX(                                    \
      const void* z, const void* y, const void* scales, const void* order,  \
      const void* lengths, long long B, long long E, long long T, int d,    \
      int replay, void* regret, void* state, void* stream) {                \
    return launch<Z, Y>(z, y, scales, order, lengths, B, E, T, d, replay,   \
                        regret, state, stream);                             \
  }
OCO_STORAGE_PAIRS(OCO_SWEEP_ENTRY)

// Registers a thread (out[0]), resident warps an SM (out[1]) and bytes of
// a thread's local frame (out[2]) of a launch at feature dimension d on
// the current card; f64 nonzero for the float64 instance.  Returns the
// cudaError_t.
extern "C" int oco_sweep_occupancy(int f64, int d, int* out) {
  return f64 ? occupancy<double>(d, out) : occupancy<float>(d, out);
}
