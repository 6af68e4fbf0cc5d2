// K3 and K3e: the hinge game on the packed API, cum and theta out, no
// comparator.
//
// Replaces the TPU kernels online_convex_optimization_tpu/ops/pallas_game.py
// _game_kernel (and its VMEM-state twin _game_kernel_dloop), entry
// play_packed, and _game_eta_kernel, entry play_packed_eta.  Python wrappers
// and plain PyTorch versions: online_convex_optimization_tpu_torch/ops/game.py
// (play_packed, play_packed_eta, play_packed_reference,
// play_packed_eta_reference).
//
// One thread per sequence, state in registers (in local memory for the
// runtime-d instances, see oco_common.cuh), a loop over all T rounds: zero
// rows are inert (the loss is 0.5*|0 - 0| and the update 0), so callers pad
// ragged horizons with them.  Each round plays K1's action and hinge step:
//   K3:  the action's scale is read from a (T,) table, scales[t]; FTL
//        (alg_flag 1) ignores it.  ftrl_scales builds the table in the
//        working type as -(eta / sqrt(t)), the expression K1 evaluates, so
//        K3 with that table gives K1's FTRL cum bit for bit.
//   K3e: FTRL with the sequence's own eta, scale -(eta_b / sqrt(t)) in K1's
//        rounding order (the TPU kernel's -eta * isqrt[t] rounds otherwise),
//        so it gives K1's cum with the same per-sequence eta bit for bit.
// The comparator is the caller's (ops/game.py replays the final FTL action
// in plain PyTorch, as the JAX package does in XLA), so neither kernel
// carries the identity statistic w.
//
// What bounds it on an H100: each round reads (d+1) values once (24 bytes
// in f32 at d = 5, plus 4 for the table entry, shared by the whole batch
// and served from L1/L2) against a serial chain of about 3d + 10 flops with
// a sqrt and a divide.  At the main path's B = 131,072 there are 1,024
// blocks of 128 threads, about 8 per SM, so many chains are in flight and
// the time approaches the bytes bound; the design relies on that and on
// coalesced time-major (T, d, B) loads, with no staging in shared memory.
//
// K3w (K3 past d = 512, packed_wide_kernel) plays a sequence on a warp,
// and so does K3ew (K3e past d = 512, the same kernel with kEta).  One
// thread a sequence with x in a (d, B) buffer (both instances' first
// design) left the card nearly empty at the path's width (B = 2,048: 16
// blocks of 4 warps on 132 SMs, each thread's round 4-6 passes over 4 KB
// vectors, a memory round trip per 8 elements).  The design:
//   - a block plays W = 32 / sizeof(z element) consecutive sequences, a
//     warp each (8 in f32, 16 in bf16, 4 in f64), so that the block's
//     elements of each (t, j) are one 32-byte sector of the time-major z;
//   - the block copies round t + 1's (d x W) tile into a shared stage with
//     cp.async while it plays round t (two stages, one barrier a round),
//     so each row crosses L2 once a block.  The stage is transposed on the
//     way in: unit q of row j's window (a 4-byte word, or the f64 element)
//     lands in column q at j, so warp w reads its sequence's elements j =
//     l + 32 m as neighbouring words, with no bank conflict (a sector's 32
//     bytes copied whole would put every lane's element in 4 banks);
//   - lane l holds elements j = l + 32 m of theta in shared memory; x is
//     never stored: each lane forms x_j from theta_j and the round's scale
//     where a product needs it (the FTRL scale times 1/sqrt(nsq) again in
//     a round that projects; -(1/sqrt(nsq)) theta_j for FTL), the products
//     scaled forms, and each sum is one lane's index-order sum of a product
//     line (oco_warp.cuh): the same bits as the thread-a-sequence helpers;
//   - the FTRL scale is scales[t] (K3w), or (K3ew) the warp's own
//     -(eta_b / sqrt(t + 1)) in the compute type, as ftrl_action forms it,
//     eta_b read once a warp;
//   - an FTRL round sums ||x||^2 and <z_t, x> side by side on lanes 0 and
//     1 and sums <z_t, x> again only where it projects; FTL sums ||theta||^2
//     then q; the update runs lane-parallel with no chain.
// What bounds it: the one-lane sums (d or 2 d dependent adds a round) and
// the issue of the lanes' products, with 16 warps an SM (f32 and bf16 at d
// = 1,024: the path's 2,048 warps in one wave).  Up to the plan's
// max_shared_d theta and the stages lie on the chip; past it theta lies in
// the caller's (B, d) buffer, contiguous a warp, and each lane reads its
// elements from the time-major rows (the block's warps read the same
// sectors, through L1): the library's plan (oco_packed_plan) reports the
// boundary, the same for K3w and K3ew, and the wrapper allocates the
// buffer it asks for.
#include "oco_warp.cuh"

namespace {

// ------------------------------------------------------------------- K3w

// Products a warp's line holds (oco_warp.cuh).
constexpr int kSeqLine = 512;
// Each lane forms a chunk's products before it stores any (oco_warp.cuh
// put_products, kBatch), and updates kSeqUnroll elements of theta at a
// time, so that its shared-memory loads are in flight together; the
// kernel's launch bounds name one block an SM, so that ptxas gives these
// their registers (without it, it held K3w to 40-64 registers and
// spilled).
constexpr int kSeqUnroll = 4;

using oco::up4;

template <typename Z>
constexpr int kSeqWarps = oco::kTileWarps<Z>;

// Bytes of a block's shared memory: two stages and W thetas (shared),
// then W product lines.
template <typename Z, typename S = oco::compute_t<Z>>
__host__ __device__ inline long long packed_state_bytes(int d, bool shared) {
  return shared ? 2 * oco::tile_stage_bytes<Z>(d) +
                      kSeqWarps<Z> * up4(d) * static_cast<long long>(sizeof(S))
                : 0;
}
template <typename Z, typename S = oco::compute_t<Z>>
__host__ __device__ inline long long packed_block_bytes(int d, bool shared) {
  return packed_state_bytes<Z>(d, shared) +
         kSeqWarps<Z> * oco::line_elems<S, kSeqLine>() *
             static_cast<long long>(sizeof(S));
}

// kEta: K3ew, FTRL with the sequence's own eta (alg_flag 0, no table).
template <typename Z, typename Y, bool kShared, bool kEta,
          typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(kSeqWarps<Z> * 32, 1)
packed_wide_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
                   const S* __restrict__ scales, const S* __restrict__ eta,
                   long long T, long long B, int d, int alg_flag,
                   S* __restrict__ cum_out, S* __restrict__ theta_out,
                   S* state) {
  using U = oco::TileUnit<Z>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b0 = static_cast<long long>(blockIdx.x) * kSeqWarps<Z>;
  const long long b = b0 + warp;
  // A warp with no sequence stays for the block's copies and barriers;
  // past the shared boundary no barrier spans the block's warps.
  const bool live = b < B;
  if (!kShared && !live) return;
  const int n = d;
  const long long stage_units = oco::tile_stage_bytes<Z>(n) / sizeof(U);
  U* stages = reinterpret_cast<U*>(smem);
  S* th = kShared ? reinterpret_cast<S*>(
                        smem + 2 * oco::tile_stage_bytes<Z>(n)) +
                        warp * up4(n)
                  : state + b * up4(n);
  S* line = reinterpret_cast<S*>(smem + packed_state_bytes<Z>(n, kShared)) +
            warp * oco::line_elems<S, kSeqLine>();
  const oco::TimeMajorTile<Z> tile(z, B, b0, n);
  // Element j of the warp's row t: from the stage, or (past the boundary)
  // from the time-major rows.
  const auto z_at = [&](const U* stage, long long t, int j) -> S {
    if constexpr (kShared)
      return tile.at(stage, t, j, warp);
    else
      return S(oco::widen(z[(t * n + j) * B + b]));
  };

  for (int j = lane; j < n; j += 32) th[j] = S(0);
  S cum = S(0);
  const bool ftrl = kEta || alg_flag == 0;
  const S eta_b = kEta && live ? eta[b] : S(0);
  // The round's FTRL scale: the table's, or -(eta_b / sqrt(t + 1)).
  const auto scale = [&](long long t) {
    if constexpr (kEta)
      return -(eta_b / oco::osqrt(S(t + 1)));
    else
      return scales[t];
  };
  S sc_next = T > 0 && ftrl ? scale(0) : S(0);
  S y_next = T > 0 && live ? S(oco::widen(y[b])) : S(0);
  if constexpr (kShared) {
    if (T > 0) tile.fetch(0, stages);
    oco::commit_copies();
  }
  for (long long t = 0; t < T; ++t) {
    const U* stage = stages;
    if constexpr (kShared) {
      oco::wait_copies<0>();
      __syncthreads();  // round t landed; round t - 1's stage is free
      stage = stages + (t & 1) * stage_units;
      if (t + 1 < T)
        tile.fetch(t + 1, stages + ((t + 1) & 1) * stage_units);
      oco::commit_copies();
      if (!live) continue;
    }
    const S sc = sc_next, yt = y_next;
    if (t + 1 < T) {
      if (ftrl) sc_next = scale(t + 1);
      y_next = S(oco::widen(y[(t + 1) * B + b]));
    }
    const auto z = [&](int j) { return z_at(stage, t, j); };
    S q;
    if (ftrl) {
      S f;
      bool proj;
      q = oco::ftrl_q<kSeqLine>(line, n, lane, sc, th, z, f, proj);
    } else {
      const S s = oco::ftl_scale<kSeqLine>(line, n, lane, th);
      q = oco::warp_dot<kSeqLine, true>(
          line, n, lane, [&](int j) { return z(j) * (s * th[j]); });
    }
    // hinge_step, then update.
    const S diff = q - yt;
    cum = cum + S(0.5) * oco::oabs(diff);
    const S g = oco::half_sign(diff);
    for (int j0 = lane; j0 < n; j0 += 32 * kSeqUnroll) {
      S zj[kSeqUnroll], tj[kSeqUnroll];
#pragma unroll
      for (int k = 0; k < kSeqUnroll; ++k) {
        const int j = j0 + 32 * k;
        if (j < n) {
          zj[k] = z_at(stage, t, j);
          tj[k] = th[j];
        }
      }
#pragma unroll
      for (int k = 0; k < kSeqUnroll; ++k)
        if (j0 + 32 * k < n) th[j0 + 32 * k] = tj[k] + g * zj[k];
    }
    __syncwarp();
  }
  if (!live) return;
  if (lane == 0) cum_out[b] = cum;
  for (int j = lane; j < n; j += 32) theta_out[j * B + b] = th[j];
}

// The largest d whose block fits shared memory with theta and the stages.
template <typename Z>
int packed_max_shared_d() {
  return oco::max_shared_d(
      [](int d) { return packed_block_bytes<Z>(d, true); });
}

// K3w's block at d: W warps, theta and the stages in shared memory up to
// packed_max_shared_d().
template <typename Z>
oco::WarpPlan packed_plan(int d) {
  oco::WarpPlan p{};
  p.warps = kSeqWarps<Z>;
  p.shared = d <= packed_max_shared_d<Z>();
  p.smem = packed_block_bytes<Z>(d, p.shared);
  p.state = p.shared ? 0 : up4(d);
  return p;
}

// K3w's (K3ew's with kEta) kernel for a plan.
template <typename Z, typename Y, bool kEta>
auto packed_wide(const oco::WarpPlan& p) {
  return p.shared ? &packed_wide_kernel<Z, Y, true, kEta>
                  : &packed_wide_kernel<Z, Y, false, kEta>;
}

template <typename Z, typename Y, bool kEta, typename S>
int launch_packed_wide(const Z* z, const Y* y, const S* scales,
                       const S* eta, long long T, long long B, int d,
                       int alg_flag, S* cum, S* theta, S* state,
                       cudaStream_t s) {
  const oco::WarpPlan p = packed_plan<Z>(d);
  if (!p.shared && state == nullptr) return cudaErrorInvalidValue;
  const long long grid = (B + p.warps - 1) / p.warps;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  return oco::launch_with_smem(packed_wide<Z, Y, kEta>(p),
                               static_cast<unsigned int>(grid), p.warps * 32,
                               static_cast<size_t>(p.smem), s, z, y, scales,
                               eta, T, B, d, alg_flag, cum, theta, state);
}

// ------------------------------------------------------------ K3, K3e

template <typename Z, typename Y, int D, bool PER_SEQ_ETA,
          typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(OCO_THREADS)
game_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
            const S* __restrict__ scales, const S* __restrict__ eta,
            long long T, long long B, int d, int alg_flag,
            S* __restrict__ cum_out, S* __restrict__ theta_out) {
  static_assert(D != oco::kWideD, "K3w and K3ew are packed_wide_kernel");
  constexpr int C = oco::Cap<D>::value;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  const int n = D > 0 ? D : d;
  const bool ftrl = PER_SEQ_ETA || alg_flag == 0;
  const S eta_b = PER_SEQ_ETA ? eta[b] : S(0);

  S th[C], x[C], zr[C];
#pragma unroll
  for (int j = 0; j < n; ++j) th[j] = S(0);
  S cum = S(0);
  for (long long t = 0; t < T; ++t) {
    const auto round = [&](auto row) {
      if (PER_SEQ_ETA)
        oco::ftrl_action<S, D>(th, x, n, eta_b, S(t + 1));
      else if (ftrl)
        oco::ftrl_action_scaled<S, D>(th, x, n, scales[t]);
      else
        oco::ftl_action<S, D>(th, x, n);
      const S g = oco::hinge_step<S, D>(
          x, row, S(oco::widen(y[t * B + b])), n, cum);
      oco::update<S, D>(th, nullptr, row, g, S(0), n);
    };
    oco::load_row<S, D>(z, t, b, B, n, zr);
    round(static_cast<const S*>(zr));
  }
  cum_out[b] = cum;
#pragma unroll
  for (int j = 0; j < n; ++j) theta_out[j * B + b] = th[j];
}

template <typename Z, typename Y, bool PER_SEQ_ETA>
int launch(const void* z, const void* y, const void* scales, const void* eta,
           long long T, long long B, int d, int alg_flag, void* cum,
           void* theta, void* state, void* stream) {
  using S = oco::compute_t<Z>;
  if (B < 1 || T < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = oco::grid_for(B);
  const auto* zp = static_cast<const Z*>(z);
  const auto* yp = static_cast<const Y*>(y);
  const auto* sp = static_cast<const S*>(scales);
  const auto* ep = static_cast<const S*>(eta);
  auto* cp = static_cast<S*>(cum);
  auto* tp = static_cast<S*>(theta);
  auto* st = static_cast<S*>(state);
  int err = cudaSuccess;
  const int launched = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if constexpr (D == oco::kWideD)
      err = launch_packed_wide<Z, Y, PER_SEQ_ETA, S>(
          zp, yp, sp, ep, T, B, d, alg_flag, cp, tp, st, s);
    else
      game_kernel<Z, Y, D, PER_SEQ_ETA><<<grid, OCO_THREADS, 0, s>>>(
          zp, yp, sp, ep, T, B, d, alg_flag, cp, tp);
  });
  return err != cudaSuccess ? err : launched;
}

template <typename Z, typename Y>
int occupancy(int per_seq_eta, int d, int* out) {
  using S = oco::compute_t<Z>;
  int err = cudaSuccess;
  const int checked = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const auto thread_a_sequence = [&](auto kernel) {
      err = oco::occupancy(kernel, OCO_THREADS, 0, out);
      if (err == cudaSuccess) err = oco::local_bytes(kernel, out + 2);
    };
    if constexpr (D != oco::kWideD) {
      thread_a_sequence(per_seq_eta ? &game_kernel<S, S, D, true>
                                    : &game_kernel<S, S, D, false>);
    } else {
      const oco::WarpPlan p = packed_plan<Z>(d);
      const auto kernel = per_seq_eta ? packed_wide<Z, Y, true>(p)
                                      : packed_wide<Z, Y, false>(p);
      const auto smem = static_cast<size_t>(p.smem);
      err = oco::occupancy(kernel, p.warps * 32, smem, out);
      if (err == cudaSuccess) err = oco::local_bytes(kernel, out + 2, smem);
    }
  });
  return err != cudaSuccess ? err : checked;
}

}  // namespace

// K3.  Inputs: z (T, d, B) and y (T, B) time-major in a storage pair of
// OCO_STORAGE_PAIRS (the suffix), scales (T,) the FTRL scale of each round
// in the compute type, alg_flag 0 (FTRL) or 1 (FTL) for the whole batch;
// any d >= 1.  Outputs, in the compute type: cum (B,), theta (d, B).
// state: where oco_packed_plan asks for one (d past its max_shared_d), a
// scratch buffer of `state` * B elements of the compute type
// (ops/game.py::wide_state_elems), else unused (may be null).  Returns the
// cudaError_t of the launch.
#define OCO_PACKED_ENTRY(SUFFIX, Z, Y)                                      \
  extern "C" int oco_play_packed_##SUFFIX(                                  \
      const void* z, const void* y, const void* scales, long long T,        \
      long long B, int d, int alg_flag, void* cum, void* theta,             \
      void* state, void* stream) {                                          \
    return launch<Z, Y, false>(z, y, scales, nullptr, T, B, d, alg_flag,    \
                               cum, theta, state, stream);                  \
  }
OCO_STORAGE_PAIRS(OCO_PACKED_ENTRY)

// K3e.  Inputs: z (T, d, B) and y (T, B) time-major in a storage pair of
// OCO_STORAGE_PAIRS (the suffix), eta (B,) the FTRL step scale of each
// sequence in the compute type; any d >= 1.  Outputs, in the compute
// type: cum (B,), theta (d, B).  state: as K3's (K3ew follows K3w's plan,
// oco_packed_plan).  Returns the cudaError_t of the launch.
#define OCO_PACKED_ETA_ENTRY(SUFFIX, Z, Y)                                  \
  extern "C" int oco_play_packed_eta_##SUFFIX(                              \
      const void* z, const void* y, const void* eta, long long T,           \
      long long B, int d, void* cum, void* theta, void* state,              \
      void* stream) {                                                       \
    return launch<Z, Y, true>(z, y, nullptr, eta, T, B, d, 0, cum, theta,   \
                              state, stream);                               \
  }
OCO_STORAGE_PAIRS(OCO_PACKED_ETA_ENTRY)

// The storage of an occupancy or plan query: 0 float32, 1 float64, 2 bf16
// z (with int8 y, the pair of the packed game's path).

// Registers a thread (out[0]), resident warps an SM (out[1]), bytes of a
// thread's local frame (out[2]) and of a block's shared memory (out[3]) of a
// K3 (per_seq_eta 0) or K3e (1) launch at feature dimension d on the current
// card (K3w at its plan's block) with z in `storage`.  Returns the
// cudaError_t.
extern "C" int oco_packed_occupancy(int storage, int per_seq_eta, int d,
                                    int* out) {
  switch (storage) {
    case 0:
      return occupancy<float, float>(per_seq_eta, d, out);
    case 1:
      return occupancy<double, double>(per_seq_eta, d, out);
    case 2:
      return occupancy<oco::bf16, signed char>(per_seq_eta, d, out);
    default:
      return cudaErrorInvalidValue;
  }
}

// K3w's (and K3ew's) plan at d > 512 with z in `storage` on the current
// card: warps a block (out[0]), bytes of dynamic shared memory a block
// (out[1]), 1 if theta and the stages lie in shared memory (out[2]),
// elements of the state buffer a sequence, 0 where shared (out[3]), and
// the largest d whose block fits shared memory (out[4]).  Returns cudaErrorInvalidValue
// for d <= 512 or an unknown storage, else cudaSuccess.
extern "C" int oco_packed_plan(int storage, int d, long long* out) {
  if (d <= OCO_LARGE_D || storage < 0 || storage > 2)
    return cudaErrorInvalidValue;
  const oco::WarpPlan p = storage == 0   ? packed_plan<float>(d)
                    : storage == 1 ? packed_plan<double>(d)
                                   : packed_plan<oco::bf16>(d);
  out[0] = p.warps;
  out[1] = p.smem;
  out[2] = p.shared ? 1 : 0;
  out[3] = p.state;
  out[4] = storage == 0   ? packed_max_shared_d<float>()
           : storage == 1 ? packed_max_shared_d<double>()
                          : packed_max_shared_d<oco::bf16>();
  return cudaSuccess;
}
