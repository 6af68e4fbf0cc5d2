// K4: advance the carried FTRL/FTL game over one time chunk.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_game.py
// _stream_kernel, entries play_packed_stream / play_packed_stream_many.
// Python wrapper and plain PyTorch version:
// online_convex_optimization_tpu_torch/ops/game.py (play_stream,
// play_stream_reference).
//
// The carry is (theta (d, B), w (d, B), cum (B,), cnt (B,)) in the port's
// conventions, those of K1: theta moves by 0.5*sign per round and losses are
// halved, so no factor of 2 needs undoing.  One thread per sequence loads
// its carry into registers, plays the chunk's CT rounds with K1's round step
// (oco::game_round) at the GLOBAL 1-based round index t0 + k + 1, and writes
// the carry back.  cnt += y_t^2 counts the rounds with a label, so zero rows
// (y = 0, z = 0), which callers use as padding, change nothing.  The index
// is formed from the 64-bit t0 in the working type: exact at any horizon in
// f64, rounded past 2^24 in f32 (as the TPU kernel documents).  Because the
// step and its order of operations are K1's, a sequence fed in chunks ends
// with the carry K1 reaches in one pass, bit for bit, and stream_result then
// gives K1's regret.
//
// What bounds it on an H100: each round reads 8*(d+1) bytes of f64 (4*(d+1)
// in f32) once; the carry costs 8*(2d+2) bytes per sequence per launch,
// nothing next to a chunk of thousands of rounds.  A round's own work is
// K1's serial chain of about 3d + 10 flops with a sqrt and divide, so a
// thread that waits for each row before it plays it is bound by the HBM
// round trip, not by the chain.  The design keeps rows in flight: each
// thread copies its own rows of the time-major (CT, d, B) layout (coalesced
// across the warp) with cp.async into its own slots of a shared-memory
// ring, kRingBytes of rows ahead of the round it plays (8
// rounds of d = 5 in f32, 4 in f64), and waits on its own copy groups
// (cp.async.wait_group), so no thread waits for another and the block needs
// no barrier.  Blocks of kStreamThreads = 64 threads spread a chunk of
// 16,384 sequences over 256 blocks, every SM of the card.  The large-d
// instance (d > 64), whose rows do not fit a ring, loads each row as it
// plays it.  With the loads hidden, a thread's time is the latency of
// game_round's serial chain (the FTRL scale's sqrt and divide, the
// projection's sqrt and reciprocal, two dot products) times CT; all of a
// chunk's sequences are resident at once, so nothing else can hide it.
//
// Narrow storage (bf16 z, int8 or bf16 y): a thread's element is 1 or 2
// bytes, and cp.async moves 4, 8 or 16, so each element goes through the
// ring as the aligned 4-byte word that holds it (oco::play_time_major_words,
// the same ring of the same depth); the large-d instance loads each row as
// it plays it.
//
// K4w (K4 past d = 512, stream_wide_kernel) plays a sequence on a warp,
// as K3w does (game_kernel.cu), whose rows it reads in the same layout.
// One thread a sequence with theta and w in the output carry and x in a
// (d, B) buffer (this instance's first design) left the card nearly empty
// at the path's width (B = 2,048: 32 blocks of 2 warps on 132 SMs, each
// thread's round 4-6 passes over 4 KB vectors, a memory round trip per 8
// elements).  The design:
//   - a block plays W = 32 / sizeof(z element) consecutive sequences, a
//     warp each, and copies each round's d x W tile of the time-major
//     chunk into a shared stage with cp.async, transposed into
//     conflict-free columns (oco_warp.cuh TimeMajorTile), so each row
//     crosses L2 once a block;
//   - lane l holds elements j = l + 32 m of theta and w in shared memory,
//     read from the input carry's columns once a launch and written to
//     the output carry's once; x is never stored: each lane forms x_j from
//     theta_j and the round's scale where a product needs it, and each sum
//     is one lane's index-order sum of a product line (oco_warp.cuh), the
//     same bits as game_round's helpers.  An FTRL round takes its scale
//     -(eta_b / sqrt(t)) at the global index t = t0 + k + 1 in the compute
//     type, sums ||x||^2 and <z_t, x> side by side on lanes 0 and 1 and
//     <z_t, x> again only where it projects; FTL sums ||theta||^2, then q;
//     the update adds g z_t to theta and y_t z_t to w, lane-parallel;
//   - w enters no sum, but in shared memory it takes 32 KB a block at f32,
//     d = 1,024, as much as a second stage.  So the block keeps one stage:
//     it copies round k + 1's tile once every warp has read round k's (a
//     barrier), while FTL warps sum round k + 1's ||theta||^2, which reads
//     no row, and a second barrier sees the copy land.  Two stages with w
//     in the output carry's columns, the block's threads adding y_t z_t a
//     32-byte sector at a time through L2 (twice the z stream's bytes),
//     took 78.4 ms for the path's 4 launches on an H100 where this takes
//     56.2 (all FTRL 69.8 and 43.7, all FTL 85.4 and 61.0);
//   - a block's flags may differ (the path alternates FTRL and FTL), so
//     its round barriers pace FTRL's one chain at FTL's two.
// What bounds it: FTL's two one-lane chains of d dependent adds a round
// and the issue of the lanes' products, with 16 warps an SM (f32 at d =
// 1,024: 114,944 bytes a block of 8 warps, the path's 2,048 warps in one
// wave).  Up to the plan's max_shared_d theta, w and the stage lie on the
// chip; past it theta and w lie in the caller's (B, 2 d) buffer,
// contiguous a warp, and each lane reads its elements from the
// time-major rows: the library's plan (oco_stream_plan) reports the
// boundary, and the wrapper allocates the buffer it asks for.  The same
// round in the same order: K4w over chunks equals K1w in one pass bit for
// bit.
#include "oco_warp.cuh"

namespace {

// Threads a block, and bytes of rows in flight a thread.  On an H100 at
// B = 16,384, CT = 8,192, d = 5, a ring of twice the bytes and blocks of 32
// threads were each measured no faster (the ring hides the loads at 8
// rounds ahead, so a round costs game_round's chain).
constexpr int kStreamThreads = 64;
constexpr int kRingBytes = 192;

// Rounds in flight for one instance: kRingBytes of d = 5 rows (a narrow
// element takes a 4-byte word), 4 rounds of the generic instance
// (d <= 64), none for the large-d one.
template <typename Z, typename Y, int D>
struct Ring {
  static constexpr int word =
      oco::kWindowed<Z, Y> ? 4 : static_cast<int>(sizeof(Z));
  static constexpr int depth =
      D > 0 ? kRingBytes / ((D + 1) * word) : (D == 0 ? 4 : 0);
  static_assert(depth == 0 || depth >= 2, "a ring needs two slots");
};

template <typename Z, typename Y, int D, typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
              const int* __restrict__ alg_flag, const S* __restrict__ eta,
              long long t0, long long CT, long long B, int d,
              const S* __restrict__ th_in, const S* __restrict__ w_in,
              const S* __restrict__ cum_in, const S* __restrict__ cnt_in,
              S* __restrict__ th_out, S* __restrict__ w_out,
              S* __restrict__ cum_out, S* __restrict__ cnt_out) {
  static_assert(D != oco::kWideD, "K4w is stream_wide_kernel");
  constexpr int C = oco::Cap<D>::value;
  constexpr int P = Ring<Z, Y, D>::depth;
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;   // the ring is per thread: no barrier to keep
  const int n = D > 0 ? D : d;
  const bool ftrl = alg_flag[b] == 0;
  const S eta_b = eta[b];

  S th[C], w[C], x[C], zr[C];
#pragma unroll
  for (int j = 0; j < n; ++j) {
    th[j] = th_in[j * B + b];
    w[j] = w_in[j * B + b];
  }
  S cum = cum_in[b], cnt = cnt_in[b];
  if constexpr (P > 0 && oco::kWindowed<Z, Y>) {
    oco::play_time_major_words<S, D, P>(
        z, y, CT, b, B, n,
        reinterpret_cast<unsigned*>(ring_bytes) + threadIdx.x, blockDim.x,
        [&](long long k, const S* row, S yt) {
          oco::game_round<S, D>(th, w, x, row, yt, ftrl, eta_b,
                                S(t0 + k + 1), n, cum);
          cnt = cnt + yt * yt;
        });
  } else if constexpr (P == 0) {
    for (long long k = 0; k < CT; ++k) {
      oco::load_row<S, D>(z, k, b, B, n, zr);
      const S yt = S(oco::widen(y[k * B + b]));
      oco::game_round<S, D>(th, w, x, zr, yt, ftrl, eta_b, S(t0 + k + 1), n,
                            cum);
      cnt = cnt + yt * yt;
    }
  } else {
    // Slot i of this thread holds a round's z_0..z_{n-1}, y at stride
    // blockDim.x: ring[(i * (n + 1) + j) * blockDim.x + threadIdx.x].
    S* mine = reinterpret_cast<S*>(ring_bytes) + threadIdx.x;
    const int step = blockDim.x;
    const auto fetch = [&](long long k) {
      S* dst = mine + static_cast<int>(k % P) * (n + 1) * step;
      const S* src = z + k * n * B + b;
      for (int j = 0; j < n; ++j)
        oco::copy_async(dst + j * step, src + j * B);
      oco::copy_async(dst + n * step, y + k * B + b);
    };
    // One copy group a round, empty past the chunk, so that group k is
    // complete once at most P - 1 newer ones are pending.
#pragma unroll
    for (int i = 0; i < P - 1; ++i) {
      if (i < CT) fetch(i);
      oco::commit_copies();
    }
    for (long long k = 0; k < CT; ++k) {
      // Slot (k - 1) % P was read last round, so it can be refilled.
      if (k + P - 1 < CT) fetch(k + P - 1);
      oco::commit_copies();
      oco::wait_copies<P - 1>();
      const S* src = mine + static_cast<int>(k % P) * (n + 1) * step;
#pragma unroll
      for (int j = 0; j < n; ++j) zr[j] = src[j * step];
      const S yt = src[n * step];
      oco::game_round<S, D>(th, w, x, zr, yt, ftrl, eta_b, S(t0 + k + 1), n,
                            cum);
      cnt = cnt + yt * yt;
    }
  }
#pragma unroll
  for (int j = 0; j < n; ++j) {
    th_out[j * B + b] = th[j];
    w_out[j * B + b] = w[j];
  }
  cum_out[b] = cum;
  cnt_out[b] = cnt;
}

// ------------------------------------------------------------------- K4w

// Products a warp's line holds (oco_warp.cuh).
constexpr int kStreamLine = 512;
// Each lane forms a chunk's products before it stores any (oco_warp.cuh
// put_products, kBatch) and updates kStreamUnroll elements of theta and w
// at a time, so that their loads are in flight together; the launch
// bounds name one block an SM, as K3w's do, so that ptxas gives these
// their registers.
constexpr int kStreamUnroll = 4;

using oco::up4;

template <typename Z>
constexpr int kStreamWarps = oco::kTileWarps<Z>;

// Bytes of a block's shared memory: one stage and W thetas and ws
// (shared), then W product lines.
template <typename Z, typename S = oco::compute_t<Z>>
__host__ __device__ inline long long stream_state_bytes(int d, bool shared) {
  return shared ? oco::tile_stage_bytes<Z>(d) +
                      2 * kStreamWarps<Z> * up4(d) *
                          static_cast<long long>(sizeof(S))
                : 0;
}
template <typename Z, typename S = oco::compute_t<Z>>
__host__ __device__ inline long long stream_block_bytes(int d, bool shared) {
  return stream_state_bytes<Z>(d, shared) +
         kStreamWarps<Z> * oco::line_elems<S, kStreamLine>() *
             static_cast<long long>(sizeof(S));
}

template <typename Z, typename Y, bool kShared,
          typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(kStreamWarps<Z> * 32, 1)
stream_wide_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
                   const int* __restrict__ alg_flag,
                   const S* __restrict__ eta, long long t0, long long CT,
                   long long B, int d, const S* __restrict__ th_in,
                   const S* __restrict__ w_in, const S* __restrict__ cum_in,
                   const S* __restrict__ cnt_in, S* __restrict__ th_out,
                   S* __restrict__ w_out, S* __restrict__ cum_out,
                   S* __restrict__ cnt_out, S* state) {
  using U = oco::TileUnit<Z>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b0 = static_cast<long long>(blockIdx.x) * kStreamWarps<Z>;
  const long long b = b0 + warp;
  // A warp with no sequence stays for the block's copies and barriers;
  // past the shared boundary no barrier spans the block's warps.
  const bool live = b < B;
  if (!kShared && !live) return;
  const int n = d;
  U* stage = reinterpret_cast<U*>(smem);
  S* th = kShared ? reinterpret_cast<S*>(
                        smem + oco::tile_stage_bytes<Z>(n)) +
                        warp * 2 * up4(n)
                  : state + b * 2 * up4(n);
  S* w = th + up4(n);
  S* line = reinterpret_cast<S*>(smem + stream_state_bytes<Z>(n, kShared)) +
            warp * oco::line_elems<S, kStreamLine>();
  const oco::TimeMajorTile<Z> tile(z, B, b0, n);
  // Element j of the warp's row k: from the stage, or (past the boundary)
  // from the time-major rows.
  const auto z_at = [&](long long k, int j) -> S {
    if constexpr (kShared)
      return tile.at(stage, k, j, warp);
    else
      return S(oco::widen(z[(k * n + j) * B + b]));
  };

  // The carry in.
  if (live) {
    for (int j = lane; j < n; j += 32) {
      th[j] = th_in[j * B + b];
      w[j] = w_in[j * B + b];
    }
  }
  S cum = live ? cum_in[b] : S(0), cnt = live ? cnt_in[b] : S(0);
  const bool ftrl = live && alg_flag[b] == 0;
  const S eta_b = live ? eta[b] : S(0);
  S y_next = CT > 0 && live ? S(oco::widen(y[b])) : S(0);
  if constexpr (kShared) {
    if (CT > 0) tile.fetch(0, stage);
    oco::commit_copies();
  }
  __syncwarp();
  for (long long k = 0; k < CT; ++k) {
    // ftl_action: x = s theta, s = -1 / ||theta|| (0 at theta == 0); its
    // ||theta||^2 reads no row, so FTL sums it while row k lands.
    const S s = live && !ftrl
                    ? oco::ftl_scale<kStreamLine>(line, n, lane, th)
                    : S(0);
    if constexpr (kShared) {
      oco::wait_copies<0>();
      __syncthreads();  // row k landed
    }
    if (live) {
      const S yt = y_next;
      if (k + 1 < CT) y_next = S(oco::widen(y[(k + 1) * B + b]));
      const auto z = [&](int j) { return z_at(k, j); };
      S q;
      if (ftrl) {
        // ftrl_action at t = t0 + k + 1.
        const S sc = -(eta_b / oco::osqrt(S(t0 + k + 1)));
        S f;
        bool proj;
        q = oco::ftrl_q<kStreamLine>(line, n, lane, sc, th, z, f, proj);
      } else {
        q = oco::warp_dot<kStreamLine, true>(
            line, n, lane, [&](int j) { return z(j) * (s * th[j]); });
      }
      // hinge_step, then update: theta, w += y_t z_t; cnt += y_t^2.
      const S diff = q - yt;
      cum = cum + S(0.5) * oco::oabs(diff);
      const S g = oco::half_sign(diff);
      for (int j0 = lane; j0 < n; j0 += 32 * kStreamUnroll) {
        S zj[kStreamUnroll], tj[kStreamUnroll], wj[kStreamUnroll];
#pragma unroll
        for (int u = 0; u < kStreamUnroll; ++u) {
          const int j = j0 + 32 * u;
          if (j < n) {
            zj[u] = z_at(k, j);
            tj[u] = th[j];
            wj[u] = w[j];
          }
        }
#pragma unroll
        for (int u = 0; u < kStreamUnroll; ++u) {
          const int j = j0 + 32 * u;
          if (j < n) {
            th[j] = tj[u] + g * zj[u];
            w[j] = wj[u] + yt * zj[u];
          }
        }
      }
      cnt = cnt + yt * yt;
    }
    if constexpr (kShared) {
      __syncthreads();  // every warp has read row k: the stage is free
      if (k + 1 < CT) tile.fetch(k + 1, stage);
      oco::commit_copies();
    } else {
      __syncwarp();
    }
  }
  if (!live) return;
  if (lane == 0) {
    cum_out[b] = cum;
    cnt_out[b] = cnt;
  }
  for (int j = lane; j < n; j += 32) {
    th_out[j * B + b] = th[j];
    w_out[j * B + b] = w[j];
  }
}

// The largest d whose block fits shared memory with theta, w and the
// stage.
template <typename Z>
int stream_max_shared_d() {
  return oco::max_shared_d(
      [](int d) { return stream_block_bytes<Z>(d, true); });
}

// K4w's block at d: W warps, theta, w and the stage in shared memory up
// to stream_max_shared_d().
template <typename Z>
oco::WarpPlan stream_plan(int d) {
  oco::WarpPlan p{};
  p.warps = kStreamWarps<Z>;
  p.shared = d <= stream_max_shared_d<Z>();
  p.smem = stream_block_bytes<Z>(d, p.shared);
  p.state = p.shared ? 0 : 2 * up4(d);
  return p;
}

// K4w's kernel for a plan.
template <typename Z, typename Y>
auto stream_wide(const oco::WarpPlan& p) {
  return p.shared ? &stream_wide_kernel<Z, Y, true>
                  : &stream_wide_kernel<Z, Y, false>;
}

template <typename Z, typename Y, typename S>
int launch_stream_wide(const Z* z, const Y* y, const int* flags,
                       const S* eta, long long t0, long long CT, long long B,
                       int d, const S* ti, const S* wi, const S* ci,
                       const S* ni, S* to, S* wo, S* co, S* no, S* state,
                       cudaStream_t s) {
  const oco::WarpPlan p = stream_plan<Z>(d);
  if (!p.shared && state == nullptr) return cudaErrorInvalidValue;
  const long long grid = (B + p.warps - 1) / p.warps;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  return oco::launch_with_smem(
      stream_wide<Z, Y>(p), static_cast<unsigned int>(grid), p.warps * 32,
      static_cast<size_t>(p.smem), s, z, y, flags, eta, t0, CT, B, d, ti, wi,
      ci, ni, to, wo, co, no, state);
}

template <typename Z, typename Y>
int launch(const void* z, const void* y, const void* alg_flag,
           const void* eta, long long t0, long long CT, long long B, int d,
           const void* th_in, const void* w_in, const void* cum_in,
           const void* cnt_in, void* th_out, void* w_out, void* cum_out,
           void* cnt_out, void* state, void* stream) {
  using S = oco::compute_t<Z>;
  if (B < 1 || CT < 0 || t0 < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = static_cast<unsigned int>(
      (B + kStreamThreads - 1) / kStreamThreads);
  const auto* zp = static_cast<const Z*>(z);
  const auto* yp = static_cast<const Y*>(y);
  const auto* fp = static_cast<const int*>(alg_flag);
  const auto* ep = static_cast<const S*>(eta);
  const auto* ti = static_cast<const S*>(th_in);
  const auto* wi = static_cast<const S*>(w_in);
  const auto* ci = static_cast<const S*>(cum_in);
  const auto* ni = static_cast<const S*>(cnt_in);
  auto* to = static_cast<S*>(th_out);
  auto* wo = static_cast<S*>(w_out);
  auto* co = static_cast<S*>(cum_out);
  auto* no = static_cast<S*>(cnt_out);
  int err = cudaSuccess;
  const int launched = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if constexpr (D == oco::kWideD) {
      err = launch_stream_wide<Z, Y, S>(zp, yp, fp, ep, t0, CT, B, d, ti, wi,
                                        ci, ni, to, wo, co, no,
                                        static_cast<S*>(state), s);
    } else {
      const size_t smem = static_cast<size_t>(Ring<Z, Y, D>::depth) *
                          (d + 1) * Ring<Z, Y, D>::word * kStreamThreads;
      err = oco::launch_with_smem(stream_kernel<Z, Y, D>, grid,
                                  kStreamThreads, smem, s, zp, yp, fp, ep, t0,
                                  CT, B, d, ti, wi, ci, ni, to, wo, co, no);
    }
  });
  return err != cudaSuccess ? err : launched;
}

template <typename Z, typename Y>
int occupancy(int d, int* out) {
  using S = oco::compute_t<Z>;
  int err = cudaSuccess;
  const int checked = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const auto measure = [&](auto kernel, int threads, size_t smem) {
      err = oco::occupancy(kernel, threads, smem, out);
      if (err == cudaSuccess) err = oco::local_bytes(kernel, out + 2, smem);
    };
    if constexpr (D == oco::kWideD) {
      const oco::WarpPlan p = stream_plan<Z>(d);
      measure(stream_wide<Z, Y>(p), p.warps * 32,
              static_cast<size_t>(p.smem));
    } else {
      measure(stream_kernel<S, S, D>, kStreamThreads,
              static_cast<size_t>(Ring<S, S, D>::depth) * (d + 1) *
                  Ring<S, S, D>::word * kStreamThreads);
    }
  });
  return err != cudaSuccess ? err : checked;
}

}  // namespace

// Inputs: z (CT, d, B) and y (CT, B) time-major in a storage pair of
// OCO_STORAGE_PAIRS (the suffix), alg_flag (B,) int32 (0 = FTRL, 1 = FTL),
// eta (B,), t0 >= 0 the rounds already played, and the carry theta (d, B),
// w (d, B), cum (B,), cnt (B,), eta and the carry in the compute type; any
// d >= 1.  Outputs: the advanced carry in separate buffers (no aliasing
// with the inputs).  state: where oco_stream_plan asks for one (d past its
// max_shared_d), a scratch buffer of `state` * B elements of the compute
// type (ops/game.py::wide_state_elems), else unused (may be null).
// Returns the cudaError_t of the launch.
#define OCO_STREAM_ENTRY(SUFFIX, Z, Y)                                      \
  extern "C" int oco_play_stream_##SUFFIX(                                  \
      const void* z, const void* y, const void* alg_flag, const void* eta,  \
      long long t0, long long CT, long long B, int d, const void* th_in,    \
      const void* w_in, const void* cum_in, const void* cnt_in,             \
      void* th_out, void* w_out, void* cum_out, void* cnt_out, void* state, \
      void* stream) {                                                       \
    return launch<Z, Y>(z, y, alg_flag, eta, t0, CT, B, d, th_in, w_in,     \
                        cum_in, cnt_in, th_out, w_out, cum_out, cnt_out,    \
                        state, stream);                                     \
  }
OCO_STORAGE_PAIRS(OCO_STREAM_ENTRY)

// Registers a thread (out[0]), resident warps an SM (out[1]), bytes of a
// thread's local frame (out[2]) and of a block's shared memory (out[3]) of a
// launch at feature dimension d on the current card (K4w at its plan's
// block); f64 nonzero for the float64 instance.  Returns the cudaError_t.
extern "C" int oco_stream_occupancy(int f64, int d, int* out) {
  return f64 ? occupancy<double, double>(d, out)
             : occupancy<float, float>(d, out);
}

// K4w's plan at d > 512 with z in `storage` (0 float32, 1 float64, 2
// bf16) on the current card: warps a block (out[0]), bytes of dynamic
// shared memory a block (out[1]), 1 if theta, w and the stage lie in
// shared memory (out[2]), elements of the state buffer a sequence, 0 where shared
// (out[3]), and the largest d whose block fits shared memory (out[4]).
// Returns cudaErrorInvalidValue for d <= 512 or an unknown storage, else
// cudaSuccess.
extern "C" int oco_stream_plan(int storage, int d, long long* out) {
  if (d <= OCO_LARGE_D || storage < 0 || storage > 2)
    return cudaErrorInvalidValue;
  const oco::WarpPlan p = storage == 0   ? stream_plan<float>(d)
                          : storage == 1 ? stream_plan<double>(d)
                                         : stream_plan<oco::bf16>(d);
  out[0] = p.warps;
  out[1] = p.smem;
  out[2] = p.shared ? 1 : 0;
  out[3] = p.state;
  out[4] = storage == 0   ? stream_max_shared_d<float>()
           : storage == 1 ? stream_max_shared_d<double>()
                          : stream_max_shared_d<oco::bf16>();
  return cudaSuccess;
}
