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
// is vector 0 of slot e * B + s (s the sequence's place in the order) in
// the caller's state buffer, laid out (d, E * B).  w is summed once a
// block and sequence, by warp 0 in its rounds (the same sums in the same
// order), into slot (block's setting group) * B + s of a (d, groups * B)
// part after theta; the block's barrier then hands it to every warp for
// the identity comparator.
//
// What bounds K5w on an H100: its state, and the rows' reads.  At the
// sweep path's shape (B = 1,024, E = 64, d = 1,024, f64) the pairs' theta
// is 0.54 GB, 11x the L2, so every pass over it goes to device memory.
// Played with K1's helpers a round touched theta and x six to eight times
// (x written, read for its norm, projected, read for q; theta read and
// written by the update): 2.5-3.3 TB at that shape, 1.46 s.  The design:
//   - a round is two passes over theta and keeps no x (PassQ, PassU): q
//     reads theta, forming x from it; the update reads it again, writes it
//     and sums the next round's ||x||^2 from the new theta, so that the
//     next q knows whether to project.  Each x_j is the same one or two
//     products, every sum the same order: the same bits.  Two reads and
//     one write of theta a round, 24 KB a pair-round in f64, 1.24 TB at
//     the path shape;
//   - each pass keeps the next blocks of 8 elements of theta in flight in
//     registers while a block's arithmetic runs (kWideBufs);
//   - the 16 warps of a block play the same 32 sequences, so a pass's rows
//     are staged once for all of them, 1 KB of each row at a time, with
//     cp.async into two stages (WideRows), and each lane reads its own row
//     from there 16 bytes at a time.  Read from global memory by each
//     thread, a warp's load touched 32 rows, one L1 wavefront each, and 16
//     warps read every row twice a round;
//   - the comparator's final FTL action is written over theta.
// Same order as the plain version at any d (rows whose bytes are not a
// multiple of 16 are read from global memory), and the local frame does
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

// ------------------------------------------------------------------ K5w

// A round's rows, staged for the block's 16 warps a chunk at a time: a
// chunk is kRowChunkBytes of each of the block's 32 rows (its sequences'
// row t), row r at r * kRowPitch in a stage, two stages.  The 512 threads
// copy a chunk with kRowCopies 16-byte cp.asyncs each (copy m of thread i
// piece 16 m + i % 16 of row i / 16), and a lane reads its own row's
// elements 16 bytes at a time: the pitch's extra 16 bytes put the 8 lanes
// of a 16-byte read's phase on 32 different banks.  A chunk's two
// barriers cost the block its slowest warp; 1 KB a row makes 8 chunks a
// pass at d = 1,024 in f64 (256 bytes a row made 32 and timed slower).
constexpr int kRowChunkBytes = 1024;
constexpr int kRowPitch = kRowChunkBytes + 16;
constexpr size_t kRowStageBytes = 32 * kRowPitch;
constexpr int kRowCopies = 32 * kRowChunkBytes / 16 / (kSweepWarps * 32);
static_assert(kRowCopies * 16 * kSweepWarps * 32 == 32 * kRowChunkBytes,
              "a chunk is whole 16-byte copies a thread");

// kWideBlock elements of a row in storage type Z at a 16-byte aligned
// address, widened to S, 16 bytes a read.
template <typename S, typename Z>
__device__ __forceinline__ void row_block16(const Z* p,
                                            S (&out)[oco::kWideBlock]) {
  static_assert(oco::kWideBlock == 8, "a block of 8 elements");
  if constexpr (std::is_same<Z, double>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const double2 v = reinterpret_cast<const double2*>(p)[i];
      out[2 * i] = S(v.x);
      out[2 * i + 1] = S(v.y);
    }
  } else if constexpr (std::is_same<Z, float>::value) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = S(v.x);
      out[4 * i + 1] = S(v.y);
      out[4 * i + 2] = S(v.z);
      out[4 * i + 3] = S(v.w);
    }
  } else {
    static_assert(std::is_same<Z, oco::bf16>::value,
                  "rows of float64, float32 or bf16");
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = S(__uint_as_float(w[i] << 16));
      out[2 * i + 1] = S(__uint_as_float(w[i] & 0xffff0000u));
    }
  }
}

// The block's rows of one round and where a lane's elements come from:
// the stage for the staged chunks (nc of them: every whole chunk where the
// rows are 16-byte aligned, vec), the lane's own row in global memory past
// them.
template <typename S, typename Z>
struct WideRows {
  static constexpr int kChunk = kRowChunkBytes / static_cast<int>(sizeof(Z));
  unsigned char* stage;
  int lane, nc;
  bool vec;
  // This thread's pieces of a chunk: row copy_row's bytes 16 (16 m +
  // piece) .. for m < kRowCopies.
  const Z* copy_src;  // that row at this round, null where it plays none
  int copy_row, piece;
  const Z* mine;      // the lane's own row at this round (live lanes)
  bool live;

  // Issues the copy of chunk c (if staged) and commits it as a group.
  __device__ __forceinline__ void issue(int c) const {
    if (c < nc && copy_src != nullptr) {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(copy_src + c * kChunk) +
          piece * 16;
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
          stage + (c & 1) * kRowStageBytes + copy_row * kRowPitch +
          piece * 16));
#pragma unroll
      for (int m = 0; m < kRowCopies; ++m)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         dst + m * 256),
                     "l"(src + m * 256)
                     : "memory");
    }
    oco::commit_copies();
  }
  // Whole block j0 of the lane's row.
  __device__ __forceinline__ void block(int j0,
                                        S (&out)[oco::kWideBlock]) const {
    const int c = j0 / kChunk;
    if (c < nc) {
      row_block16(reinterpret_cast<const Z*>(stage + (c & 1) * kRowStageBytes +
                                             lane * kRowPitch) +
                      (j0 - c * kChunk),
                  out);
    } else if (!live) {
#pragma unroll
      for (int k = 0; k < oco::kWideBlock; ++k) out[k] = S(0);
    } else if (vec) {
      row_block16(mine + j0, out);
    } else {
#pragma unroll
      for (int k = 0; k < oco::kWideBlock; ++k)
        out[k] = S(oco::widen(mine[j0 + k]));
    }
  }
};

// Blocks of theta a pass keeps in registers: the one in use and the next
// two, or the next one where w rides along (warp 0's pass U).  Two blocks
// ahead or one timed the same in float64 and float32, and four ahead in
// float32 no faster (PERF.md).
template <bool kW>
constexpr int kWideBufs = kW ? 2 : 3;

// One pass over theta and the round's rows: every thread of the block
// takes part (the stages' barriers), a lane past its sequence's rounds
// with live false.  The whole blocks of theta (p.load) go P::kBufs - 1
// ahead of the block in use, carried in registers as whole blocks (a
// guarded write into a carried block keeps the blocks in the local frame);
// the last partial block is read and used at once.
template <typename S, typename Z, typename P>
__device__ __forceinline__ void wide_pass(int n, P& p,
                                          const WideRows<S, Z>& rows) {
  constexpr int K = oco::kWideBlock;
  constexpr int CB = WideRows<S, Z>::kChunk / K;
  constexpr int R = P::kBufs;
  const int nb = n / K;
  rows.issue(0);
  typename P::Blk buf[R];
#pragma unroll
  for (int r = 0; r + 1 < R; ++r)
    p.template load<false>(min(r, nb - 1) * K, buf[r]);
  for (int i = 0; i < nb; ++i) {
    const bool staged = i / CB < rows.nc;
    if (staged && i % CB == 0) {
      rows.issue(i / CB + 1);
      oco::wait_copies<1>();
      __syncthreads();
    }
    p.template load<false>(min(i + R - 1, nb - 1) * K, buf[R - 1]);
    S z[K];
    rows.block(i * K, z);
    p.template use<false>(i * K, buf[0], z);
#pragma unroll
    for (int r = 0; r + 1 < R; ++r) buf[r] = buf[r + 1];
    // The stage is refilled two chunks on.
    if (staged && (i + 1) % CB == 0) __syncthreads();
  }
  const int j0 = nb * K;
  if (j0 < n) {
    typename P::Blk t;
    p.template load<true>(j0, t);
    S z[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      z[k] = rows.live && j0 + k < n ? S(oco::widen(rows.mine[j0 + k])) : S(0);
    p.template use<true>(j0, t, z);
  }
}

// Pass Q: q = <z_t, x>, x_j = scale * theta_j, times f = 1 / sqrt(nsq)
// where the round projects (nsq = ||scale * theta||^2, from the last
// pass U): scaled, dot and hinge_step's products in their order.
template <typename S, typename TH>
struct PassQ {
  static constexpr int kBufs = kWideBufs<false>;
  struct Blk {
    S t[oco::kWideBlock];
  };
  TH th;
  int n;
  S scale, f;
  bool proj;
  S acc;
  template <bool kGuard>
  __device__ __forceinline__ void load(int j0, Blk& b) const {
#pragma unroll
    for (int k = 0; k < oco::kWideBlock; ++k)
      if (!kGuard || j0 + k < n) b.t[k] = th[j0 + k];
  }
  template <bool kGuard>
  __device__ __forceinline__ void use(int j0, const Blk& b,
                                      const S (&z)[oco::kWideBlock]) {
#pragma unroll
    for (int k = 0; k < oco::kWideBlock; ++k) {
      if (!kGuard || j0 + k < n) {
        S x = scale * b.t[k];
        if (proj) x = f * x;
        acc = acc + z[k] * x;
      }
    }
  }
};

// Pass U: theta_j += g z_tj (w_j += y_t z_tj where W is not nullptr_t),
// stored where the lane is live, and acc += (next * theta_j)^2: the next
// round's nsq.
template <typename S, typename TH, typename W>
struct PassU {
  static constexpr bool kW = !std::is_same<W, std::nullptr_t>::value;
  static constexpr int kBufs = kWideBufs<kW>;
  struct Blk {
    S t[oco::kWideBlock], u[kW ? oco::kWideBlock : 1];
  };
  TH th;
  W w;
  int n;
  S g, yt, next;
  bool live;
  S acc;
  template <bool kGuard>
  __device__ __forceinline__ void load(int j0, Blk& b) const {
#pragma unroll
    for (int k = 0; k < oco::kWideBlock; ++k) {
      if (!kGuard || j0 + k < n) {
        b.t[k] = th[j0 + k];
        if constexpr (kW) b.u[k] = w[j0 + k];
      }
    }
  }
  template <bool kGuard>
  __device__ __forceinline__ void use(int j0, const Blk& b,
                                      const S (&z)[oco::kWideBlock]) {
#pragma unroll
    for (int k = 0; k < oco::kWideBlock; ++k) {
      if (!kGuard || j0 + k < n) {
        const S t = b.t[k] + g * z[k];
        if (live) {
          th[j0 + k] = t;
          if constexpr (kW) w[j0 + k] = b.u[k] + yt * z[k];
        }
        const S v = next * t;
        acc = acc + v * v;
      }
    }
  }
};

// K5w's pair: its rounds in two passes over theta (PassQ, PassU), theta
// and the block's w in the state buffer, no x, the rows staged for the
// block; the final FTL action written over theta for the comparator.
// Every sum starts from -0, the additive identity, so that its first add
// gives the first product as dot's first product does: the same bits.
template <typename Z, typename Y, typename S>
__device__ __forceinline__ void sweep_wide_body(
    const Z* __restrict__ z, const Y* __restrict__ y,
    const S* __restrict__ scales, const int* __restrict__ order,
    const int* __restrict__ lengths, long long B, long long E, long long T,
    int n, int replay, S* __restrict__ regret, S* state) {
  constexpr int D = oco::kWideD;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long setting_blocks = (E + kSweepWarps - 1) / kSweepWarps;
  const long long group = blockIdx.x % setting_blocks;
  const long long first = (blockIdx.x / setting_blocks) * 32;
  const long long slot = first + lane;
  const long long e = group * kSweepWarps + warp;
  const long long b = slot < B ? order[slot] : -1;
  const bool on = b >= 0 && e < E;
  const int seq_len = b >= 0 ? lengths[b] : 0;
  const int len = on ? seq_len : 0;
  // Every warp holds the block's 32 sequences, so every thread finds the
  // block's rounds: the longest of its warp's.
  const int rounds = __reduce_max_sync(oco::kFullMask, seq_len);
  // Warp 0 plays a setting of every sequence (e < E), so its rounds are
  // the sequence's own: it sums the block's w (a whole warp, so that the
  // passes' barriers sit in one branch; a lane past B stores nothing).
  const bool sums_w = warp == 0;
  const long long slots = E * B;
  const oco::Strided<S> th{state + (on ? e * B + slot : 0), slots};
  const oco::Strided<S> w{state + slots * n + (b >= 0 ? group * B + slot : 0),
                          setting_blocks * B};
  if (on) {
    for (int j = 0; j < n; ++j) th[j] = S(0);
  }
  if (sums_w && b >= 0) {
    for (int j = 0; j < n; ++j) w[j] = S(0);
  }
  // The row this thread copies a piece of.
  const int copy_row = threadIdx.x >> 4;
  const long long copy_slot = first + copy_row;
  const long long copy_b = copy_slot < B ? order[copy_slot] : -1;
  const int copy_len = copy_b >= 0 ? lengths[copy_b] : 0;
  const bool vec = n * static_cast<int>(sizeof(Z)) % 16 == 0 &&
                   (reinterpret_cast<unsigned long long>(z) & 15) == 0;
  WideRows<S, Z> rows{smem, lane, vec ? n / WideRows<S, Z>::kChunk : 0, vec,
                      nullptr, copy_row, static_cast<int>(threadIdx.x & 15),
                      nullptr, false};
  const S* srow = scales + (on ? e : 0) * T;
  // ||x||^2 of the round's x before its projection: 0 at round 0, where
  // theta = 0; then from the last round's pass U.
  S cum = S(0), nsq = S(0);
  for (int t = 0; t < rounds; ++t) {
    const bool live = t < len;
    rows.live = live;
    rows.mine = live ? z + (b * T + t) * n : nullptr;
    rows.copy_src = t < copy_len ? z + (copy_b * T + t) * n : nullptr;
    const S yt = live ? S(oco::widen(y[b * T + t])) : S(0);
    const S scale = srow[t];
    const bool proj = nsq > S(1);
    PassQ<S, oco::Strided<S>> q{th, n, scale,
                                proj ? S(1) / oco::osqrt(nsq) : S(1), proj,
                                S(-0.0)};
    wide_pass(n, q, rows);
    const S diff = q.acc - yt;
    if (live) cum = cum + S(0.5) * oco::oabs(diff);
    const S g = live ? oco::half_sign(diff) : S(0);
    const S next = t + 1 < T ? srow[t + 1] : S(0);
    if (sums_w) {
      PassU<S, oco::Strided<S>, oco::Strided<S>> u{th, w, n, g, yt, next,
                                                   live, S(-0.0)};
      wide_pass(n, u, rows);
      if (live) nsq = u.acc;
    } else {
      PassU<S, oco::Strided<S>, std::nullptr_t> u{th, nullptr, n, g, yt,
                                                  next, live, S(-0.0)};
      wide_pass(n, u, rows);
      if (live) nsq = u.acc;
    }
  }
  // Warp 0's w of the block's sequences, for every warp; then only the
  // pairs play on (an idle thread's slot is another's).
  if (!replay) __syncthreads();
  if (!on) return;
  S comp;
  if (replay) {
    oco::ftl_action<S, D>(th, th, n);
    comp = oco::replay_comparator_rows<S, D>(z, y, b, T, n, len, th);
  } else {
    comp = oco::identity_comparator<S, D>(th, w, th, n, S(len));
  }
  regret[e * B + b] = cum - comp;
}

template <typename Z, typename Y, int D, typename S = oco::compute_t<Z>>
__device__ __forceinline__ void sweep_body(
    const Z* __restrict__ z, const Y* __restrict__ y,
    const S* __restrict__ scales, const int* __restrict__ order,
    const int* __restrict__ lengths, long long B, long long E, long long T,
    const oco::TileShape& ts, int replay, S* __restrict__ regret, S* state) {
  if constexpr (D == oco::kWideD) {
    sweep_wide_body<Z, Y, S>(z, y, scales, order, lengths, B, E, T, ts.n,
                             replay, regret, state);
  } else {
    constexpr int C = oco::Cap<D>::value;
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

    S th[C], w[C], x[C];
#pragma unroll
    for (int j = 0; j < n; ++j) th[j] = w[j] = S(0);
    S cum = S(0);
    oco::play_rows<S, D>(
        z, y, e < E ? scales + e * T : nullptr, b, T, ts, 0, len, smem,
        [&](int, auto zr, S yt, S scale) {
          oco::ftrl_action_scaled<S, D>(th, x, n, scale);
          const S g = oco::hinge_step<S, D>(x, zr, yt, n, cum);
#pragma unroll
          for (int j = 0; j < n; ++j) {
            th[j] = th[j] + g * zr[j];
            if constexpr (D < 0) w[j] = w[j] + yt * zr[j];
          }
        },
        [&](int t0, const Z* rows, const Y* labels, int R) {
          const int k_hi = min(seq_len - t0, R);
#pragma unroll
          for (int j = 0; j < n; ++j) {
            if (j % kSweepWarps != warp) continue;
            S wj = w[j];
            for (int k = 0; k < k_hi; ++k)
              wj = wj +
                   S(oco::widen(labels[k])) * S(oco::widen(rows[k * n + j]));
            w[j] = wj;
          }
        });
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

// The ring, then the warps' exchange of w (none for the large-d instance,
// which reads its rows from global memory; the wide instance's two row
// stages).
template <typename S, int D>
size_t sweep_smem(const oco::TileShape& ts, int d) {
  if (D == oco::kWideD) return 2 * kRowStageBytes;
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
    const size_t smem = sweep_smem<S, D>(ts, d);
    err = oco::occupancy(sweep_kernel<S, S, D>, kSweepWarps * 32, smem, out);
    if (err == cudaSuccess)
      err = oco::local_bytes(sweep_kernel<S, S, D>, out + 2, smem);
  });
  return err != cudaSuccess ? err : checked;
}

}  // namespace

// Inputs: z (B, T, d) and y (B, T) contiguous in a storage pair of
// OCO_STORAGE_PAIRS (the suffix), scales (E, T) the per-round FTRL scales
// -(eta_e / sqrt(t)) in the compute type, order (B,) int32 a permutation
// of the sequences (blocks take them in this order), lengths (B,) int32
// with 0 <= len <= T; any d >= 1.  Output: regret (E, B) in the compute
// type.  state: past d = 512 a scratch buffer of (E + ceil(E / 16)) * d
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

// Registers a thread (out[0]), resident warps an SM (out[1]), bytes of a
// thread's local frame (out[2]) and of a block's shared memory (out[3]) of a
// launch at feature dimension d on the current card; f64 nonzero for the
// float64 instance.  Returns the cudaError_t.
extern "C" int oco_sweep_occupancy(int f64, int d, int* out) {
  return f64 ? occupancy<double>(d, out) : occupancy<float>(d, out);
}
