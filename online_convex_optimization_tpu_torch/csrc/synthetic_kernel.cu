// K7: the generation-fused FTRL/FTL regret game, with no input data.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_game.py
// _synthetic_kernel, entry synthetic_regrets.  Python wrapper and plain
// PyTorch version: online_convex_optimization_tpu_torch/ops/game.py
// (synthetic_regrets, synthetic_regrets_reference).
//
// Each round of each sequence draws its row and label from Philox4x32-10
// (csrc/oco_philox.cuh): the key is the 64-bit seed, the counter of round t
// (0-based) of sequence b is (t, b, k, 0), and call k gives bits 128k ..
// 128k + 127; bit j < d is the sign of z_j = +-c, with c = 1/sqrt(d) rounded
// to float as the host computes it, and bit d the sign of y = +-1.  The
// round is K1's (the FTRL scale -eta / sqrt(t + 1) correctly rounded, not
// the TPU kernel's rsqrt, then oco::play_action), and the comparator is the
// final FTL action scored by the hinge identity 0.5 * (T - <x_c, w>): the
// labels are +-1 and every row has norm ~1 (within an ulp), so cnt = T.  So
// K7 on a seed equals K1 on synthetic_stream's materialized rows of that
// seed, bit for bit.  The counter word holds t < 2^32, which the wrapper
// checks, and the round loop counts in 32 bits.
//
// What bounds it on an H100: it reads nothing, so not bytes, and every
// sequence-step is the same instruction stream, so the issue of its
// instructions.  Of the Philox counter only t changes; a call needs at
// most 20 32 x 32-bit products (IMAD, on the FMA pipe beside the game's
// float operations) and 20 three-input xors (LOP3, on the integer ALU),
// and a shift and a select a bit.  The design keeps in each step only the
// work that differs between threads:
//   - the round keys depend on the seed alone: the wrapper forms them on
//     the host and passes them as a parameter (oco::PhiloxKeys), so LOP3
//     reads them from the constant bank;
//   - the FTRL scale depends on t and eta alone: each block writes it for
//     a chunk of OCO_SCALE_CHUNK rounds into shared memory, with the
//     per-round expression, and each step reads one word (a broadcast);
//   - FTL launches (a template instance of their own) have no table.
// One thread per sequence, state in registers for d = 5 (local memory for
// the runtime-d instances); no global traffic but the one (B,) store.  The
// TPU kernel fills a VMEM tile of bits per chunk; here every round is
// drawn where it is used, so nothing scales with T and T = 2^20 is one
// launch.
//
// Past d = 512 (K7w, the wide instance) one warp plays a sequence
// (synthetic_wide_kernel).  One thread a sequence with its vectors in a
// (d, B) device buffer (this instance's first design) left the card
// nearly empty at the path's width (16,384 sequences: 128 blocks of 4
// warps on 132 SMs, each thread's round 8-10 passes over 4 KB vectors in
// a buffer 4x the L2, a memory round trip per 8 elements) and drew each
// row twice (17 Philox calls a round at d = 1,024 where the bits need 9).
// The design:
//   - lane l holds elements j = l + 32 m of theta and w, which lie in
//     shared memory (conflict-free: a warp's access is 32 neighbouring
//     words) while a warp's lines fit a block, and past that in the
//     caller's buffer, (B, state floats a sequence), contiguous a warp;
//   - the round's Philox calls run side by side, call k on lane k % 32,
//     their words written to the warp's words line: 9 calls a round at d =
//     1,024, none repeated; element j's bit is bit l of word m;
//   - x is never stored: each lane forms x_j from theta_j where a product
//     needs it, writes the products of a chunk of at most kWideLine
//     elements to the warp's product line, and lane 0 sums the line in
//     index order, four floats a read, then broadcasts the sum (nsq, q, the
//     comparator's two sums): the same products in the same order as the
//     thread-a-sequence helpers, so the same bits (oco_warp.cuh, which
//     K3w and K6aw share);
//   - an FTRL round sums ||x||^2 and <z_t, x> of the unprojected x side by
//     side, lane 0 the one and lane 1 the other in the same instructions
//     (warp_dot2), and sums <z_t, x> again only in a round that projects:
//     one chain of d adds a round where it does not, two where it does;
//     FTL's q needs the norm first, so its two chains stay in turn;
//   - the FTRL scale is the same expression, formed by the warp each round
//     (no table, no block barrier).
// What bounds it: the one-lane sums, d or 2 d dependent adds a round, and
// their reads of the line; a block's warps (wide_plan) fill the SM's
// shared memory so that enough chains are in flight.  The state lives on
// the chip up to d = max_shared_d (28,100), in device memory past it: the
// library's plan (oco_synthetic_plan) reports the boundary and the block,
// and the wrapper allocates the buffer it asks for.
#include "oco_philox.cuh"
#include "oco_tiles.cuh"
#include "oco_warp.cuh"

// Rounds of FTRL scales a block holds in shared memory at a time.
#define OCO_SCALE_CHUNK 1024

namespace {

template <int D, bool FTRL>
__global__ void __launch_bounds__(OCO_THREADS)
synthetic_kernel(oco::PhiloxKeys keys, float eta, unsigned int T,
                 long long B, int d, float c, float* __restrict__ out) {
  constexpr int C = oco::Cap<D>::value;
  __shared__ float scale[FTRL ? OCO_SCALE_CHUNK : 1];
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  // A thread past B still takes part in the block's barriers.
  const bool live = b < B;
  const int n = D > 0 ? D : d;
  const unsigned int ub = static_cast<unsigned int>(b);

  float th[C], w[C], x[C], zr[C];
#pragma unroll
  for (int j = 0; j < n; ++j) th[j] = w[j] = 0.0f;
  float cum = 0.0f;

  for (unsigned long long c0 = 0; c0 < T; c0 += OCO_SCALE_CHUNK) {
    const auto t0 = static_cast<unsigned int>(c0);
    const unsigned int len = min(static_cast<unsigned int>(OCO_SCALE_CHUNK),
                                 T - t0);
    if constexpr (FTRL) {
      __syncthreads();  // the last chunk's reads are done
      for (unsigned int k = threadIdx.x; k < len; k += blockDim.x)
        scale[k] = -(eta / oco::osqrt(static_cast<float>(t0 + k + 1u)));
      __syncthreads();
    }
    if (!live) continue;
    for (unsigned int k = 0; k < len; ++k) {
      const unsigned int ut = t0 + k;
      oco::Philox4 r = oco::philox4x32_10(ut, ub, 0u, 0u, keys);
#pragma unroll
      for (int j = 0; j < n; ++j) {
        if (j > 0 && (j & 127) == 0)
          r = oco::philox4x32_10(ut, ub, j >> 7, 0u, keys);
        zr[j] = oco::philox_bit(r, j & 127) ? c : -c;
      }
      if ((n & 127) == 0) r = oco::philox4x32_10(ut, ub, n >> 7, 0u, keys);
      const float yt = oco::philox_bit(r, n & 127) ? 1.0f : -1.0f;
      if constexpr (FTRL)
        oco::ftrl_action_scaled<float, D>(th, x, n, scale[k]);
      else
        oco::ftl_action<float, D>(th, x, n);
      oco::play_action<float, D>(th, w, x, static_cast<const float*>(zr), yt,
                                 n, cum);
    }
  }
  if (live)
    out[b] = cum - oco::identity_comparator<float, D>(
                       th, w, x, n, static_cast<float>(T));
}

// ------------------------------------------------------------------- K7w

// Products a warp's line holds; warps a block at most.
constexpr int kWideLine = 1024;
constexpr int kWideWarps = 8;

// A sequence's lines, in floats, each a multiple of 4 (16 bytes): theta,
// w, the round's Philox words (4 a call, calls 0 .. d >> 7), then, in
// shared memory only, the product line of oco_warp.cuh: kWideLine floats,
// or two halves of kWideLine / 2 for two sums side by side, the second
// oco::kLineGap<float> floats further on.
using oco::up4;
__host__ __device__ inline int words_of(int d) { return 4 * ((d >> 7) + 1); }
constexpr int kLineFloats = oco::line_elems<float, kWideLine>();
__host__ __device__ inline long long state_floats(int d) {
  return 2 * up4(d) + words_of(d);
}
// Floats of shared memory a warp takes: its lines, or (state in device
// memory) its product line alone.
__host__ __device__ inline long long warp_floats(int d, bool shared) {
  return (shared ? state_floats(d) : 0) + kLineFloats;
}

// The largest d whose lines fit one warp's block in shared memory.
inline int max_shared_d() {
  return oco::max_shared_d([](int d) { return warp_floats(d, true) * 4; });
}

template <bool FTRL, bool kShared>
__global__ void __launch_bounds__(kWideWarps * 32)
synthetic_wide_kernel(oco::PhiloxKeys keys, float eta, unsigned int T,
                      long long B, int d, float c, float* __restrict__ out,
                      float* state) {
  extern __shared__ __align__(16) float wsm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  // No barrier spans the block's warps.
  if (b >= B) return;
  const int n = d;
  const unsigned int ub = static_cast<unsigned int>(b);
  float* own = wsm + warp * warp_floats(n, kShared);
  float* th = kShared ? own : state + b * state_floats(n);
  float* w = th + up4(n);
  unsigned int* words = reinterpret_cast<unsigned int*>(w + up4(n));
  float* line = kShared ? own + state_floats(n) : own;
  for (int j = lane; j < n; j += 32) th[j] = w[j] = 0.0f;
  const int calls = (n >> 7) + 1;
  // Element j's sign: bit j & 31 (the lane's) of word j >> 5.
  const auto z_of = [&](int j) {
    return (words[j >> 5] >> (j & 31)) & 1u ? c : -c;
  };
  float cum = 0.0f;
  for (unsigned int t = 0; t < T; ++t) {
    for (int k = lane; k < calls; k += 32) {
      const oco::Philox4 r = oco::philox4x32_10(
          t, ub, static_cast<unsigned int>(k), 0u, keys);
      *reinterpret_cast<uint4*>(words + 4 * k) =
          make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
    }
    __syncwarp();
    const float yt = (words[n >> 5] >> (n & 31)) & 1u ? 1.0f : -1.0f;
    float q;
    if constexpr (FTRL) {
      // ftrl_action_scaled: x = scale theta, projected iff ||x||^2 > 1.
      // ||x||^2 and <z_t, x> of the unprojected x are summed side by side;
      // the round that projects sums <z_t, x> again with f x.
      const float scale =
          -(eta / oco::osqrt(static_cast<float>(t + 1u)));
      const auto sums = oco::warp_dot2<kWideLine>(
          line, n, lane,
          [&](int j) {
            const float x = scale * th[j];
            return x * x;
          },
          [&](int j) { return z_of(j) * (scale * th[j]); });
      q = sums.y;
      if (sums.x > 1.0f) {
        const float f = 1.0f / oco::osqrt(sums.x);
        q = oco::warp_dot<kWideLine>(line, n, lane, [&](int j) {
          return z_of(j) * (f * (scale * th[j]));
        });
      }
    } else {
      // ftl_action: x = -theta / ||theta||, 0 at theta == 0.
      const float nsq = oco::warp_dot<kWideLine>(
          line, n, lane, [&](int j) { return th[j] * th[j]; });
      const float scale = nsq > 0.0f ? -(1.0f / oco::osqrt(nsq)) : 0.0f;
      q = oco::warp_dot<kWideLine>(
          line, n, lane, [&](int j) { return z_of(j) * (scale * th[j]); });
    }
    // hinge_step, then update.
    const float diff = q - yt;
    cum = cum + 0.5f * oco::oabs(diff);
    const float g = oco::half_sign(diff);
    for (int j = lane; j < n; j += 32) {
      const float zj = z_of(j);
      th[j] = th[j] + g * zj;
      w[j] = w[j] + yt * zj;
    }
    __syncwarp();
  }
  // identity_comparator: x_c = ftl_action(theta), 0.5 (T - <x_c, w>).
  const float nsq = oco::warp_dot<kWideLine>(
      line, n, lane, [&](int j) { return th[j] * th[j]; });
  const float scale = nsq > 0.0f ? -(1.0f / oco::osqrt(nsq)) : 0.0f;
  const float xw = oco::warp_dot<kWideLine>(
      line, n, lane, [&](int j) { return (scale * th[j]) * w[j]; });
  if (lane == 0)
    out[b] = cum - 0.5f * (static_cast<float>(T) - xw);
}

// K7w's plan at d: theta and w in shared memory up to max_shared_d(), and
// the warps a block that keep the most warps resident an SM
// (oco::best_block).
template <bool FTRL>
int wide_plan(int d, oco::WarpPlan* p) {
  if (d <= OCO_LARGE_D) return cudaErrorInvalidValue;
  p->shared = d <= max_shared_d();
  p->state = p->shared ? 0 : state_floats(d);
  const auto kernel = p->shared ? &synthetic_wide_kernel<FTRL, true>
                                : &synthetic_wide_kernel<FTRL, false>;
  return oco::best_block(kernel, kWideWarps, warp_floats(d, p->shared) * 4,
                         p);
}

template <bool FTRL>
int launch_wide(const oco::PhiloxKeys& keys, float eta, unsigned int T,
                long long B, int d, float c, float* out, float* state,
                cudaStream_t s) {
  oco::WarpPlan p{};
  const int err = wide_plan<FTRL>(d, &p);
  if (err != cudaSuccess) return err;
  if (!p.shared && state == nullptr) return cudaErrorInvalidValue;
  const long long grid = (B + p.warps - 1) / p.warps;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto g = static_cast<unsigned int>(grid);
  return p.shared
             ? oco::launch_with_smem(synthetic_wide_kernel<FTRL, true>, g,
                                     p.warps * 32, p.smem, s, keys, eta, T,
                                     B, d, c, out, state)
             : oco::launch_with_smem(synthetic_wide_kernel<FTRL, false>, g,
                                     p.warps * 32, p.smem, s, keys, eta, T,
                                     B, d, c, out, state);
}

template <bool FTRL>
int launch(const oco::PhiloxKeys& keys, float eta, unsigned int T,
           long long B, int d, float c, float* out, float* state,
           cudaStream_t s) {
  const unsigned int grid = oco::grid_for(B);
  int err = cudaSuccess;
  const int launched = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if constexpr (D == oco::kWideD)
      err = launch_wide<FTRL>(keys, eta, T, B, d, c, out, state, s);
    else
      synthetic_kernel<D, FTRL><<<grid, OCO_THREADS, 0, s>>>(keys, eta, T, B,
                                                            d, c, out);
  });
  return err != cudaSuccess ? err : launched;
}

template <bool FTRL>
int occupancy(int d, int* out) {
  int err = cudaSuccess;
  const int checked = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if constexpr (D == oco::kWideD) {
      oco::WarpPlan p{};
      err = wide_plan<FTRL>(d, &p);
      const auto kernel = p.shared ? &synthetic_wide_kernel<FTRL, true>
                                   : &synthetic_wide_kernel<FTRL, false>;
      if (err == cudaSuccess)
        err = oco::occupancy(kernel, p.warps * 32, p.smem, out);
      if (err == cudaSuccess) err = oco::local_bytes(kernel, out + 2, p.smem);
    } else {
      err = oco::occupancy(synthetic_kernel<D, FTRL>, OCO_THREADS, 0, out);
      if (err == cudaSuccess)
        err = oco::local_bytes(synthetic_kernel<D, FTRL>, out + 2);
    }
  });
  return err != cudaSuccess ? err : checked;
}

}  // namespace

// keys: the 20 round keys of the 64-bit seed, k0[0..9] then k1[0..9]
// (ops/philox.py round_keys); eta: the FTRL step scale (float); T rounds
// (1 <= T < 2^32); B = 8 * lane_batch sequences; any d >= 1; alg_flag 0 =
// FTRL, 1 = FTL; c = (float)(1 / sqrt(d)).  Output: regrets (B,) float32,
// sequence b at index b.  state: where oco_synthetic_plan asks for one (d
// past its max_shared_d), a scratch buffer of `state` * B float32
// (ops/game.py::wide_state_elems), else unused (may be null).  Returns the
// cudaError_t of the launch.
extern "C" int oco_synthetic_regrets_f32(const unsigned int* keys, float eta,
                                         long long T, long long B, int d,
                                         int alg_flag, float c, void* out,
                                         void* state, void* stream) {
  if (B < 1 || T < 1 || T > 0xFFFFFFFFLL || B > 0xFFFFFFFFLL)
    return cudaErrorInvalidValue;
  oco::PhiloxKeys k;
  for (int i = 0; i < 10; ++i) {
    k.k0[i] = keys[i];
    k.k1[i] = keys[10 + i];
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<float*>(out);
  auto* st = static_cast<float*>(state);
  const auto uT = static_cast<unsigned int>(T);
  return alg_flag == 0 ? launch<true>(k, eta, uT, B, d, c, op, st, s)
                       : launch<false>(k, eta, uT, B, d, c, op, st, s);
}

// Registers a thread (out[0]), resident warps an SM (out[1]), bytes of a
// thread's local frame (out[2]) and of a block's shared memory (out[3]) of
// a launch at feature dimension d on the current card; alg_flag 0 for the
// FTRL instance, 1 for FTL.  Returns the cudaError_t.
extern "C" int oco_synthetic_occupancy(int alg_flag, int d, int* out) {
  return alg_flag == 0 ? occupancy<true>(d, out) : occupancy<false>(d, out);
}

// K7w's plan at d > 512 (alg_flag 0 FTRL, 1 FTL) on the current card:
// warps a block (out[0]), bytes of dynamic shared memory a block (out[1]),
// 1 if theta and w lie in shared memory (out[2]), floats of the state
// buffer a sequence, 0 where shared (out[3]), and the largest d whose
// lines fit shared memory (out[4]).  Returns the cudaError_t
// (cudaErrorInvalidValue for d <= 512).
extern "C" int oco_synthetic_plan(int alg_flag, int d, long long* out) {
  oco::WarpPlan p{};
  const int err = alg_flag == 0 ? wide_plan<true>(d, &p)
                                : wide_plan<false>(d, &p);
  out[0] = p.warps;
  out[1] = p.smem;
  out[2] = p.shared ? 1 : 0;
  out[3] = p.state;
  out[4] = max_shared_d();
  return err;
}
