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
// Past d = 512 (K7w, the wide instance, D == oco::kWideD) a thread keeps no
// vector in its frame: theta, w and x are vectors 0, 1 and 2 of slot b of
// the caller's state buffer, laid out (d, B) (oco::state_vec), and the row
// is drawn where the helpers read it (PhiloxRow: element j from call
// j / 128 of the round's counter, the last call's words kept in the
// thread's frame, so a pass over the row in index order makes each call
// once: two passes a round, the hinge step's and the update's, and one
// call for the label).  The same bits, the same round in the same order:
// K7w on a seed equals its plain version bit for bit at any d.
#include "oco_philox.cuh"
#include "oco_tiles.cuh"

// Rounds of FTRL scales a block holds in shared memory at a time.
#define OCO_SCALE_CHUNK 1024

namespace {

// Row t of sequence b, element j = +-c by bit j of the round's stream,
// drawn on read.  The helpers take their vectors by value and read them
// in index order, so each copy keeps the words of its last call.
struct PhiloxRow {
  const oco::PhiloxKeys& keys;
  unsigned int t, b;
  float c;
  mutable oco::Philox4 words;
  mutable int call;
  __device__ __forceinline__ float operator[](int j) const {
    if ((j >> 7) != call) {
      call = j >> 7;
      words = oco::philox4x32_10(t, b, static_cast<unsigned int>(call), 0u,
                                 keys);
    }
    return oco::philox_bit(words, j & 127) ? c : -c;
  }
};

template <int D, bool FTRL>
__global__ void __launch_bounds__(OCO_THREADS)
synthetic_kernel(oco::PhiloxKeys keys, float eta, unsigned int T,
                 long long B, int d, float c, float* __restrict__ out,
                 float* state) {
  constexpr int C = oco::Cap<D>::value;
  __shared__ float scale[FTRL ? OCO_SCALE_CHUNK : 1];
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  // A thread past B still takes part in the block's barriers.
  const bool live = b < B;
  const int n = D > 0 ? D : d;
  const unsigned int ub = static_cast<unsigned int>(b);

  // The thread's vectors: arrays, or (wide) its slot of the state buffer.
  float th_a[C], w_a[C], x_a[C], zr[C];
  const long long own = live ? b : 0;
  const auto th = oco::state_vec<D>(th_a, state, 0, own, B, n);
  const auto w = oco::state_vec<D>(w_a, state, 1, own, B, n);
  const auto x = oco::state_vec<D>(x_a, state, 2, own, B, n);
  if (D != oco::kWideD || live) {
#pragma unroll
    for (int j = 0; j < n; ++j) th[j] = w[j] = 0.0f;
  }
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
      const auto round = [&](auto row, float yt) {
        if constexpr (FTRL)
          oco::ftrl_action_scaled<float, D>(th, x, n, scale[k]);
        else
          oco::ftl_action<float, D>(th, x, n);
        oco::play_action<float, D>(th, w, x, row, yt, n, cum);
      };
      if constexpr (D == oco::kWideD) {
        const oco::Philox4 r =
            oco::philox4x32_10(ut, ub, static_cast<unsigned int>(n >> 7), 0u,
                               keys);
        round(PhiloxRow{keys, ut, ub, c, {}, -1},
              oco::philox_bit(r, n & 127) ? 1.0f : -1.0f);
      } else {
        oco::Philox4 r = oco::philox4x32_10(ut, ub, 0u, 0u, keys);
#pragma unroll
        for (int j = 0; j < n; ++j) {
          if (j > 0 && (j & 127) == 0)
            r = oco::philox4x32_10(ut, ub, j >> 7, 0u, keys);
          zr[j] = oco::philox_bit(r, j & 127) ? c : -c;
        }
        if ((n & 127) == 0) r = oco::philox4x32_10(ut, ub, n >> 7, 0u, keys);
        round(static_cast<const float*>(zr),
              oco::philox_bit(r, n & 127) ? 1.0f : -1.0f);
      }
    }
  }
  if (live)
    out[b] = cum - oco::identity_comparator<float, D>(
                       th, w, x, n, static_cast<float>(T));
}

template <bool FTRL>
int launch(const oco::PhiloxKeys& keys, float eta, unsigned int T,
           long long B, int d, float c, float* out, float* state,
           cudaStream_t s) {
  const unsigned int grid = oco::grid_for(B);
  return oco::launch_for_any_d(d, [&](auto dc) {
    synthetic_kernel<decltype(dc)::value, FTRL><<<grid, OCO_THREADS, 0, s>>>(
        keys, eta, T, B, d, c, out, state);
  });
}

template <bool FTRL>
int occupancy(int d, int* out) {
  int err = cudaSuccess;
  const int checked = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    err = oco::occupancy(synthetic_kernel<D, FTRL>, OCO_THREADS, 0, out);
    if (err == cudaSuccess)
      err = oco::local_bytes(synthetic_kernel<D, FTRL>, out + 2);
  });
  return err != cudaSuccess ? err : checked;
}

}  // namespace

// keys: the 20 round keys of the 64-bit seed, k0[0..9] then k1[0..9]
// (ops/philox.py round_keys); eta: the FTRL step scale (float); T rounds
// (1 <= T < 2^32); B = 8 * lane_batch sequences; any d >= 1; alg_flag 0 =
// FTRL, 1 = FTL; c = (float)(1 / sqrt(d)).  Output: regrets (B,) float32,
// sequence b at index b.  state: past d = 512 a scratch buffer of 3 * d *
// B float32 (ops/game.py::wide_state_elems), else unused (may be null).
// Returns the cudaError_t of the launch.
extern "C" int oco_synthetic_regrets_f32(const unsigned int* keys, float eta,
                                         long long T, long long B, int d,
                                         int alg_flag, float c, void* out,
                                         void* state, void* stream) {
  if (B < 1 || T < 1 || T > 0xFFFFFFFFLL || B > 0xFFFFFFFFLL)
    return cudaErrorInvalidValue;
  if (d > OCO_LARGE_D && state == nullptr) return cudaErrorInvalidValue;
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

// Registers a thread (out[0]), resident warps an SM (out[1]) and bytes of
// a thread's local frame (out[2]) of a launch at feature dimension d on
// the current card; alg_flag 0 for the FTRL instance, 1 for FTL.  Returns
// the cudaError_t.
extern "C" int oco_synthetic_occupancy(int alg_flag, int d, int* out) {
  return alg_flag == 0 ? occupancy<true>(d, out) : occupancy<false>(d, out);
}
