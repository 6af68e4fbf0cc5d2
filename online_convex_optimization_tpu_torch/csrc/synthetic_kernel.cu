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
#include "oco_common.cuh"
#include "oco_philox.cuh"

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
      oco::play_action<float, D>(th, w, x, zr, yt, n, cum);
    }
  }
  if (live)
    out[b] = cum - oco::identity_comparator<float, D>(
                       th, w, x, n, static_cast<float>(T));
}

template <bool FTRL>
int launch(const oco::PhiloxKeys& keys, float eta, unsigned int T,
           long long B, int d, float c, float* out, cudaStream_t s) {
  const unsigned int grid = oco::grid_for(B);
  return oco::launch_for_d(d, [&](auto dc) {
    synthetic_kernel<decltype(dc)::value, FTRL><<<grid, OCO_THREADS, 0, s>>>(
        keys, eta, T, B, d, c, out);
  });
}

}  // namespace

// keys: the 20 round keys of the 64-bit seed, k0[0..9] then k1[0..9]
// (ops/philox.py round_keys); eta: the FTRL step scale (float); T rounds
// (1 <= T < 2^32); B = 8 * lane_batch sequences; alg_flag 0 = FTRL, 1 =
// FTL; c = (float)(1 / sqrt(d)).  Output: regrets (B,) float32, sequence b
// at index b.  Returns the cudaError_t of the launch.
extern "C" int oco_synthetic_regrets_f32(const unsigned int* keys, float eta,
                                         long long T, long long B, int d,
                                         int alg_flag, float c, void* out,
                                         void* stream) {
  if (B < 1 || T < 1 || T > 0xFFFFFFFFLL || B > 0xFFFFFFFFLL)
    return cudaErrorInvalidValue;
  oco::PhiloxKeys k;
  for (int i = 0; i < 10; ++i) {
    k.k0[i] = keys[i];
    k.k1[i] = keys[10 + i];
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<float*>(out);
  const auto uT = static_cast<unsigned int>(T);
  return alg_flag == 0 ? launch<true>(k, eta, uT, B, d, c, op, s)
                       : launch<false>(k, eta, uT, B, d, c, op, s);
}
