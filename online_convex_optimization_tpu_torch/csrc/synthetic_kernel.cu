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
// round is K1's (oco::game_round, with the FTRL scale -eta / sqrt(t + 1)
// correctly rounded, not the TPU kernel's rsqrt), and the comparator is the
// final FTL action scored by the hinge identity 0.5 * (T - <x_c, w>): the
// labels are +-1 and every row has norm ~1 (within an ulp), so cnt = T.  So
// K7 on a seed equals K1 on synthetic_stream's materialized rows of that
// seed, bit for bit.  The round index is 64-bit (as in K4); the counter
// word holds t < 2^32, which the wrapper checks.
//
// What bounds it on an H100: it reads nothing, so not bytes.  The key
// schedule is the seed's and of the counter only t changes, so a
// sequence-step needs at most 20 32 x 32-bit products (IMAD, on the FMA
// pipe beside the game's float operations) and 20 three-input xors (LOP3,
// on the integer ALU) a Philox call, and a shift and a select a bit.  One
// thread per sequence, state
// in registers for d = 5 (local memory for the runtime-d instances); no
// shared memory, no global traffic but the one (B,) store.  The TPU kernel
// fills a VMEM tile of bits per chunk; here every round is drawn where it is
// used, so nothing scales with T and T = 2^20 is one launch.
#include "oco_common.cuh"
#include "oco_philox.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(OCO_THREADS)
synthetic_kernel(unsigned long long seed, float eta, long long T, long long B,
                 int d, int ftrl, float c, float* __restrict__ out) {
  constexpr int C = oco::Cap<D>::value;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  const int n = D > 0 ? D : d;
  const unsigned int ub = static_cast<unsigned int>(b);

  float th[C], w[C], x[C], zr[C];
#pragma unroll
  for (int j = 0; j < n; ++j) th[j] = w[j] = 0.0f;
  float cum = 0.0f;

  for (long long t = 0; t < T; ++t) {
    const unsigned int ut = static_cast<unsigned int>(t);
    oco::Philox4 r = oco::philox4x32_10(ut, ub, 0u, 0u, seed);
#pragma unroll
    for (int j = 0; j < n; ++j) {
      if (j > 0 && (j & 127) == 0)
        r = oco::philox4x32_10(ut, ub, j >> 7, 0u, seed);
      zr[j] = oco::philox_bit(r, j & 127) ? c : -c;
    }
    if ((n & 127) == 0) r = oco::philox4x32_10(ut, ub, n >> 7, 0u, seed);
    const float yt = oco::philox_bit(r, n & 127) ? 1.0f : -1.0f;
    oco::game_round<float, D>(th, w, x, zr, yt, ftrl != 0, eta,
                              static_cast<float>(t + 1), n, cum);
  }
  out[b] = cum - oco::identity_comparator<float, D>(th, w, x, n,
                                                    static_cast<float>(T));
}

}  // namespace

// seed: the 64-bit Philox key; eta: the FTRL step scale (float); T rounds
// (1 <= T < 2^32); B = 8 * lane_batch sequences; alg_flag 0 = FTRL, 1 = FTL;
// c = (float)(1 / sqrt(d)).  Output: regrets (B,) float32, sequence b at
// index b.  Returns the cudaError_t of the launch.
extern "C" int oco_synthetic_regrets_f32(unsigned long long seed, float eta,
                                         long long T, long long B, int d,
                                         int alg_flag, float c, void* out,
                                         void* stream) {
  if (B < 1 || T < 1 || T > 0xFFFFFFFFLL || B > 0xFFFFFFFFLL)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = oco::grid_for(B);
  auto* op = static_cast<float*>(out);
  const int ftrl = alg_flag == 0;
  return oco::launch_for_d(d, [&](auto dc) {
    synthetic_kernel<decltype(dc)::value><<<grid, OCO_THREADS, 0, s>>>(
        seed, eta, T, B, d, ftrl, c, op);
  });
}
