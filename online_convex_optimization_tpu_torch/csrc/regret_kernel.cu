// K1: the FTRL/FTL regret game and its final-FTL comparator in one pass.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_game.py
// _regret_kernel (and its VMEM-state twin _regret_kernel_dloop), entry
// regrets_fused.  Python wrapper and plain PyTorch version:
// online_convex_optimization_tpu_torch/ops/game.py.
//
// One thread per sequence, state in registers, a loop over the sequence's
// own rounds (it stops at its own length, so ragged horizons and mixed
// FTRL/FTL flags share one launch).  Per round (oco::game_round, shared
// with K4 and K5): the action (FTRL with the ball projection, or FTL),
// q = <z_t, x>, the hinge loss, the tie-exact subgradient update, and the
// identity statistic w += y_t z_t.  The final
// comparator is the final FTL action x_c scored by the hinge identity
// comp = 0.5 * (len - <x_c, w>), exact when every row has ||z_t|| <= 1 and
// y_t = +-1; for other data the wrapper picks the replay mode, which scores
// x_c by a second loop over the thread's own rows.
//
// What bounds it on an H100: each round reads 8*(d+1) bytes of f64 input
// once (48 bytes at d = 5) against a serial dependency chain of about
// 3d + 10 flops through the action, the dot product and the update, plus a
// correctly rounded sqrt and divide.  Per thread the chain is latency-bound;
// the card as a whole is bound by how many independent sequences are in
// flight.  This first design leaves the dependency chain as the reference
// writes it (the f64 instance must reproduce its rounding) and relies on
// one thread per sequence with coalesced time-major loads (T, d, B) to keep
// many chains in flight; it does not stage tiles in shared memory.
#include "oco_common.cuh"

namespace {

template <typename S, int D>
__global__ void __launch_bounds__(OCO_THREADS)
regret_kernel(const S* __restrict__ z, const S* __restrict__ y,
              const int* __restrict__ alg_flag, const S* __restrict__ eta,
              const int* __restrict__ lengths, long long B, int d, int replay,
              S* __restrict__ cum_out, S* __restrict__ comp_out,
              S* __restrict__ x_last) {
  constexpr int C = oco::Cap<D>::value;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  const int n = D > 0 ? D : d;
  const int len = lengths[b];
  const bool ftrl = alg_flag[b] == 0;
  const S eta_b = eta[b];

  S th[C], w[C], x[C], xl[C], zr[C];
#pragma unroll
  for (int j = 0; j < n; ++j) th[j] = w[j] = xl[j] = S(0);
  S cum = S(0);

  for (int t = 0; t < len; ++t) {
    oco::load_row<S, D>(z, t, b, B, n, zr);
    oco::game_round<S, D>(th, w, x, zr, y[t * B + b], ftrl, eta_b, S(t + 1),
                          n, cum);
#pragma unroll
    for (int j = 0; j < n; ++j) xl[j] = x[j];
  }

  // Comparator: the final FTL action, by the identity or by a replay.
  S comp = oco::identity_comparator<S, D>(th, w, x, n, S(len));
  if (replay) comp = oco::replay_comparator<S, D>(z, y, b, B, n, len, x);
  cum_out[b] = cum;
  comp_out[b] = comp;
#pragma unroll
  for (int j = 0; j < n; ++j) x_last[j * B + b] = xl[j];
}

template <typename S>
int launch(const void* z, const void* y, const void* alg_flag,
           const void* eta, const void* lengths, long long B, int d,
           int replay, void* cum, void* comp, void* x_last, void* stream) {
  if (B < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = oco::grid_for(B);
  const auto* zp = static_cast<const S*>(z);
  const auto* yp = static_cast<const S*>(y);
  const auto* fp = static_cast<const int*>(alg_flag);
  const auto* ep = static_cast<const S*>(eta);
  const auto* lp = static_cast<const int*>(lengths);
  auto* cp = static_cast<S*>(cum);
  auto* kp = static_cast<S*>(comp);
  auto* xp = static_cast<S*>(x_last);
  return oco::launch_for_d(d, [&](auto dc) {
    regret_kernel<S, decltype(dc)::value><<<grid, OCO_THREADS, 0, s>>>(
        zp, yp, fp, ep, lp, B, d, replay, cp, kp, xp);
  });
}

}  // namespace

// Inputs: z (T, d, B) and y (T, B) time-major, alg_flag (B,) int32
// (0 = FTRL, 1 = FTL), eta (B,), lengths (B,) int32 with 0 <= len <= T.
// Outputs: cum_loss (B,), comp_loss (B,), x_last (d, B).  Returns the
// cudaError_t of the launch.
extern "C" int oco_regrets_fused_f64(const void* z, const void* y,
                                     const void* alg_flag, const void* eta,
                                     const void* lengths, long long B, int d,
                                     int replay, void* cum, void* comp,
                                     void* x_last, void* stream) {
  return launch<double>(z, y, alg_flag, eta, lengths, B, d, replay, cum, comp,
                        x_last, stream);
}

extern "C" int oco_regrets_fused_f32(const void* z, const void* y,
                                     const void* alg_flag, const void* eta,
                                     const void* lengths, long long B, int d,
                                     int replay, void* cum, void* comp,
                                     void* x_last, void* stream) {
  return launch<float>(z, y, alg_flag, eta, lengths, B, d, replay, cum, comp,
                       x_last, stream);
}
