// K5: the FTRL regret of every (sequence, eta setting) pair in one launch.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_game.py
// _sweep_kernel, entry eta_sweep_packed.  Python wrapper and plain PyTorch
// version: online_convex_optimization_tpu_torch/ops/game.py (eta_sweep,
// eta_sweep_reference).
//
// One thread per (sequence b, setting e), state in registers, a loop over
// the sequence's own rounds: the per-round step is K1's (oco::game_round),
// in K1's order of operations (a true divide by a correctly rounded sqrt,
// project iff ||x||^2 > 1), not the TPU kernel's folded
// (eta*scaleh)*rsqrt(max(eta^2*s2*||theta2||^2, 1)).  So column e of the
// sweep equals K1 run on the same sequences with eta = eta_grid[e], bit for
// bit.  The comparator is the final FTL action scored by the hinge identity
// on contract data and by a replay of the thread's own rows otherwise; the
// wrapper chooses before the launch.
//
// What bounds it on an H100: every setting re-reads the sequence's rows,
// 8*(d+1) bytes of f64 per round (E = 64 settings of 32,768 sequences at
// T = 1,024 stream z 64 times: 43 GB in f64), against K1's serial chain of
// about 3d + 10 flops and a sqrt and divide per round.  The design
// duplicates no data: block k serves setting k % E of sequence block
// k / E, so the E blocks that read one block of sequences are launched
// together and find its rows in the 50 MB L2 rather than in HBM.
#include "oco_common.cuh"

namespace {

template <typename S, int D>
__global__ void __launch_bounds__(OCO_THREADS)
sweep_kernel(const S* __restrict__ z, const S* __restrict__ y,
             const S* __restrict__ eta_grid, const int* __restrict__ lengths,
             long long B, long long E, int d, int replay,
             S* __restrict__ regret) {
  constexpr int C = oco::Cap<D>::value;
  long long b, e;
  oco::sweep_coords(E, &b, &e);
  if (b >= B) return;
  const int n = D > 0 ? D : d;
  const int len = lengths[b];
  const S eta = eta_grid[e];

  S th[C], w[C], x[C], zr[C];
#pragma unroll
  for (int j = 0; j < n; ++j) th[j] = w[j] = S(0);
  S cum = S(0);
  for (int t = 0; t < len; ++t) {
    oco::load_row<S, D>(z, t, b, B, n, zr);
    oco::game_round<S, D>(th, w, x, zr, y[t * B + b], true, eta, S(t + 1),
                          n, cum);
  }
  S comp = oco::identity_comparator<S, D>(th, w, x, n, S(len));
  if (replay) comp = oco::replay_comparator<S, D>(z, y, b, B, n, len, x);
  regret[e * B + b] = cum - comp;
}

template <typename S>
int launch(const void* z, const void* y, const void* eta_grid,
           const void* lengths, long long B, long long E, int d, int replay,
           void* regret, void* stream) {
  if (B < 1 || E < 1) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(oco::grid_for(B)) * E;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned int>(blocks);
  const auto* zp = static_cast<const S*>(z);
  const auto* yp = static_cast<const S*>(y);
  const auto* ep = static_cast<const S*>(eta_grid);
  const auto* lp = static_cast<const int*>(lengths);
  auto* rp = static_cast<S*>(regret);
  return oco::launch_for_d(d, [&](auto dc) {
    sweep_kernel<S, decltype(dc)::value><<<grid, OCO_THREADS, 0, s>>>(
        zp, yp, ep, lp, B, E, d, replay, rp);
  });
}

}  // namespace

// Inputs: z (T, d, B) and y (T, B) time-major, eta_grid (E,), lengths (B,)
// int32 with 0 <= len <= T.  Output: regret (E, B).  Returns the
// cudaError_t of the launch.
extern "C" int oco_eta_sweep_f64(const void* z, const void* y,
                                 const void* eta_grid, const void* lengths,
                                 long long B, long long E, int d, int replay,
                                 void* regret, void* stream) {
  return launch<double>(z, y, eta_grid, lengths, B, E, d, replay, regret,
                        stream);
}

extern "C" int oco_eta_sweep_f32(const void* z, const void* y,
                                 const void* eta_grid, const void* lengths,
                                 long long B, long long E, int d, int replay,
                                 void* regret, void* stream) {
  return launch<float>(z, y, eta_grid, lengths, B, E, d, replay, regret,
                       stream);
}
