// K2: the whole single-switch SMART algorithm in one pass.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_smart.py
// _smart_kernel (round step _smart_round), entry smart_regrets_packed.
// Python wrapper and plain PyTorch version:
// online_convex_optimization_tpu_torch/ops/smart.py.
//
// One thread per sequence, state in registers, a loop over the sequence's
// own rounds.  The round step is oco::smart_round (oco_common.cuh, shared
// with the threshold sweep K6; models/smart.py semantics):
//   1. the always-on FTL track plays its pre-update action and updates;
//      F accumulates its losses, (w, cnt) the identity statistics;
//   2. once switched (the round AFTER the test first passed), a fresh FTRL
//      track plays with the GLOBAL round index t+1 and its losses count;
//      before that the FTL loss counts;
//   3. before the switch, the post-update FTL action s is scored on the
//      prefix by the hinge identity L = 0.5 * (cnt - <s, w>), and the switch
//      fires at the first round with F - L >= threshold; tau is that round,
//      T when it never fires.
// The switch test always uses the identity statistics, as the scan does.
// The final comparator (the final FTL action) is scored by the identity on
// contract data (||z_t|| <= 1, y_t = +-1) and by a replay of the thread's own
// rows otherwise; the wrapper chooses before the launch.
//
// What bounds it on an H100: 8*(d+1) bytes of f64 input per round, read
// once, against a serial chain of about 3d + 10 flops per track per round
// (two actions with their sqrt and divide, two dot products, the identity
// dot and two updates).  As for K1 the chain is latency-bound per thread and
// the card is bound by the number of sequences in flight; this first design
// keeps the reference's order of operations and relies on one thread per
// sequence with coalesced time-major loads.
#include "oco_common.cuh"

namespace {

template <typename S, int D>
__global__ void __launch_bounds__(OCO_THREADS)
smart_kernel(const S* __restrict__ z, const S* __restrict__ y,
             const S* __restrict__ threshold, const S* __restrict__ eta,
             const int* __restrict__ lengths, long long B, long long T, int d,
             int replay, S* __restrict__ cum_out, S* __restrict__ comp_out,
             S* __restrict__ x_last, long long* __restrict__ switch_t) {
  constexpr int C = oco::Cap<D>::value;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  const int n = D > 0 ? D : d;
  const int len = lengths[b];
  const S thr_b = threshold[b];
  const S eta_b = eta[b];

  oco::SmartState<S, D> st;
  oco::smart_begin<S, D>(st, n, T);
  S x[C], zr[C];
  for (int t = 0; t < len; ++t) {
    oco::load_row<S, D>(z, t, b, B, n, zr);
    oco::smart_round<S, D>(st, zr, y[t * B + b], t, n, thr_b, eta_b);
  }

  // Comparator: the final FTL action, by the identity or by a replay.
  S comp = oco::identity_comparator<S, D>(st.th, st.w, x, n, st.cnt);
  if (replay) comp = oco::replay_comparator<S, D>(z, y, b, B, n, len, x);
  cum_out[b] = st.total;
  comp_out[b] = comp;
  switch_t[b] = st.tau;
  // x_last: the FTRL track's last action once switched (zero if it never
  // played), the final FTL action otherwise (models/smart.py).
#pragma unroll
  for (int j = 0; j < n; ++j) x_last[j * B + b] = st.switched ? st.xr[j] : x[j];
}

template <typename S>
int launch(const void* z, const void* y, const void* threshold,
           const void* eta, const void* lengths, long long B, long long T,
           int d, int replay, void* cum, void* comp, void* x_last,
           void* switch_t, void* stream) {
  if (B < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = oco::grid_for(B);
  const auto* zp = static_cast<const S*>(z);
  const auto* yp = static_cast<const S*>(y);
  const auto* hp = static_cast<const S*>(threshold);
  const auto* ep = static_cast<const S*>(eta);
  const auto* lp = static_cast<const int*>(lengths);
  auto* cp = static_cast<S*>(cum);
  auto* kp = static_cast<S*>(comp);
  auto* xp = static_cast<S*>(x_last);
  auto* tp = static_cast<long long*>(switch_t);
  return oco::launch_for_d(d, [&](auto dc) {
    smart_kernel<S, decltype(dc)::value><<<grid, OCO_THREADS, 0, s>>>(
        zp, yp, hp, ep, lp, B, T, d, replay, cp, kp, xp, tp);
  });
}

}  // namespace

// Inputs: z (T, d, B) and y (T, B) time-major, threshold (B,), eta (B,),
// lengths (B,) int32 with 0 <= len <= T.  Outputs: cum_loss (B,),
// comp_loss (B,), x_last (d, B), switch_t (B,) int64.  Returns the
// cudaError_t of the launch.
extern "C" int oco_smart_regrets_f64(const void* z, const void* y,
                                     const void* threshold, const void* eta,
                                     const void* lengths, long long B,
                                     long long T, int d, int replay,
                                     void* cum, void* comp, void* x_last,
                                     void* switch_t, void* stream) {
  return launch<double>(z, y, threshold, eta, lengths, B, T, d, replay, cum,
                        comp, x_last, switch_t, stream);
}

extern "C" int oco_smart_regrets_f32(const void* z, const void* y,
                                     const void* threshold, const void* eta,
                                     const void* lengths, long long B,
                                     long long T, int d, int replay,
                                     void* cum, void* comp, void* x_last,
                                     void* switch_t, void* stream) {
  return launch<float>(z, y, threshold, eta, lengths, B, T, d, replay, cum,
                       comp, x_last, switch_t, stream);
}
