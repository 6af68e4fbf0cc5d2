// K6: the SMART regret and switch round of every (sequence, threshold)
// pair in one launch.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_smart.py
// _smart_sweep_kernel, entry smart_sweep_packed.  Python wrapper and plain
// PyTorch version: online_convex_optimization_tpu_torch/ops/smart.py
// (smart_sweep, smart_sweep_reference).
//
// One thread per (sequence b, threshold g), with a scalar eta, state in
// registers, a loop over the sequence's own rounds.  The round step is K2's
// (oco::smart_round), so column g equals K2 run on the same sequences with
// threshold = thresholds[g], bit for bit, and the switch test keeps K2's
// form F - L >= threshold, which is exact at the ties the z = e1 families
// reach (the TPU kernel compares the un-halved lead with 2*threshold).
// The final comparator is scored by the identity on contract data and by a
// replay of the thread's own rows otherwise; the wrapper chooses.
//
// What bounds it on an H100: every threshold re-reads the sequence's rows,
// 8*(d+1) bytes of f64 per round, against K2's serial chain (two actions
// with their sqrt and divide, up to three dot products and two updates per
// round).  The design duplicates no data: block k serves threshold k % G
// of sequence block k / G, so the G blocks that read one block of
// sequences are launched together and find its rows in L2.
#include "oco_common.cuh"

namespace {

template <typename S, int D>
__global__ void __launch_bounds__(OCO_THREADS)
smart_sweep_kernel(const S* __restrict__ z, const S* __restrict__ y,
                   const S* __restrict__ thresholds,
                   const int* __restrict__ lengths, long long B, long long G,
                   long long T, int d, S eta, int replay,
                   S* __restrict__ regret, long long* __restrict__ switch_t) {
  constexpr int C = oco::Cap<D>::value;
  long long b, g;
  oco::sweep_coords(G, &b, &g);
  if (b >= B) return;
  const int n = D > 0 ? D : d;
  const int len = lengths[b];
  const S thresh = thresholds[g];

  oco::SmartState<S, D> st;
  oco::smart_begin<S, D>(st, n, T);
  S x[C], zr[C];
  for (int t = 0; t < len; ++t) {
    oco::load_row<S, D>(z, t, b, B, n, zr);
    oco::smart_round<S, D>(st, zr, y[t * B + b], t, n, thresh, eta);
  }
  S comp = oco::identity_comparator<S, D>(st.th, st.w, x, n, st.cnt);
  if (replay) comp = oco::replay_comparator<S, D>(z, y, b, B, n, len, x);
  regret[g * B + b] = st.total - comp;
  switch_t[g * B + b] = st.tau;
}

template <typename S>
int launch(const void* z, const void* y, const void* thresholds,
           const void* lengths, long long B, long long G, long long T, int d,
           double eta, int replay, void* regret, void* switch_t,
           void* stream) {
  if (B < 1 || G < 1) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(oco::grid_for(B)) * G;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned int>(blocks);
  const auto* zp = static_cast<const S*>(z);
  const auto* yp = static_cast<const S*>(y);
  const auto* hp = static_cast<const S*>(thresholds);
  const auto* lp = static_cast<const int*>(lengths);
  auto* rp = static_cast<S*>(regret);
  auto* tp = static_cast<long long*>(switch_t);
  const S eta_s = static_cast<S>(eta);
  return oco::launch_for_d(d, [&](auto dc) {
    smart_sweep_kernel<S, decltype(dc)::value><<<grid, OCO_THREADS, 0, s>>>(
        zp, yp, hp, lp, B, G, T, d, eta_s, replay, rp, tp);
  });
}

}  // namespace

// Inputs: z (T, d, B) and y (T, B) time-major, thresholds (G,), lengths
// (B,) int32 with 0 <= len <= T, eta the FTRL step scale (rounded to the
// working type).  Outputs: regret (G, B), switch_t (G, B) int64.  Returns
// the cudaError_t of the launch.
extern "C" int oco_smart_sweep_f64(const void* z, const void* y,
                                   const void* thresholds, const void* lengths,
                                   long long B, long long G, long long T,
                                   int d, double eta, int replay,
                                   void* regret, void* switch_t,
                                   void* stream) {
  return launch<double>(z, y, thresholds, lengths, B, G, T, d, eta, replay,
                        regret, switch_t, stream);
}

extern "C" int oco_smart_sweep_f32(const void* z, const void* y,
                                   const void* thresholds, const void* lengths,
                                   long long B, long long G, long long T,
                                   int d, double eta, int replay,
                                   void* regret, void* switch_t,
                                   void* stream) {
  return launch<float>(z, y, thresholds, lengths, B, G, T, d, eta, replay,
                       regret, switch_t, stream);
}
