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
// in f32) once, against K1's serial chain of about 3d + 10 flops with a
// sqrt and divide.  Like K1 the chain is latency-bound per thread and the
// card is bound by the number of sequences in flight; the carry costs
// 8*(2d+2) bytes per sequence per launch, nothing next to a chunk of
// thousands of rounds.  The design keeps one thread per sequence with
// coalesced time-major (CT, d, B) loads.
#include "oco_common.cuh"

namespace {

template <typename S, int D>
__global__ void __launch_bounds__(OCO_THREADS)
stream_kernel(const S* __restrict__ z, const S* __restrict__ y,
              const int* __restrict__ alg_flag, const S* __restrict__ eta,
              long long t0, long long CT, long long B, int d,
              const S* __restrict__ th_in, const S* __restrict__ w_in,
              const S* __restrict__ cum_in, const S* __restrict__ cnt_in,
              S* __restrict__ th_out, S* __restrict__ w_out,
              S* __restrict__ cum_out, S* __restrict__ cnt_out) {
  constexpr int C = oco::Cap<D>::value;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
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
  for (long long k = 0; k < CT; ++k) {
    oco::load_row<S, D>(z, k, b, B, n, zr);
    const S yt = y[k * B + b];
    oco::game_round<S, D>(th, w, x, zr, yt, ftrl, eta_b, S(t0 + k + 1), n,
                          cum);
    cnt = cnt + yt * yt;
  }
#pragma unroll
  for (int j = 0; j < n; ++j) {
    th_out[j * B + b] = th[j];
    w_out[j * B + b] = w[j];
  }
  cum_out[b] = cum;
  cnt_out[b] = cnt;
}

template <typename S>
int launch(const void* z, const void* y, const void* alg_flag,
           const void* eta, long long t0, long long CT, long long B, int d,
           const void* th_in, const void* w_in, const void* cum_in,
           const void* cnt_in, void* th_out, void* w_out, void* cum_out,
           void* cnt_out, void* stream) {
  if (B < 1 || CT < 0 || t0 < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = oco::grid_for(B);
  const auto* zp = static_cast<const S*>(z);
  const auto* yp = static_cast<const S*>(y);
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
  return oco::launch_for_d(d, [&](auto dc) {
    stream_kernel<S, decltype(dc)::value><<<grid, OCO_THREADS, 0, s>>>(
        zp, yp, fp, ep, t0, CT, B, d, ti, wi, ci, ni, to, wo, co, no);
  });
}

}  // namespace

// Inputs: z (CT, d, B) and y (CT, B) time-major, alg_flag (B,) int32
// (0 = FTRL, 1 = FTL), eta (B,), t0 >= 0 the rounds already played, and
// the carry theta (d, B), w (d, B), cum (B,), cnt (B,).  Outputs: the
// advanced carry in separate buffers (no aliasing with the inputs).
// Returns the cudaError_t of the launch.
extern "C" int oco_play_stream_f64(const void* z, const void* y,
                                   const void* alg_flag, const void* eta,
                                   long long t0, long long CT, long long B,
                                   int d, const void* th_in, const void* w_in,
                                   const void* cum_in, const void* cnt_in,
                                   void* th_out, void* w_out, void* cum_out,
                                   void* cnt_out, void* stream) {
  return launch<double>(z, y, alg_flag, eta, t0, CT, B, d, th_in, w_in,
                        cum_in, cnt_in, th_out, w_out, cum_out, cnt_out,
                        stream);
}

extern "C" int oco_play_stream_f32(const void* z, const void* y,
                                   const void* alg_flag, const void* eta,
                                   long long t0, long long CT, long long B,
                                   int d, const void* th_in, const void* w_in,
                                   const void* cum_in, const void* cnt_in,
                                   void* th_out, void* w_out, void* cum_out,
                                   void* cnt_out, void* stream) {
  return launch<float>(z, y, alg_flag, eta, t0, CT, B, d, th_in, w_in,
                       cum_in, cnt_in, th_out, w_out, cum_out, cnt_out,
                       stream);
}
