// K3 and K3e: the hinge game on the packed API, cum and theta out, no
// comparator.
//
// Replaces the TPU kernels online_convex_optimization_tpu/ops/pallas_game.py
// _game_kernel (and its VMEM-state twin _game_kernel_dloop), entry
// play_packed, and _game_eta_kernel, entry play_packed_eta.  Python wrappers
// and plain PyTorch versions: online_convex_optimization_tpu_torch/ops/game.py
// (play_packed, play_packed_eta, play_packed_reference,
// play_packed_eta_reference).
//
// One thread per sequence, state in registers (in local memory for the
// runtime-d instances, see oco_common.cuh), a loop over all T rounds: zero
// rows are inert (the loss is 0.5*|0 - 0| and the update 0), so callers pad
// ragged horizons with them.  Each round plays K1's action and hinge step:
//   K3:  the action's scale is read from a (T,) table, scales[t]; FTL
//        (alg_flag 1) ignores it.  ftrl_scales builds the table in the
//        working type as -(eta / sqrt(t)), the expression K1 evaluates, so
//        K3 with that table gives K1's FTRL cum bit for bit.
//   K3e: FTRL with the sequence's own eta, scale -(eta_b / sqrt(t)) in K1's
//        rounding order (the TPU kernel's -eta * isqrt[t] rounds otherwise),
//        so it gives K1's cum with the same per-sequence eta bit for bit.
// The comparator is the caller's (ops/game.py replays the final FTL action
// in plain PyTorch, as the JAX package does in XLA), so neither kernel
// carries the identity statistic w.
//
// What bounds it on an H100: each round reads (d+1) values once (24 bytes
// in f32 at d = 5, plus 4 for the table entry, shared by the whole batch
// and served from L1/L2) against a serial chain of about 3d + 10 flops with
// a sqrt and a divide.  At the main path's B = 131,072 there are 1,024
// blocks of 128 threads, about 8 per SM, so many chains are in flight and
// the time approaches the bytes bound; the design relies on that and on
// coalesced time-major (T, d, B) loads, with no staging in shared memory.
//
// Past d = 512 (K3w and K3ew, the wide instances, D == oco::kWideD) a
// thread keeps no vector in its frame: theta is the output itself, column
// b of theta_out (d, B), zeroed first, and x is vector 0 of slot b of the
// caller's (d, B) state buffer (oco::state_vec); each row is read from the
// time-major input where it is used (an oco::Widened view, coalesced
// across the warp, as K4w reads it).  The same round in the same order:
// K3w and K3ew equal their plain versions bit for bit at any d.
#include "oco_tiles.cuh"

namespace {

template <typename Z, typename Y, int D, bool PER_SEQ_ETA,
          typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(OCO_THREADS)
game_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
            const S* __restrict__ scales, const S* __restrict__ eta,
            long long T, long long B, int d, int alg_flag,
            S* __restrict__ cum_out, S* __restrict__ theta_out, S* state) {
  constexpr int C = oco::Cap<D>::value;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  const int n = D > 0 ? D : d;
  const bool ftrl = PER_SEQ_ETA || alg_flag == 0;
  const S eta_b = PER_SEQ_ETA ? eta[b] : S(0);

  // The thread's vectors: arrays, or (wide) its column of the output theta
  // and its slot of the state buffer.
  S th_a[C], x_a[C], zr[C];
  const auto th = oco::state_vec<D>(th_a, theta_out, 0, b, B, n);
  const auto x = oco::state_vec<D>(x_a, state, 0, b, B, n);
#pragma unroll
  for (int j = 0; j < n; ++j) th[j] = S(0);
  S cum = S(0);
  for (long long t = 0; t < T; ++t) {
    const auto round = [&](auto row) {
      if (PER_SEQ_ETA)
        oco::ftrl_action<S, D>(th, x, n, eta_b, S(t + 1));
      else if (ftrl)
        oco::ftrl_action_scaled<S, D>(th, x, n, scales[t]);
      else
        oco::ftl_action<S, D>(th, x, n);
      const S g = oco::hinge_step<S, D>(
          x, row, S(oco::widen(y[t * B + b])), n, cum);
      oco::update<S, D>(th, nullptr, row, g, S(0), n);
    };
    if constexpr (D == oco::kWideD) {
      round(oco::Widened<S, Z>{z + t * n * B + b, B});
    } else {
      oco::load_row<S, D>(z, t, b, B, n, zr);
      round(static_cast<const S*>(zr));
    }
  }
  cum_out[b] = cum;
  if constexpr (D != oco::kWideD) {
#pragma unroll
    for (int j = 0; j < n; ++j) theta_out[j * B + b] = th[j];
  }
}

template <typename Z, typename Y, bool PER_SEQ_ETA>
int launch(const void* z, const void* y, const void* scales, const void* eta,
           long long T, long long B, int d, int alg_flag, void* cum,
           void* theta, void* state, void* stream) {
  using S = oco::compute_t<Z>;
  if (B < 1 || T < 0) return cudaErrorInvalidValue;
  if (d > OCO_LARGE_D && state == nullptr) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = oco::grid_for(B);
  const auto* zp = static_cast<const Z*>(z);
  const auto* yp = static_cast<const Y*>(y);
  const auto* sp = static_cast<const S*>(scales);
  const auto* ep = static_cast<const S*>(eta);
  auto* cp = static_cast<S*>(cum);
  auto* tp = static_cast<S*>(theta);
  auto* st = static_cast<S*>(state);
  return oco::launch_for_any_d(d, [&](auto dc) {
    game_kernel<Z, Y, decltype(dc)::value, PER_SEQ_ETA>
        <<<grid, OCO_THREADS, 0, s>>>(zp, yp, sp, ep, T, B, d, alg_flag, cp,
                                      tp, st);
  });
}

template <typename S>
int occupancy(int per_seq_eta, int d, int* out) {
  int err = cudaSuccess;
  const int checked = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const auto kernel = per_seq_eta ? game_kernel<S, S, D, true>
                                    : game_kernel<S, S, D, false>;
    err = oco::occupancy(kernel, OCO_THREADS, 0, out);
    if (err == cudaSuccess) err = oco::local_bytes(kernel, out + 2);
  });
  return err != cudaSuccess ? err : checked;
}

}  // namespace

// K3.  Inputs: z (T, d, B) and y (T, B) time-major in a storage pair of
// OCO_STORAGE_PAIRS (the suffix), scales (T,) the FTRL scale of each round
// in the compute type, alg_flag 0 (FTRL) or 1 (FTL) for the whole batch;
// any d >= 1.  Outputs, in the compute type: cum (B,), theta (d, B).
// state: past d = 512 a scratch buffer of d * B elements of the compute
// type (ops/game.py::wide_state_elems), else unused (may be null).
// Returns the cudaError_t of the launch.
#define OCO_PACKED_ENTRY(SUFFIX, Z, Y)                                      \
  extern "C" int oco_play_packed_##SUFFIX(                                  \
      const void* z, const void* y, const void* scales, long long T,        \
      long long B, int d, int alg_flag, void* cum, void* theta,             \
      void* state, void* stream) {                                          \
    return launch<Z, Y, false>(z, y, scales, nullptr, T, B, d, alg_flag,    \
                               cum, theta, state, stream);                  \
  }
OCO_STORAGE_PAIRS(OCO_PACKED_ENTRY)

// K3e.  Inputs: z (T, d, B) and y (T, B) time-major in a storage pair of
// OCO_STORAGE_PAIRS (the suffix), eta (B,) the FTRL step scale of each
// sequence in the compute type; any d >= 1.  Outputs, in the compute
// type: cum (B,), theta (d, B).  state: as K3's.  Returns the cudaError_t
// of the launch.
#define OCO_PACKED_ETA_ENTRY(SUFFIX, Z, Y)                                  \
  extern "C" int oco_play_packed_eta_##SUFFIX(                              \
      const void* z, const void* y, const void* eta, long long T,           \
      long long B, int d, void* cum, void* theta, void* state,              \
      void* stream) {                                                       \
    return launch<Z, Y, true>(z, y, nullptr, eta, T, B, d, 0, cum, theta,   \
                              state, stream);                               \
  }
OCO_STORAGE_PAIRS(OCO_PACKED_ETA_ENTRY)

// Registers a thread (out[0]), resident warps an SM (out[1]), bytes of a
// thread's local frame (out[2]) and of a block's shared memory (out[3]) of a
// K3 (per_seq_eta 0) or K3e (1) launch at feature dimension d on the current
// card; f64 nonzero for the float64 instance.  Returns the cudaError_t.
extern "C" int oco_packed_occupancy(int f64, int per_seq_eta, int d,
                                    int* out) {
  return f64 ? occupancy<double>(per_seq_eta, d, out)
             : occupancy<float>(per_seq_eta, d, out);
}
