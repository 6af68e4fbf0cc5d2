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
// in f32) once; the carry costs 8*(2d+2) bytes per sequence per launch,
// nothing next to a chunk of thousands of rounds.  A round's own work is
// K1's serial chain of about 3d + 10 flops with a sqrt and divide, so a
// thread that waits for each row before it plays it is bound by the HBM
// round trip, not by the chain.  The design keeps rows in flight: each
// thread copies its own rows of the time-major (CT, d, B) layout (coalesced
// across the warp) with cp.async into its own slots of a shared-memory
// ring, kRingBytes of rows ahead of the round it plays (8
// rounds of d = 5 in f32, 4 in f64), and waits on its own copy groups
// (cp.async.wait_group), so no thread waits for another and the block needs
// no barrier.  Blocks of kStreamThreads = 64 threads spread a chunk of
// 16,384 sequences over 256 blocks, every SM of the card.  The large-d
// instance (d > 64), whose rows do not fit a ring, loads each row as it
// plays it.  With the loads hidden, a thread's time is the latency of
// game_round's serial chain (the FTRL scale's sqrt and divide, the
// projection's sqrt and reciprocal, two dot products) times CT; all of a
// chunk's sequences are resident at once, so nothing else can hide it.
//
// Narrow storage (bf16 z, int8 or bf16 y): a thread's element is 1 or 2
// bytes, and cp.async moves 4, 8 or 16, so each element goes through the
// ring as the aligned 4-byte word that holds it (oco::play_time_major_words,
// the same ring of the same depth); the large-d instance loads each row as
// it plays it.
//
// Past d = 512 (K4w, the wide instance, D == oco::kWideD) a thread keeps no
// vector in its frame: theta and w are the output carry itself (th_out and
// w_out, (d, B), copied from the input carry first), x is vector 0 of the
// caller's (d, B) state buffer, and each row is read from the time-major
// chunk where it is used (an oco::Widened view, coalesced across the
// warp).  The same round in the same order: K4w over chunks equals K1w in
// one pass bit for bit.
#include "oco_tiles.cuh"

namespace {

// Threads a block, and bytes of rows in flight a thread.  On an H100 at
// B = 16,384, CT = 8,192, d = 5, a ring of twice the bytes and blocks of 32
// threads were each measured no faster (the ring hides the loads at 8
// rounds ahead, so a round costs game_round's chain).
constexpr int kStreamThreads = 64;
constexpr int kRingBytes = 192;

// Rounds in flight for one instance: kRingBytes of d = 5 rows (a narrow
// element takes a 4-byte word), 4 rounds of the generic instance
// (d <= 64), none for the large-d one.
template <typename Z, typename Y, int D>
struct Ring {
  static constexpr int word =
      oco::kWindowed<Z, Y> ? 4 : static_cast<int>(sizeof(Z));
  static constexpr int depth =
      D > 0 ? kRingBytes / ((D + 1) * word) : (D == 0 ? 4 : 0);
  static_assert(depth == 0 || depth >= 2, "a ring needs two slots");
};

template <typename Z, typename Y, int D, typename S = oco::compute_t<Z>>
__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const Z* __restrict__ z, const Y* __restrict__ y,
              const int* __restrict__ alg_flag, const S* __restrict__ eta,
              long long t0, long long CT, long long B, int d,
              const S* __restrict__ th_in, const S* __restrict__ w_in,
              const S* __restrict__ cum_in, const S* __restrict__ cnt_in,
              S* __restrict__ th_out, S* __restrict__ w_out,
              S* __restrict__ cum_out, S* __restrict__ cnt_out, S* state) {
  constexpr int C = oco::Cap<D>::value;
  constexpr int P = Ring<Z, Y, D>::depth;
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;   // the ring is per thread: no barrier to keep
  const int n = D > 0 ? D : d;
  const bool ftrl = alg_flag[b] == 0;
  const S eta_b = eta[b];

  // The thread's vectors: arrays, or (wide) its columns of the output
  // carry and of the state buffer.
  S th_a[C], w_a[C], x_a[C], zr[C];
  const auto th = oco::state_vec<D>(th_a, th_out, 0, b, B, n);
  const auto w = oco::state_vec<D>(w_a, w_out, 0, b, B, n);
  const auto x = oco::state_vec<D>(x_a, state, 0, b, B, n);
#pragma unroll
  for (int j = 0; j < n; ++j) {
    th[j] = th_in[j * B + b];
    w[j] = w_in[j * B + b];
  }
  S cum = cum_in[b], cnt = cnt_in[b];
  if constexpr (D == oco::kWideD) {
    for (long long k = 0; k < CT; ++k) {
      const S yt = S(oco::widen(y[k * B + b]));
      const oco::Widened<S, Z> row{z + k * n * B + b, B};
      oco::game_round<S, D>(th, w, x, row, yt, ftrl, eta_b, S(t0 + k + 1), n,
                            cum);
      cnt = cnt + yt * yt;
    }
  } else if constexpr (P > 0 && oco::kWindowed<Z, Y>) {
    oco::play_time_major_words<S, D, P>(
        z, y, CT, b, B, n,
        reinterpret_cast<unsigned*>(ring_bytes) + threadIdx.x, blockDim.x,
        [&](long long k, const S* row, S yt) {
          oco::game_round<S, D>(th, w, x, row, yt, ftrl, eta_b,
                                S(t0 + k + 1), n, cum);
          cnt = cnt + yt * yt;
        });
  } else if constexpr (P == 0) {
    for (long long k = 0; k < CT; ++k) {
      oco::load_row<S, D>(z, k, b, B, n, zr);
      const S yt = S(oco::widen(y[k * B + b]));
      oco::game_round<S, D>(th, w, x, zr, yt, ftrl, eta_b, S(t0 + k + 1), n,
                            cum);
      cnt = cnt + yt * yt;
    }
  } else {
    // Slot i of this thread holds a round's z_0..z_{n-1}, y at stride
    // blockDim.x: ring[(i * (n + 1) + j) * blockDim.x + threadIdx.x].
    S* mine = reinterpret_cast<S*>(ring_bytes) + threadIdx.x;
    const int step = blockDim.x;
    const auto fetch = [&](long long k) {
      S* dst = mine + static_cast<int>(k % P) * (n + 1) * step;
      const S* src = z + k * n * B + b;
      for (int j = 0; j < n; ++j)
        oco::copy_async(dst + j * step, src + j * B);
      oco::copy_async(dst + n * step, y + k * B + b);
    };
    // One copy group a round, empty past the chunk, so that group k is
    // complete once at most P - 1 newer ones are pending.
#pragma unroll
    for (int i = 0; i < P - 1; ++i) {
      if (i < CT) fetch(i);
      oco::commit_copies();
    }
    for (long long k = 0; k < CT; ++k) {
      // Slot (k - 1) % P was read last round, so it can be refilled.
      if (k + P - 1 < CT) fetch(k + P - 1);
      oco::commit_copies();
      oco::wait_copies<P - 1>();
      const S* src = mine + static_cast<int>(k % P) * (n + 1) * step;
#pragma unroll
      for (int j = 0; j < n; ++j) zr[j] = src[j * step];
      const S yt = src[n * step];
      oco::game_round<S, D>(th, w, x, zr, yt, ftrl, eta_b, S(t0 + k + 1), n,
                            cum);
      cnt = cnt + yt * yt;
    }
  }
  if constexpr (D != oco::kWideD) {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      th_out[j * B + b] = th[j];
      w_out[j * B + b] = w[j];
    }
  }
  cum_out[b] = cum;
  cnt_out[b] = cnt;
}

template <typename Z, typename Y>
int launch(const void* z, const void* y, const void* alg_flag,
           const void* eta, long long t0, long long CT, long long B, int d,
           const void* th_in, const void* w_in, const void* cum_in,
           const void* cnt_in, void* th_out, void* w_out, void* cum_out,
           void* cnt_out, void* state, void* stream) {
  using S = oco::compute_t<Z>;
  if (B < 1 || CT < 0 || t0 < 0) return cudaErrorInvalidValue;
  if (d > OCO_LARGE_D && state == nullptr) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = static_cast<unsigned int>(
      (B + kStreamThreads - 1) / kStreamThreads);
  const auto* zp = static_cast<const Z*>(z);
  const auto* yp = static_cast<const Y*>(y);
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
  auto* st = static_cast<S*>(state);
  int err = cudaSuccess;
  const int launched = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const auto kernel = stream_kernel<Z, Y, D>;
    const size_t smem = static_cast<size_t>(Ring<Z, Y, D>::depth) * (d + 1) *
                        Ring<Z, Y, D>::word * kStreamThreads;
    if (smem > 48 * 1024)
      err = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem)));
    if (err == cudaSuccess)
      kernel<<<grid, kStreamThreads, smem, s>>>(
          zp, yp, fp, ep, t0, CT, B, d, ti, wi, ci, ni, to, wo, co, no, st);
  });
  return err != cudaSuccess ? err : launched;
}

template <typename S>
int occupancy(int d, int* out) {
  int err = cudaSuccess;
  const int checked = oco::launch_for_any_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const size_t smem = static_cast<size_t>(Ring<S, S, D>::depth) * (d + 1) *
                        Ring<S, S, D>::word * kStreamThreads;
    err = oco::occupancy(stream_kernel<S, S, D>, kStreamThreads, smem, out);
    if (err == cudaSuccess) err = oco::local_bytes(stream_kernel<S, S, D>,
                                                   out + 2, smem);
  });
  return err != cudaSuccess ? err : checked;
}

}  // namespace

// Inputs: z (CT, d, B) and y (CT, B) time-major in a storage pair of
// OCO_STORAGE_PAIRS (the suffix), alg_flag (B,) int32 (0 = FTRL, 1 = FTL),
// eta (B,), t0 >= 0 the rounds already played, and the carry theta (d, B),
// w (d, B), cum (B,), cnt (B,), eta and the carry in the compute type; any
// d >= 1.  Outputs: the advanced carry in separate buffers (no aliasing
// with the inputs).  state: past d = 512 a scratch buffer of d * B
// elements of the compute type (ops/game.py::wide_state_elems), else
// unused (may be null).  Returns the cudaError_t of the launch.
#define OCO_STREAM_ENTRY(SUFFIX, Z, Y)                                      \
  extern "C" int oco_play_stream_##SUFFIX(                                  \
      const void* z, const void* y, const void* alg_flag, const void* eta,  \
      long long t0, long long CT, long long B, int d, const void* th_in,    \
      const void* w_in, const void* cum_in, const void* cnt_in,             \
      void* th_out, void* w_out, void* cum_out, void* cnt_out, void* state, \
      void* stream) {                                                       \
    return launch<Z, Y>(z, y, alg_flag, eta, t0, CT, B, d, th_in, w_in,     \
                        cum_in, cnt_in, th_out, w_out, cum_out, cnt_out,    \
                        state, stream);                                     \
  }
OCO_STORAGE_PAIRS(OCO_STREAM_ENTRY)

// Registers a thread (out[0]), resident warps an SM (out[1]), bytes of a
// thread's local frame (out[2]) and of a block's shared memory (out[3]) of a
// launch at feature dimension d on the current card; f64 nonzero for the
// float64 instance.  Returns the cudaError_t.
extern "C" int oco_stream_occupancy(int f64, int d, int* out) {
  return f64 ? occupancy<double>(d, out) : occupancy<float>(d, out);
}
