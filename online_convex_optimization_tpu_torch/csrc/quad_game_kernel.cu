// K8: the quadratic-loss game (exact ball-constrained least-squares FTL, or
// projected FTRL), its exact comparator and the whole RunResult in one pass.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_trs.py
// _quad_game_kernel, entry quadratic_regrets_packed.  Python wrapper and
// plain PyTorch version: online_convex_optimization_tpu_torch/ops/trs.py
// (quadratic_regrets, quadratic_regrets_reference).
//
// One thread per sequence keeps the running statistics in registers (in
// local memory for the runtime-d instance): the lower triangle of
// A = sum z z^T, b = sum y z, c = sum y^2, and cum.  Each round
// (loss_t(x) = 0.5 * (<z_t, x> - y_t)^2, ||x|| <= 1):
//   alg_flag 1 (FTL): x is the trust-region action of the statistics
//     before the update (oco::trs_action, shared with K9);
//   alg_flag 0 (FTRL): the JAX scan's projected gradient leader
//     (models/quadratic.py), x = xf / max(||xf||, 1) with
//     xf = -(eta / sqrt(t)) * theta and theta += r z.  This is not the
//     hinge FTRL round: it projects every round, and its step is r, not
//     half a sign.
// then cum += 0.5 * r^2 with r = <z_t, x> - y_t, and the statistics take
// row t.  At the end the exact comparator x_c = trs_action(A, b) is scored
// from the statistics, 0.5 * (x_c^T A x_c - 2 b^T x_c + c), so the
// outputs are cum, comp, x_c and the last action played: the JAX fused
// path's epilogue (a Gram reduction and two more solves) is not needed.
// The flag is per sequence, so the study's FTRL and FTL runs share one
// launch.
//
// What bounds it on an H100: the latency of one thread's chain.  An FTL
// round's solve is a run of Newton passes, each a d x d Cholesky and three
// triangular solves (about 250 flops at d = 5, with 5 sqrts and 20
// divides on the chain, each correctly rounded in its own basic block),
// against 4*(d+1) bytes of input; the bench shape has only B = 4,096
// sequences (2,048 FTL), in blocks of one warp.  The design cuts the
// chain's length, exactly:
//   - a solve stops once its Newton carry settles (oco::trs_pass), after
//     about 4 passes on average where the fixed count takes 13 solves in
//     f32 and 21 in f64 (PERF.md counts them on the bench shape);
//   - each lane plays its own rounds: every pass of the loop below runs
//     one Newton pass for each lane of the warp, convergent, and a lane
//     whose solve is done finishes its round and starts the next in a
//     divergent branch (the loop's comment says how it is kept one loop).
//     A warp thus takes its slowest lane's passes, not the sum over rounds
//     of each round's slowest.  Nothing assumes lockstep: no shuffle, no
//     vote;
//   - the wrapper hands the kernel a lane map that puts FTRL and FTL
//     sequences in warps of their own (ops/trs.py quad_lanes): an FTRL
//     round is a few operations, an FTL round a solve.  An FTL warp holds
//     only as many sequences as spread them over ~8 warps an SM
//     (ops/trs.py ftl_width): a warp of fewer lanes waits on a less slow
//     slowest lane, and the SM's warps hide each other's latency.
// Each thread reads and writes only its own sequence's columns, so the
// outputs need no unpermuting.
//
// K8w, the wide instance (d > OCO_QUAD_MAX_D, quad_wide_kernel): one warp
// a sequence, on the solve of K9w (oco_trs.cuh oco::wide), so its x_c
// equals K9w on the same statistics bit for bit.  The statistics A and b
// live in the warp's slice of a device scratch buffer and in the
// workspace's triangle (shared memory where it fits, a scratch slice
// otherwise), theta and the round's row in the workspace; a round's O(d)
// and O(d^2) updates spread over the lanes, each entry's sum in the thin
// instance's order, and the sums over the index (r, the FTRL norm, the
// comparator's loss) run in index order on every lane.  The grid is
// persistent, one warp a block, and a warp claims its next sequence from a
// counter in the order of the wrapper's warp map (ops/trs.py quad_warps:
// the FTL sequences first, the longest work); the flag stays per sequence,
// so FTRL and FTL sequences share the launch.  What bounds it: the FTL
// rounds' solves, each a run of Newton passes whose chain (K9w's note) one
// warp plays in order: 2,048 FTL sequences of 1,024 rounds fill one wave.
#include "oco_trs.cuh"

#define OCO_QUAD_THREADS 32

namespace {

// The round's update once the action x is chosen: cum += 0.5 r^2 with
// r = <z_t, x> - y_t, theta += r z_t (FTRL), and the statistics take the
// row.
template <typename S, int D>
__device__ __forceinline__ void quad_update(S* A, S* bv, S* th, S& c, S& cum,
                                            const S* x, const S* zr, S yt,
                                            int n) {
  const S r = oco::dot<S, D>(zr, x, n) - yt;
  cum = cum + S(0.5) * r * r;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    th[i] = th[i] + r * zr[i];
#pragma unroll
    for (int j = 0; j <= i; ++j)
      A[oco::tri(i, j)] = A[oco::tri(i, j)] + zr[i] * zr[j];
    bv[i] = bv[i] + yt * zr[i];
  }
  c = c + yt * yt;
}

template <typename S, int D>
__global__ void __launch_bounds__(OCO_QUAD_THREADS)
quad_game_kernel(const S* __restrict__ z, const S* __restrict__ y,
                 const int* __restrict__ alg_flag, const S* __restrict__ eta,
                 const int* __restrict__ lanes, long long n_lanes,
                 long long T, long long B, int d, S* __restrict__ cum_out,
                 S* __restrict__ comp_out, S* __restrict__ xc_out,
                 S* __restrict__ xlast_out) {
  constexpr int C = oco::QCap<D>::value;
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
  if (lane >= n_lanes || lanes[lane] < 0) return;
  const long long b = lanes[lane];
  const int n = D > 0 ? D : d;
  const bool ftrl = alg_flag[b] == 0;
  const S eta_b = eta[b];

  S A[oco::QCap<D>::tri], bv[C], th[C], x[C], zr[C];
#pragma unroll
  for (int i = 0; i < oco::tri(n, 0); ++i) A[i] = S(0);
#pragma unroll
  for (int i = 0; i < n; ++i) bv[i] = th[i] = x[i] = S(0);
  S c = S(0), cum = S(0);

  if (ftrl) {
    for (long long t = 0; t < T; ++t) {
      oco::load_row<S, D>(z, t, b, B, n, zr);
      const S yt = y[t * B + b];
      const S scale = -(eta_b / oco::osqrt(S(t + 1)));
#pragma unroll
      for (int i = 0; i < n; ++i) x[i] = scale * th[i];
      oco::to_ball<S, D>(x, n);
      quad_update<S, D>(A, bv, th, c, cum, x, zr, yt, n);
    }
  } else if (T > 0) {
    // Round t's solve is in flight on the statistics of rounds < t; row t
    // waits in zr.  Each pass of the loop first lets the lanes whose solve
    // ended on the last pass play their round and begin the next (the
    // divergent branch), then runs one Newton pass on every lane, where
    // the warp meets again.  The order matters: with the hand-over after
    // the pass, the compiler made the passes an inner loop, and the warp
    // waited at its exit for the round's slowest lane (scripts/
    // sass_census.py reports the loops).
    long long t = 0;
    oco::load_row<S, D>(z, 0, b, B, n, zr);
    S yt = y[b];
    oco::TrsSolve<S, D> s;
    oco::trs_begin<S, D>(s, A, bv, n);
    bool solved = false;
    for (;;) {
      if (solved) {
        oco::to_ball<S, D>(x, n);
        quad_update<S, D>(A, bv, th, c, cum, x, zr, yt, n);
        if (++t == T) break;
        oco::load_row<S, D>(z, t, b, B, n, zr);
        yt = y[t * B + b];
        oco::trs_begin<S, D>(s, A, bv, n);
      }
      solved = oco::trs_pass<S, D>(s, A, bv, x, n);
    }
  }

  // The exact comparator from the final statistics; zr holds x_c.
  oco::trs_action<S, D>(A, bv, zr, n);
  S quad = S(0), dotb = S(0);
#pragma unroll
  for (int i = 0; i < n; ++i) {
    S xa = S(0);
#pragma unroll
    for (int j = 0; j < n; ++j)
      xa = xa + (j <= i ? A[oco::tri(i, j)] : A[oco::tri(j, i)]) * zr[j];
    quad = quad + zr[i] * xa;
    dotb = dotb + bv[i] * zr[i];
  }
  cum_out[b] = cum;
  comp_out[b] = S(0.5) * ((quad - S(2) * dotb) + c);
#pragma unroll
  for (int i = 0; i < n; ++i) {
    xc_out[i * B + b] = zr[i];
    xlast_out[i * B + b] = x[i];
  }
}

template <typename S>
int launch(const void* z, const void* y, const void* alg_flag,
           const void* eta, const void* lanes, long long n_lanes,
           long long T, long long B, int d, void* cum, void* comp, void* x_c,
           void* x_last, void* stream) {
  if (B < 1 || T < 0 || d < 1 || d > OCO_QUAD_MAX_D || n_lanes < B)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned int>(
      (n_lanes + OCO_QUAD_THREADS - 1) / OCO_QUAD_THREADS);
  const auto* zp = static_cast<const S*>(z);
  const auto* yp = static_cast<const S*>(y);
  const auto* fp = static_cast<const int*>(alg_flag);
  const auto* ep = static_cast<const S*>(eta);
  const auto* mp = static_cast<const int*>(lanes);
  auto* cp = static_cast<S*>(cum);
  auto* kp = static_cast<S*>(comp);
  auto* xp = static_cast<S*>(x_c);
  auto* lp = static_cast<S*>(x_last);
  if (d == 5)
    quad_game_kernel<S, 5><<<grid, OCO_QUAD_THREADS, 0, s>>>(
        zp, yp, fp, ep, mp, n_lanes, T, B, d, cp, kp, xp, lp);
  else
    quad_game_kernel<S, 0><<<grid, OCO_QUAD_THREADS, 0, s>>>(
        zp, yp, fp, ep, mp, n_lanes, T, B, d, cp, kp, xp, lp);
  return static_cast<int>(cudaGetLastError());
}

// K8w: persistent one-warp blocks; each warp claims the next entry of
// `order` and plays that sequence (with `passes`, each solve's ridge
// solves: row t for an FTL round, row T for the comparator).  The
// statistics' lower triangle A and b live in the warp's slice of the
// scratch buffer, in the order of the workspace's augmented triangle
// (oco_trs.cuh), which each Newton pass copies in; theta and the round's
// row live in the workspace.  A round's update of A and b runs on the
// triangle, which holds them (trs_action leaves it so, and no solve
// touches it on an FTRL sequence), and is written through to the slice:
// the next round's first pass starts from it with no copy.
template <typename S, bool kShared>
__global__ void __launch_bounds__(32, oco::wide::kMinBlocks<S>)
quad_wide_kernel(const S* __restrict__ z, const S* __restrict__ y,
                 const int* __restrict__ alg_flag, const S* __restrict__ eta,
                 const int* __restrict__ order, long long T, long long B,
                 int d, unsigned long long* __restrict__ counter,
                 S* __restrict__ scratch, S* __restrict__ cum_out,
                 S* __restrict__ comp_out, S* __restrict__ xc_out,
                 S* __restrict__ xlast_out, int* __restrict__ passes) {
  namespace wd = oco::wide;
  const int lane = threadIdx.x;
  const unsigned nst = static_cast<unsigned>(wd::stats_elems<S>(d));
  const unsigned ntri = static_cast<unsigned>(wd::tri_elems<S>(d));
  S* const stats = scratch + blockIdx.x * (wd::stats_elems<S>(d) +
                                           (kShared ? 0 : wd::work_elems<S>(d)));
  const auto w = wd::workspace<S, kShared>(stats + nst, d);
  S* const ws = w.p();
  const wd::PackedSeed<S> sd{stats};
  for (;;) {
    unsigned long long q = 0;
    if (lane == 0) q = atomicAdd(counter, 1ULL);
    const long long c = static_cast<long long>(__shfl_sync(wd::kWarp, q, 0));
    if (c >= B) break;
    const long long b = order[c];
    const bool ftrl = alg_flag[b] == 0;
    const S eta_b = eta[b];
    for (unsigned e = lane; e < ntri; e += 32) ws[e] = S(0);
    for (unsigned e = lane; e < nst; e += 32) stats[e] = S(0);
    for (int i = lane; i < d; i += 32) ws[w.th + i] = ws[w.x + i] = S(0);
    S cs = S(0), cum = S(0);
    __syncwarp();
    for (long long t = 0; t < T; ++t) {
      for (int i = lane; i < d; i += 32)
        ws[w.zr + i] = z[(t * d + i) * B + b];
      const S yt = y[t * B + b];
      __syncwarp();
      if (ftrl) {
        const S scale = -(eta_b / oco::osqrt(S(t + 1)));
        for (int i = lane; i < d; i += 32) ws[w.x + i] = scale * ws[w.th + i];
        __syncwarp();
        wd::to_ball(ws + w.x, d, lane);
      } else {
        const int k = wd::trs_action(w, sd, true, lane);
        if (passes != nullptr && lane == 0) passes[t * B + b] = k;
      }
      // The round's update (quad_update): cum, theta, the statistics.
      const S r = wd::wdot(ws + w.zr, ws + w.x, d) - yt;
      cum = cum + S(0.5) * r * r;
      for (int i = lane; i < d; i += 32) {
        ws[w.th + i] = ws[w.th + i] + r * ws[w.zr + i];
        const S bi = ws[w.rb + i] + yt * ws[w.zr + i];
        ws[w.rb + i] = bi;
        stats[w.rb + i] = bi;
      }
      unsigned ri = 0;
      for (int i = 0; i < d; ++i) {
        const S zi = ws[w.zr + i];
        for (int j = lane; j <= i; j += 32) {
          const S a = ws[ri + j] + zi * ws[w.zr + j];
          ws[ri + j] = a;
          stats[ri + j] = a;
        }
        ri += i + 1;
      }
      cs = cs + yt * yt;
      __syncwarp();
    }
    for (int i = lane; i < d; i += 32) xlast_out[i * B + b] = ws[w.x + i];
    __syncwarp();
    // The exact comparator from the final statistics into x, and its loss:
    // xa_i = sum_j a_ij x_j on lane i mod 32 (into v), then the two
    // index-order sums.
    const int kc = wd::trs_action(w, sd, true, lane);
    if (passes != nullptr && lane == 0) passes[T * B + b] = kc;
    for (int i = lane; i < d; i += 32) {
      const unsigned ri = wd::rs(i);
      S xa = S(0);
      for (int j = 0; j < d; ++j)
        xa = xa + (j <= i ? ws[ri + j] : ws[wd::rs(j) + i]) * ws[w.x + j];
      ws[w.v + i] = xa;
    }
    __syncwarp();
    S quad = S(0), dotb = S(0);
    for (int i = 0; i < d; ++i) {
      quad = quad + ws[w.x + i] * ws[w.v + i];
      dotb = dotb + ws[w.rb + i] * ws[w.x + i];
    }
    if (lane == 0) {
      cum_out[b] = cum;
      comp_out[b] = S(0.5) * ((quad - S(2) * dotb) + cs);
    }
    for (int i = lane; i < d; i += 32) xc_out[i * B + b] = ws[w.x + i];
    __syncwarp();
  }
}

template <typename S>
int plan_wide(int d, long long B, long long* out) {
  return oco::wide::plan<S>(quad_wide_kernel<S, true>,
                            quad_wide_kernel<S, false>, d, B,
                            oco::wide::stats_elems<S>(d), out);
}

template <typename S>
int launch_wide(const void* z, const void* y, const void* alg_flag,
                const void* eta, const void* order, long long T, long long B,
                int d, void* counter, void* scratch, void* cum, void* comp,
                void* x_c, void* x_last, void* passes, void* stream) {
  if (T < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* cp = static_cast<unsigned long long*>(counter);
  long long plan[5];
  const int err = oco::wide::prepare<S>(
      quad_wide_kernel<S, true>, quad_wide_kernel<S, false>, d, B,
      oco::wide::stats_elems<S>(d), scratch, cp, s, plan);
  if (err != cudaSuccess) return err;
  const auto grid = static_cast<unsigned>(plan[0]);
  const auto* zp = static_cast<const S*>(z);
  const auto* yp = static_cast<const S*>(y);
  const auto* fp = static_cast<const int*>(alg_flag);
  const auto* ep = static_cast<const S*>(eta);
  const auto* op = static_cast<const int*>(order);
  auto* wp = static_cast<S*>(scratch);
  auto* kp = static_cast<S*>(cum);
  auto* mp = static_cast<S*>(comp);
  auto* xp = static_cast<S*>(x_c);
  auto* lp = static_cast<S*>(x_last);
  auto* pp = static_cast<int*>(passes);
  if (plan[2] > 0)
    quad_wide_kernel<S, true><<<grid, 32, plan[2], s>>>(
        zp, yp, fp, ep, op, T, B, d, cp, wp, kp, mp, xp, lp, pp);
  else
    quad_wide_kernel<S, false><<<grid, 32, 0, s>>>(
        zp, yp, fp, ep, op, T, B, d, cp, wp, kp, mp, xp, lp, pp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs: z (T, d, B) and y (T, B) time-major, alg_flag (B,) int32
// (0 = FTRL, 1 = FTL), eta (B,) the FTRL step scale, lanes (n_lanes,)
// int32: thread i plays sequence lanes[i], none where it is negative;
// every sequence must appear once.  Outputs: cum (B,), comp (B,), x_c
// (d, B) the exact comparator, x_last (d, B) the last action played.
// Returns the cudaError_t of the launch.
extern "C" int oco_quad_game_f64(const void* z, const void* y,
                                 const void* alg_flag, const void* eta,
                                 const void* lanes, long long n_lanes,
                                 long long T, long long B, int d, void* cum,
                                 void* comp, void* x_c, void* x_last,
                                 void* stream) {
  return launch<double>(z, y, alg_flag, eta, lanes, n_lanes, T, B, d, cum,
                        comp, x_c, x_last, stream);
}

extern "C" int oco_quad_game_f32(const void* z, const void* y,
                                 const void* alg_flag, const void* eta,
                                 const void* lanes, long long n_lanes,
                                 long long T, long long B, int d, void* cum,
                                 void* comp, void* x_c, void* x_last,
                                 void* stream) {
  return launch<float>(z, y, alg_flag, eta, lanes, n_lanes, T, B, d, cum,
                       comp, x_c, x_last, stream);
}

// K8w, d > OCO_QUAD_MAX_D (any d): the inputs and outputs of
// oco_quad_game_*, with order (B,) int32 the sequence each claim plays
// (every sequence once; ops/trs.py quad_warps), counter 8 bytes of device
// scratch (the launch zeroes it on the stream) and scratch the device
// buffer of the plan's out[1] elements (null where that is 0); passes,
// null or (T + 1, B) int32, each solve's ridge solves (0 for an FTRL
// round; row T the comparator's).
extern "C" int oco_quad_game_wide_f64(const void* z, const void* y,
                                      const void* alg_flag, const void* eta,
                                      const void* order, long long T,
                                      long long B, int d, void* counter,
                                      void* scratch, void* cum, void* comp,
                                      void* x_c, void* x_last, void* passes,
                                      void* stream) {
  return launch_wide<double>(z, y, alg_flag, eta, order, T, B, d, counter,
                             scratch, cum, comp, x_c, x_last, passes,
                             stream);
}

extern "C" int oco_quad_game_wide_f32(const void* z, const void* y,
                                      const void* alg_flag, const void* eta,
                                      const void* order, long long T,
                                      long long B, int d, void* counter,
                                      void* scratch, void* cum, void* comp,
                                      void* x_c, void* x_last, void* passes,
                                      void* stream) {
  return launch_wide<float>(z, y, alg_flag, eta, order, T, B, d, counter,
                            scratch, cum, comp, x_c, x_last, passes, stream);
}

// K8w's plan for B sequences of dimension d on the current card
// (oco_trs.cuh oco::wide::plan); f64 nonzero for float64.  Returns the
// cudaError_t.
extern "C" int oco_quad_wide_plan(int f64, int d, long long B,
                                  long long* out) {
  return f64 ? plan_wide<double>(d, B, out) : plan_wide<float>(d, B, out);
}
