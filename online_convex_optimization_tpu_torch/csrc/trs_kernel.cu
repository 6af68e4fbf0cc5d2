// K9: batched ball-constrained least squares, persistent lanes that each
// keep one trust-region solve in flight and refill as soon as it ends.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_trs.py
// _trs_kernel, entry trs_solve_packed (behind ball_ls_action_pallas).
// Python wrapper and plain PyTorch version:
// online_convex_optimization_tpu_torch/ops/trs.py (trs_solve,
// trs_solve_reference; refill_iterations models the schedule below).
//
// Every solve runs oco::trs_begin / trs_pass / to_ball (oco_trs.cuh, shared
// with K8) on its own problem, so K8's x_c is this kernel's answer on the
// same statistics bit for bit; the schedule decides only which lane
// computes which problem.  The inputs are the port's public layout, (N, d,
// d) and (N, d) row-major: no packing pass (the TPU's pack_stats / (8, 128)
// tiling is not ported).
//
// What bounds it on an H100: each lane's chain of Newton passes (a d x d
// Cholesky and three triangular solves, 26 correctly rounded divides and 6
// sqrts a pass at d = 5 under --fmad=false), not the 4 (d d + 2 d) bytes a
// problem moves.  The passes a solve needs vary (the exact exit of
// trs_pass: ~4 on average, 13 in f32 at the cap), and a warp issues as long
// as any lane computes, so one problem a thread made a warp cost its
// slowest lane (~12 passes for 32 neighbouring prefixes).  Here a lane
// whose solve ends waits only until kMinIdle lanes of its warp are idle:
//   - each loop pass first hands over on the lanes whose solve has ended
//     (to_ball, the store, the next problem's load, trs_begin; the
//     divergent branch) once kMinIdle of them are idle, then runs one
//     Newton pass on every lane that holds a solve, where the warp meets
//     again.  The order matters (K8 found it first): with the hand-over
//     after the pass the compiler built an inner loop of passes, which is
//     lockstep again (scripts/sass_census.py reports the loops);
//   - problems are claimed warp by warp: a ballot of the lanes that need
//     one, consecutive indices handed out in lane order from the warp's
//     range, and a new range from a global counter (one atomicAdd by lane
//     0) when the range runs short: 32 problems the first time, kChunk
//     after.  A claim a warp and pass would be ~1.5e9 atomics a second on
//     one address;
//   - the grid is persistent: as many blocks as the SMs hold at the
//     kernel's registers, so the warps drain the counter together and
//     finish within about one solve of each other.
//
// K9w, the wide instance (d > OCO_QUAD_MAX_D, trs_wide_kernel): one warp a
// problem, on oco::wide's solve (oco_trs.cuh says how its Cholesky and
// substitutions spread over the lanes), with the answer of the plain
// version in every bit.  A warp's workspace (the factor's triangle, b as
// its last row, five vectors) lives in shared memory up to d = 334 in
// float32 and 234 in float64, in a device scratch slice read through L2
// above that; A stays in the caller's (N, d, d), and each Newton pass
// copies its lower triangle and b in with cp.async.  The grid is
// persistent, one warp a block (each with its own workspace), and a warp
// claims its next problem from the counter as its solve ends.  What bounds
// it: the latency of one warp's chain (a pass at d = 64 is ~180,000 clocks
// alone on an SM, most of it correctly rounded divides and sqrts and the
// loads and shuffles between them; scripts/wide_probe.py --split), hidden
// by as many warps as the workspace lets an SM hold (21 at d = 64 in
// float32, 11 in float64).
#include "oco_tiles.cuh"
#include "oco_trs.cuh"

namespace {

constexpr int kThreads = 128;
// Problems a warp claims from the counter at once: 2 a lane, ~8 loop
// passes of hand-overs at ~4 passes a solve.
constexpr int kChunk = 64;
// Idle lanes a warp waits for before it hands over (at every pass once the
// counter has passed N): a hand-over issues about half a Newton pass's
// instructions in its divergent branch however few lanes it serves, and at
// 8 the lanes' later start costs less than the hand-overs saved (PERF.md
// gives the times at 1, 4, 8, 12 and 16).  At most 32, so that a warp with
// no solve in flight hands over.
constexpr int kMinIdle = 8;
static_assert(kMinIdle >= 1 && kMinIdle <= 32, "kMinIdle: 1..32 lanes");

// Blocks an SM is to hold, which caps the registers a thread: 8 (64
// registers) in float32, 4 (128) in float64.  The Newton pass is issue-
// and latency-bound with ~6 warps a scheduler, so more resident warps beat
// the few spills the cap costs (PERF.md gives the times at other counts).
template <typename S>
constexpr int kMinBlocks = sizeof(S) == 4 ? 8 : 4;

template <typename S, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<S>)
trs_refill_kernel(const S* __restrict__ A, const S* __restrict__ bvec,
                  long long N, int d, unsigned long long* __restrict__ counter,
                  S* __restrict__ x_out) {
  constexpr int C = oco::QCap<D>::value;
  const int n = D > 0 ? D : d;
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  S At[oco::QCap<D>::tri], bv[C], x[C];
  oco::TrsSolve<S, D> s;
  long long p = -1;         // this lane's problem, -1 for none
  bool done = true;         // no solve in flight: none yet, or it ended
  // The warp's claimed range [cur, cur + left) (the same on every lane),
  // and whether the counter has passed N.
  long long cur = 0, left = 0;
  bool drained = false;
  for (;;) {
    const unsigned idle = __ballot_sync(oco::kFullMask, done);
    const bool hand = __popc(idle) >= kMinIdle || drained;
    long long q = -1;
    if (hand && !drained) {
      const int need = __popc(idle);
      const int rank = __popc(idle & below);
      // A warp's first range is one problem a lane, so that a batch of at
      // most 32 problems a warp spreads over every warp.
      const int size = cur == 0 ? 32 : kChunk;
      long long fresh = 0;
      if (left < need) {
        unsigned long long base = 0;
        if ((threadIdx.x & 31) == 0)
          base = atomicAdd(counter, static_cast<unsigned long long>(size));
        fresh = static_cast<long long>(
            __shfl_sync(oco::kFullMask, base, 0));
      }
      if (done) q = rank < left ? cur + rank : fresh + (rank - left);
      if (left < need) {
        cur = fresh + (need - left);
        left = size - (need - left);
      } else {
        cur += need;
        left -= need;
      }
      drained = cur >= N;
    }
    if (hand && done) {
      if (p >= 0) {
        oco::to_ball<S, D>(x, n);
#pragma unroll
        for (int i = 0; i < n; ++i) x_out[p * n + i] = x[i];
      }
      p = q < N ? q : -1;
      if (p >= 0) {
        const S* Ap = A + p * n * n;
#pragma unroll
        for (int i = 0; i < n; ++i) {
#pragma unroll
          for (int j = 0; j <= i; ++j) At[oco::tri(i, j)] = Ap[i * n + j];
          bv[i] = bvec[p * n + i];
        }
        oco::trs_begin<S, D>(s, At, bv, n);
        done = false;
      }
    }
    if (!__any_sync(oco::kFullMask, !done)) break;
    if (!done) done = oco::trs_pass<S, D>(s, At, bv, x, n);
  }
}

// Blocks of the persistent grid: what the SMs hold at the instance's
// registers, and no more than the problems fill.
template <typename K>
int persistent_grid(K kernel, long long N, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  const long long need = (N + kThreads - 1) / kThreads;
  const long long full = static_cast<long long>(sms) * per_sm;
  *grid = static_cast<unsigned>(need < full ? need : full);
  return static_cast<int>(err);
}

template <typename S, int D>
int launch_d(const S* A, const S* b, long long N, int d,
             unsigned long long* counter, S* x, cudaStream_t s) {
  unsigned grid = 0;
  int err = persistent_grid(trs_refill_kernel<S, D>, N, &grid);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counter, 0, sizeof(*counter), s);
  if (err != cudaSuccess) return err;
  trs_refill_kernel<S, D><<<grid, kThreads, 0, s>>>(A, b, N, d, counter,
                                                    x);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch(const void* A, const void* b, long long N, int d, void* counter,
           void* x, void* stream) {
  if (N < 1 || d < 1 || d > OCO_QUAD_MAX_D) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const S*>(A);
  const auto* bp = static_cast<const S*>(b);
  auto* cp = static_cast<unsigned long long*>(counter);
  auto* xp = static_cast<S*>(x);
  return d == 5 ? launch_d<S, 5>(ap, bp, N, d, cp, xp, s)
                : launch_d<S, 0>(ap, bp, N, d, cp, xp, s);
}

template <typename S>
int occupancy(int d, int* out) {
  if (d < 1 || d > OCO_QUAD_MAX_D) return cudaErrorInvalidValue;
  return d == 5
             ? oco::occupancy(trs_refill_kernel<S, 5>, kThreads, 0, out)
             : oco::occupancy(trs_refill_kernel<S, 0>, kThreads, 0, out);
}

// K9w: persistent one-warp blocks; each warp claims a problem, issues the
// copy of its lower triangle and b into the workspace's augmented triangle
// (each pass copies them again from A and b, which stay in device memory),
// solves and stores x (and, with `passes`, the solve's ridge solves).
template <typename S, bool kShared>
__global__ void __launch_bounds__(32, oco::wide::kMinBlocks<S>)
trs_wide_kernel(const S* __restrict__ A, const S* __restrict__ bvec,
                long long N, int d, unsigned long long* __restrict__ counter,
                S* __restrict__ scratch, S* __restrict__ x_out,
                int* __restrict__ passes) {
  namespace wd = oco::wide;
  const int lane = threadIdx.x;
  const auto w = wd::workspace<S, kShared>(
      scratch + (kShared ? 0 : blockIdx.x * wd::work_elems<S>(d)), d);
  S* const ws = w.p();
  OCO_SPLIT(-1);
  for (;;) {
    unsigned long long q = 0;
    if (lane == 0) q = atomicAdd(counter, 1ULL);
    const long long p = static_cast<long long>(__shfl_sync(wd::kWarp, q, 0));
    if (p >= N) break;
    const wd::RowSeed<S> sd{A + p * d * d, bvec + p * d};
    wd::seed_issue(w, sd, lane);
    wd::seed_wait<kShared>();
    OCO_SPLIT(wd::kSplitProblem);
    const int k = wd::trs_action(w, sd, false, lane);
    if (passes != nullptr && lane == 0) passes[p] = k;
    for (int i = lane; i < d; i += 32) x_out[p * d + i] = ws[w.x + i];
    __syncwarp();
  }
  OCO_SPLIT(wd::kSplitProblem);
}

template <typename S>
int plan_wide(int d, long long N, long long* out) {
  return oco::wide::plan<S>(trs_wide_kernel<S, true>,
                            trs_wide_kernel<S, false>, d, N, 0, out);
}

template <typename S>
int launch_wide(const void* A, const void* b, long long N, int d,
                void* counter, void* scratch, void* x, void* passes,
                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* cp = static_cast<unsigned long long*>(counter);
  long long plan[5];
  const int err = oco::wide::prepare<S>(trs_wide_kernel<S, true>,
                                        trs_wide_kernel<S, false>, d, N, 0,
                                        scratch, cp, s, plan);
  if (err != cudaSuccess) return err;
  const auto grid = static_cast<unsigned>(plan[0]);
  const auto* ap = static_cast<const S*>(A);
  const auto* bp = static_cast<const S*>(b);
  auto* wp = static_cast<S*>(scratch);
  auto* xp = static_cast<S*>(x);
  auto* pp = static_cast<int*>(passes);
  if (plan[2] > 0)
    trs_wide_kernel<S, true><<<grid, 32, plan[2], s>>>(ap, bp, N, d, cp, wp,
                                                       xp, pp);
  else
    trs_wide_kernel<S, false><<<grid, 32, 0, s>>>(ap, bp, N, d, cp, wp, xp,
                                                  pp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs: A (N, d, d) row-major (its lower triangle is read), b (N, d);
// counter: 8 bytes of device scratch (the launch zeroes it on the stream).
// Output: x (N, d) with ||x|| <= 1.  Returns the cudaError_t of the launch.
extern "C" int oco_trs_solve_f64(const void* A, const void* b, long long N,
                                 int d, void* counter, void* x,
                                 void* stream) {
  return launch<double>(A, b, N, d, counter, x, stream);
}

extern "C" int oco_trs_solve_f32(const void* A, const void* b, long long N,
                                 int d, void* counter, void* x,
                                 void* stream) {
  return launch<float>(A, b, N, d, counter, x, stream);
}

// Registers a thread (out[0]) and resident warps an SM (out[1]) of the
// instance for d on the current card; f64 nonzero for float64.  Returns
// the cudaError_t.
extern "C" int oco_trs_occupancy(int f64, int d, int* out) {
  return f64 ? occupancy<double>(d, out) : occupancy<float>(d, out);
}

// K9w, d > OCO_QUAD_MAX_D (any d): the inputs and output of
// oco_trs_solve_*, with scratch the device buffer of the plan's out[1]
// elements (null where that is 0) and passes, null or (N,) int32, each
// solve's ridge solves.
extern "C" int oco_trs_solve_wide_f64(const void* A, const void* b,
                                      long long N, int d, void* counter,
                                      void* scratch, void* x, void* passes,
                                      void* stream) {
  return launch_wide<double>(A, b, N, d, counter, scratch, x, passes,
                             stream);
}

extern "C" int oco_trs_solve_wide_f32(const void* A, const void* b,
                                      long long N, int d, void* counter,
                                      void* scratch, void* x, void* passes,
                                      void* stream) {
  return launch_wide<float>(A, b, N, d, counter, scratch, x, passes, stream);
}

#ifdef OCO_WIDE_SPLIT
// The probe build's clocks by phase (oco_trs.cuh SplitPhase), summed over
// warps, into out[kSplitPhases]; zeroed after the read.
extern "C" int oco_wide_split(unsigned long long* out) {
  namespace wd = oco::wide;
  cudaError_t err = cudaMemcpyFromSymbol(out, wd::split_clocks,
                                         sizeof(wd::split_clocks));
  static const unsigned long long zero[wd::kSplitPhases] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(wd::split_clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

// K9w's plan for N problems of dimension d on the current card
// (oco_trs.cuh oco::wide::plan: grid warps, scratch elements, shared bytes
// a warp, registers, warps an SM); f64 nonzero for float64.  Returns the
// cudaError_t.
extern "C" int oco_trs_wide_plan(int f64, int d, long long N,
                                 long long* out) {
  return f64 ? plan_wide<double>(d, N, out) : plan_wide<float>(d, N, out);
}
