// K9: batched ball-constrained least squares, one trust-region solve per
// thread.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_trs.py
// _trs_kernel, entry trs_solve_packed (behind ball_ls_action_pallas).
// Python wrapper and plain PyTorch version:
// online_convex_optimization_tpu_torch/ops/trs.py (trs_solve,
// trs_solve_reference).
//
// Each thread loads its problem's lower triangle of A and its b once, into
// registers (local memory for the runtime-d instance), and runs the whole
// safeguarded Newton there (oco::trs_action, shared with K8, so K8's x_c is
// this kernel's answer on the same statistics bit for bit).  The inputs are
// the port's public layout, (N, d, d) and (N, d) row-major: no packing pass
// (the TPU's pack_stats / (8, 128) tiling is not ported).  A warp's loads of
// one entry are strided by d*d values, so each touches 32 sectors; the
// problem's other entries then come from L1.
//
// What bounds it on an H100: operations.  12 Newton iterations in f32 (each
// a d x d Cholesky and three triangular solves, about 250 flops at d = 5)
// against 4*(d*d + d) = 120 bytes read per problem; with millions of
// problems the card is full, and the correctly rounded sqrt and divide
// sequences (--fmad=false, no fast math) are the most expensive part of
// the chain.
#include "oco_trs.cuh"

namespace {

template <typename S, int D>
__global__ void __launch_bounds__(OCO_THREADS)
trs_kernel(const S* __restrict__ A, const S* __restrict__ bvec, long long N,
           int d, S* __restrict__ x_out) {
  constexpr int C = oco::QCap<D>::value;
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (p >= N) return;
  const int n = D > 0 ? D : d;
  const S* Ap = A + p * n * n;
  S At[oco::QCap<D>::tri], bv[C], x[C];
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) At[oco::tri(i, j)] = Ap[i * n + j];
    bv[i] = bvec[p * n + i];
  }
  oco::trs_action<S, D>(At, bv, x, n);
#pragma unroll
  for (int i = 0; i < n; ++i) x_out[p * n + i] = x[i];
}

template <typename S>
int launch(const void* A, const void* b, long long N, int d, void* x,
           void* stream) {
  if (N < 1 || d < 1 || d > OCO_QUAD_MAX_D) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = oco::grid_for(N);
  const auto* ap = static_cast<const S*>(A);
  const auto* bp = static_cast<const S*>(b);
  auto* xp = static_cast<S*>(x);
  if (d == 5)
    trs_kernel<S, 5><<<grid, OCO_THREADS, 0, s>>>(ap, bp, N, d, xp);
  else
    trs_kernel<S, 0><<<grid, OCO_THREADS, 0, s>>>(ap, bp, N, d, xp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs: A (N, d, d) row-major (its lower triangle is read), b (N, d).
// Output: x (N, d) with ||x|| <= 1.  Returns the cudaError_t of the launch.
extern "C" int oco_trs_solve_f64(const void* A, const void* b, long long N,
                                 int d, void* x, void* stream) {
  return launch<double>(A, b, N, d, x, stream);
}

extern "C" int oco_trs_solve_f32(const void* A, const void* b, long long N,
                                 int d, void* x, void* stream) {
  return launch<float>(A, b, N, d, x, stream);
}
