// K10: all-prefix exact-FTL hinge ADMM on the l2 ball, one warp per
// (replicate, prefix) row.
//
// Replaces the TPU kernel online_convex_optimization_tpu/ops/pallas_admm.py
// _admm_kernel, entry admm_all_prefixes_l2.  Python wrapper, prologue and
// plain PyTorch version: online_convex_optimization_tpu_torch/ops/admm.py
// (admm_all_prefixes_l2, admm_prologue, admm_all_prefixes_l2_reference).
//
// Row (b, p) solves the length-(p + 1) prefix of replicate b:
//   minimize_{||x|| <= 1}  0.5 * sum_{t <= p} |<z_t, x> - y_t|
// by the TPU kernel's splitting (s = Z x - y with a soft threshold, w = x
// with the ball projection), over-relaxed by alpha.  Per iteration:
//   rhs_j = sum_t ((y_t + s_t) - u_t) z_tj + (w_j - v_j)
//   x     = (Gram_p + I)^{-1} rhs, by multiply-only substitutions through
//           the packed Cholesky factor with inverted diagonal (the prologue,
//           ops/admm.py::admm_prologue, forms it outside the kernel)
//   r_t = <x, z_t> - y_t, r^_t = alpha r_t + (1 - alpha) s_t
//   s_t = sign(r^_t + u_t) max(|r^_t + u_t| - kappa, 0), u_t += r^_t - s_t
//   x^ = alpha x + (1 - alpha) w, w = (x^ + v) / sqrt(max(||x^ + v||^2, 1)),
//   v = (v + x^) - w.
// Every check_every iterations (tol > 0) the row computes its residual
// max(max_t |r_t - s_t|, max_j |x_j - w_j|) and stops once it is not above
// tol (a NaN residual stops it too and is reported), after at most
// ceil(iters / check_every) blocks; tol = 0 runs exactly iters iterations.
// The TPU kernel exits per 256-row VMEM block; here each row exits on its
// own residual, and the plain version applies the same per-row rule.
//
// Design.  A block holds OCO_ADMM_WARPS rows of one replicate and stages
// that replicate's z (transposed, z_j[t]) and y in shared memory, (d + 1) T
// floats: 24 KB at T = 1000, d = 5.  Each lane keeps its share of the row's
// s and u in registers, NT = ceil(T_max / 32) of each, and touches only the
// entries below the row's length (they are 0 past it throughout, as in the
// TPU kernel, where the mask keeps them so).  The d partial sums of rhs go
// through a butterfly of warp shuffles, after which every lane holds the
// same sums (a + b == b + a in IEEE arithmetic), so every lane does the
// d x d substitution and the projection redundantly: no __syncthreads in
// the iteration loop.  The pass that updates s and u also accumulates the
// next iteration's rhs partial sums, in the same order a fresh pass would,
// so a continued solve equals a longer one bit for bit.  Blocks of the
// longest rows are scheduled first (blockIdx.y 0 holds them).
//
// Numerics: exact sqrt and a true divide in the projection, never rsqrt
// (pallas_admm.py:112-116: a ~1e-6 projection bias broke the polish's
// active-set identification); no tensor cores (bf16/TF32 dots stalled the
// TPU's residual at ~8e-2); --fmad=false.  Maxima propagate NaN and
// sign(NaN) = 0, as torch.maximum, amax, clamp and sign do in the plain
// version.
//
// What bounds it on an H100: operations.  About 4d + 16 float operations
// per active (row, t) entry per iteration, with d + 1 shared-memory loads;
// the state never leaves the chip while the row iterates (s and u are read
// and written once per launch).
#include <cuda_runtime.h>

#define OCO_ADMM_MAX_D 8
#define OCO_ADMM_MAX_T 1024
#define OCO_ADMM_WARPS 8

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int tri(int j, int k) { return j * (j + 1) / 2 + k; }

// max that propagates NaN from either side (torch.maximum).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// torch.sign: 0 at 0 and at NaN.
__device__ __forceinline__ float sgn(float a) {
  return a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f);
}

// torch.clamp(a, min=0): NaN stays NaN.
__device__ __forceinline__ float relu(float a) {
  return (a > 0.f || a != a) ? a : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int D>
struct Dim {
  static constexpr int cap = D > 0 ? D : OCO_ADMM_MAX_D;
  static constexpr int ntri = cap * (cap + 1) / 2;
};

// <x, z_t> summed in index order.
template <int D>
__device__ __forceinline__ float predict(const float* x, const float* zs,
                                         int T, int t, int n) {
  float q = x[0] * zs[t];
#pragma unroll
  for (int j = 1; j < Dim<D>::cap; ++j)
    if (j < n) q = q + x[j] * zs[j * T + t];
  return q;
}

// The row's residual max(max_t |r_t - s_t|, max_j |x_j - w_j|), the same on
// every lane.  Entries past the length hold r = s = 0.
template <int D, int NT>
__device__ __forceinline__ float residual(const float (&s)[NT],
                                          const float* x, const float* w,
                                          const float* zs, const float* ys,
                                          int T, int L, int n, int lane) {
  float pri = 0.f;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    if (k * 32 >= L) break;
    const int t = k * 32 + lane;
    if (t < L) {
      const float r = predict<D>(x, zs, T, t, n) - ys[t];
      pri = nan_max(pri, fabsf(r - s[k]));
    }
  }
  pri = warp_max(pri);
  float cons = fabsf(x[0] - w[0]);
#pragma unroll
  for (int j = 1; j < Dim<D>::cap; ++j)
    if (j < n) cons = nan_max(cons, fabsf(x[j] - w[j]));
  return nan_max(pri, cons);
}

template <int D, int NT>
__global__ void __launch_bounds__(32 * OCO_ADMM_WARPS)
admm_kernel(const float* __restrict__ z, const float* __restrict__ y,
            const float* __restrict__ Lpk, const float* __restrict__ s0,
            const float* __restrict__ u0, const float* __restrict__ x0,
            const float* __restrict__ w0, const float* __restrict__ v0,
            int T, int d, int iters, int check_every, float tol, float kappa,
            float alpha, float beta, float* __restrict__ s_out,
            float* __restrict__ u_out, float* __restrict__ x_out,
            float* __restrict__ w_out, float* __restrict__ v_out,
            float* __restrict__ res_out) {
  constexpr int C = Dim<D>::cap;
  extern __shared__ float smem[];
  const int n = D > 0 ? D : d;
  const int b = blockIdx.x;
  const int p0 = (gridDim.y - 1 - blockIdx.y) * OCO_ADMM_WARPS;
  const int t_need = min(T, p0 + OCO_ADMM_WARPS);
  float* zs = smem;           // zs[j * T + t] = z[b, t, j]
  float* ys = smem + n * T;   // ys[t] = y[b, t]
  const float* zb = z + static_cast<long long>(b) * T * n;
  for (int i = threadIdx.x; i < t_need * n; i += blockDim.x) {
    const int t = i / n;
    zs[(i - t * n) * T + t] = zb[i];
  }
  for (int t = threadIdx.x; t < t_need; t += blockDim.x)
    ys[t] = y[static_cast<long long>(b) * T + t];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int p = p0 + (threadIdx.x >> 5);
  if (p >= T) return;
  const int L = p + 1;
  const long long row = static_cast<long long>(b) * T + p;
  const int ntri = n * (n + 1) / 2;

  float Lf[Dim<D>::ntri];
#pragma unroll
  for (int k = 0; k < Dim<D>::ntri; ++k)
    Lf[k] = k < ntri ? Lpk[row * ntri + k] : 0.f;
  float s[NT], u[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int t = k * 32 + lane;
    const bool in = s0 != nullptr && t < L;
    s[k] = in ? s0[row * T + t] : 0.f;
    u[k] = in ? u0[row * T + t] : 0.f;
  }
  float x[C], w[C], v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const bool in = x0 != nullptr && j < n;
    x[j] = in ? x0[row * n + j] : 0.f;
    w[j] = in ? w0[row * n + j] : 0.f;
    v[j] = in ? v0[row * n + j] : 0.f;
  }

  // This lane's partial sums of rhs for the current state.
  float acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = 0.f;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    if (k * 32 >= L) break;
    const int t = k * 32 + lane;
    if (t < L) {
      const float ysu = (ys[t] + s[k]) - u[k];
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (j < n) acc[j] = acc[j] + ysu * zs[j * T + t];
    }
  }

  const bool checked = tol > 0.f;
  const int n_blocks = checked ? (iters + check_every - 1) / check_every
                               : (iters > 0 ? 1 : 0);
  const int per_block = checked ? check_every : iters;
  for (int blk = 0; blk < n_blocks; ++blk) {
    for (int it = 0; it < per_block; ++it) {
      // x-step: forward then backward substitution, multiply-only.
      float a[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (j < n) {
          float sj = warp_sum(acc[j]) + (w[j] - v[j]);
#pragma unroll
          for (int k = 0; k < j; ++k) sj = sj - Lf[tri(j, k)] * a[k];
          a[j] = sj * Lf[tri(j, j)];
        }
      }
#pragma unroll
      for (int j = C - 1; j >= 0; --j) {
        if (j < n) {
          float sj = a[j];
#pragma unroll
          for (int k = j + 1; k < C; ++k)
            if (k < n) sj = sj - Lf[tri(k, j)] * x[k];
          x[j] = sj * Lf[tri(j, j)];
        }
      }
      // Residual split: soft threshold, dual update, next rhs partials.
#pragma unroll
      for (int j = 0; j < C; ++j) acc[j] = 0.f;
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        if (k * 32 >= L) break;
        const int t = k * 32 + lane;
        if (t < L) {
          const float yt = ys[t];
          const float r = predict<D>(x, zs, T, t, n) - yt;
          const float rh = alpha * r + beta * s[k];
          const float sp = rh + u[k];
          const float sn = sgn(sp) * relu(fabsf(sp) - kappa);
          u[k] = (u[k] + rh) - sn;
          s[k] = sn;
          const float ysu = (yt + sn) - u[k];
#pragma unroll
          for (int j = 0; j < C; ++j)
            if (j < n) acc[j] = acc[j] + ysu * zs[j * T + t];
        }
      }
      // Ball split: over-relaxed projection onto the unit l2 ball.
      float xh[C], tv[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (j < n) {
          xh[j] = alpha * x[j] + beta * w[j];
          tv[j] = xh[j] + v[j];
        }
      }
      float n2 = tv[0] * tv[0];
#pragma unroll
      for (int j = 1; j < C; ++j)
        if (j < n) n2 = n2 + tv[j] * tv[j];
      const float nrm = sqrtf(nan_max(n2, 1.f));
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (j < n) {
          w[j] = tv[j] / nrm;
          v[j] = (v[j] + xh[j]) - w[j];
        }
      }
    }
    if (checked &&
        !(residual<D, NT>(s, x, w, zs, ys, T, L, n, lane) > tol))
      break;
  }

  const float res = residual<D, NT>(s, x, w, zs, ys, T, L, n, lane);
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int t = k * 32 + lane;
    if (t < T) {
      s_out[row * T + t] = t < L ? s[k] : 0.f;
      u_out[row * T + t] = t < L ? u[k] : 0.f;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j < n) {
        x_out[row * n + j] = x[j];
        w_out[row * n + j] = w[j];
        v_out[row * n + j] = v[j];
      }
    }
    res_out[row] = res;
  }
}

template <int D, int NT>
int launch_nt(const float* z, const float* y, const float* Lpk,
              const float* s0, const float* u0, const float* x0,
              const float* w0, const float* v0, int B, int T, int d,
              int iters, int check_every, float tol, float kappa,
              float alpha, float beta, float* s, float* u, float* x,
              float* w, float* v, float* res, cudaStream_t stream) {
  const dim3 grid(B, (T + OCO_ADMM_WARPS - 1) / OCO_ADMM_WARPS);
  const size_t smem = static_cast<size_t>(d + 1) * T * sizeof(float);
  admm_kernel<D, NT><<<grid, 32 * OCO_ADMM_WARPS, smem, stream>>>(
      z, y, Lpk, s0, u0, x0, w0, v0, T, d, iters, check_every, tol, kappa,
      alpha, beta, s, u, x, w, v, res);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const float* z, const float* y, const float* Lpk,
             const float* s0, const float* u0, const float* x0,
             const float* w0, const float* v0, int B, int T, int d,
             int iters, int check_every, float tol, float kappa, float alpha,
             float beta, float* s, float* u, float* x, float* w, float* v,
             float* res, cudaStream_t stream) {
  if (T <= 256)
    return launch_nt<D, 8>(z, y, Lpk, s0, u0, x0, w0, v0, B, T, d, iters,
                           check_every, tol, kappa, alpha, beta, s, u, x, w,
                           v, res, stream);
  if (T <= 512)
    return launch_nt<D, 16>(z, y, Lpk, s0, u0, x0, w0, v0, B, T, d, iters,
                            check_every, tol, kappa, alpha, beta, s, u, x, w,
                            v, res, stream);
  return launch_nt<D, 32>(z, y, Lpk, s0, u0, x0, w0, v0, B, T, d, iters,
                          check_every, tol, kappa, alpha, beta, s, u, x, w, v,
                          res, stream);
}

}  // namespace

// Inputs: z (B, T, d) and y (B, T) float32; Lpk (B*T, d(d+1)/2) the packed
// lower Cholesky factors of Gram_p + I with inverted diagonal, row b*T + p
// for the length-(p+1) prefix; the state s0, u0 (B*T, T) and x0, w0, v0
// (B*T, d), all five null for the zero state.  Outputs: the state after the
// solve, s, u (B*T, T) (zero past each row's length) and x, w, v (B*T, d),
// and res (B*T) the final residuals.  1 <= d <= 8, 1 <= T <= 1024,
// check_every >= 1.  Returns the cudaError_t of the launch.
extern "C" int oco_admm_all_prefixes_f32(
    const void* z, const void* y, const void* Lpk, const void* s0,
    const void* u0, const void* x0, const void* w0, const void* v0, int B,
    int T, int d, int iters, int check_every, float tol, float kappa,
    float alpha, float beta, void* s, void* u, void* x, void* w, void* v,
    void* res, void* stream) {
  if (B < 1 || T < 1 || T > OCO_ADMM_MAX_T || d < 1 ||
      d > OCO_ADMM_MAX_D || iters < 0 || check_every < 1)
    return cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto g = [](void* p) { return static_cast<float*>(p); };
  const auto st = static_cast<cudaStream_t>(stream);
  if (d == 5)
    return launch_d<5>(f(z), f(y), f(Lpk), f(s0), f(u0), f(x0), f(w0),
                       f(v0), B, T, d, iters, check_every, tol, kappa, alpha,
                       beta, g(s), g(u), g(x), g(w), g(v), g(res), st);
  return launch_d<0>(f(z), f(y), f(Lpk), f(s0), f(u0), f(x0), f(w0), f(v0),
                     B, T, d, iters, check_every, tol, kappa, alpha, beta,
                     g(s), g(u), g(x), g(w), g(v), g(res), st);
}
