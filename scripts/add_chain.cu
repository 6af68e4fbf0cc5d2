// A chain of dependent adds on one thread, timed with the SM's cycle
// counter: the latency that a one-lane line sum (csrc/oco_warp.cuh) pays
// an element.  scripts/wide_d_probe.py --cases adds builds it with the
// library's nvcc flags (--fmad=false, no fast math, so no add is folded or
// reassociated) and calls oco_add_chain through ctypes.
template <typename S>
__global__ void add_chain(const S* c, long long n, S* sink,
                          long long* clocks) {
  S a = c[0];
  const S b = c[1];
  const long long t0 = clock64();
  for (long long i = 0; i < n; i += 64) {
#pragma unroll
    for (int k = 0; k < 64; ++k) a = a + b;
  }
  const long long t1 = clock64();
  sink[0] = a;
  clocks[0] = t1 - t0;
}

// c: two values of the type (float64 where f64, else float32), the start
// and the addend; n adds, a multiple of 64; sink: one value of the type;
// clocks: one int64, the SM cycles of the chain.  One thread on one SM.
// Returns the cudaError_t of the launch.
extern "C" int oco_add_chain(int f64, const void* c, long long n, void* sink,
                             void* clocks, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* ck = static_cast<long long*>(clocks);
  if (f64)
    add_chain<double><<<1, 1, 0, s>>>(static_cast<const double*>(c), n,
                                      static_cast<double*>(sink), ck);
  else
    add_chain<float><<<1, 1, 0, s>>>(static_cast<const float*>(c), n,
                                     static_cast<float*>(sink), ck);
  return static_cast<int>(cudaGetLastError());
}
