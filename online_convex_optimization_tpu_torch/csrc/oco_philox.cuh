// Philox4x32-10 (Salmon et al., SC 2011), the counter-based bit generator of
// kernel K7 (csrc/synthetic_kernel.cu), written out by hand.  The plain
// version ops/philox.py computes the same function on int64 tensors, so the
// kernel and its plain version draw the same bits.
//
// Ten rounds; each multiplies two counter words by the Philox constants,
// keeping both 32-bit halves of the products, and xors the high halves with
// the other two words and the round key; the key is bumped by the Weyl
// constants between rounds.
#pragma once

#include <cuda_runtime.h>

namespace oco {

struct Philox4 {
  unsigned int w[4];
};

// The round keys depend on the key alone.  Forming all ten once a thread
// (in registers, outside K7's round loop) made K7 slower on an H100 than
// bumping them here, where the compiler schedules the adds itself (PERF.md).
__device__ __forceinline__ Philox4 philox4x32_10(unsigned int c0,
                                                 unsigned int c1,
                                                 unsigned int c2,
                                                 unsigned int c3,
                                                 unsigned long long key) {
  unsigned int k0 = static_cast<unsigned int>(key);
  unsigned int k1 = static_cast<unsigned int>(key >> 32);
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned int hi0 = __umulhi(0xD2511F53u, c0);
    const unsigned int lo0 = 0xD2511F53u * c0;
    const unsigned int hi1 = __umulhi(0xCD9E8D57u, c2);
    const unsigned int lo1 = 0xCD9E8D57u * c2;
    const unsigned int n0 = hi1 ^ c1 ^ k0;
    const unsigned int n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Philox4{{c0, c1, c2, c3}};
}

// Bit j (0 <= j < 128) of a Philox output: word j / 32, bit j % 32.
__device__ __forceinline__ unsigned int philox_bit(const Philox4& r, int j) {
  return (r.w[j >> 5] >> (j & 31)) & 1u;
}

}  // namespace oco
