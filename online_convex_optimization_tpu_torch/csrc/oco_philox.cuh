// Philox4x32-10 (Salmon et al., SC 2011), the counter-based bit generator of
// kernel K7 (csrc/synthetic_kernel.cu), written out by hand.  The plain
// version ops/philox.py computes the same function on int64 tensors, so the
// kernel and its plain version draw the same bits.
//
// Ten rounds; each multiplies two counter words by the Philox constants,
// keeping both 32-bit halves of the products, and xors the high halves with
// the other two words and the round key; the key is bumped by the Weyl
// constants between rounds.  An output word the caller never reads is
// dead code after inlining, and so is all the work only it needs.
#pragma once

#include <cuda_runtime.h>

namespace oco {

struct Philox4 {
  unsigned int w[4];
};

// The ten round keys of a 64-bit key: k0[i] = (key mod 2^32) + i * W0 and
// k1[i] = (key >> 32) + i * W1, mod 2^32.  They depend on the key alone,
// so the wrapper forms them on the host (ops/philox.py round_keys) and
// the kernel takes them as a parameter: they sit in the constant bank,
// where LOP3 reads them as operands, and cost no register and no add a
// call.  (Formed once a thread in registers instead, they made K7 3.8%
// slower than bumping them in each call; PERF.md.)
struct PhiloxKeys {
  unsigned int k0[10], k1[10];
};

__device__ __forceinline__ Philox4 philox4x32_10(unsigned int c0,
                                                 unsigned int c1,
                                                 unsigned int c2,
                                                 unsigned int c3,
                                                 const PhiloxKeys& key) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned int hi0 = __umulhi(0xD2511F53u, c0);
    const unsigned int lo0 = 0xD2511F53u * c0;
    const unsigned int hi1 = __umulhi(0xCD9E8D57u, c2);
    const unsigned int lo1 = 0xCD9E8D57u * c2;
    const unsigned int n0 = hi1 ^ c1 ^ key.k0[i];
    const unsigned int n2 = hi0 ^ c3 ^ key.k1[i];
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
