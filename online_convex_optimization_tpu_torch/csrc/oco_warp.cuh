// The sums of the wide instances that play one sequence on a warp (K7w,
// K3w, K6aw).
//
// Lane l holds elements j = l + 32 m of the sequence's vectors.  A sum over
// j of products prod(j) is formed in index order, as the thread-a-sequence
// helpers (oco_common.cuh dot) form it, and so with the same bits: the
// lanes write the products of a chunk of at most kLine elements to the
// warp's product line in shared memory, and one lane adds the line in
// order, 16 bytes a read (a float4 in float32, a double2 in float64), from
// -0, the additive identity (so the first add gives the first product).
// Two independent sums can run side by side, lane 0 adding the one and
// lane 1 the other in the same instructions (warp_dot2): one chain of n
// adds where two in turn would take 2 n.  A lane writes the products of
// its own elements only (kLine / 2 is a multiple of 32), so a vector whose
// element j lane j % 32 alone writes needs no barrier but the line's.
// The plans of these launches share a block shape (WarpPlan), the block's
// shared-memory limit, the boundary search (max_shared_d) and the choice
// of warps a block (best_block).
#pragma once

#include "oco_tiles.cuh"

namespace oco {

// Elements between the two halves of a line that holds two sums: 16
// bytes, so that lane 0's and lane 1's 16-byte reads fall in different
// banks.
template <typename S>
constexpr int kLineGap = 16 / static_cast<int>(sizeof(S));

// Elements of a warp's product line for chunks of kLine products.
template <typename S, int kLine>
__host__ __device__ constexpr int line_elems() {
  static_assert(kLine % 64 == 0, "half a line is a multiple of 32");
  return kLine + kLineGap<S>;
}

// Two sums of one line.
template <typename S>
struct Sums2 {
  S x, y;
};

// acc + line[0] + ... + line[len - 1], added in index order, 16 bytes a
// read.
__device__ __forceinline__ float add_line(float acc, const float* line,
                                          int len) {
  int i = 0;
#pragma unroll 8
  for (; i + 4 <= len; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(line + i);
    acc = acc + v.x;
    acc = acc + v.y;
    acc = acc + v.z;
    acc = acc + v.w;
  }
  for (; i < len; ++i) acc = acc + line[i];
  return acc;
}

__device__ __forceinline__ double add_line(double acc, const double* line,
                                           int len) {
  int i = 0;
#pragma unroll 8
  for (; i + 2 <= len; i += 2) {
    const double2 v = *reinterpret_cast<const double2*>(line + i);
    acc = acc + v.x;
    acc = acc + v.y;
  }
  for (; i < len; ++i) acc = acc + line[i];
  return acc;
}

// add_line over exactly kLen elements (a whole chunk), unrolled in full so
// that the reads run ahead of the adds.
template <int kLen, typename S>
__device__ __forceinline__ S add_full_line(S acc, const S* line) {
  static_assert(kLen % 4 == 0, "a whole number of 16-byte reads");
  if constexpr (sizeof(S) == 4) {
#pragma unroll
    for (int i = 0; i < kLen; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(line + i);
      acc = acc + v.x;
      acc = acc + v.y;
      acc = acc + v.z;
      acc = acc + v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kLen; i += 2) {
      const double2 v = *reinterpret_cast<const double2*>(line + i);
      acc = acc + v.x;
      acc = acc + v.y;
    }
  }
  return acc;
}

// Writes line[i] = prod(c0 + i) for the lane's i = lane + 32 k < len, k <
// kPer.  With kBatch every product of the lane is formed before any is
// stored, so their shared-memory loads are in flight together (a store to
// the line may alias them, so the loop form waits a load latency an
// element); else one element at a time.  The sums below take kBatch too:
// with it a whole chunk's adds are unrolled in full (add_full_line).  K3w
// and K6aw sum with kBatch; K7w keeps the loop forms.
template <int kPer, bool kBatch, typename S, typename P>
__device__ __forceinline__ void put_products(S* line, int len, int lane,
                                             int c0, P&& prod) {
  if constexpr (kBatch) {
    S v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (lane + 32 * k < len) v[k] = prod(c0 + lane + 32 * k);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (lane + 32 * k < len) line[lane + 32 * k] = v[k];
  } else {
    for (int i = lane; i < len; i += 32) line[i] = prod(c0 + i);
  }
}

// The sum over elements 0 .. n - 1 of prod(j) in index order from -0: a
// chunk of at most kLine products at a time written to the line (16-byte
// aligned, line_elems<S, kLine>() elements; put_products), lane 0 adding
// it; every lane gets the sum.
template <int kLine, bool kBatch = false, typename S, typename P>
__device__ __forceinline__ S warp_dot(S* line, int n, int lane, P&& prod) {
  S acc = S(-0.0);
  for (int c0 = 0; c0 < n; c0 += kLine) {
    const int len = min(kLine, n - c0);
    put_products<kLine / 32, kBatch>(line, len, lane, c0, prod);
    __syncwarp();
    if (lane == 0) {
      if constexpr (kBatch)
        acc = len == kLine ? add_full_line<kLine>(acc, line)
                           : add_line(acc, line, len);
      else
        acc = add_line(acc, line, len);
    }
    __syncwarp();
  }
  return __shfl_sync(kFullMask, acc, 0);
}

// The two sums over elements 0 .. n - 1 of pa(j) and of pb(j), each in
// index order from -0, side by side: chunks of kLine / 2 elements, the
// lanes writing pa's products to the line's first half and pb's to its
// second, kLineGap elements further on, lane 0 adding the first while
// lane 1 adds the second; every lane gets both sums.
template <int kLine, bool kBatch = false, typename S, typename PA,
          typename PB>
__device__ __forceinline__ Sums2<S> warp_dot2(S* line, int n, int lane,
                                              PA&& pa, PB&& pb) {
  constexpr int kHalf = kLine / 2;
  constexpr int kSecond = kHalf + kLineGap<S>;
  S acc = S(-0.0);
  const S* mine = line + (lane == 1 ? kSecond : 0);
  for (int c0 = 0; c0 < n; c0 += kHalf) {
    const int len = min(kHalf, n - c0);
    if constexpr (kBatch) {
      constexpr int kPer = kHalf / 32;
      S va[kPer], vb[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (lane + 32 * k < len) {
          va[k] = pa(c0 + lane + 32 * k);
          vb[k] = pb(c0 + lane + 32 * k);
        }
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (lane + 32 * k < len) {
          line[lane + 32 * k] = va[k];
          line[kSecond + lane + 32 * k] = vb[k];
        }
      }
    } else {
      for (int i = lane; i < len; i += 32) {
        line[i] = pa(c0 + i);
        line[kSecond + i] = pb(c0 + i);
      }
    }
    __syncwarp();
    if (lane < 2) {
      if constexpr (kBatch)
        acc = len == kHalf ? add_full_line<kHalf>(acc, mine)
                           : add_line(acc, mine, len);
      else
        acc = add_line(acc, mine, len);
    }
    __syncwarp();
  }
  return {__shfl_sync(kFullMask, acc, 0), __shfl_sync(kFullMask, acc, 1)};
}

// Rounds a count of elements up to a multiple of 4.
__host__ __device__ inline long long up4(long long v) {
  return (v + 3) & ~3LL;
}

// ------------------------------------------------------------ the plans

// The shared memory a block may take on an H100 (227 KB).
constexpr long long kBlockSmem = 232448;

// Block shape of a launch that plays a sequence on a warp: warps a block,
// bytes of dynamic shared memory a block, whether the sequence's vectors
// lie in shared memory, elements of the state buffer a sequence (0 where
// shared).
struct WarpPlan {
  int warps;
  long long smem;
  bool shared;
  long long state;
};

// The largest d (at most 2^20) whose block fits kBlockSmem with the
// vectors in shared memory, where bytes(d), which grows with d, is the
// shared memory of that block.
template <typename F>
inline int max_shared_d(F&& bytes) {
  int lo = 1, hi = 1 << 20;
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (bytes(mid) <= kBlockSmem)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// p->warps and p->smem: the warps a block, 1 .. max_warps, each taking
// warp_bytes of shared memory, that keep the most warps of `kernel`
// resident an SM (the fewest on a tie), from the card's occupancy
// calculator.  Returns the cudaError_t.
template <typename K>
inline int best_block(K kernel, int max_warps, long long warp_bytes,
                      WarpPlan* p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBlockSmem));
  int best = 0;
  for (int wb = 1; wb <= max_warps && err == cudaSuccess; ++wb) {
    const long long smem = wb * warp_bytes;
    if (smem > kBlockSmem) break;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, wb * 32, static_cast<size_t>(smem));
    if (err == cudaSuccess && blocks * wb > best) {
      best = blocks * wb;
      p->warps = wb;
      p->smem = smem;
    }
  }
  if (err == cudaSuccess && best == 0) err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace oco
