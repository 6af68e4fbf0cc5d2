// The sums of the wide instances that play one sequence (or one play or
// tail of it) on a warp (K7w, K3w, K3ew, K4w, K6aw, K6bw, K1w), and the
// time-major tiles of K3w, K3ew and K4w.
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

#include <type_traits>

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

// An FTRL round's q = <z_t, x> for the action x = sc theta, projected iff
// ||x||^2 > 1 (ftrl_action_scaled, then hinge_step's dot): ||x||^2 and
// <z_t, x> side by side, and <z_t, f x> again, f = 1 / sqrt(||x||^2),
// only where the round projects.  z(j) is element j of z_t; f is set to
// the action's factor (1 where it does not project), so that x_j is
// f * (sc * theta_j) there and sc * theta_j elsewhere.
template <int kLine, typename S, typename Z>
__device__ __forceinline__ S ftrl_q(S* line, int n, int lane, S sc,
                                    const S* th, Z&& z, S& f, bool& proj) {
  const auto sums = warp_dot2<kLine, true>(
      line, n, lane,
      [&](int j) {
        const S x = sc * th[j];
        return x * x;
      },
      [&](int j) { return z(j) * (sc * th[j]); });
  proj = sums.x > S(1);
  f = S(1);
  if (!proj) return sums.y;
  f = S(1) / osqrt(sums.x);
  return warp_dot<kLine, true>(line, n, lane, [&](int j) {
    return z(j) * (f * (sc * th[j]));
  });
}

// The FTL action's scale s = -1 / ||theta|| (0 at theta == 0), x = s theta
// (ftl_action).
template <int kLine, typename S>
__device__ __forceinline__ S ftl_scale(S* line, int n, int lane,
                                       const S* th) {
  const S nsq = warp_dot<kLine, true>(
      line, n, lane, [&](int j) { return th[j] * th[j]; });
  return nsq > S(0) ? -(S(1) / osqrt(nsq)) : S(0);
}

// Rounds a count of elements up to a multiple of 4.
__host__ __device__ inline long long up4(long long v) {
  return (v + 3) & ~3LL;
}

// ---------------------------------------------- time-major tiles (K3w, K4w)
//
// A block that plays W = 32 / sizeof(z element) consecutive sequences of
// the time-major (T, d, B) rows, a warp each (8 in f32, 16 in bf16, 4 in
// f64), reads one 32-byte sector of z at each (t, j).  It copies round
// t + 1's d x W tile into a shared stage with cp.async while it plays
// round t (two stages, one barrier a round), so each row crosses L2 once a
// block.  The stage is transposed on the way in: unit q of row j's window
// (a 4-byte word, or the f64 element) lands in column q at j, so warp w
// reads its sequence's elements j = l + 32 m as neighbouring words, with
// no bank conflict (a sector's 32 bytes copied whole would put every
// lane's element in 4 banks).

// Sequences (warps) a block: one 32-byte sector of elements a (t, j).
template <typename Z>
constexpr int kTileWarps = 32 / static_cast<int>(sizeof(Z));

// The unit a stage copies: the element in f64, else a 4-byte word (a bf16
// pair in bf16), and the units of a row's window: the block's W elements,
// and one more where a unit holds two (the first may lie in its second
// half).
template <typename Z>
using TileUnit =
    std::conditional_t<sizeof(Z) == 8, unsigned long long, unsigned>;
template <typename Z>
constexpr int kTileUnits =
    static_cast<int>(kTileWarps<Z> * sizeof(Z) / sizeof(TileUnit<Z>)) +
    (sizeof(Z) < sizeof(TileUnit<Z>) ? 1 : 0);

// Units between two columns of a stage: d rounded up to 32, and 4 more,
// so that a copying warp's 32 units (4 rows of 8 columns in f32) fall in
// 32 banks.
__host__ __device__ inline long long tile_pitch(int d) {
  return ((d + 31LL) & ~31LL) + 4;
}

template <typename Z>
__host__ __device__ inline long long tile_stage_bytes(int d) {
  return kTileUnits<Z> * tile_pitch(d) *
         static_cast<long long>(sizeof(TileUnit<Z>));
}

// The stages of the block of sequences b0 .. b0 + W - 1 (the last block
// may hold fewer, nb) of the time-major rows z, as the block's threads
// copy and its warps read them.
template <typename Z, typename S = compute_t<Z>>
struct TimeMajorTile {
  using U = TileUnit<Z>;
  static constexpr int W = kTileWarps<Z>, Q = kTileUnits<Z>;
  // Rows a pass of the block's copies covers, a thread taking unit q.
  static constexpr int R = 32 * W / Q;
  const Z* z;
  long long B, b0, pitch;
  int n, nb, q0, j0;
  // bf16: the parity of z's half-word address, and whether B is odd.
  int z_half;
  bool odd_b;

  __device__ TimeMajorTile(const Z* z_, long long B_, long long b0_, int n_)
      : z(z_), B(B_), b0(b0_), pitch(tile_pitch(n_)), n(n_),
        nb(static_cast<int>(min(static_cast<long long>(W), B_ - b0_))),
        q0(threadIdx.x % Q), j0(threadIdx.x / Q),
        z_half(static_cast<int>(
            (reinterpret_cast<unsigned long long>(z_) >> 1) & 1)),
        odd_b((B_ & 1) != 0) {}

  // Round t's tile into a stage: unit q of row j's window, the aligned
  // units around the block's elements z[t, j, b0 .. b0 + nb), at column
  // q, row j.  A unit holds an element of the row, so it lies in that
  // element's page.
  __device__ __forceinline__ void fetch(long long t, U* stage) const {
    if (j0 >= R) return;
    const Z* first = z + (t * n + j0) * B + b0;
    for (int j = j0; j < n; j += R, first += R * B) {
      const auto a = reinterpret_cast<unsigned long long>(first);
      const int off = static_cast<int>(a & (sizeof(U) - 1));
      if (q0 * static_cast<int>(sizeof(U)) <
          off + nb * static_cast<int>(sizeof(Z)))
        copy_async(stage + q0 * pitch + j,
                   reinterpret_cast<const U*>(a & ~(sizeof(U) - 1)) + q0);
    }
  }

  // Element j of sequence b0 + col's row t in a stage.  In bf16 a row's
  // window starts at its first element or at the one before it, as that
  // element's address is 4-byte aligned or not: the parity of z's
  // half-word address and, where B is odd, of t n + j (b0 is even).
  __device__ __forceinline__ S at(const U* stage, long long t, int j,
                                  int col) const {
    if constexpr (sizeof(Z) == sizeof(U)) {
      return S(widen(reinterpret_cast<const Z*>(stage + col * pitch)[j]));
    } else {
      // bf16: element `col` is half e & 1 of unit e >> 1.
      const int e = (z_half ^ (odd_b && ((t * n + j) & 1))) + col;
      const unsigned u = stage[(e >> 1) * pitch + j];
      return S(widen(bf16{static_cast<unsigned short>(u >> (16 * (e & 1)))}));
    }
  }
};

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
