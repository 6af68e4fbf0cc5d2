// Staged rows for the sweeps (K5, K6a, K6b) and the cp.async helpers that
// K4's ring also uses.
//
// A sweep block serves 32 sequences, one a lane, in the caller's (B, T, d)
// / (B, T) layout, and one or more setting-warps: every warp of the block
// plays the same 32 sequences, each with its own setting.  The block stages
// a chunk of `chunk` rounds of its 32 sequences' rows in shared memory with
// cp.async, into a ring of kTileStages stages, and every warp reads its
// rows from there: the rows cross L2 once per block, not once per setting.
//
// Layout of a stage: 32 slots of `slot` words, lane s's slot holding its
// sequence's chunk as the caller stores it (z_0..z_{n-1} of each round,
// round after round, then the chunk's labels), then `scale_rows` rows of
// `chunk` FTRL scales: one a warp where each warp has its own setting (K5),
// one that every warp reads where they share it (K6b, a scalar eta).  The
// warps a block and the bytes a stage are each kernel's constants; the
// chunk follows from them, d and the dtype.  A sequence's chunk is
// contiguous in global memory, so the copy of a slot is coalesced across
// the lanes of the copying warp; `slot` is odd, so the 32 lanes reading
// element k of their own slots hit 32 different banks.
//
// The large-d instance (D == -1, d > 64), whose rows do not fit a stage,
// reads each row from global memory as it plays it (play_rows_global).
#pragma once

#include <climits>

#include "oco_common.cuh"

namespace oco {

constexpr unsigned kFullMask = 0xffffffffu;

// Two stages: the next chunk's copy overlaps the current chunk's rounds,
// which take far longer than the copy (thousands of clocks a chunk).
constexpr int kTileStages = 2;

template <typename S>
__device__ __forceinline__ void copy_async(S* dst, const S* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(addr),
               "l"(src), "n"(static_cast<int>(sizeof(S)))
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Most rounds a stage holds: a chunk's barrier and copies then cost a
// small share of its rounds.
constexpr int kMaxChunk = 64;

// Shape of a block's tile ring, fixed by the host for one launch.
struct TileShape {
  int n;           // features a row
  int chunk;       // rounds a stage
  int slot;        // words a lane's slot: chunk * (n + 1), made odd
  int warps;       // setting-warps a block
  int scale_rows;  // rows of scales a stage: warps, or 1 (shared)
  __host__ __device__ int stage_words() const {
    return 32 * slot + scale_rows * chunk;
  }
};

// The shape of `warps` warps a block whose stage holds at most stage_bytes
// of the 32 sequences' rows (1 to kMaxChunk rounds of them).
template <typename S>
inline TileShape tile_shape(int n, int warps, size_t stage_bytes,
                            int scale_rows) {
  const size_t fit = stage_bytes / (32 * (n + 1) * sizeof(S));
  const int chunk = static_cast<int>(
      fit < 1 ? 1 : (fit > kMaxChunk ? kMaxChunk : fit));
  return {n, chunk, (chunk * (n + 1)) | 1, warps, scale_rows};
}

// Bytes of the ring for one launch (none for the large-d instance).
template <typename S, int D>
inline size_t ring_bytes(const TileShape& ts) {
  return D < 0 ? 0
               : static_cast<size_t>(kTileStages) * ts.stage_words() *
                     sizeof(S);
}

// Launches kernel<<<grid, threads, smem, stream>>>(args...), first raising
// the kernel's dynamic shared memory limit where smem exceeds 48 KB;
// returns the cudaError_t of the attribute call or of the launch.
template <typename K, typename... A>
inline int launch_with_smem(K kernel, unsigned grid, int threads, size_t smem,
                            cudaStream_t stream, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Plays rounds [lo, hi) of sequence b through fn(t, zr, y_t, scale), in
// order, each thread reading its own rows from global memory, with scale =
// scale_row[t] (0 where scale_row is null).  The instances with registers
// for two rows (D >= 0) load round t + 1's row before they play round t,
// so the load's latency overlaps a round.
template <typename S, int D, typename F>
__device__ __forceinline__ void play_rows_global(
    const S* __restrict__ z, const S* __restrict__ y,
    const S* __restrict__ scale_row, long long b, long long T, int n, int lo,
    int hi, F&& fn) {
  S zr[Cap<D>::value];
  const auto load = [&](int t, S* row, S& yt, S& scale) {
    const S* src = z + (b * T + t) * n;
#pragma unroll
    for (int j = 0; j < n; ++j) row[j] = src[j];
    yt = y[b * T + t];
    scale = scale_row != nullptr ? scale_row[t] : S(0);
  };
  S yt, scale;
  if constexpr (D < 0) {
    for (int t = lo; t < hi; ++t) {
      load(t, zr, yt, scale);
      fn(t, static_cast<const S*>(zr), yt, scale);
    }
  } else {
    S next[Cap<D>::value], y_next, scale_next;
    if (lo < hi) load(lo, next, y_next, scale_next);
    for (int t = lo; t < hi; ++t) {
#pragma unroll
      for (int j = 0; j < n; ++j) zr[j] = next[j];
      yt = y_next;
      scale = scale_next;
      if (t + 1 < hi) load(t + 1, next, y_next, scale_next);
      fn(t, static_cast<const S*>(zr), yt, scale);
    }
  }
}

// Plays rounds [lo, hi) of this lane's sequence b (b < 0: none) through
// fn(t, zr, y_t, scale), in order, with scale = scale_row[t] (scale_row may
// be null, and then scale is unspecified).  Where ts.scale_rows is 1, warp
// 0's scale_row is staged once and every warp reads it.  Every thread of
// the block must call it with the same z, y, T and ts: the staged instances
// hold barriers.  They copy only the chunks that some thread of the block
// plays, and call chunk_fn(t0, slot, R) once a chunk, before its rounds,
// with the lane's slot of the staged chunk (round k's row at slot[k * n],
// its label at slot[chunk * n + k]) that starts at round t0 and holds R
// rounds.
template <typename S, int D, typename F, typename G>
__device__ __forceinline__ void play_rows(const S* __restrict__ z,
                                          const S* __restrict__ y,
                                          const S* __restrict__ scale_row,
                                          long long b, long long T,
                                          const TileShape& ts, int lo, int hi,
                                          S* ring, F&& fn, G&& chunk_fn) {
  const int n = D > 0 ? D : ts.n;
  if constexpr (D < 0) {
    play_rows_global<S, D>(z, y, scale_row, b, T, n, lo, hi, fn);
  } else {
    S zr[Cap<D>::value];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // The block's chunks: from the first round any thread plays to the last.
    __shared__ int first, last;
    if (threadIdx.x == 0) {
      first = INT_MAX;
      last = 0;
    }
    __syncthreads();
    if (lo < hi) {
      atomicMin(&first, lo);
      atomicMax(&last, hi);
    }
    __syncthreads();
    const int c_hi = (last + ts.chunk - 1) / ts.chunk;
    const int c_lo = first == INT_MAX ? c_hi : first / ts.chunk;
    const auto stage = [&](int c) {
      return ring + (c % kTileStages) * ts.stage_words();
    };
    const auto rounds = [&](int c) {
      return static_cast<int>(min(static_cast<long long>(ts.chunk),
                                  T - static_cast<long long>(c) * ts.chunk));
    };
    // Warp w copies the slots w, w + warps, ..., and its row of scales.
    const auto issue = [&](int c) {
      const long long t0 = static_cast<long long>(c) * ts.chunk;
      const int R = rounds(c);
      S* st = stage(c);
      for (int s = warp; s < 32; s += ts.warps) {
        const long long bs = __shfl_sync(kFullMask, b, s);
        if (bs < 0) continue;
        S* dst = st + s * ts.slot;
        const S* zs = z + (bs * T + t0) * n;
        for (int o = lane; o < R * n; o += 32) copy_async(dst + o, zs + o);
        const S* ys = y + bs * T + t0;
        for (int o = lane; o < R; o += 32)
          copy_async(dst + ts.chunk * n + o, ys + o);
      }
      if (scale_row != nullptr && warp < ts.scale_rows) {
        S* sc = st + 32 * ts.slot + warp * ts.chunk;
        for (int o = lane; o < R; o += 32)
          copy_async(sc + o, scale_row + t0 + o);
      }
    };
    // One copy group a chunk, empty past the last, so that chunk c's group
    // is complete once at most kTileStages - 2 newer ones are pending.
#pragma unroll
    for (int i = 0; i < kTileStages - 1; ++i) {
      if (c_lo + i < c_hi) issue(c_lo + i);
      commit_copies();
    }
    for (int c = c_lo; c < c_hi; ++c) {
      wait_copies<kTileStages - 2>();
      // Chunk c has landed for every thread, and every thread is done with
      // chunk c - 1, whose stage the next copy refills.
      __syncthreads();
      if (c + kTileStages - 1 < c_hi) issue(c + kTileStages - 1);
      commit_copies();
      const int t0 = c * ts.chunk;
      const int k_lo = max(lo - t0, 0), k_hi = min(hi - t0, rounds(c));
      const S* st = stage(c);
      const S* row = st + lane * ts.slot;
      chunk_fn(t0, row, rounds(c));
      // Round k's row, label and scale, stepped through by pointer.
      const S* label = row + ts.chunk * n + k_lo;
      const S* scale =
          st + 32 * ts.slot + (warp % ts.scale_rows) * ts.chunk + k_lo;
      row += k_lo * n;
      for (int t = t0 + k_lo; t < t0 + k_hi; ++t) {
#pragma unroll
        for (int j = 0; j < n; ++j) zr[j] = row[j];
        fn(t, static_cast<const S*>(zr), *label, *scale);
        row += n;
        ++label;
        ++scale;
      }
    }
  }
}

// A chunk_fn for play_rows that does nothing.
struct NoChunkPass {
  template <typename S>
  __device__ void operator()(int, const S*, int) const {}
};

// Final comparator loss 0.5 * sum_{t < len} |<z_t, x> - y_t| replayed over
// sequence b's rows in the (B, T, d) layout (the sweeps' replay mode).
template <typename S, int D>
__device__ __forceinline__ S replay_comparator_rows(const S* __restrict__ z,
                                                   const S* __restrict__ y,
                                                   long long b, long long T,
                                                   int n, int len,
                                                   const S* x) {
  S comp = S(0);
  for (int t = 0; t < len; ++t) {
    const S q = dot<S, D>(z + (b * T + t) * n, x, n);
    comp = comp + S(0.5) * oabs(q - y[b * T + t]);
  }
  return comp;
}

}  // namespace oco
