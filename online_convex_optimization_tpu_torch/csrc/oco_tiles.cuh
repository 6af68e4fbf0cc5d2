// Staged rows for the sweeps (K5, K6b), the regret game (K1) and SMART
// (K2), and the cp.async helpers that K4's ring also uses.
//
// A block serves 32 sequences, one a lane, in the caller's (B, T, d) /
// (B, T) layout, and one or more warps: every warp of the block plays the
// same 32 sequences, each with its own setting (K5, K6b: play_rows), play
// (K1) or role (K2: the FTL track, or a threshold's FTRL tails;
// play_chunks).  The block stages a chunk of `chunk` rounds of its 32
// sequences' rows in shared memory with cp.async, into a ring of stages,
// and every warp reads its rows from there: the rows cross L2 once per
// block, not once per warp, and no load sits in a round's chain.
//
// Layout of a stage: 32 slots of `slot` words, lane s's slot holding its
// sequence's chunk as the caller stores it (z_0..z_{n-1} of each round,
// round after round, then the chunk's labels), then `scale_rows` rows of
// `chunk` FTRL scales: one a warp where each warp has its own setting (K5),
// one that every warp reads where they share it (K6b, a scalar eta), none
// where each lane reads its own row of the table a round ahead (K1, K2:
// ScaleAhead).  The warps a block and the bytes a stage are each kernel's
// constants; the chunk follows from them, d and the dtype.  A sequence's
// chunk is contiguous in global memory, so the copy of a slot is coalesced
// across the lanes of the copying warp; `slot` is odd, so the 32 lanes
// reading element k of their own slots hit 32 different banks.
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

// Registers a thread (out[0]) and resident warps an SM (out[1]) of a
// launch of `kernel` with `threads` threads and `smem` bytes of dynamic
// shared memory a block on the current card; returns the cudaError_t.
template <typename K>
inline int occupancy(K kernel, int threads, size_t smem, int* out) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  out[0] = err == cudaSuccess ? attr.numRegs : 0;
  out[1] = blocks * threads / 32;
  return static_cast<int>(err);
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

// ------------------------------------------------- bulk-copied chunks
// K1's and K2's blocks have one to five warps, too few to spread the
// cp.async copies of 32 slots a chunk over (each warp would issue about a
// hundred 8-byte copies a chunk in its own instruction stream, between its
// rounds).  Their stages are filled by the Tensor Memory Accelerator
// instead: lane s of warp 0 copies its own sequence's rows and labels of a
// chunk with two cp.async.bulk copies, which complete on the stage's
// mbarrier, so a chunk costs the block a few instructions.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrives on bar, first raising the bytes its phase waits for by bytes.
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the phase of bar with the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copies bytes (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shape of a block's ring of bulk-copied chunks, fixed by the host for one
// launch.  Lane s's slot of a stage holds the 16-byte aligned window of
// global memory around its sequence's rows of the chunk (zw elements), then
// the window around their labels (yw elements); the lane finds its rows at
// the offset of their first address within the window.  A slot is a
// multiple of 16 bytes and an odd multiple of 16, so that the lanes' 8-byte
// reads fall on at most two of a bank's words.
struct ChunkShape {
  int n;      // features a row
  int chunk;  // rounds a stage
  int zw;     // elements of a slot's row window
  int slot;   // elements a slot: the row window, then the label window
  __host__ __device__ int stage_words() const { return 32 * slot; }
};

// The shape of a ring whose stage holds about stage_bytes of the 32
// sequences' rows (1 to kMaxChunk rounds of them; kMaxChunk for the large-d
// instance, which stages nothing).
template <typename S, int D>
inline ChunkShape chunk_shape(int n, size_t stage_bytes) {
  const size_t fit =
      D < 0 ? kMaxChunk : stage_bytes / (32 * (n + 1) * sizeof(S));
  const int chunk = static_cast<int>(
      fit < 1 ? 1 : (fit > kMaxChunk ? kMaxChunk : fit));
  const auto window = [](size_t bytes) {
    return static_cast<int>(((bytes + 15) / 16 + 1) * 16 / sizeof(S));
  };
  const int zw = window(chunk * n * sizeof(S));
  int slot = zw + window(chunk * sizeof(S));
  if (slot * sizeof(S) % 32 == 0) slot += 16 / sizeof(S);
  return {n, chunk, zw, slot};
}

// Bytes of play_chunks' mbarriers (three a stage), 16-byte aligned.
__host__ __device__ constexpr size_t chunk_bars_bytes(int stages) {
  return 16 * ((stages * 3 * 8 + 15) / 16);
}

// Bytes of a ring of `stages` stages and their mbarriers (the large-d
// instance stages nothing, and keeps the mbarriers).
template <typename S, int D>
inline size_t chunk_ring_bytes(const ChunkShape& cs, int stages) {
  return chunk_bars_bytes(stages) +
         (D < 0 ? 0
                : static_cast<size_t>(stages) * cs.stage_words() * sizeof(S));
}

// A warp's part in play_chunks.
enum class ChunkRole {
  kProducer,  // fills the stages; plays nothing
  kLead,      // plays each chunk once it has landed
  kTrail,     // plays each chunk once it has landed and the leads have
              // played it (K2's FTRL tails, which read what the FTL warp
              // published while it played the chunk)
};

// Plays the rounds of this lane's sequence b (b < 0: none) chunk by chunk
// through fn(t, zr, y_t), in order, for blocks whose warps all serve the
// same 32 sequences, lane s of every warp sequence blockIdx.x * 32 + s (K1's
// plays, K2's FTL and FTRL warps), over a ring of kStages bulk-copied
// stages in `smem` (chunk_ring_bytes): a warp-specialised pipeline with no
// block barrier after the first.  The block's last warp is the producer:
// lane s copies its sequence's rows and labels of chunk c into stage
// c % kStages once every consumer warp has released the chunk that stage
// held, and the copies complete on the stage's `full` mbarrier.  A consumer
// warp waits on `full`, plays the chunk, and releases it on `empty`; a lead
// warp also marks it `done`, and a trail warp waits for that before it
// plays.  lo_of(t1) is called before each chunk [t0, t1) a consumer plays
// and returns the lane's first round (rounds [lo, hi) are played; lo may
// grow as a trail warp learns it).  z and y hold B * T rows and labels: a
// window that would run past their end is cut at its last 16-byte boundary
// and the lane copies the rest itself.  Every thread of the block must
// call it once, with the same z, y, B, T and cs, and `leads` and
// `consumers` (warps) the same.  The large-d instance (D == -1) stages
// nothing: it passes fn its global row, and keeps the pipeline's barriers
// only to order the trail after the leads.
template <typename S, int D, int kStages, typename Lo, typename F>
__device__ __forceinline__ void play_chunks(
    const S* __restrict__ z, const S* __restrict__ y, long long b,
    long long B, long long T, const ChunkShape& cs, int hi, ChunkRole role,
    int leads, int consumers, unsigned char* smem, Lo&& lo_of, F&& fn) {
  const int n = D > 0 ? D : cs.n;
  const int lane = threadIdx.x & 31;
  // Three mbarriers a stage: full, empty, done.
  auto* bars = reinterpret_cast<unsigned long long*>(smem);
  const auto full = [&](int c) { return &bars[3 * (c % kStages)]; };
  const auto empty = [&](int c) { return &bars[3 * (c % kStages) + 1]; };
  const auto done = [&](int c) { return &bars[3 * (c % kStages) + 2]; };
  S* ring = reinterpret_cast<S*>(smem + chunk_bars_bytes(kStages));
  // The block's chunks: up to the last round any thread plays.
  __shared__ int last;
  if (threadIdx.x == 0) {
    last = 0;
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 32);
      mbar_init(empty(i), 32 * consumers);
      mbar_init(done(i), 32 * leads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (hi > 0) atomicMax(&last, hi);
  __syncthreads();
  const int chunks = (last + cs.chunk - 1) / cs.chunk;
  const auto stage = [&](int c) {
    return ring + (c % kStages) * cs.stage_words();
  };
  const auto aligned = [](const S* p) {
    return reinterpret_cast<const S*>(reinterpret_cast<unsigned long long>(p) &
                                      ~15ull);
  };

  if (role == ChunkRole::kProducer) {
    for (int c = 0; c < chunks; ++c) {
      if (c >= kStages) mbar_wait(empty(c), (c / kStages - 1) & 1);
      unsigned bytes = 0;
      const long long t0 = static_cast<long long>(c) * cs.chunk;
      const long long R =
          b >= 0 ? max(0LL, min(static_cast<long long>(cs.chunk), hi - t0))
                 : 0;
      if (D >= 0 && R > 0) {
        // The 16-byte aligned windows around the lane's rows and labels of
        // the chunk, cut at the arrays' last 16-byte boundary.
        S* dst = stage(c) + lane * cs.slot;
        const S* parts[2] = {z + (b * T + t0) * n, y + b * T + t0};
        const S* ends[2] = {aligned(z + B * T * n), aligned(y + B * T)};
        const long long counts[2] = {R * n, R};
        S* dsts[2] = {dst, dst + cs.zw};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const S* w0 = aligned(parts[k]);
          const S* w1 = aligned(parts[k] + counts[k] + 16 / sizeof(S) - 1);
          if (w1 > ends[k]) w1 = ends[k];
          if (w1 < w0) w1 = w0;
          const unsigned nb = static_cast<unsigned>((w1 - w0) * sizeof(S));
          if (nb > 0) bulk_copy(dsts[k], w0, nb, full(c));
          bytes += nb;
          for (const S* q = w1 > parts[k] ? w1 : parts[k];
               q < parts[k] + counts[k]; ++q)
            dsts[k][q - w0] = *q;
        }
      }
      mbar_arrive_tx(full(c), bytes);
    }
    // The block outlives its copies: every stage's last chunk released.
    for (int c = max(0, chunks - kStages); c < chunks; ++c)
      mbar_wait(empty(c), (c / kStages) & 1);
    return;
  }

  S zr[D >= 0 ? Cap<D>::value : 1];
  for (int c = 0; c < chunks; ++c) {
    const unsigned parity = (c / kStages) & 1;
    mbar_wait(full(c), parity);
    if (role == ChunkRole::kTrail) mbar_wait(done(c), parity);
    const int t0 = c * cs.chunk, R = min(cs.chunk, last - t0);
    const int k_lo = max(lo_of(t0 + R) - t0, 0), k_hi = min(hi - t0, R);
    if (k_lo < k_hi) {
      if constexpr (D >= 0) {
        // Round k's row and label, stepped through by pointer from their
        // offsets in the slot's windows.
        const S* slot = stage(c) + lane * cs.slot;
        const S* zs = z + (b * T + t0) * n;
        const S* ys = y + b * T + t0;
        const S* row = slot + (zs - aligned(zs)) + k_lo * n;
        const S* label = slot + cs.zw + (ys - aligned(ys)) + k_lo;
        for (int t = t0 + k_lo; t < t0 + k_hi; ++t) {
#pragma unroll
          for (int j = 0; j < n; ++j) zr[j] = row[j];
          fn(t, static_cast<const S*>(zr), *label);
          row += n;
          ++label;
        }
      } else {
        for (int t = t0 + k_lo; t < t0 + k_hi; ++t)
          fn(t, z + (b * T + t) * n, y[b * T + t]);
      }
    }
    __syncwarp();
    if (role == ChunkRole::kLead) mbar_arrive(done(c));
    mbar_arrive(empty(c));
  }
}

// The FTRL scales of consecutive rounds from a row of the (E, T) scale
// table, each read one round ahead so that its load is off the round's
// chain: start(t0) loads round t0's, then take(t) for t = t0, t0 + 1, ...
// returns round t's and starts the load of round t + 1's.
template <typename S>
struct ScaleAhead {
  const S* __restrict__ row;
  long long T;
  S next;
  __device__ __forceinline__ void start(int t) {
    if (t < T) next = row[t];
  }
  __device__ __forceinline__ S take(int t) {
    const S s = next;
    if (t + 1 < T) next = row[t + 1];
    return s;
  }
};

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
