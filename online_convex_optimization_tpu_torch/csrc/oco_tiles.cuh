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
// Layout of a stage: 32 slots of `slot` bytes, lane s's slot holding its
// sequence's chunk as the caller stores it (z_0..z_{n-1} of each round,
// round after round, then the chunk's labels), then `scale_rows` rows of
// `chunk` FTRL scales: one a warp where each warp has its own setting (K5),
// one that every warp reads where they share it (K6b, a scalar eta), none
// where each lane reads its own row of the table a round ahead (K1, K2:
// ScaleAhead).  The warps a block and the bytes a stage are each kernel's
// constants; the chunk follows from them, d and the dtype.  A sequence's
// chunk is contiguous in global memory, so the copy of a slot is coalesced
// across the lanes of the copying warp; `slot` is an odd number of 4-byte
// words, so the 32 lanes reading element k of their own slots hit 32
// different banks.
//
// Narrow storage (bf16 z, int8 or bf16 y: kWindowed) cannot be copied an
// element at a time, since cp.async moves 4, 8 or 16 bytes.  A slot then
// holds the 4-byte aligned window of global memory around the lane's rows,
// and another around its labels, copied a 4-byte word a lane; the lane
// finds its rows at the offset of their first address within the window.
// Every word of a window holds an element of the arrays, so it lies in
// that element's page: the few bytes it holds past the rows are read, never
// used, and cannot fault.
//
// The large-d instance (D == -1, d > 64), whose rows do not fit a stage,
// reads each row from global memory as it plays it (play_rows_global).  No
// wide instance (D == kWideD, d > 512) plays through these helpers.
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

// The element offset of p within its 4-byte word: where a window or word copied
// around p holds *p.
template <typename T>
__device__ __forceinline__ int window_offset(const T* p) {
  return static_cast<int>((reinterpret_cast<unsigned long long>(p) & 3ull) /
                          sizeof(T));
}

// Plays rounds [0, T) of sequence b of the time-major (T, n, B) z and
// (T, B) y through fn(t, zr, y_t), in order, from this thread's ring of P
// rounds in shared memory (`ring` its first word, `step` words between its
// words: the block's threads interleaved), filled P - 1 rounds ahead with
// cp.async and waited on per thread: no barrier.  A narrow element (1 or
// 2 bytes) is copied as the aligned 4-byte word that holds it, and read at
// its offset there; the word lies in the page of the element, so it cannot
// fault, and neighbouring threads' words share their sectors, so the
// device memory read is the array's.
template <typename S, int D, int P, typename Z, typename Y, typename F>
__device__ __forceinline__ void play_time_major_words(
    const Z* __restrict__ z, const Y* __restrict__ y, long long T,
    long long b, long long B, int n, unsigned* ring, int step, F&& fn) {
  static_assert(P >= 2, "a ring needs two slots");
  const auto word = [](const void* p) {
    return reinterpret_cast<const unsigned*>(
        reinterpret_cast<unsigned long long>(p) & ~3ull);
  };
  const auto fetch = [&](long long k) {
    unsigned* dst = ring + static_cast<int>(k % P) * (n + 1) * step;
    const Z* src = z + k * n * B + b;
    for (int j = 0; j < n; ++j) copy_async(dst + j * step, word(src + j * B));
    copy_async(dst + n * step, word(y + k * B + b));
  };
  // One copy group a round, empty past the end, so that group k is
  // complete once at most P - 1 newer ones are pending.
#pragma unroll
  for (int i = 0; i < P - 1; ++i) {
    if (i < T) fetch(i);
    commit_copies();
  }
  S zr[Cap<D>::value];
  for (long long k = 0; k < T; ++k) {
    // Slot (k - 1) % P was read last round, so it can be refilled.
    if (k + P - 1 < T) fetch(k + P - 1);
    commit_copies();
    wait_copies<P - 1>();
    const unsigned* src = ring + static_cast<int>(k % P) * (n + 1) * step;
    const Z* row = z + k * n * B + b;
#pragma unroll
    for (int j = 0; j < n; ++j)
      zr[j] = S(widen(reinterpret_cast<const Z*>(
          src + j * step)[window_offset(row + j * B)]));
    const S yt = S(widen(reinterpret_cast<const Y*>(
        src + n * step)[window_offset(y + k * B + b)]));
    fn(k, static_cast<const S*>(zr), yt);
  }
}

// Most rounds a stage holds: a chunk's barrier and copies then cost a
// small share of its rounds.
constexpr int kMaxChunk = 64;

// Shape of a block's tile ring, fixed by the host for one launch.
struct TileShape {
  int n;           // features a row
  int chunk;       // rounds a stage
  int slot;        // bytes a lane's slot: an odd number of 4-byte words
  int labels;      // bytes from a slot's start to its labels
  int warps;       // setting-warps a block
  int scale_rows;  // rows of scales a stage: warps, or 1 (shared)
  int scale_size;  // bytes a scale (the compute type's)
  __host__ __device__ int stage_bytes() const {
    return 32 * slot + scale_rows * chunk * scale_size;
  }
};

// The shape of `warps` warps a block whose stage holds at most stage_bytes
// of the 32 sequences' rows (1 to kMaxChunk rounds of them).  A stage of
// the pairs stored in the compute type holds chunk * (n + 1) elements a
// slot, made odd; a windowed one each window and 4 bytes for its offset.
template <typename Z, typename Y>
inline TileShape tile_shape(int n, int warps, size_t stage_bytes,
                            int scale_rows) {
  using S = typename Compute<Z>::type;
  const size_t fit = stage_bytes / (32 * (n * sizeof(Z) + sizeof(Y)));
  const int chunk = static_cast<int>(
      fit < 1 ? 1 : (fit > kMaxChunk ? kMaxChunk : fit));
  if constexpr (!kWindowed<Z, Y>) {
    const int slot = (chunk * (n + 1)) | 1;
    return {n,     chunk,      static_cast<int>(slot * sizeof(S)),
            static_cast<int>(chunk * n * sizeof(S)), warps, scale_rows,
            static_cast<int>(sizeof(S))};
  } else {
    const int zw = static_cast<int>((chunk * n * sizeof(Z) + 3 + 3) / 4);
    const int yw = static_cast<int>((chunk * sizeof(Y) + 3 + 3) / 4);
    const int slot = (zw + yw) | 1;
    return {n,         chunk,      4 * slot, 4 * zw, warps, scale_rows,
            static_cast<int>(sizeof(S))};
  }
}

// Bytes of the ring for one launch (none for the large-d instance).
template <int D>
inline size_t ring_bytes(const TileShape& ts) {
  return D < 0 ? 0 : static_cast<size_t>(kTileStages) * ts.stage_bytes();
}

// Copies the 4-byte aligned window around elements [src, src + count)
// into dst, the lanes of a warp copying a 4-byte word each in turn with
// cp.async: *src lands at dst + window_offset(src) elements.
template <typename T>
__device__ __forceinline__ void copy_window(unsigned char* dst, const T* src,
                                            long long count, int lane) {
  const auto addr = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p);
  };
  const auto* w0 = reinterpret_cast<const unsigned*>(addr(src) & ~3ull);
  const long long words =
      static_cast<long long>(addr(src + count) - addr(w0) + 3) / 4;
  for (long long o = lane; o < words; o += 32)
    copy_async(reinterpret_cast<unsigned*>(dst) + o, w0 + o);
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

// Bytes of a thread's local frame of `kernel` (out[0],
// cudaFuncAttributes.localSizeBytes) and of a block's shared memory at
// `smem` bytes of dynamic shared memory (out[1], its static bytes plus
// smem); returns the cudaError_t.
template <typename K>
inline int local_bytes(K kernel, int* out, size_t smem = 0) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  const bool ok = err == cudaSuccess;
  out[0] = ok ? static_cast<int>(attr.localSizeBytes) : 0;
  out[1] = ok ? static_cast<int>(attr.sharedSizeBytes + smem) : 0;
  return static_cast<int>(err);
}

// Plays rounds [lo, hi) of sequence b through fn(t, zr, y_t, scale), in
// order, each thread reading its own rows from global memory, with scale =
// scale_row[t] (0 where scale_row is null).  The instances with registers
// for two rows (D >= 0) load round t + 1's row before they play round t,
// so the load's latency overlaps a round.
template <typename S, int D, typename Z, typename Y, typename F>
__device__ __forceinline__ void play_rows_global(
    const Z* __restrict__ z, const Y* __restrict__ y,
    const S* __restrict__ scale_row, long long b, long long T, int n, int lo,
    int hi, F&& fn) {
  S zr[Cap<D>::value];
  const auto load = [&](int t, S* row, S& yt, S& scale) {
    const Z* src = z + (b * T + t) * n;
#pragma unroll
    for (int j = 0; j < n; ++j) row[j] = S(widen(src[j]));
    yt = S(widen(y[b * T + t]));
    scale = scale_row != nullptr ? scale_row[t] : S(0);
  };
  static_assert(D != kWideD, "no wide instance plays rows here");
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
// the block must call it with the same z, y, T and ts: the staged
// instances hold barriers.  They copy only the chunks that some thread of
// the block plays, and call chunk_fn(t0, rows, labels, R) once a chunk,
// before its rounds, with the lane's staged rows (round k's at
// rows[k * n]) and labels (labels[k]) of the chunk that starts at round t0
// and holds R rounds.
template <typename S, int D, typename Z, typename Y, typename F, typename G>
__device__ __forceinline__ void play_rows(const Z* __restrict__ z,
                                          const Y* __restrict__ y,
                                          const S* __restrict__ scale_row,
                                          long long b, long long T,
                                          const TileShape& ts, int lo, int hi,
                                          unsigned char* ring, F&& fn,
                                          G&& chunk_fn) {
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
      return ring + (c % kTileStages) * ts.stage_bytes();
    };
    const auto rounds = [&](int c) {
      return static_cast<int>(min(static_cast<long long>(ts.chunk),
                                  T - static_cast<long long>(c) * ts.chunk));
    };
    // Warp w copies the slots w, w + warps, ..., and its row of scales.
    const auto issue = [&](int c) {
      const long long t0 = static_cast<long long>(c) * ts.chunk;
      const int R = rounds(c);
      unsigned char* st = stage(c);
      for (int s = warp; s < 32; s += ts.warps) {
        const long long bs = __shfl_sync(kFullMask, b, s);
        if (bs < 0) continue;
        const Z* zs = z + (bs * T + t0) * n;
        const Y* ys = y + bs * T + t0;
        if constexpr (kWindowed<Z, Y>) {
          copy_window(st + s * ts.slot, zs, static_cast<long long>(R) * n,
                      lane);
          copy_window(st + s * ts.slot + ts.labels, ys, R, lane);
        } else {
          S* dst = reinterpret_cast<S*>(st + s * ts.slot);
          for (int o = lane; o < R * n; o += 32) copy_async(dst + o, zs + o);
          for (int o = lane; o < R; o += 32)
            copy_async(dst + ts.chunk * n + o, ys + o);
        }
      }
      if (scale_row != nullptr && warp < ts.scale_rows) {
        S* sc = reinterpret_cast<S*>(st + 32 * ts.slot) + warp * ts.chunk;
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
      const unsigned char* st = stage(c);
      const Z* row = reinterpret_cast<const Z*>(st + lane * ts.slot);
      const Y* label =
          reinterpret_cast<const Y*>(st + lane * ts.slot + ts.labels);
      if constexpr (kWindowed<Z, Y>) {
        // The lane's rows and labels at their offsets in the windows (a
        // lane with no sequence reads nothing).
        const long long bb = b >= 0 ? b : 0;
        row += window_offset(z + (bb * T + t0) * n);
        label += window_offset(y + bb * T + t0);
      }
      chunk_fn(t0, row, label, rounds(c));
      // Round k's row, label and scale, stepped through by pointer.
      label += k_lo;
      const S* scale = reinterpret_cast<const S*>(st + 32 * ts.slot) +
                       (warp % ts.scale_rows) * ts.chunk + k_lo;
      row += k_lo * n;
      for (int t = t0 + k_lo; t < t0 + k_hi; ++t) {
#pragma unroll
        for (int j = 0; j < n; ++j) zr[j] = S(widen(row[j]));
        fn(t, static_cast<const S*>(zr), S(widen(*label)), *scale);
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
// global memory around its sequence's rows of the chunk (zw bytes), then
// the window around their labels; the lane finds its rows at the offset of
// their first address within the window.  A slot is an odd multiple of 16
// bytes, so that the lanes' 8-byte reads fall on at most two of a bank's
// words.  z and y may have different element sizes (narrow storage).
struct ChunkShape {
  int n;      // features a row
  int chunk;  // rounds a stage
  int zw;     // bytes of a slot's row window
  int slot;   // bytes a slot: the row window, then the label window
  __host__ __device__ int stage_bytes() const { return 32 * slot; }
};

// The shape of a ring whose stage holds about stage_bytes of the 32
// sequences' rows (1 to kMaxChunk rounds of them; kMaxChunk for the large-d
// instance, which stages nothing).
template <typename Z, typename Y, int D>
inline ChunkShape chunk_shape(int n, size_t stage_bytes) {
  const size_t fit =
      D < 0 ? kMaxChunk : stage_bytes / (32 * (n * sizeof(Z) + sizeof(Y)));
  const int chunk = static_cast<int>(
      fit < 1 ? 1 : (fit > kMaxChunk ? kMaxChunk : fit));
  const auto window = [](size_t bytes) {
    return static_cast<int>(((bytes + 15) / 16 + 1) * 16);
  };
  const int zw = window(chunk * n * sizeof(Z));
  int slot = zw + window(chunk * sizeof(Y));
  if (slot % 32 == 0) slot += 16;
  return {n, chunk, zw, slot};
}

// Bytes of play_chunks' mbarriers (three a stage), 16-byte aligned.
__host__ __device__ constexpr size_t chunk_bars_bytes(int stages) {
  return 16 * ((stages * 3 * 8 + 15) / 16);
}

// Bytes of a ring of `stages` stages and their mbarriers (the large-d
// instance stages nothing, and keeps the mbarriers).
template <int D>
inline size_t chunk_ring_bytes(const ChunkShape& cs, int stages) {
  return chunk_bars_bytes(stages) +
         (D < 0 ? 0 : static_cast<size_t>(stages) * cs.stage_bytes());
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
// nothing: it passes fn its global row (widened into local memory where z
// is narrow), and keeps the pipeline's barriers only to order the trail
// after the leads.
template <typename S, int D, int kStages, typename Z, typename Y,
          typename Lo, typename F>
__device__ __forceinline__ void play_chunks(
    const Z* __restrict__ z, const Y* __restrict__ y, long long b,
    long long B, long long T, const ChunkShape& cs, int hi, ChunkRole role,
    int leads, int consumers, unsigned char* smem, Lo&& lo_of, F&& fn) {
  static_assert(D != kWideD, "no wide instance plays chunks");
  const int n = D > 0 ? D : cs.n;
  const int lane = threadIdx.x & 31;
  // Three mbarriers a stage: full, empty, done.
  auto* bars = reinterpret_cast<unsigned long long*>(smem);
  const auto full = [&](int c) { return &bars[3 * (c % kStages)]; };
  const auto empty = [&](int c) { return &bars[3 * (c % kStages) + 1]; };
  const auto done = [&](int c) { return &bars[3 * (c % kStages) + 2]; };
  unsigned char* ring = smem + chunk_bars_bytes(kStages);
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
    return ring + (c % kStages) * cs.stage_bytes();
  };
  const auto aligned = [](const auto* p) {
    return reinterpret_cast<decltype(p)>(
        reinterpret_cast<unsigned long long>(p) & ~15ull);
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
        unsigned char* dst = stage(c) + lane * cs.slot;
        const auto part = [&](const auto* src, long long count,
                              const auto* end, auto* out) {
          using T = typename std::remove_const<
              typename std::remove_pointer<decltype(src)>::type>::type;
          const T* w0 = aligned(src);
          const T* w1 = aligned(src + count + 16 / sizeof(T) - 1);
          if (w1 > aligned(end)) w1 = aligned(end);
          if (w1 < w0) w1 = w0;
          const unsigned nb = static_cast<unsigned>((w1 - w0) * sizeof(T));
          if (nb > 0) bulk_copy(out, w0, nb, full(c));
          bytes += nb;
          for (const T* q = w1 > src ? w1 : src; q < src + count; ++q)
            reinterpret_cast<T*>(out)[q - w0] = *q;
        };
        part(z + (b * T + t0) * n, R * n, z + B * T * n, dst);
        part(y + b * T + t0, R, y + B * T, dst + cs.zw);
      }
      mbar_arrive_tx(full(c), bytes);
    }
    // The block outlives its copies: every stage's last chunk released.
    for (int c = max(0, chunks - kStages); c < chunks; ++c)
      mbar_wait(empty(c), (c / kStages) & 1);
    return;
  }

  // The large-d instance widens a narrow global row into local memory.
  constexpr bool kWidenGlobal = D == -1 && !std::is_same<Z, S>::value;
  S zr[D >= 0 || kWidenGlobal ? Cap<D>::value : 1];
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
        const unsigned char* slot = stage(c) + lane * cs.slot;
        const Z* zs = z + (b * T + t0) * n;
        const Y* ys = y + b * T + t0;
        const Z* row =
            reinterpret_cast<const Z*>(slot) + (zs - aligned(zs)) + k_lo * n;
        const Y* label = reinterpret_cast<const Y*>(slot + cs.zw) +
                         (ys - aligned(ys)) + k_lo;
        for (int t = t0 + k_lo; t < t0 + k_hi; ++t) {
#pragma unroll
          for (int j = 0; j < n; ++j) zr[j] = S(widen(row[j]));
          fn(t, static_cast<const S*>(zr), S(widen(*label)));
          row += n;
          ++label;
        }
      } else if constexpr (kWidenGlobal) {
        for (int t = t0 + k_lo; t < t0 + k_hi; ++t) {
          const Z* src = z + (b * T + t) * n;
          for (int j = 0; j < n; ++j) zr[j] = S(widen(src[j]));
          fn(t, static_cast<const S*>(zr), S(widen(y[b * T + t])));
        }
      } else {
        for (int t = t0 + k_lo; t < t0 + k_hi; ++t)
          fn(t, z + (b * T + t) * n, S(widen(y[b * T + t])));
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
  template <typename Z, typename Y>
  __device__ void operator()(int, const Z*, const Y*, int) const {}
};

// Final comparator loss 0.5 * sum_{t < len} |<z_t, x> - y_t| replayed over
// sequence b's rows in the (B, T, d) layout (the sweeps' replay mode).
template <typename S, int D, typename Z, typename Y, typename X>
__device__ __forceinline__ S replay_comparator_rows(const Z* __restrict__ z,
                                                   const Y* __restrict__ y,
                                                   long long b, long long T,
                                                   int n, int len, X x) {
  S comp = S(0);
  for (int t = 0; t < len; ++t) {
    const S q = dot<S, D>(z + (b * T + t) * n, x, n);
    comp = comp + S(0.5) * oabs(q - S(widen(y[b * T + t])));
  }
  return comp;
}

}  // namespace oco
