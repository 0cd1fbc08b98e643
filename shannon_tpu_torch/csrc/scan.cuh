// Single-pass prefix scan over tiles with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA, 2016).  K2 (reduce_sorted, kernels.cu), K10 (compact_keep,
// correction.cu) and the kernels that followed them (K5, K14, K15, K17, K18,
// K19) count their 0/1 flags with it in the same pass that reads them: no
// scan array goes to device memory and no separate scan launch runs.  K27
// (ownership_unpack, multihost.cu) scans the received path lengths into
// their offsets with it, in the launch that copies the rest; K26
// (ownership_pack) uses only block_exclusive_scan, in its offsets pass and
// its pad fill.
//
// Shape.  A block of SCAN_THREADS threads takes one tile of SCAN_TILE lanes,
// SCAN_ITEMS consecutive lanes a thread (a blocked layout: a thread counts its
// own lanes in registers).  Inside the tile the scan is warp shuffles plus one
// shared word a warp.  Across tiles, each tile has one 64-bit status word:
// 2 flag bits (none, aggregate, inclusive) above a 62-bit value.
//
// Scratch: tiles + 1 words, zeroed by the caller before every launch (the
// wrapper's torch.zeros), so no state survives a call.  Word 0 is the ticket
// counter, word 1 + t the status of tile t.
//
// Memory-ordering contract.
//  - Tickets.  A block's tile is the value of one atomicAdd on the counter,
//    not blockIdx.  Tiles are handed out in the order blocks start, so every
//    tile a block waits on belongs to a block that is already running: the
//    look-back never waits on a block that was not scheduled, in whatever
//    order the hardware schedules blocks.
//  - Publish.  A tile writes its status word with one 64-bit store after
//    __threadfence(): (aggregate, its own count) as soon as its count is
//    known, then (inclusive, prefix + count) once its prefix is (tile 0 writes
//    its inclusive word at once).  A word is stored whole, so a reader sees
//    none, the aggregate or the inclusive word, never a torn one.
//  - Look-back.  The first warp of a tile reads the 32 preceding status words
//    together, one a lane, with acquire loads at device scope.  While any of
//    them is still none it reloads those; then it adds the values up to and
//    including the nearest inclusive word, or all 32 aggregates and moves 32
//    tiles back.  Tile 0 never waits, so every chain ends.
//  - A tile writes its own outputs only after its prefix is known, and no
//    tile reads another tile's outputs.
//
// What cannot be fused.  A compaction's tail (PAD and 0 past n) is a second
// launch in stream order (scan_fill_tail_kernel), never done by the tiles.  A
// tile that knows its prefix p and count a cannot fill [p + a, tile end): its
// output slots lag its input lanes, and a later tile may already have taken
// its prefix from this tile's aggregate and written its own kept lanes into
// that range.  Only when every tile has written is n known and [n, C) free.
#pragma once

#include <cuda/atomic>

#include "common.cuh"

#define SCAN_THREADS 256
#define SCAN_ITEMS 16
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)  // 4,096 lanes
#define SCAN_WARPS (SCAN_THREADS / 32)
#define SCAN_FULL_MASK 0xffffffffu
#define SCAN_AGGREGATE (1ull << 62)
#define SCAN_INCLUSIVE (2ull << 62)
#define SCAN_VALUE_MASK ((1ull << 62) - 1)
// Blocks of the tail fill's grid-stride loop: enough warps to fill every SM.
#define SCAN_FILL_BLOCKS 1024

// Per-block state of the scan (in shared memory).
struct ScanShared {
  long long tile;
  unsigned long long prefix;
};

static inline long long scan_tiles(int64_t lanes) {
  return (lanes + SCAN_TILE - 1) / SCAN_TILE;
}

static __device__ __forceinline__ unsigned long long scan_flag(unsigned long long word) {
  return word >> 62;
}

static __device__ __forceinline__ unsigned long long scan_load(unsigned long long* word) {
  return cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(*word).load(
      cuda::std::memory_order_acquire);
}

static __device__ __forceinline__ void scan_store(unsigned long long* word,
                                                  unsigned long long value) {
  __threadfence();
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(*word).store(
      value, cuda::std::memory_order_relaxed);
}

// The block's tile, by ticket.  Every thread of the block calls it.
static __device__ __forceinline__ long long scan_ticket(unsigned long long* scratch,
                                                        ScanShared* sh) {
  if (threadIdx.x == 0) sh->tile = (long long)atomicAdd(scratch, 1ull);
  __syncthreads();
  return sh->tile;
}

template <typename T>
static __device__ __forceinline__ T warp_inclusive_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T u = __shfl_up_sync(SCAN_FULL_MASK, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Exclusive scan of one value a thread over the block, in thread order; the
// block's sum goes to *total.  Every thread calls it; s_warp (SCAN_WARPS
// words of shared memory) must not be reused by a later call of the same
// launch.  Unsigned T wraps modulo 2^bits, as integer sums do.
template <typename T>
static __device__ __forceinline__ T block_exclusive_scan(T v, T* s_warp, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T inc = warp_inclusive_scan(v);
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  T before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < SCAN_WARPS; ++w) {
    const T x = s_warp[w];
    if (w < warp) before += x;
    sum += x;
  }
  *total = sum;
  return before + inc - v;
}

// Publish the tile's own count; tile 0's is already its inclusive value.
// Every thread calls it, thread 0 stores.
static __device__ __forceinline__ void scan_publish_aggregate(unsigned long long* status,
                                                              long long tile,
                                                              unsigned long long aggregate) {
  if (threadIdx.x == 0) {
    scan_store(status + tile, (tile == 0 ? SCAN_INCLUSIVE : SCAN_AGGREGATE) | aggregate);
  }
}

// The tile's exclusive prefix: the sum of every earlier tile's count, by
// decoupled look-back over status (the scratch past its ticket word); the
// tile's inclusive word is published before it returns.  Every thread calls
// it after scan_publish_aggregate, and all get the prefix; it ends with
// __syncthreads(), which also orders the block's shared-memory writes before
// it against its reads after it.
static __device__ __forceinline__ unsigned long long scan_tile_prefix(
    unsigned long long* status, long long tile, unsigned long long aggregate,
    ScanShared* sh) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned long long prefix = 0;
    for (long long last = tile - 1; last >= 0; last -= 32) {
      const long long j = last - lane;
      // before tile 0 counts as an inclusive 0, which ends the chain
      unsigned long long w = j >= 0 ? scan_load(status + j) : SCAN_INCLUSIVE;
      while (__any_sync(SCAN_FULL_MASK, scan_flag(w) == 0)) {
        if (scan_flag(w) == 0) w = scan_load(status + j);
      }
      const unsigned inclusive = __ballot_sync(SCAN_FULL_MASK, scan_flag(w) == 2);
      const int stop = inclusive ? __ffs(inclusive) - 1 : 31;  // nearest inclusive lane
      unsigned long long v = lane <= stop ? (w & SCAN_VALUE_MASK) : 0ull;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(SCAN_FULL_MASK, v, d);
      prefix += v;
      if (inclusive) break;
    }
    if (lane == 0) {
      if (tile > 0) scan_store(status + tile, SCAN_INCLUSIVE | (prefix + aggregate));
      sh->prefix = prefix;
    }
  }
  __syncthreads();
  return sh->prefix;
}

// A compaction's kept lanes: the tile offsets first + j of the set bits j of
// `bits`, in order, into s_lane from slot r on (r is the thread's exclusive
// count in the tile).  The copy-out after scan_tile_prefix reads them: kept
// lane q of the tile goes to slot prefix + q.  K10 and K18 share it.
static __device__ __forceinline__ void scan_record_lanes(unsigned bits, int first, unsigned r,
                                                         uint16_t* s_lane) {
  while (bits) {
    const int j = __ffs(bits) - 1;
    bits &= bits - 1;
    s_lane[r++] = (uint16_t)(first + j);
  }
}

// The tail of a compaction, launched after the scanning kernel in stream
// order: lanes [n, len) of key get PAD and, where count is given, of count 0.
// n is the scan's total, the value of the last tile's inclusive word
// (last_status), or 0 where there was no tile (null).
static __global__ void scan_fill_tail_kernel(const unsigned long long* __restrict__ last_status,
                                             int64_t len, int64_t* __restrict__ key,
                                             int32_t* __restrict__ count) {
  const int64_t n = last_status != nullptr ? (int64_t)(*last_status & SCAN_VALUE_MASK) : 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = n + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < len; s += stride) {
    key[s] = PAD_KEY;
    if (count != nullptr) count[s] = 0;
  }
}

// Launch the tail fill after a scan over `tiles` tiles whose scratch is
// `scratch` (tiles + 1 words).
static inline void scan_fill_tail(const unsigned long long* scratch, long long tiles,
                                  int64_t len, int64_t* key, int32_t* count,
                                  cudaStream_t stream) {
  if (len <= 0) return;
  const int64_t blocks = (len + THREADS - 1) / THREADS;
  scan_fill_tail_kernel<<<(unsigned int)(blocks < SCAN_FILL_BLOCKS ? blocks : SCAN_FILL_BLOCKS),
                          THREADS, 0, stream>>>(tiles > 0 ? scratch + tiles : nullptr, len, key,
                                                count);
}
