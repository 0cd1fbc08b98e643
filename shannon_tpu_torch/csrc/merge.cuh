// Merge-path tiles over two sorted int64 key runs, a and b, with ties to a.
// K17 (merge_runs_kernel, kernels.cu) merges two count tables with them and
// K18 (drop_join_kernel, tipclip.cu) joins the spectrum with the node table.
//
// Both tables are sorted with PAD past their real lanes.  A persistent block
// finds the real lengths once, then takes SCAN_TILE merged lanes at a time
// (scan.cuh's tickets): the tile's two diagonals are split by merge_split
// (common.cuh), its runs of a and b are loaded coalesced into shared memory,
// a's run first, with one pad slot every 32 lanes so that the threads' merge
// heads fall on different banks, and each thread finds the split of its own
// diagonal, SCAN_ITEMS merged lanes a thread, by a binary search there.
#pragma once

#include "common.cuh"
#include "scan.cuh"

#define MERGE_SLOTS (SCAN_TILE + SCAN_TILE / 32)

// The shared-memory slot of a tile's lane p: one pad slot every 32 lanes.
static __device__ __forceinline__ int merge_slot(int p) { return p + (p >> 5); }

// The real lengths of a[0, Ca) and b[0, Cb) (the first PAD lane of each, a
// 32-ary search by one warp each) into s_len[0] and s_len[1].  Every thread
// calls it; it ends with __syncthreads().
static __device__ __forceinline__ void merge_real_lengths(const int64_t* __restrict__ a,
                                                          int64_t Ca,
                                                          const int64_t* __restrict__ b,
                                                          int64_t Cb, int64_t* s_len) {
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t* key = warp == 0 ? a : b;
    const int64_t n = warp_partition(0, warp == 0 ? Ca : Cb,
                                     [&](int64_t i) { return key[i] != PAD_KEY; });
    if ((threadIdx.x & 31) == 0) s_len[warp] = n;
  }
  __syncthreads();
}

// a's lanes before the tile's diagonals d0 and d1 into s_split[0] and
// s_split[1].  Every thread calls it; it ends with __syncthreads().
static __device__ __forceinline__ void merge_tile_splits(const int64_t* __restrict__ a,
                                                         int64_t na,
                                                         const int64_t* __restrict__ b,
                                                         int64_t nb, int64_t d0, int64_t d1,
                                                         int64_t* s_split) {
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t i = merge_split(a, na, b, nb, warp == 0 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) s_split[warp] = i;
  }
  __syncthreads();
}

// The tile's runs a[a0, a0 + la) and b[b0, b0 + L - la) into lanes [0, la)
// and [la, L) of s_key (and their counts into s_count, where Counts), read
// coalesced.  The caller's next barrier publishes them.
template <bool Counts>
static __device__ __forceinline__ void merge_load_tile(
    const int64_t* __restrict__ a_key, const int32_t* __restrict__ a_count, int64_t a0,
    const int64_t* __restrict__ b_key, const int32_t* __restrict__ b_count, int64_t b0, int la,
    int L, int64_t* s_key, unsigned* s_count) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int64_t kv[SCAN_ITEMS / 2];
    unsigned cv[SCAN_ITEMS / 2];
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS / 2; ++q) {
      const int p = threadIdx.x + (h * SCAN_ITEMS / 2 + q) * SCAN_THREADS;
      if (p < la) {
        kv[q] = a_key[a0 + p];
        if (Counts) cv[q] = (unsigned)a_count[a0 + p];
      } else if (p < L) {
        kv[q] = b_key[b0 + (p - la)];
        if (Counts) cv[q] = (unsigned)b_count[b0 + (p - la)];
      }
    }
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS / 2; ++q) {
      const int p = threadIdx.x + (h * SCAN_ITEMS / 2 + q) * SCAN_THREADS;
      if (p < L) {
        s_key[merge_slot(p)] = kv[q];
        if (Counts) s_count[merge_slot(p)] = cv[q];
      }
    }
  }
}

// a's lanes among the tile's first `first` merged lanes (first < la + lb),
// ties to a: a binary search of the thread's diagonal in the loaded tile.
static __device__ __forceinline__ int merge_thread_split(const int64_t* s_key, int la, int lb,
                                                         int first) {
  int lo = first > lb ? first - lb : 0, hi = first < la ? first : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_key[merge_slot(mid)] <= s_key[merge_slot(la + first - 1 - mid)]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}
