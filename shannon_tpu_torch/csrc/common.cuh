// Definitions shared by the port's kernel sources (shannon_tpu_torch/csrc).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PAD_KEY 0x7FFFFFFFFFFFFFFFLL
#define THREADS 256

static inline unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + THREADS - 1) / THREADS);
}

// Reverse complement of the low 2k bits of a key (k <= 31): complement,
// reverse the 64 bits, swap the two bits of each base back, shift down.  Bits
// above 2k are ignored, as ops/kmers.revcomp_key ignores them.  K7
// (probe_lookup), K11/K14 (node_strands, contig_reduce) and K22
// (sibling_maxes, through probe_key) share it.
static __device__ __forceinline__ uint64_t revcomp_bits(uint64_t key, int k) {
  const uint64_t mask = (1ull << (2 * k)) - 1;
  uint64_t r = __brevll(~key & mask);
  r = ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
  return r >> (64 - 2 * k);
}

// The first index in [lo, hi) of the sorted table whose key is >= `key`, or
// hi: a binary search.  K12's tile bounds (link_bounds_kernel) take it as it
// is; lower_bound_hit clamps it.
static __device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ table,
                                                      int64_t lo, int64_t hi, int64_t key) {
  while (lo < hi) {
    int64_t mid = lo + ((hi - lo) >> 1);
    if (table[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Binary search of `key` in the sorted table[0, table_len) (table_len >= 1):
// the lower bound clamped to table_len - 1 goes to *idx, and the result says
// whether that lane holds the key.  The kernels that search inside other
// work use it: K14 (condense.cu).  K3 (lookup_sorted), K7 (probe_lookup),
// K21 (lookup_counts), K22 (sibling_maxes) and K28 (neighbor_counts; the
// last three over the real lanes alone) walk the 16-ary index of search.cuh
// instead, and K18
// (drop_join_kernel) finds the same lower bound of each sorted query by a
// merge join; every searcher returns the same exact clamped lower bound, so
// all give the same (idx, hit) for the same query.
static __device__ __forceinline__ bool lower_bound_hit(
    const int64_t* __restrict__ table, int64_t table_len, int64_t key,
    int64_t* idx) {
  const int64_t lo = lower_bound(table, 0, table_len, key);
  int64_t i = lo < table_len ? lo : table_len - 1;
  *idx = i;
  return table[i] == key;
}

// Probe p of key v, with the bit operations of probe_keys in
// shannon_tpu_torch/ops/spectrum.py (pad keys included, whose probes keep the
// bits above 2k): base b = p >> 1; even rows are right probes, odd rows left
// ones.  Siblings are prefix.b = (v & ~3) | b and b.suffix = (v & (mask >> 2))
// | b << 2(k-1); with side_ext, extensions suffix.b = ((v << 2) | b) & mask and
// b.prefix = (v >> 2) | b << 2(k-1).  With canonical, the smaller of the probe
// and its reverse complement.  K7 (probe_lookup), K22 (sibling_maxes) and K28
// (neighbor_counts) share it, so all search the same keys.
static __device__ __forceinline__ int64_t probe_key(uint64_t v, int k, int p,
                                                    int side_ext, int canonical) {
  const uint64_t mask = (1ull << (2 * k)) - 1;
  const uint64_t b = (uint64_t)(p >> 1);
  const int hs = 2 * (k - 1);
  const bool right = (p & 1) == 0;
  uint64_t q;
  if (side_ext) {
    q = right ? (((v << 2) | b) & mask) : ((v >> 2) | (b << hs));
  } else {
    q = right ? ((v & ~3ull) | b) : ((v & (mask >> 2)) | (b << hs));
  }
  int64_t key = (int64_t)q;
  if (canonical) {
    const int64_t rc = (int64_t)revcomp_bits(q, k);
    key = rc < key ? rc : key;
  }
  return key;
}

// The first index in [lo, hi) where pred is false, or hi, where pred is true
// on a prefix of the range.  One warp calls it together, with the same lo
// and hi in every lane; each round tests 32 pivots that cut the range into
// 33 parts, so a range of 2^24 lanes takes 5 rounds of one load a lane.
template <typename Pred>
static __device__ __forceinline__ int64_t warp_partition(int64_t lo, int64_t hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  while (hi > lo) {
    const int64_t span = hi - lo;
    if (span <= 32) {
      const bool t = lane < span && pred(lo + lane);
      return lo + __popc(__ballot_sync(0xffffffffu, t));
    }
    const int64_t p = lo + span * (lane + 1) / 33;
    const int c = __popc(__ballot_sync(0xffffffffu, pred(p)));
    const int64_t below = __shfl_sync(0xffffffffu, p, c > 0 ? c - 1 : 0);
    const int64_t above = __shfl_sync(0xffffffffu, p, c < 32 ? c : 31);
    if (c > 0) lo = below + 1;
    if (c < 32) hi = above;
  }
  return lo;
}

// a's lanes among the first d lanes of the merge of a[0, na) and b[0, nb),
// ties to a.  One warp calls it together.  K17 (merge_runs_kernel), K18
// (drop_join_kernel, through merge.cuh) and K11 (node_merge_kernel) split
// their tiles with it.
static __device__ __forceinline__ int64_t merge_split(const int64_t* __restrict__ a, int64_t na,
                                                      const int64_t* __restrict__ b, int64_t nb,
                                                      int64_t d) {
  return warp_partition(d > nb ? d - nb : 0, d < na ? d : na,
                        [&](int64_t i) { return a[i] <= b[d - 1 - i]; });
}
