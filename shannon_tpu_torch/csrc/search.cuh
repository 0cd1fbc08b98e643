// Exact lower-bound search of int64 keys in a sorted int64 table, over an
// implicit 16-ary index that each call builds (search_build_kernel) and then
// walks: a lane a query through the top level in shared memory
// (search_top), then 8 lanes a query through the levels below it
// (search_walk), or one lane a query (search_lane).  K3 (lookup_sorted,
// kernels.cu) and K7 (probe_lookup, correction.cu) walk it by groups, K21,
// K22 and K28 (lookup_counts, sibling_maxes, neighbor_counts, spectrum.cu,
// an index of the spectrum's real lanes alone) a lane a query.
//
// Replaces shannon_tpu/ops/spectrum.py:137 lookup_hilo and :28
// lower_bound_hilo (the log2(C)-step binary search on the TPU; its
// sort-merge join at :71 was the TPU's way round gathers) and the search of
// shannon_tpu/ops/correction.py:78 _probe_resolve.
//
// Bound.  A binary search gives each query one thread and log2(C) dependent
// 8-byte loads (23 at 2^22 lanes).  A warp's load of 32 unrelated addresses
// costs the L1 pipeline one pass (wavefront) per distinct line, so the
// search is bound by those passes, about one an SM clock, far above the
// bytes the call must move (the table and the queries read once, idx and
// hit written once).
//
// Design.
//  - Index.  Level 0 is the table itself, cut into 16-lane lines (128
//    bytes).  Level t + 1 holds, for each group of 16 entries of level t,
//    the last one: entry j of level t + 1 is table[min(16^(t+1) (j + 1), C)
//    - 1], the largest key of its subtree.  Levels stop at the first one of
//    at most SEARCH_TOP_WORDS entries, the top (no level when C <= 16).
//    The scratch holds the levels top first, each rounded up to whole nodes
//    and filled up with PAD, so every node is one aligned 128-byte line
//    (ops/spectrum.py search_layout computes sizes and offsets; the entry
//    points check them, search_index_from).  2^22 lanes give 262,144 +
//    16,384 entries and a top of 1,024 (2.2 MB), 12,582,912 lanes 786,432 +
//    49,152 and a top of 3,072 (6.7 MB): they stay in the 50 MB L2 where
//    the table may not.
//  - Build.  One thread a word, one gather each from the table: about 1/16
//    of the table read, in the same entry point as the walk, on every call.
//    No index outlives its call, so none can go stale.
//  - Top.  Each block copies the top into shared memory once (blocks are
//    persistent: a grid of what fits on the card at once), and each lane
//    finds its own query's lower bound in it by a binary search, clamped to
//    the top's last entry: the query's node one level down.  A lane a query
//    costs far fewer instructions here than a group a query would.
//  - Walk.  Below the top, a group of SEARCH_GROUP (8) lanes resolves a
//    query: at each level its lanes load the node's 16 entries, 16 bytes a
//    lane, one coalesced line (one L1 pass against a binary search's four),
//    and rank the query by __ballot_sync and __popc; the rank picks the
//    child, clamped to the level's last entry (a query above every key
//    walks the last child of each level and ends at C, clamped by the
//    caller).  At the leaf line, lower bound = 16 line + #(keys < q), and
//    hit whether any key of the line equals q (the line is sorted, so that
//    key is the one at the lower bound): no further load.  Lanes past the
//    table's end compare greater than every query, PAD included, so the
//    table needs no pad.  Each group keeps Q queries in flight, their loads
//    issued together; every index is 32-bit (tables below 2^31 lanes).
//  - The table needs no alignment beyond its int64 keys: where it is not
//    16-byte aligned (a view that starts at an odd lane) its leaf lines load
//    8 bytes at a time.
//
// Every other searcher (K11, K14, K18) keeps common.cuh's lower_bound_hit
// inside its own work; all return the same exact lower
// bound clamped to C - 1.
#pragma once

#include "common.cuh"

#define SEARCH_FANOUT 16
// Lanes that walk one query below the top, 16 bytes (two entries) each.
#define SEARCH_GROUP 8
// Index levels at most (the table is below 2^31 lanes).
#define SEARCH_MAX_LEVELS 8
// Entries of the top level at most, the keys a block holds in shared
// memory (32 KB).
#define SEARCH_TOP_WORDS 4096
#define SEARCH_THREADS 256
#define SEARCH_FULL_MASK 0xffffffffu
// Words of the layout array the wrapper passes: the number of levels, then
// SEARCH_MAX_LEVELS sizes and SEARCH_MAX_LEVELS offsets.
#define SEARCH_LAYOUT_WORDS (1 + 2 * SEARCH_MAX_LEVELS)

struct SearchIndex {
  int levels;                     // index levels above the table
  int top_size;                   // entries of the top level (at offset 0)
  int size[SEARCH_MAX_LEVELS];    // entries of level t + 1
  int offset[SEARCH_MAX_LEVELS];  // where level t + 1 starts in the scratch
};

static __host__ __device__ inline int64_t search_round_up(int64_t m) {
  return (m + SEARCH_FANOUT - 1) / SEARCH_FANOUT * SEARCH_FANOUT;
}

// Reads the layout the wrapper computed for a table of n lanes and checks
// it against the rule above and the scratch's size; false refuses the call.
static inline bool search_index_from(const int64_t* layout, int64_t n, int64_t scratch_words,
                                     SearchIndex* ix) {
  if (layout == nullptr || n < 1 || n >= (1ll << 31)) return false;
  const int64_t levels = layout[0];
  if (levels < 0 || levels > SEARCH_MAX_LEVELS) return false;
  ix->levels = (int)levels;
  int64_t m = n;
  for (int t = 0; t < SEARCH_MAX_LEVELS; ++t) {
    ix->size[t] = t < levels ? (int)layout[1 + t] : 0;
    ix->offset[t] = t < levels ? (int)layout[1 + SEARCH_MAX_LEVELS + t] : 0;
    if (t >= levels) continue;
    if (m <= (t == 0 ? SEARCH_FANOUT : SEARCH_TOP_WORDS)) return false;  // a level above the top
    m = (m + SEARCH_FANOUT - 1) / SEARCH_FANOUT;
    if (ix->size[t] != m) return false;
  }
  if (m > (levels == 0 ? SEARCH_FANOUT : SEARCH_TOP_WORDS)) return false;  // no top
  int64_t at = 0;
  for (int t = (int)levels - 1; t >= 0; --t) {
    if (ix->offset[t] != at) return false;
    at += search_round_up(ix->size[t]);
  }
  if (at != scratch_words) return false;
  ix->top_size = levels > 0 ? ix->size[levels - 1] : 0;
  return true;
}

// Fills the scratch: entry j of level t + 1 is the last key of its subtree,
// and the words that round a level up to whole nodes are PAD, which no
// query is above, so a walk ranks a query in a level's last node without
// checking the level's end.
static __global__ void search_build_kernel(const int64_t* __restrict__ table, int64_t n,
                                           SearchIndex ix, int64_t words,
                                           int64_t* __restrict__ index) {
  const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= words) return;
  int64_t span = SEARCH_FANOUT;
#pragma unroll
  for (int t = 0; t < SEARCH_MAX_LEVELS; ++t) {
    if (t < ix.levels && w >= ix.offset[t] && w < ix.offset[t] + search_round_up(ix.size[t])) {
      const int64_t last = span * (w - ix.offset[t] + 1) - 1;
      index[w] = w < ix.offset[t] + ix.size[t] ? table[last < n ? last : n - 1] : PAD_KEY;
    }
    span *= SEARCH_FANOUT;
  }
}

// Launch the build; the walk kernel follows it in stream order.
static inline cudaError_t search_build(const int64_t* table, int64_t n, const SearchIndex& ix,
                                       int64_t words, int64_t* index, cudaStream_t stream) {
  if (words > 0) {
    search_build_kernel<<<blocks_for(words), THREADS, 0, stream>>>(table, n, ix, words, index);
  }
  return cudaGetLastError();
}

// The persistent grid of a walk kernel: as many blocks as fit on the card at
// once with `smem` bytes of dynamic shared memory, and no more than `want`.
static inline cudaError_t search_grid(const void* kernel, size_t smem, int64_t want,
                                      unsigned int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SEARCH_THREADS, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t full = (int64_t)per_sm * sms;
  *grid = (unsigned int)(want < 1 ? 1 : (want < full ? want : full));
  return cudaSuccess;
}

// Copies the top level into the block's shared memory.  Every thread calls
// it; it ends with __syncthreads().
static __device__ __forceinline__ void search_load_top(const SearchIndex& ix,
                                                       const int64_t* __restrict__ index,
                                                       int64_t* top) {
  for (int w = threadIdx.x; w < ix.top_size; w += blockDim.x) top[w] = index[w];
  __syncthreads();
}

// A lane's own query q: its lower bound in the top level (a binary search
// in shared memory), clamped to the top's last entry, which is q's node one
// level down (its leaf line where the top is level 1; line 0 where there is
// no index).
static __device__ __forceinline__ int search_top(const SearchIndex& ix, const int64_t* top,
                                                 int64_t q) {
  int lo = 0, len = ix.top_size;
  while (len > 0) {
    const int h = len >> 1;
    if (top[lo + h] < q) {
      lo += h + 1;
      len -= h + 1;
    } else {
      len = h;
    }
  }
  return lo < ix.top_size ? lo : (ix.top_size > 0 ? ix.top_size - 1 : 0);
}

// Lower bounds of Q queries in table[0, n), a group of SEARCH_GROUP lanes a
// query, from node[j], the query's node one level below the top
// (search_top): q[j] and node[j] must be the same on the lanes of a group
// (each group of the warp walks its own), and all 32 lanes of the warp call
// it together.  A lane loads 16 bytes of a node, two entries.  lb[j] is the
// lower bound in [0, n] (n where every key is below the query), hit[j]
// whether table[lb[j]] == q[j]; both the same on the lanes of the group.
// table_vec: the table is 16-byte aligned, so its leaf lines load 16 bytes a
// lane too.
template <int Q>
static __device__ __forceinline__ void search_walk(const SearchIndex& ix,
                                                   const int64_t* __restrict__ index,
                                                   const int64_t* __restrict__ table, int n,
                                                   bool table_vec, const int64_t (&q)[Q],
                                                   int (&node)[Q], int (&lb)[Q], bool (&hit)[Q]) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (SEARCH_GROUP - 1), gbase = lane & ~(SEARCH_GROUP - 1);
  const unsigned gmask = ((1u << SEARCH_GROUP) - 1) << gbase;
#pragma unroll
  for (int t = SEARCH_MAX_LEVELS - 2; t >= 0; --t) {
    if (t < ix.levels - 1) {  // the levels below the top
      const int size = ix.size[t];
      const longlong2* __restrict__ level = (const longlong2*)(index + ix.offset[t]);
      longlong2 e[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) e[j] = __ldg(level + node[j] * SEARCH_GROUP + gl);
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const unsigned b0 = __ballot_sync(SEARCH_FULL_MASK, e[j].x < q[j]) & gmask;
        const unsigned b1 = __ballot_sync(SEARCH_FULL_MASK, e[j].y < q[j]) & gmask;
        const int c = node[j] * SEARCH_FANOUT + __popc(b0) + __popc(b1);
        node[j] = c < size ? c : size - 1;  // past every key: the last child
      }
    }
  }
  int64_t e0[Q], e1[Q];
  bool ok0[Q], ok1[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int pos = node[j] * SEARCH_FANOUT + 2 * gl;
    ok0[j] = pos < n;
    ok1[j] = pos + 1 < n;
    if (table_vec && ok1[j]) {
      const longlong2 v = __ldg((const longlong2*)(table + pos));
      e0[j] = v.x;
      e1[j] = v.y;
    } else {
      e0[j] = ok0[j] ? __ldg(table + pos) : 0;
      e1[j] = ok1[j] ? __ldg(table + pos + 1) : 0;
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const unsigned lt0 = __ballot_sync(SEARCH_FULL_MASK, ok0[j] && e0[j] < q[j]) & gmask;
    const unsigned lt1 = __ballot_sync(SEARCH_FULL_MASK, ok1[j] && e1[j] < q[j]) & gmask;
    // the line is sorted, so a key equal to q, if any, is entry r
    const unsigned eq = __ballot_sync(SEARCH_FULL_MASK, (ok0[j] && e0[j] == q[j]) ||
                                                            (ok1[j] && e1[j] == q[j])) & gmask;
    lb[j] = node[j] * SEARCH_FANOUT + __popc(lt0) + __popc(lt1);
    hit[j] = eq != 0;
  }
}

// One lane's own query q from node, its node one level below the top
// (search_top): the lower bound of q in table[0, n) and whether that lane
// holds q.  A lane walks alone (no warp collective, so any subset of a
// warp's lanes may call it): at each level below the top, and at the leaf
// line, a binary search of the node's 16 entries, four dependent 8-byte
// loads (lanes past the table's end compare greater than every query).
// q must not exceed table[n - 1], so no node is ranked past its last entry
// (each level's entry is the last key of its subtree, the level's last node
// filled up with PAD) and the lower bound is a lane of the table.
static __device__ __forceinline__ int search_lane(const SearchIndex& ix,
                                                  const int64_t* __restrict__ index,
                                                  const int64_t* __restrict__ table, int n,
                                                  int64_t q, int node, bool* hit) {
#pragma unroll
  for (int t = SEARCH_MAX_LEVELS - 2; t >= 0; --t) {
    if (t < ix.levels - 1) {  // the levels below the top
      const int64_t* __restrict__ level = index + ix.offset[t] + node * SEARCH_FANOUT;
      int r = 0;
#pragma unroll
      for (int h = SEARCH_FANOUT / 2; h > 0; h >>= 1) {
        if (__ldg(level + r + h - 1) < q) r += h;
      }
      node = node * SEARCH_FANOUT + r;
    }
  }
  const int base = node * SEARCH_FANOUT;
  int r = 0;
#pragma unroll
  for (int h = SEARCH_FANOUT / 2; h > 0; h >>= 1) {
    const int pos = base + r + h - 1;
    if (pos < n && __ldg(table + pos) < q) r += h;
  }
  *hit = __ldg(table + base + r) == q;
  return base + r;
}
