// Hand-written Hopper (sm_90a) kernels of the shannon_tpu_torch port: the
// k-mer kernels K1-K3 and K24 and the count merge K17 (threading's K4-K5 are
// in thread.cu, the sparse-flow solver K6 in sparseflow.cu, correction's
// K7-K10, K16, K20 and K23 in correction.cu, condensation's K11-K15 in
// condense.cu, tip clip's K18-K19 in tipclip.cu, the count lookups K21-K22
// in spectrum.cu, the sharded count's owner bucketing K25 in
// distributed.cu).
//
// Plain C interface, built with nvcc into build/kernels/libshannon_kernels.so
// and bound with ctypes (shannon_tpu_torch/kernels.py).  Every entry point
// launches on the stream it is given, allocates nothing (the Python wrapper
// allocates every output and scratch buffer with torch.empty) and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// A k-mer is one int64 key: 2k bits, base i of the window at bits
// [2(k-1-i), 2(k-1-i)+2).  k <= 31, so real keys are below 2^62 and the pad
// key 2^63-1 sorts after every real key under signed comparison.

#include "common.cuh"
#include "scan.cuh"
#include "search.cuh"

// ---------------------------------------------------------------------------
// K1: k-mer extraction from 2-bit packed reads.
// Replaces shannon_tpu/ops/kmers.py:151 extract_kmers_packed (with
// unpack_words_device :131, unpack_mask_device :142, _windows_from_c32 :78,
// revcomp_hilo :49, canonical_hilo :69).
// Bound: memory.  Each window writes 9 bytes (key + valid) and reads a few
// words of its read row, which neighbouring threads share through L1.  One
// thread per (read, window), consecutive threads on consecutive windows of a
// row, so the key and valid stores are coalesced; the forward key and its
// reverse complement are built in the same k-step loop, so canonical mode
// costs no second pass.
// ---------------------------------------------------------------------------
__global__ void extract_kmers_kernel(const uint32_t* __restrict__ words,
                                     const int32_t* __restrict__ lengths,
                                     const uint32_t* __restrict__ mask,
                                     int64_t n_reads, int words_per_row,
                                     int mask_words_per_row, int n_windows,
                                     int k, int canonical,
                                     int64_t* __restrict__ keys,
                                     uint8_t* __restrict__ valid) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_reads * (int64_t)n_windows) return;
  int64_t r = t / n_windows;
  int j = (int)(t - r * n_windows);
  const uint32_t* row = words + r * words_per_row;
  bool ok = j + k <= lengths[r];
  uint64_t fwd = 0, rc = 0;
  for (int i = 0; i < k; ++i) {
    int p = j + i;
    uint64_t c = (row[p >> 4] >> (2 * (p & 15))) & 3u;
    fwd = (fwd << 2) | c;
    rc |= (3ull - c) << (2 * i);
    if (mask != nullptr &&
        ((mask[r * mask_words_per_row + (p >> 5)] >> (p & 31)) & 1u)) {
      ok = false;
    }
  }
  uint64_t v = (canonical && rc < fwd) ? rc : fwd;
  keys[t] = ok ? (int64_t)v : PAD_KEY;
  valid[t] = ok ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K24: k-mer extraction from [N, L] uint8 base codes.
// Replaces shannon_tpu/ops/kmers.py:116 extract_kmers (with _windows_from_c32
// :78, revcomp_hilo :49, canonical_hilo :69).  K1's design with a byte per
// base: one thread per (read, window), consecutive threads on consecutive
// windows, forward key and reverse complement in one k-step loop.  A code >= 4
// (N) invalidates its windows before its low 2 bits are read
// (ops/kmers.py:127-128), so an N never reads as A.  The loop is K1's own,
// written out again: one template for both code sources cost K1's unmasked
// case a third of its speed on the H100 (PERF.md, section 6).
// Bound: memory (k bytes read a window, shared with the neighbours through
// L1; 9 bytes written).
// ---------------------------------------------------------------------------
__global__ void extract_codes_kernel(const uint8_t* __restrict__ codes,
                                     const int32_t* __restrict__ lengths,
                                     int64_t n_reads, int row_len, int n_windows,
                                     int k, int canonical,
                                     int64_t* __restrict__ keys,
                                     uint8_t* __restrict__ valid) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_reads * (int64_t)n_windows) return;
  int64_t r = t / n_windows;
  int j = (int)(t - r * n_windows);
  const uint8_t* row = codes + r * row_len;
  bool ok = j + k <= lengths[r];
  uint64_t fwd = 0, rc = 0;
  for (int i = 0; i < k; ++i) {
    const uint32_t code = row[j + i];
    if (code > 3u) ok = false;
    const uint64_t c = code & 3u;
    fwd = (fwd << 2) | c;
    rc |= (3ull - c) << (2 * i);
  }
  uint64_t v = (canonical && rc < fwd) ? rc : fwd;
  keys[t] = ok ? (int64_t)v : PAD_KEY;
  valid[t] = ok ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K2: run reduction of a sorted key array into a capacity-padded table.
// Replaces shannon_tpu/ops/count.py:196 _spectrum_from_windows ->
// :158 _unique_reduce_unit (unit counts) and :110 _unique_reduce (summed
// counts, as prefix-sum differences).  The TPU compacted with a second sort
// because scatters were slow there; here each run start goes straight to its
// slot.  The sort itself stays torch.sort.
// Bound: memory.  The function must read the m keys (and the m int32 counts
// when merging) and write the three capacity-lane outputs: 8 m (+ 4 m) + 20
// capacity bytes.  One pass over the keys with the single-pass scan of
// scan.cuh.  A tile of 4,096 keys, 16 consecutive keys a thread (loaded as
// longlong2, the counts as int4): a lane is a run start when it is real and
// differs from its left neighbour (a thread reads the key before its first
// lane, the tile's left halo for thread 0).  The tile scans its start flags
// (the look-back gives each start its slot) and the lanes' weights (1 or the
// lane's count, 0 for PAD) in one block scan, and records each start's tile
// offset and the weight before it in shared memory; a run's count is then the
// difference of two neighbouring records (unsigned, so a sum wraps modulo 2^32
// as the plain version's int32 cast does).  The starts are written out with
// consecutive threads on consecutive slots.  A run that crosses a tile edge is
// summed with integer atomicAdd into out_count, which the wrapper zeroed: the
// tile where it starts adds its part (the right halo key says whether the run
// goes on), and each later tile adds the weight of its lanes before its first
// start into slot prefix - 1 (a tile wholly inside a run adds all of its
// weight).  Integer adds commute, so the counts are exact and the same on
// every run.  Only slots below capacity are written; n counts every run.  The
// PAD tail [n, capacity) of out_key is the second launch (scan_fill_tail);
// out_count is zero there already.  No m-length flag, scan or prefix array.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(SCAN_THREADS)
    reduce_runs_kernel(const int64_t* __restrict__ keys, const int32_t* __restrict__ counts,
                       int64_t m, int64_t capacity, unsigned long long* __restrict__ scratch,
                       int64_t* __restrict__ out_key, int32_t* __restrict__ out_count,
                       int64_t* __restrict__ start) {
  __shared__ ScanShared sh;
  __shared__ unsigned s_warp_starts[SCAN_WARPS];
  __shared__ unsigned s_warp_weight[SCAN_WARPS];
  __shared__ uint16_t s_lane[SCAN_TILE];  // tile offset of each start, in order
  __shared__ unsigned s_before[SCAN_TILE];  // the tile's weight before each start
  unsigned long long* status = scratch + 1;
  const long long tile = scan_ticket(scratch, &sh);
  const int64_t base = (int64_t)tile * SCAN_TILE;
  const int first = threadIdx.x * SCAN_ITEMS;
  const int64_t i0 = base + first;

  int64_t k[SCAN_ITEMS];
  unsigned w[SCAN_ITEMS];
  if (i0 + SCAN_ITEMS <= m && ((uintptr_t)(keys + i0) & 15) == 0) {
    const longlong2* kv = reinterpret_cast<const longlong2*>(keys + i0);
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS / 2; ++q) {
      const longlong2 v = kv[q];
      k[2 * q] = v.x;
      k[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) k[j] = i0 + j < m ? keys[i0 + j] : PAD_KEY;
  }
  if (counts == nullptr) {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) w[j] = 1u;
  } else if (i0 + SCAN_ITEMS <= m && ((uintptr_t)(counts + i0) & 15) == 0) {
    const int4* cv = reinterpret_cast<const int4*>(counts + i0);
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS / 4; ++q) {
      const int4 v = cv[q];
      w[4 * q] = (unsigned)v.x;
      w[4 * q + 1] = (unsigned)v.y;
      w[4 * q + 2] = (unsigned)v.z;
      w[4 * q + 3] = (unsigned)v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) w[j] = i0 + j < m ? (unsigned)counts[i0 + j] : 0u;
  }
  // PAD (and lanes past m, read as PAD) weigh 0 and start no run; the key
  // before lane 0 reads as PAD, so a real lane 0 starts a run
  int64_t prev = (i0 > 0 && i0 <= m) ? keys[i0 - 1] : PAD_KEY;
  unsigned bits = 0, weight = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const bool real = k[j] != PAD_KEY;
    if (real && k[j] != prev) bits |= 1u << j;
    if (!real) w[j] = 0u;
    weight += w[j];
    prev = k[j];
  }

  unsigned starts, tile_weight;
  unsigned r = block_exclusive_scan((unsigned)__popc(bits), s_warp_starts, &starts);
  unsigned before = block_exclusive_scan(weight, s_warp_weight, &tile_weight);
  scan_publish_aggregate(status, tile, starts);
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    if ((bits >> j) & 1u) {
      s_lane[r] = (uint16_t)(first + j);
      s_before[r] = before;
      ++r;
    }
    before += w[j];
  }
  const int64_t prefix = (int64_t)scan_tile_prefix(status, tile, starts, &sh);

  // the lanes before the tile's first start continue run prefix - 1
  if (threadIdx.x == 0 && prefix > 0 && prefix - 1 < capacity) {
    const unsigned lead = starts > 0 ? s_before[0] : tile_weight;
    if (lead != 0u) atomicAdd((unsigned*)out_count + (prefix - 1), lead);
  }
  for (unsigned q = threadIdx.x; q < starts; q += SCAN_THREADS) {
    const int64_t g = prefix + q;
    if (g >= capacity) break;
    const int64_t i = base + s_lane[q];
    out_key[g] = keys[i];
    start[g] = i;
    if (q + 1 < starts) {
      out_count[g] = (int32_t)(s_before[q + 1] - s_before[q]);
    } else {
      const unsigned c = tile_weight - s_before[q];
      const int64_t end = base + SCAN_TILE;
      if (end < m && keys[end] != PAD_KEY && keys[end] == keys[end - 1]) {
        atomicAdd((unsigned*)out_count + g, c);  // the run goes on into the next tile
      } else {
        out_count[g] = (int32_t)c;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: exact-hit lookup of query keys in a sorted table.
// Replaces shannon_tpu/ops/spectrum.py:137 lookup_hilo (:71 join_lookup_hilo,
// :28 lower_bound_hilo).  Bound: L1 passes and the latency of scattered
// loads (search.cuh); the bytes it must move are the table and the queries
// read once and idx and hit written once.  The entry point builds the
// 16-ary index of the table (search_build_kernel), then this kernel walks
// it: persistent blocks, a warp takes 32 consecutive queries (one coalesced
// load), each lane finds its own query's node below the top in shared
// memory, and each group of 8 lanes walks its lanes' 8 queries LOOKUP_Q at a
// time down to their leaf lines; the warp then writes their idx and hit
// coalesced.  The main path's queries (read windows against the node table)
// have no order to exploit, so every query walks.  idx is the lower bound
// clamped to C - 1, so a miss still returns a valid lane, as
// lower_bound_hit gives it.
// ---------------------------------------------------------------------------
#define LOOKUP_Q 4

// 6 blocks an SM (40 registers): more queries in flight beat the registers
// the compiler would take otherwise (80 at 3 blocks an SM, 4% slower).
__global__ void __launch_bounds__(SEARCH_THREADS, 6)
    lookup_sorted_kernel(const int64_t* __restrict__ table, int table_len,
                         const int64_t* __restrict__ index, SearchIndex ix,
                         const int64_t* __restrict__ query, int64_t n_query,
                         int64_t* __restrict__ idx, uint8_t* __restrict__ hit) {
  extern __shared__ int64_t top[];
  search_load_top(ix, index, top);
  const int lane = threadIdx.x & 31;
  const int gl = lane & (SEARCH_GROUP - 1), gbase = lane & ~(SEARCH_GROUP - 1);
  const bool table_vec = ((uintptr_t)table & 15) == 0;
  const int64_t chunks = (n_query + 31) / 32;
  const int64_t warp = (int64_t)blockIdx.x * (SEARCH_THREADS / 32) + (threadIdx.x >> 5);
  const int64_t warps = (int64_t)gridDim.x * (SEARCH_THREADS / 32);
  for (int64_t c = warp; c < chunks; c += warps) {
    const int64_t i = c * 32 + lane;
    const bool live = i < n_query;
    const int64_t mine = live ? query[i] : 0;
    const int my_node = search_top(ix, top, mine);
    int my_lb = 0;
    bool my_hit = false;
#pragma unroll
    for (int b = 0; b < SEARCH_GROUP / LOOKUP_Q; ++b) {
      int64_t q[LOOKUP_Q];
      int node[LOOKUP_Q], lb[LOOKUP_Q];
      bool h[LOOKUP_Q];
#pragma unroll
      for (int j = 0; j < LOOKUP_Q; ++j) {
        const int src = gbase + b * LOOKUP_Q + j;
        q[j] = __shfl_sync(SEARCH_FULL_MASK, mine, src);
        node[j] = __shfl_sync(SEARCH_FULL_MASK, my_node, src);
      }
      search_walk<LOOKUP_Q>(ix, index, table, table_len, table_vec, q, node, lb, h);
#pragma unroll
      for (int j = 0; j < LOOKUP_Q; ++j) {
        if (gl == b * LOOKUP_Q + j) {
          my_lb = lb[j];
          my_hit = h[j];
        }
      }
    }
    if (live) {
      idx[i] = my_lb < table_len ? my_lb : table_len - 1;
      hit[i] = my_hit ? 1 : 0;
    }
  }
}

// ---------------------------------------------------------------------------
// K17: merge of two sorted count tables (the batch loop's merge).
// Replaces shannon_tpu/ops/count.py:257 _merge_at (with :65 _sort3), which
// re-sorted the concatenation of the two tables.  Both tables are sorted with
// PAD last, so each lane's place in the merged order is its own index plus its
// rank in the other table: a[i] goes to i + (lanes of b below a[i]), b[j] to
// j + (lanes of a at or below b[j]).  These places are a permutation of
// [0, Ca + Cb) (a key found in both tables lands a's lane just before b's), so
// the merged keys equal the sorted concatenation exactly, and K2's single pass
// then sums the counts of equal keys.
// Bound: memory (12 bytes read and written a lane); the rank is a binary
// search of the other table, bounded by the latency of its dependent loads,
// with neighbouring threads on neighbouring keys so the search paths share
// cache lines.  A merge-path partition would make it linear.
// ---------------------------------------------------------------------------
static __device__ __forceinline__ int64_t rank_in(const int64_t* __restrict__ table,
                                                  int64_t len, int64_t key,
                                                  bool inclusive) {
  int64_t lo = 0, hi = len;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    const int64_t v = table[mid];
    if (v < key || (inclusive && v == key)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void merge_tables_kernel(const int64_t* __restrict__ a_key,
                                    const int32_t* __restrict__ a_count,
                                    int64_t Ca,
                                    const int64_t* __restrict__ b_key,
                                    const int32_t* __restrict__ b_count,
                                    int64_t Cb, int64_t* __restrict__ out_key,
                                    int32_t* __restrict__ out_count) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Ca + Cb) return;
  int64_t key, pos;
  int32_t c;
  if (t < Ca) {
    key = a_key[t];
    c = a_count[t];
    pos = t + rank_in(b_key, Cb, key, false);
  } else {
    const int64_t j = t - Ca;
    key = b_key[j];
    c = b_count[j];
    pos = j + rank_in(a_key, Ca, key, true);
  }
  out_key[pos] = key;
  out_count[pos] = c;
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
extern "C" {

const char* shannon_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int shannon_extract_kmers(const void* words, const void* lengths,
                          const void* mask, int64_t n_reads, int words_per_row,
                          int mask_words_per_row, int n_windows, int k,
                          int canonical, void* keys, void* valid,
                          void* stream) {
  int64_t total = n_reads * (int64_t)n_windows;
  if (total > 0) {
    extract_kmers_kernel<<<blocks_for(total), THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const int32_t*)lengths,
        (const uint32_t*)mask, n_reads, words_per_row, mask_words_per_row,
        n_windows, k, canonical, (int64_t*)keys, (uint8_t*)valid);
  }
  return (int)cudaGetLastError();
}

int shannon_extract_codes(const void* codes, const void* lengths, int64_t n_reads,
                          int row_len, int n_windows, int k, int canonical,
                          void* keys, void* valid, void* stream) {
  int64_t total = n_reads * (int64_t)n_windows;
  if (total > 0) {
    extract_codes_kernel<<<blocks_for(total), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const int32_t*)lengths, n_reads, row_len, n_windows,
        k, canonical, (int64_t*)keys, (uint8_t*)valid);
  }
  return (int)cudaGetLastError();
}

// counts: null for unit counts.  out_count must be zeroed (a run that crosses
// a tile edge is summed by atomicAdd); scratch: exactly tiles + 1 zeroed
// words (scan.cuh), tiles = ceil(m / SCAN_TILE), or the call is refused.
// Lanes of start past n are left as they were.
int shannon_reduce_sorted(const void* keys, const void* counts, int64_t m, int64_t capacity,
                          void* scratch, int64_t scratch_words, void* out_key,
                          void* out_count, void* start, void* stream) {
  const long long tiles = scan_tiles(m);
  if (scratch_words != tiles + 1) return (int)cudaErrorInvalidValue;
  if (tiles > 0) {
    reduce_runs_kernel<<<(unsigned int)tiles, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)keys, (const int32_t*)counts, m, capacity,
        (unsigned long long*)scratch, (int64_t*)out_key, (int32_t*)out_count,
        (int64_t*)start);
  }
  scan_fill_tail((const unsigned long long*)scratch, tiles, capacity, (int64_t*)out_key,
                 nullptr, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int shannon_merge_tables(const void* a_key, const void* a_count, int64_t Ca,
                         const void* b_key, const void* b_count, int64_t Cb,
                         void* out_key, void* out_count, void* stream) {
  if (Ca + Cb > 0) {
    merge_tables_kernel<<<blocks_for(Ca + Cb), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)a_key, (const int32_t*)a_count, Ca, (const int64_t*)b_key,
        (const int32_t*)b_count, Cb, (int64_t*)out_key, (int32_t*)out_count);
  }
  return (int)cudaGetLastError();
}

// layout: SEARCH_LAYOUT_WORDS host words (ops/spectrum.py search_layout);
// scratch: exactly the index's words, or the call is refused.
int shannon_lookup_sorted(const void* table, int64_t table_len, const void* query,
                          int64_t n_query, void* scratch, int64_t scratch_words,
                          const void* layout, void* idx, void* hit, void* stream) {
  SearchIndex ix;
  if (!search_index_from((const int64_t*)layout, table_len, scratch_words, &ix)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_query == 0) return (int)cudaGetLastError();
  cudaError_t err = search_build((const int64_t*)table, table_len, ix, scratch_words,
                                 (int64_t*)scratch, (cudaStream_t)stream);
  const size_t smem = sizeof(int64_t) * (size_t)ix.top_size;
  unsigned int grid = 0;
  if (err == cudaSuccess) {
    err = search_grid((const void*)lookup_sorted_kernel, smem,
                      (n_query + SEARCH_THREADS - 1) / SEARCH_THREADS, &grid);
  }
  if (err != cudaSuccess) return (int)err;
  lookup_sorted_kernel<<<grid, SEARCH_THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)table, (int)table_len, (const int64_t*)scratch, ix, (const int64_t*)query,
      n_query, (int64_t*)idx, (uint8_t*)hit);
  return (int)cudaGetLastError();
}

}  // extern "C"
