// Hand-written Hopper (sm_90a) kernels of the shannon_tpu_torch port: the
// k-mer kernels K1-K3 and K24 and the count merge K17 (threading's K4-K5 are
// in thread.cu, the sparse-flow solver K6 in sparseflow.cu, correction's
// K7, K9, K10, K16, K20 and K23 in correction.cu and its dead-end rescue K8
// in rescue.cu, condensation's K11-K15 in condense.cu, tip clip's K18-K19 in
// tipclip.cu, the count lookups K21-K22 in spectrum.cu, the sharded count's
// owner bucketing K25 in distributed.cu).
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
#include "merge.cuh"
#include "scan.cuh"
#include "search.cuh"

// ---------------------------------------------------------------------------
// K1: k-mer extraction from 2-bit packed reads.
// Replaces shannon_tpu/ops/kmers.py:151 extract_kmers_packed (with
// unpack_words_device :131, unpack_mask_device :142, _windows_from_c32 :78,
// revcomp_hilo :49, canonical_hilo :69).
// Bound: memory.  Each window writes 9 bytes (key + valid); the read rows
// are 4 bytes a 16 bases.  A block stages a run of read rows (their words,
// mask words and lengths) in shared memory with coalesced loads, then its
// threads walk the block's flat windows (extract_windows, shared with K24).
// Rows too long to stage in EXTRACT_SMEM bytes are read from device memory
// in place, a row a block.
// ---------------------------------------------------------------------------
#define EXTRACT_ROWS 32
#define EXTRACT_SMEM (48 * 1024)

// The window walk of K1 and K24 over a block's rows in K1's layout: `rows`
// rows of words_per_row 2-bit words (base p at bits 2(p & 15) of word p >> 4)
// and wm N-mask words (bit p & 31 of word p >> 5 set where base p is
// invalid; row_mask null for none), and each row's length in row_len; the
// keys and flags of row r's window j go to out_key / out_valid[r * n_windows
// + j].  Consecutive threads take consecutive windows across row ends, so
// every key and valid store is coalesced; a thread finds its first window's
// row with one 32-bit division and steps row and offset by constants after
// that.  A window is one funnel shift of the (at most three) words holding
// bases [j, j + k): S, base j in its low bits.  That is the reverse
// complement with its bases complemented, so rc = ~S & mask and fwd =
// revcomp_bits(rc, k); no per-base loop.  The mask bits of [j, j + k) are
// one funnel shift of at most two mask words.  Words past a row's last read
// 0, so bases past it only ever land above the window's 2k bits.
static __device__ __forceinline__ void extract_windows(
    const uint32_t* row_words, int words_per_row, const uint32_t* row_mask, int wm,
    const int32_t* row_len, int rows, int n_windows, int k, int canonical,
    int64_t* __restrict__ out_key, uint8_t* __restrict__ out_valid) {
  const uint64_t kmask = (1ull << (2 * k)) - 1;
  const uint32_t bad_bits = 0xFFFFFFFFu >> (32 - k);
  const int total = rows * n_windows;
  const int step_r = blockDim.x / n_windows, step_j = blockDim.x - step_r * n_windows;
  int r = threadIdx.x / n_windows;
  int j = threadIdx.x - r * n_windows;
  for (int f = threadIdx.x; f < total; f += blockDim.x) {
    const uint32_t* row = row_words + r * words_per_row;
    const int w0 = j >> 4, shift = 2 * (j & 15);
    const uint32_t x0 = row[w0];
    const uint32_t x1 = w0 + 1 < words_per_row ? row[w0 + 1] : 0u;
    const uint32_t x2 = w0 + 2 < words_per_row ? row[w0 + 2] : 0u;
    const uint64_t S = ((uint64_t)__funnelshift_r(x1, x2, shift) << 32) |
                       (uint64_t)__funnelshift_r(x0, x1, shift);
    const uint64_t rc = ~S & kmask;
    const uint64_t fwd = revcomp_bits(rc, k);
    bool ok = j + k <= row_len[r];
    if (row_mask != nullptr) {
      const uint32_t* mrow = row_mask + r * wm;
      const int m0 = j >> 5;
      const uint32_t y1 = m0 + 1 < wm ? mrow[m0 + 1] : 0u;
      if (__funnelshift_r(mrow[m0], y1, j & 31) & bad_bits) ok = false;
    }
    const uint64_t v = (canonical && rc < fwd) ? rc : fwd;
    out_key[f] = ok ? (int64_t)v : PAD_KEY;
    out_valid[f] = ok ? 1 : 0;
    j += step_j;
    r += step_r;
    if (j >= n_windows) {
      j -= n_windows;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    extract_kmers_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ lengths,
                         const uint32_t* __restrict__ mask, int64_t n_reads, int words_per_row,
                         int mask_words_per_row, int n_windows, int k, int canonical,
                         int rows_per_block, int staged, int64_t* __restrict__ keys,
                         uint8_t* __restrict__ valid) {
  extern __shared__ uint32_t s_rows[];
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int rows = (int)(n_reads - r0 < rows_per_block ? n_reads - r0 : rows_per_block);
  const int wm = mask != nullptr ? mask_words_per_row : 0;
  const int n_words = rows * words_per_row, n_mask = rows * wm;
  const uint32_t* row_words = words + r0 * words_per_row;
  const uint32_t* row_mask = mask != nullptr ? mask + r0 * wm : nullptr;
  int32_t* s_len = (int32_t*)s_rows;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) s_len[i] = lengths[r0 + i];
  if (staged) {
    uint32_t* s_words = s_rows + rows_per_block;
    uint32_t* s_mask = s_words + n_words;
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) s_words[i] = row_words[i];
    for (int i = threadIdx.x; i < n_mask; i += blockDim.x) s_mask[i] = row_mask[i];
    row_words = s_words;
    row_mask = mask != nullptr ? s_mask : nullptr;
  }
  __syncthreads();
  extract_windows(row_words, words_per_row, row_mask, wm, s_len, rows, n_windows, k, canonical,
                  keys + r0 * n_windows, valid + r0 * n_windows);
}

// ---------------------------------------------------------------------------
// K24: k-mer extraction from [N, L] uint8 base codes.
// Replaces shannon_tpu/ops/kmers.py:116 extract_kmers (with _windows_from_c32
// :78, revcomp_hilo :49, canonical_hilo :69).  A code >= 4 (N) invalidates
// its windows before its low 2 bits are read (ops/kmers.py:127-128), so an N
// never reads as A.
// Bound: memory.  The function must read the codes once (a byte a base) and
// write 9 bytes a window; at 65,536 x 128 codes and k = 24, 8.4 MB in and
// 61.9 MB out, 0.021 ms at 3.35 TB/s.  K1 writes the same windows from 2-bit
// words; K24 packs its bytes straight into K1's layout in shared memory and
// runs K1's window walk (extract_windows), so no thread loops over a
// window's bytes.
// Design.
//  - A block takes a run of rows, whose code bytes are one contiguous span
//    [r0 L, (r0 + rows) L).  A thread takes 16 bases of a row: the <= 5
//    aligned 4-byte words that hold them (byte loads for a word that
//    straddles either end of the span, so any L (100, 101) and any view's
//    start work), funnel-shifted by the bases' byte offset, become one 2-bit
//    word (each byte's low 2 bits, four bases a byte by two shift-ors) and
//    one half of an N-mask word (__vcmpgtu4 against 3, one bit a byte by a
//    multiply), stored in shared memory; bytes past the row count as 0.
//    Consecutive threads take consecutive 16 bases, so the warp's loads are
//    coalesced, and the bytes never pass through shared memory.
//  - Then, after one barrier, the block walks its windows as K1 does.
//  - A row too long to stage (its lengths, words and mask past EXTRACT_SMEM)
//    is taken in pieces of CODES_PIECE windows, a piece a block: the piece
//    stages its windows' bases, CODES_PIECE + k - 1 of them (a k - 1 base
//    halo past its last window), as a row of its own whose length is the
//    read's less the piece's first window, and its keys go to that window's
//    place in the row.
// ---------------------------------------------------------------------------
#define CODES_PIECE 16384

// Bytes of shared memory a K24 block of `rows` rows of `len` bases takes:
// the lengths, the 2-bit words (one a 16 bases) and the mask words (one a
// 32 bases).
static __host__ __device__ inline int64_t codes_smem_bytes(int64_t rows, int64_t len) {
  const int64_t units = (len + 15) / 16;
  return 4 * rows * (1 + units + (units + 1) / 2);
}

// Four code bytes as four bases' 2-bit codes (low byte first, 8 bits).
static __device__ __forceinline__ uint32_t pack4(uint32_t b) {
  const uint32_t c = b & 0x03030303u;
  const uint32_t t = c | (c >> 6);
  return (t & 0xFu) | ((t >> 12) & 0xF0u);
}

// Four code bytes as four N-mask bits: bit q set where byte q is >= 4.
static __device__ __forceinline__ uint32_t bad4(uint32_t b) {
  return ((__vcmpgtu4(b, 0x03030303u) & 0x08040201u) * 0x01010101u) >> 24;
}

// The aligned 4-byte word at w, its bytes outside [lo, hi) read as 0 (and
// not read).
static __device__ __forceinline__ uint32_t span_word(const uint32_t* w, const uint8_t* lo,
                                                     const uint8_t* hi) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(w);
  if (p >= lo && p + 4 <= hi) return __ldg(w);
  uint32_t x = 0;
  for (int b = 0; b < 4; ++b) {
    if (p + b >= lo && p + b < hi) x |= (uint32_t)p[b] << (8 * b);
  }
  return x;
}

__global__ void __launch_bounds__(THREADS)
    extract_codes_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                         int64_t n_reads, int row_len, int n_windows, int k, int canonical,
                         int rows_per_block, int pieces, int64_t* __restrict__ keys,
                         uint8_t* __restrict__ valid) {
  // pieces: 0 where a block takes rows_per_block whole rows, else each row's
  // pieces (rows_per_block is then 1)
  extern __shared__ uint32_t s_codes[];
  int64_t r0;
  int rows, len, win, j0;
  if (pieces == 0) {  // whole rows
    r0 = (int64_t)blockIdx.x * rows_per_block;
    rows = (int)(n_reads - r0 < rows_per_block ? n_reads - r0 : rows_per_block);
    j0 = 0;
    win = n_windows;
    len = row_len;
  } else {  // a piece of one row
    r0 = blockIdx.x / pieces;
    j0 = (int)(blockIdx.x - r0 * pieces) * CODES_PIECE;
    rows = 1;
    win = n_windows - j0 < CODES_PIECE ? n_windows - j0 : CODES_PIECE;
    len = win + k - 1;
  }
  const int units = (len + 15) >> 4;  // 2-bit words a row, 16 bases each
  const int wm = (units + 1) >> 1;    // mask words a row, 32 bases each
  int32_t* s_len = (int32_t*)s_codes;
  uint32_t* s_words = s_codes + rows_per_block;
  uint32_t* s_mask = s_words + rows_per_block * units;
  uint16_t* s_half = reinterpret_cast<uint16_t*>(s_mask);

  const uint8_t* src = codes + r0 * row_len + j0;
  const uint8_t* end = src + rows * len;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) s_len[i] = lengths[r0 + i] - j0;
  for (int t = threadIdx.x; t < rows * units; t += blockDim.x) {
    const int i = t / units, u = t - i * units;
    const uint8_t* a = src + i * len + 16 * u;
    const int nb = min(16, len - 16 * u);  // the unit's bases inside the row
    const uint32_t* w = reinterpret_cast<const uint32_t*>((uintptr_t)a & ~(uintptr_t)3);
    const int sh = 8 * (int)((uintptr_t)a & 3);
    const int nw = (sh / 8 + nb + 3) >> 2;  // words holding the unit's bytes
    uint32_t x[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) x[q] = q < nw ? span_word(w + q, src, end) : 0u;
    uint32_t word = 0, bad = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t b = __funnelshift_r(x[q], x[q + 1], sh);
      const int in_row = nb - 4 * q;
      if (in_row < 4) b = in_row <= 0 ? 0u : b & ((1u << (8 * in_row)) - 1u);
      word |= pack4(b) << (8 * q);
      bad |= bad4(b) << (4 * q);
    }
    s_words[i * units + u] = word;
    s_half[2 * (i * wm + (u >> 1)) + (u & 1)] = (uint16_t)bad;
    if ((u & 1) == 0 && u + 1 == units) s_half[2 * (i * wm + (u >> 1)) + 1] = 0;
  }
  __syncthreads();
  extract_windows(s_words, units, s_mask, wm, s_len, rows, win, k, canonical,
                  keys + r0 * n_windows + j0, valid + r0 * n_windows + j0);
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
// Replaces shannon_tpu/ops/count.py:257 _merge_at (with :65 _sort3 and :110
// _unique_reduce), which re-sorted the concatenation of the two tables and
// summed the counts of equal keys.  One pass that merges and sums, on the
// single-pass scan of scan.cuh, then the scan's tail fill.
//  - Real lengths: every block finds the first PAD lane of a and of b (a
//    32-ary search by one warp each), so the merge reads only real lanes and
//    its result depends on the keys alone.
//  - Tiles: persistent blocks take SCAN_TILE merged lanes at a time by
//    ticket, until a ticket lies past na + nb.  A tile finds the merge-path
//    split of its two diagonals (a 32-ary search by one warp each), loads its
//    runs of a and b, keys and counts, coalesced into shared memory (one pad
//    slot every 32, so the threads' merge heads fall on different banks),
//    and each thread merges its SCAN_ITEMS lanes from a binary search of its
//    own diagonal there (merge.cuh, shared with K18).  Ties go to a, in the
//    splits and in the merge alike; equal keys are summed, so any fixed rule
//    gives the same table.
//  - Then K2's tile logic (reduce_runs_kernel): start flags and weights,
//    the two block scans, the look-back, each start's slot and the weight
//    before it recorded in shared memory, and the copy-out from there.  A
//    thread merges its lanes twice, for the flags and weights before the
//    scans and for the records after them, so that no lane's key or count
//    is held across the scans (3 blocks an SM).  The key before the tile is
//    the larger of a[a0 - 1] and b[b0 - 1], the key after it the smaller of
//    the two heads past the tile.  A run that crosses a
//    tile edge is summed by atomicAdd into out_count, which the wrapper
//    zeroed, as in K2; a run may be of any length (a table may repeat a key).
//    Counts sum as unsigned, modulo 2^32, as the plain version's int32 cast.
//  - n counts every distinct key, past capacity too.  The tile that holds
//    the last merged lane also stores its inclusive word in the last status
//    word of the scratch, where kernels.scan_total and the tail fill read n.
// Bound: memory.  The function must read the real lanes of both tables, 12
// bytes each, and write the capacity lanes of the merged table, 12 bytes
// each.  No (Ca + Cb)-lane temporary, sort or scan array.
// ---------------------------------------------------------------------------
// The tile's keys and counts, then each start's weight before it and slot.
#define MERGE_SMEM                                        \
  (MERGE_SLOTS * (sizeof(int64_t) + sizeof(unsigned)) + \
   SCAN_TILE * (sizeof(unsigned) + sizeof(uint16_t)))

// The tile helpers (real lengths, splits, the coalesced load and a thread's
// split) are in merge.cuh, shared with K18.

// Merges a thread's lanes [first, first + SCAN_ITEMS) of the tile (clipped
// to L) from its split: ai of a's lanes before `first`, `prev` the merged
// key before it.  visit(j, slot, start, count) for each lane in order, where
// slot is the lane's shared-memory slot and start whether its key differs
// from the one before (every lane below L is real).  Ties go to a.
template <typename Visit>
static __device__ __forceinline__ void merge_lanes(const int64_t* s_key, const unsigned* s_count,
                                                   int la, int lb, int L, int first, int ai,
                                                   int64_t prev, Visit visit) {
  int bi = first - ai;
  // a run's head reads as PAD once it is used up; real keys sort below PAD
  int64_t ka = ai < la ? s_key[merge_slot(ai)] : PAD_KEY;
  int64_t kb = bi < lb ? s_key[merge_slot(la + bi)] : PAD_KEY;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    if (first + j >= L) break;
    int slot;
    int64_t key;
    if (ka <= kb) {
      key = ka;
      slot = merge_slot(ai++);
      ka = ai < la ? s_key[merge_slot(ai)] : PAD_KEY;
    } else {
      key = kb;
      slot = merge_slot(la + bi++);
      kb = bi < lb ? s_key[merge_slot(la + bi)] : PAD_KEY;
    }
    visit(j, slot, key != prev, s_count[slot]);
    prev = key;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS, 3)
    merge_runs_kernel(const int64_t* __restrict__ a_key, const int32_t* __restrict__ a_count,
                      int64_t Ca, const int64_t* __restrict__ b_key,
                      const int32_t* __restrict__ b_count, int64_t Cb, int64_t capacity,
                      unsigned long long* __restrict__ scratch, long long last_tile,
                      int64_t* __restrict__ out_key, int32_t* __restrict__ out_count) {
  extern __shared__ int64_t s_merge[];
  int64_t* s_key = s_merge;  // the tile's keys: a's run, then b's
  unsigned* s_count = (unsigned*)(s_key + MERGE_SLOTS);  // their counts
  unsigned* s_before = s_count + MERGE_SLOTS;  // the tile's weight before each start
  uint16_t* s_lane = (uint16_t*)(s_before + SCAN_TILE);  // each start's slot, in order
  __shared__ ScanShared sh;
  __shared__ unsigned s_warp_starts[SCAN_WARPS];
  __shared__ unsigned s_warp_weight[SCAN_WARPS];
  __shared__ int64_t s_len[2];    // na, nb
  __shared__ int64_t s_split[2];  // a's lanes before the tile's two diagonals
  __shared__ int64_t s_edge[2];   // the merged key before the tile, and after it
  unsigned long long* status = scratch + 1;
  const int64_t lowest = -PAD_KEY - 1;

  merge_real_lengths(a_key, Ca, b_key, Cb, s_len);
  const int64_t na = s_len[0], nb = s_len[1], N = na + nb;

  for (;;) {
    const long long tile = scan_ticket(scratch, &sh);
    const int64_t d0 = (int64_t)tile * SCAN_TILE;
    if (d0 >= N) break;
    const int64_t d1 = d0 + SCAN_TILE < N ? d0 + SCAN_TILE : N;
    merge_tile_splits(a_key, na, b_key, nb, d0, d1, s_split);
    const int64_t a0 = s_split[0], a1 = s_split[1], b0 = d0 - a0, b1 = d1 - a1;
    const int la = (int)(a1 - a0), L = (int)(d1 - d0), lb = L - la;

    merge_load_tile<true>(a_key, a_count, a0, b_key, b_count, b0, la, L, s_key, s_count);
    if (threadIdx.x == SCAN_THREADS - 1) {
      int64_t before = PAD_KEY;  // before lane 0, as in K2: a real lane 0 starts a run
      if (d0 > 0) {
        const int64_t x = a0 > 0 ? a_key[a0 - 1] : lowest;
        const int64_t y = b0 > 0 ? b_key[b0 - 1] : lowest;
        before = x > y ? x : y;
      }
      const int64_t x = a1 < na ? a_key[a1] : PAD_KEY;
      const int64_t y = b1 < nb ? b_key[b1] : PAD_KEY;
      s_edge[0] = before;
      s_edge[1] = x < y ? x : y;
    }
    __syncthreads();

    // this thread's diagonal: its split by binary search in the tile, and
    // the merged key before its first lane
    const int first = threadIdx.x * SCAN_ITEMS;
    int ai = 0;
    int64_t prev = s_edge[0];
    if (first < L) {
      ai = merge_thread_split(s_key, la, lb, first);
      const int bi = first - ai;
      if (first > 0) {
        const int64_t x = ai > 0 ? s_key[merge_slot(ai - 1)] : lowest;
        const int64_t y = bi > 0 ? s_key[merge_slot(la + bi - 1)] : lowest;
        prev = x > y ? x : y;
      }
    }
    unsigned bits = 0, weight = 0;
    merge_lanes(s_key, s_count, la, lb, L, first, ai, prev,
                [&](int j, int, bool start, unsigned c) {
                  if (start) bits |= 1u << j;
                  weight += c;
                });

    unsigned starts, tile_weight;
    unsigned r = block_exclusive_scan((unsigned)__popc(bits), s_warp_starts, &starts);
    unsigned before = block_exclusive_scan(weight, s_warp_weight, &tile_weight);
    scan_publish_aggregate(status, tile, starts);
    // the merge again, recording each start's slot and the weight before it
    merge_lanes(s_key, s_count, la, lb, L, first, ai, prev,
                [&](int, int slot, bool start, unsigned c) {
                  if (start) {
                    s_lane[r] = (uint16_t)slot;
                    s_before[r] = before;
                    ++r;
                  }
                  before += c;
                });
    const int64_t prefix = (int64_t)scan_tile_prefix(status, tile, starts, &sh);

    // the lanes before the tile's first start continue run prefix - 1
    if (threadIdx.x == 0 && prefix > 0 && prefix - 1 < capacity) {
      const unsigned lead = starts > 0 ? s_before[0] : tile_weight;
      if (lead != 0u) atomicAdd((unsigned*)out_count + (prefix - 1), lead);
    }
    for (unsigned q = threadIdx.x; q < starts; q += SCAN_THREADS) {
      const int64_t g = prefix + q;
      if (g >= capacity) break;
      const int64_t key = s_key[s_lane[q]];
      out_key[g] = key;
      if (q + 1 < starts) {
        out_count[g] = (int32_t)(s_before[q + 1] - s_before[q]);
      } else {
        const unsigned c = tile_weight - s_before[q];
        if (s_edge[1] == key) {
          atomicAdd((unsigned*)out_count + g, c);  // the run goes on into the next tile
        } else {
          out_count[g] = (int32_t)c;
        }
      }
    }
    if (threadIdx.x == 0 && d1 == N && tile != last_tile) {
      scan_store(status + last_tile, SCAN_INCLUSIVE | (unsigned long long)(prefix + starts));
    }
  }
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
extern "C" {

const char* shannon_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// A block stages up to EXTRACT_ROWS rows in EXTRACT_SMEM bytes of shared
// memory; a row longer than that is read in place, a row a block.
int shannon_extract_kmers(const void* words, const void* lengths,
                          const void* mask, int64_t n_reads, int words_per_row,
                          int mask_words_per_row, int n_windows, int k,
                          int canonical, void* keys, void* valid,
                          void* stream) {
  if (n_reads <= 0 || n_windows <= 0) return (int)cudaGetLastError();
  const int64_t row_bytes =
      4 * (1 + (int64_t)words_per_row + (mask != nullptr ? mask_words_per_row : 0));
  int64_t rows = EXTRACT_SMEM / row_bytes;
  const int staged = rows > 0;
  if (rows > EXTRACT_ROWS) rows = EXTRACT_ROWS;
  if (rows < 1) rows = 1;
  const size_t smem = (size_t)(staged ? rows * row_bytes : 4 * rows);
  extract_kmers_kernel<<<(unsigned int)((n_reads + rows - 1) / rows), THREADS, smem,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)lengths, (const uint32_t*)mask, n_reads,
      words_per_row, mask_words_per_row, n_windows, k, canonical, (int)rows, staged,
      (int64_t*)keys, (uint8_t*)valid);
  return (int)cudaGetLastError();
}

// A block takes whole rows that fit EXTRACT_SMEM bytes of shared memory
// (codes_smem_bytes): up to EXTRACT_ROWS, and no more than n_reads / sms
// rounded up, so that a small batch still spreads over the card's sms SMs
// (a dry run's 256-row shard: 2 rows a block, its 2,048-row batch 16); a
// row that does not fit alone is taken in pieces of CODES_PIECE windows, a
// piece a block.  On an H100 a shard took 2.00 us at 2 rows a block against
// 2.05 at 1; a block trimmed to its windows gained at most 0.01 us more.
int shannon_extract_codes(const void* codes, const void* lengths, int64_t n_reads, int row_len,
                          int n_windows, int k, int canonical, int sms, void* keys, void* valid,
                          void* stream) {
  if (sms < 1) return (int)cudaErrorInvalidValue;
  if (n_reads <= 0 || n_windows <= 0) return (int)cudaGetLastError();
  const int64_t spread = (n_reads + sms - 1) / sms;
  int64_t rows = spread < EXTRACT_ROWS ? spread : EXTRACT_ROWS;
  int64_t len = row_len, blocks = 0;
  while (rows > 0 && codes_smem_bytes(rows, row_len) > EXTRACT_SMEM) --rows;
  int pieces = 0;
  if (rows > 0) {
    blocks = (n_reads + rows - 1) / rows;
  } else {  // W > CODES_PIECE here: a row of that many bases fits
    rows = 1;
    pieces = (n_windows + CODES_PIECE - 1) / CODES_PIECE;
    len = CODES_PIECE + k - 1;
    blocks = n_reads * pieces;
  }
  extract_codes_kernel<<<(unsigned int)blocks, THREADS, (size_t)codes_smem_bytes(rows, len),
                         (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)lengths, n_reads, row_len, n_windows, k, canonical,
      (int)rows, pieces, (int64_t*)keys, (uint8_t*)valid);
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

// out_count must be zeroed (a run that crosses a tile edge is summed by
// atomicAdd); scratch: exactly tiles + 1 zeroed words (scan.cuh), tiles =
// ceil((Ca + Cb) / SCAN_TILE), or the call is refused.  The grid is the
// blocks that fit on the card at once, at most tiles.
static_assert(SEARCH_THREADS == SCAN_THREADS, "search_grid sizes K17's grid");

int shannon_merge_tables(const void* a_key, const void* a_count, int64_t Ca,
                         const void* b_key, const void* b_count, int64_t Cb,
                         int64_t capacity, void* scratch, int64_t scratch_words,
                         void* out_key, void* out_count, void* stream) {
  const long long tiles = scan_tiles(Ca + Cb);
  if (scratch_words != tiles + 1) return (int)cudaErrorInvalidValue;
  if (tiles > 0) {
    unsigned int grid = 0;
    cudaError_t err = cudaFuncSetAttribute((const void*)merge_runs_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)MERGE_SMEM);
    if (err == cudaSuccess) {
      err = search_grid((const void*)merge_runs_kernel, MERGE_SMEM, tiles, &grid);
    }
    if (err != cudaSuccess) return (int)err;
    merge_runs_kernel<<<grid, SCAN_THREADS, MERGE_SMEM, (cudaStream_t)stream>>>(
        (const int64_t*)a_key, (const int32_t*)a_count, Ca, (const int64_t*)b_key,
        (const int32_t*)b_count, Cb, capacity, (unsigned long long*)scratch, tiles - 1,
        (int64_t*)out_key, (int32_t*)out_count);
  }
  scan_fill_tail((const unsigned long long*)scratch, tiles, capacity, (int64_t*)out_key,
                 nullptr, (cudaStream_t)stream);
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
