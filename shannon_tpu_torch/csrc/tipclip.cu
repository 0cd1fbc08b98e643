// Tip-clip kernels K18-K19 of the shannon_tpu_torch port (plain C interface;
// see kernels.cu for the conventions every entry point follows).
//
// The clip's host rounds decide which contigs go and how the survivors merge;
// these kernels apply that decision to the k-mer table (K18) and to the node
// table of the condensation that preceded the clip (K19).  The node table is
// C2 sorted int64 keys, PAD past its real nodes; contig ids, lanes and offsets
// are int64, counts int32.

#include "common.cuh"
#include "merge.cuh"
#include "scan.cuh"
#include "search.cuh"

static __device__ __forceinline__ int64_t clamp_lane(int64_t v, int64_t len) {
  return v < 0 ? 0 : (v < len ? v : len - 1);
}

// ---------------------------------------------------------------------------
// K18: the k-mers that survive the clip, compacted.
// Replaces shannon_tpu/ops/tipclip.py:407 _drop_contigs: its lookup of every
// k-mer in the node table, contig gather, doom test and compaction.  A lane
// is dropped where it is PAD, or where its key is in the node table, the
// contig id at the first equal node lane is >= 0 and that contig's doom flag
// (at the reference's clamp of the id to [0, C2 - 1]) is set.
// Both tables are sorted, so one merge join finds every hit: in the merge of
// the spectrum's real keys a with the real node keys b, ties to a, the b lanes
// before a k-mer are exactly the node keys below it, so the b head after it
// is its lower bound, and a hit where that head holds the same key.  One
// pass, on merge.cuh's tiles (as K17) and scan.cuh's look-back (as K10):
//  - persistent blocks take SCAN_TILE merged lanes at a time, split by
//    merge-path, so a tile never spans more than SCAN_TILE lanes of either
//    table, however the keys are spread (the reverse complements crowd the
//    high key range, where the canonical k-mers thin out);
//  - the tile's keys go to shared memory and each thread walks its
//    SCAN_ITEMS merged lanes, noting each k-mer's lower bound; past the
//    tile's b run, the b head is the first node key after the tile;
//  - the thread gathers node_cid at its hits and the doom flag of each
//    contig id >= 0 (both loads independent, issued together), counts its
//    kept k-mers, and the tile scans them and looks back;
//  - the kept keys are copied out of shared memory, their counts gathered in
//    lane order, to their slots.
// The tile that holds the last merged lane stores its inclusive word in the
// last status word, where kernels.scan_total and the tail fill read n; then
// scan_fill_tail_kernel writes PAD / 0 over [n, C).
// Bound: memory.  The real spectrum lanes (12 bytes), the real node keys
// once, node_cid at each hit, the clipped table out; the doom flags of the
// contigs stay in L2.  No per-lane binary search, no keep array.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(SCAN_THREADS)
    drop_join_kernel(const int64_t* __restrict__ key, const int32_t* __restrict__ count,
                     int64_t C, const int64_t* __restrict__ node_key,
                     const int64_t* __restrict__ node_cid, int64_t C2,
                     const uint8_t* __restrict__ doomed, unsigned long long* __restrict__ scratch,
                     long long last_tile, int64_t* __restrict__ out_key,
                     int32_t* __restrict__ out_count) {
  __shared__ int64_t s_key[MERGE_SLOTS];  // the tile's spectrum keys, then its node keys
  __shared__ uint16_t s_lane[SCAN_TILE];  // the tile's kept spectrum lanes, in order
  __shared__ ScanShared sh;
  __shared__ unsigned s_warp[SCAN_WARPS];
  __shared__ int64_t s_len[2];    // real spectrum lanes, real node lanes
  __shared__ int64_t s_split[2];  // spectrum lanes before the tile's two diagonals
  __shared__ int64_t s_edge;      // the first node key after the tile, or PAD
  unsigned long long* status = scratch + 1;

  merge_real_lengths(key, C, node_key, C2, s_len);
  const int64_t na = s_len[0], nb = s_len[1], N = na + nb;

  for (;;) {
    const long long tile = scan_ticket(scratch, &sh);
    const int64_t d0 = (int64_t)tile * SCAN_TILE;
    if (d0 >= N) break;
    const int64_t d1 = d0 + SCAN_TILE < N ? d0 + SCAN_TILE : N;
    merge_tile_splits(key, na, node_key, nb, d0, d1, s_split);
    const int64_t a0 = s_split[0], a1 = s_split[1], b0 = d0 - a0, b1 = d1 - a1;
    const int la = (int)(a1 - a0), L = (int)(d1 - d0), lb = L - la;
    merge_load_tile<false>(key, nullptr, a0, node_key, nullptr, b0, la, L, s_key, nullptr);
    if (threadIdx.x == SCAN_THREADS - 1) s_edge = b1 < nb ? node_key[b1] : PAD_KEY;
    __syncthreads();

    // the walk: bit j of is_a marks a k-mer at the thread's merged lane j,
    // hit[j] the node lane of its key or -1
    const int first = threadIdx.x * SCAN_ITEMS;
    int ai0 = 0;
    unsigned is_a = 0;
    int64_t hit[SCAN_ITEMS];
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) hit[j] = -1;
    if (first < L) {
      ai0 = merge_thread_split(s_key, la, lb, first);
      int ai = ai0, bi = first - ai0;
      // a used-up spectrum run reads as PAD; a used-up node run as the edge
      int64_t ka = ai < la ? s_key[merge_slot(ai)] : PAD_KEY;
      int64_t kb = bi < lb ? s_key[merge_slot(la + bi)] : s_edge;
#pragma unroll
      for (int j = 0; j < SCAN_ITEMS; ++j) {
        if (first + j < L) {
          if (ka <= kb) {
            is_a |= 1u << j;
            if (ka == kb) hit[j] = b0 + bi;
            ++ai;
            ka = ai < la ? s_key[merge_slot(ai)] : PAD_KEY;
          } else {
            ++bi;
            kb = bi < lb ? s_key[merge_slot(la + bi)] : s_edge;
          }
        }
      }
    }
    int64_t cid[SCAN_ITEMS];
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) cid[j] = hit[j] >= 0 ? node_cid[hit[j]] : -1;
    // kept, by the rank of the k-mer among the thread's k-mers ai0, ai0 + 1, ...
    unsigned kept = 0;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      if ((is_a >> j) & 1u) {
        if (cid[j] < 0 || !doomed[cid[j] < C2 ? cid[j] : C2 - 1]) kept |= 1u << rank;
        ++rank;
      }
    }

    unsigned total;
    const unsigned r = block_exclusive_scan((unsigned)__popc(kept), s_warp, &total);
    scan_publish_aggregate(status, tile, total);
    scan_record_lanes(kept, ai0, r, s_lane);
    const int64_t prefix = (int64_t)scan_tile_prefix(status, tile, total, &sh);
    for (unsigned q = threadIdx.x; q < total; q += SCAN_THREADS) {
      const int t = s_lane[q];
      out_key[prefix + q] = s_key[merge_slot(t)];
      out_count[prefix + q] = count[a0 + t];
    }
    if (threadIdx.x == 0 && d1 == N && tile != last_tile) {
      scan_store(status + last_tile, SCAN_INCLUSIVE | (unsigned long long)(prefix + total));
    }
  }
}

// ---------------------------------------------------------------------------
// K19: the node table renumbered to the merged contigs and front-compacted.
// Replaces shannon_tpu/ops/tipclip.py:423 _device_clip_remap, which moved the
// kept lanes to the front with a sort of (position key, iota) and gathered
// every field through the permutation.  A lane is kept where its contig
// survives: node_cid >= 0 and new_cid at the reference's clamp of node_cid to
// [0, npad - 1] is >= 0.  Kept lanes keep table order, so the table stays
// sorted without a sort.  Two launches:
//  - remap_nodes_kernel, one pass on scan.cuh over the C2 node lanes, the
//    keep test in registers: a warp reads 16 words of 32 lanes coalesced, a
//    lane a node, and each word's keep bits are one ballot; the tile counts
//    its kept lanes, looks back, and copies each kept lane whose slot is
//    below out_cap (key, count, new cid, shifted offset) to its slot, as K10
//    copies.  It also leaves a rank structure in the scratch: the ballots,
//    a keep bit a lane, and for each word the kept lanes of its tile before
//    it (a uint16), ahead of each tile's inclusive status word.  Old lane h's
//    new lane, the plain version's cumsum - 1, is then
//    incl[tile(h) - 1] + word_count[h / 32]
//    + popc(bits[h / 32] & (the bits through h % 32)) - 1, for any h,
//    dropped lanes included.
//  - remap_tail_kernel, in stream order after every tile: lanes
//    [min(n_keep, out_cap), out_cap) get PAD / 0 / -1 / -1, n_keep read from
//    the last status word; and each new contig's head and tail lane through
//    the rank structure, and its float32 abundance
//    __fdiv_rn(__ll2float_rn(sum), __ll2float_rn(klen)), bit-equal to the
//    plain float division (K14 does the same; the intrinsics keep nvcc from
//    approximating).
// No keep byte array, no scan array, no torch.cumsum; the entry zeroes the
// ticket and status words itself, and the wrapper reads n_keep once, after
// both launches.
// Bound: memory.  node_cid of every lane (8 bytes), the key, count and
// offset of each moved lane (20) and its four fields out (28), the new
// contigs' lanes and sums in and their head, tail and abundance out; the
// contig maps and the rank structure (1.5 bits a lane) stay in L2.
// ---------------------------------------------------------------------------
#define REMAP_WORDS (SCAN_TILE / 32)  // 32-lane rank words a tile

#define REMAP_BATCH 8  // words a warp reads at once, two batches a tile

__global__ void __launch_bounds__(SCAN_THREADS)
    remap_nodes_kernel(const int64_t* __restrict__ node_key,
                       const int32_t* __restrict__ node_count,
                       const int64_t* __restrict__ node_cid, const int64_t* __restrict__ node_off,
                       int64_t C2, const int64_t* __restrict__ new_cid,
                       const int64_t* __restrict__ off_shift, int64_t npad, int64_t out_cap,
                       unsigned long long* __restrict__ scratch, uint32_t* __restrict__ bits,
                       uint16_t* __restrict__ word_count, int64_t* __restrict__ out_key,
                       int32_t* __restrict__ out_count, int64_t* __restrict__ out_cid,
                       int64_t* __restrict__ out_off) {
  __shared__ ScanShared sh;
  __shared__ unsigned s_warp[SCAN_WARPS];
  __shared__ uint16_t s_lane[SCAN_TILE];  // tile offsets of the kept lanes, in order
  unsigned long long* status = scratch + 1;
  const long long tile = scan_ticket(scratch, &sh);
  const int64_t base = (int64_t)tile * SCAN_TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wfirst = warp * 32 * SCAN_ITEMS;  // the warp's SCAN_ITEMS words of 32 lanes
  unsigned mine = 0;  // lane j < SCAN_ITEMS: the keep bits of the warp's word j
#pragma unroll
  for (int h = 0; h < SCAN_ITEMS; h += REMAP_BATCH) {
    int64_t c[REMAP_BATCH], nc[REMAP_BATCH];
#pragma unroll
    for (int k = 0; k < REMAP_BATCH; ++k) {
      const int64_t i = base + wfirst + 32 * (h + k) + lane;
      c[k] = i < C2 ? node_cid[i] : -1;
    }
#pragma unroll
    for (int k = 0; k < REMAP_BATCH; ++k) nc[k] = c[k] >= 0 ? new_cid[clamp_lane(c[k], npad)] : -1;
#pragma unroll
    for (int k = 0; k < REMAP_BATCH; ++k) {
      const unsigned word = __ballot_sync(SCAN_FULL_MASK, nc[k] >= 0);
      if (lane == h + k) mine = word;
    }
  }
  unsigned kept;
  const unsigned r =
      block_exclusive_scan(lane < SCAN_ITEMS ? (unsigned)__popc(mine) : 0u, s_warp, &kept);
  scan_publish_aggregate(status, tile, kept);
  if (lane < SCAN_ITEMS) {
    const int64_t w = (int64_t)tile * REMAP_WORDS + warp * SCAN_ITEMS + lane;
    bits[w] = mine;
    word_count[w] = (uint16_t)r;
  }
  // each kept lane's tile offset at its place in the tile's order
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const unsigned word = __shfl_sync(SCAN_FULL_MASK, mine, k);
    const unsigned at = __shfl_sync(SCAN_FULL_MASK, r, k);
    if ((word >> lane) & 1u) {
      s_lane[at + __popc(word & ((1u << lane) - 1u))] = (uint16_t)(wfirst + 32 * k + lane);
    }
  }
  const int64_t prefix = (int64_t)scan_tile_prefix(status, tile, kept, &sh);
  for (unsigned q = threadIdx.x; q < kept; q += SCAN_THREADS) {
    const int64_t slot = prefix + q;
    if (slot >= out_cap) break;
    const int64_t i = base + s_lane[q];
    const int64_t oc = clamp_lane(node_cid[i], npad);
    out_key[slot] = node_key[i];
    out_count[slot] = node_count[i];
    out_cid[slot] = new_cid[oc];
    out_off[slot] = node_off[i] + off_shift[oc];
  }
}

// Old lane h's new lane (kept lanes at or before h, less one) from the rank
// structure remap_nodes_kernel left; status holds every tile's inclusive word.
static __device__ __forceinline__ int64_t remap_new_lane(
    const unsigned long long* __restrict__ status, const uint32_t* __restrict__ bits,
    const uint16_t* __restrict__ word_count, int64_t h) {
  const int64_t tile = h / SCAN_TILE, w = h >> 5;
  const int64_t before = tile > 0 ? (int64_t)(status[tile - 1] & SCAN_VALUE_MASK) : 0;
  const unsigned b = (unsigned)(h & 31);
  const unsigned through = b == 31 ? SCAN_FULL_MASK : (2u << b) - 1u;
  return before + word_count[w] + __popc(bits[w] & through) - 1;
}

__global__ void remap_tail_kernel(const unsigned long long* __restrict__ status, long long tiles,
                                  const uint32_t* __restrict__ bits,
                                  const uint16_t* __restrict__ word_count, int64_t C2,
                                  int64_t out_cap, int64_t* __restrict__ out_key,
                                  int32_t* __restrict__ out_count, int64_t* __restrict__ out_cid,
                                  int64_t* __restrict__ out_off, const int64_t* __restrict__ hlane,
                                  const int64_t* __restrict__ tlane,
                                  const int64_t* __restrict__ klen,
                                  const int64_t* __restrict__ csum, int64_t M,
                                  int64_t* __restrict__ head, int64_t* __restrict__ tail,
                                  float* __restrict__ abundance) {
  const int64_t n_keep = (int64_t)(status[tiles - 1] & SCAN_VALUE_MASK);
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = n_keep + t0; s < out_cap; s += stride) {
    out_key[s] = PAD_KEY;
    out_count[s] = 0;
    out_cid[s] = -1;
    out_off[s] = -1;
  }
  for (int64_t j = t0; j < M; j += stride) {
    const int64_t h = hlane[j], tl = tlane[j];
    head[j] = h >= 0 ? remap_new_lane(status, bits, word_count, clamp_lane(h, C2)) : -1;
    tail[j] = tl >= 0 ? remap_new_lane(status, bits, word_count, clamp_lane(tl, C2)) : -1;
    const int64_t kl = klen[j];
    abundance[j] = kl > 0 ? __fdiv_rn(__ll2float_rn(csum[j]), __ll2float_rn(kl)) : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
extern "C" {

static_assert(SEARCH_THREADS == SCAN_THREADS, "search_grid sizes K18's grid");

// K18.  key, count [C]: the spectrum, sorted, PAD past its real lanes;
// node_key, node_cid [C2] (C2 >= 1), doomed [C2]; scratch: exactly tiles + 1
// zeroed words (scan.cuh), tiles = ceil((C + C2) / SCAN_TILE), or the call is
// refused; out_key, out_count [C].  The grid is the blocks that fit on the
// card at once, at most tiles.
int shannon_drop_contigs(const void* key, const void* count, int64_t C, const void* node_key,
                         const void* node_cid, int64_t C2, const void* doomed, void* scratch,
                         int64_t scratch_words, void* out_key, void* out_count, void* stream) {
  const long long tiles = scan_tiles(C + C2);
  if (C2 < 1 || scratch_words != tiles + 1) return (int)cudaErrorInvalidValue;
  unsigned int grid = 0;
  cudaError_t err = search_grid((const void*)drop_join_kernel, 0, tiles, &grid);
  if (err != cudaSuccess) return (int)err;
  drop_join_kernel<<<grid, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)key, (const int32_t*)count, C, (const int64_t*)node_key,
      (const int64_t*)node_cid, C2, (const uint8_t*)doomed, (unsigned long long*)scratch,
      tiles - 1, (int64_t*)out_key, (int32_t*)out_count);
  scan_fill_tail((const unsigned long long*)scratch, tiles, C, (int64_t*)out_key,
                 (int32_t*)out_count, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The int64 words of K19's rank structure over `tiles` tiles: the keep bits
// (a uint32 a 32-lane word), then the word counts (a uint16 a word),
// REMAP_WORDS words a tile.
static int64_t remap_rank_words(long long tiles) {
  return tiles * REMAP_WORDS * (int64_t)(sizeof(uint32_t) + sizeof(uint16_t)) / 8;
}

// K19's scratch: the rank structure, then a ticket word and a status word a
// tile, so that its last word is the last tile's inclusive word, which holds
// n_keep (kernels.scan_total reads it there).
int64_t shannon_clip_remap_words(int64_t C2) {
  const long long tiles = scan_tiles(C2);
  return remap_rank_words(tiles) + 1 + tiles;
}

// K19.  C2 in [1, 2^31), npad >= 1, out_cap >= 0; scratch: exactly
// shannon_clip_remap_words(C2) words, in any state (the ticket and status
// words are zeroed here), or the call is refused; out_* [out_cap]; hlane,
// tlane, klen, csum, head, tail, abundance [M].
int shannon_clip_remap(const void* node_key, const void* node_count, const void* node_cid,
                       const void* node_off, int64_t C2, const void* new_cid,
                       const void* off_shift, int64_t npad, int64_t out_cap, void* scratch,
                       int64_t scratch_words, void* out_key, void* out_count, void* out_cid,
                       void* out_off, const void* hlane, const void* tlane, const void* klen,
                       const void* csum, int64_t M, void* head, void* tail, void* abundance,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C2 < 1 || C2 >= (1ll << 31) || npad < 1 || out_cap < 0 || M < 0 ||
      scratch_words != shannon_clip_remap_words(C2)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = scan_tiles(C2);
  uint32_t* bits = (uint32_t*)scratch;
  uint16_t* word_count = (uint16_t*)(bits + tiles * REMAP_WORDS);
  unsigned long long* sc = (unsigned long long*)scratch + remap_rank_words(tiles);
  cudaError_t err = cudaMemsetAsync(sc, 0, sizeof(unsigned long long) * (size_t)(tiles + 1), s);
  if (err != cudaSuccess) return (int)err;
  remap_nodes_kernel<<<(unsigned int)tiles, SCAN_THREADS, 0, s>>>(
      (const int64_t*)node_key, (const int32_t*)node_count, (const int64_t*)node_cid,
      (const int64_t*)node_off, C2, (const int64_t*)new_cid, (const int64_t*)off_shift, npad,
      out_cap, sc, bits, word_count, (int64_t*)out_key, (int32_t*)out_count, (int64_t*)out_cid,
      (int64_t*)out_off);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t lanes = out_cap > M ? out_cap : M;
  if (lanes > 0) {
    const int64_t blocks = (lanes + THREADS - 1) / THREADS;
    remap_tail_kernel<<<(unsigned int)(blocks < SCAN_FILL_BLOCKS ? blocks : SCAN_FILL_BLOCKS),
                        THREADS, 0, s>>>(
        sc + 1, tiles, bits, word_count, C2, out_cap, (int64_t*)out_key, (int32_t*)out_count,
        (int64_t*)out_cid, (int64_t*)out_off, (const int64_t*)hlane, (const int64_t*)tlane,
        (const int64_t*)klen, (const int64_t*)csum, M, (int64_t*)head, (int64_t*)tail,
        (float*)abundance);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
