// de Bruijn condensation kernels K11-K15 of the shannon_tpu_torch port (plain
// C interface; see kernels.cu for the conventions every entry point follows).
//
// The node table is C2 sorted int64 keys, PAD past its real nodes.  Lanes,
// pointers, contig ids and offsets are int64; counts int32.  Every output is
// written over its full capacity, pads included, with exactly the values the
// plain versions in shannon_tpu_torch/ops/condense.py leave there.

#include "common.cuh"
#include "scan.cuh"

// ---------------------------------------------------------------------------
// K11: oriented node table (both strands of each canonical k-mer).
// Replaces shannon_tpu/ops/condense.py:82 _nodes_stage, which sorted the
// (key, count) pairs of both strands of all C lanes, pads included, and kept
// the first pair of each run (a palindrome is its own reverse complement, so
// it appears twice).
// The spectrum holds canonical keys, sorted, PAD past its n real lanes: one
// strand, already sorted.  For a canonical x, rc(x) is another canonical key
// y only where x is a palindrome (y <= rc(y) = x <= rc(x) = y), so the other
// strand is the n reverse complements less the palindromes, and the two
// strands share no key.  So:
//  - node_rc_kernel writes rc(key) for the n real lanes, PAD for a
//    palindrome (odd k has none), and counts the palindromes (a warp's
//    ballot, one atomicAdd a warp);
//  - the wrapper sorts those n keys with torch.sort, whose indices give
//    each reverse complement's spectrum lane;
//  - node_merge_kernel merges the two sorted lists.  They share no key, so
//    a node's lane is its index plus its co-rank in the other list: no
//    reduction, scan or look-back.  A block takes NODE_TILE node lanes,
//    finds the merge-path split of its two diagonals (merge_split, one warp
//    each), loads its stretch of both lists into shared memory coalesced (a
//    reverse complement's count gathered through its index), and each
//    thread takes the tile's lanes THREADS apart, each from a binary search
//    of its diagonal in shared memory, so the node table is written
//    coalesced.  Lanes past n_nodes = 2n - palindromes get PAD and 0.
// No K2, no per-node search, no pad lane in the sort.  The wrapper reads the
// palindrome count once, for n_nodes.
// Bound: memory.  The function must read the spectrum's n real lanes (12
// bytes each) and write the 2C node lanes (12 bytes each); the design adds
// torch.sort's passes over n keys and their indices, and reads the sorted
// keys and indices once more in the merge.
// ---------------------------------------------------------------------------
#define NODE_TILE 2048  // node lanes a merge block writes

__global__ void node_rc_kernel(const int64_t* __restrict__ key, int64_t n, int k,
                               int64_t* __restrict__ rc, unsigned long long* __restrict__ n_pal) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool pal = false;
  if (i < n) {
    const int64_t v = key[i];
    const int64_t r = (int64_t)revcomp_bits((uint64_t)v, k);
    pal = r == v;
    rc[i] = pal ? PAD_KEY : r;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, pal);
  if ((threadIdx.x & 31) == 0 && ballot != 0) {
    atomicAdd(n_pal, (unsigned long long)__popc(ballot));
  }
}

__global__ void __launch_bounds__(THREADS) node_merge_kernel(
    const int64_t* __restrict__ key, const int32_t* __restrict__ count, int64_t n,
    const int64_t* __restrict__ rc_key, const int64_t* __restrict__ rc_lane,
    const unsigned long long* __restrict__ n_pal, int64_t C2,
    int64_t* __restrict__ node_key, int32_t* __restrict__ node_count) {
  __shared__ int64_t s_key[NODE_TILE];  // the tile's stretch of key, then of rc_key
  __shared__ int32_t s_count[NODE_TILE];
  __shared__ int64_t s_split[2];        // key's lanes before the tile's two diagonals
  const int64_t nb = n - (int64_t)*n_pal, N = n + nb;
  const int64_t d0 = (int64_t)blockIdx.x * NODE_TILE;
  const int64_t e = d0 + NODE_TILE < C2 ? d0 + NODE_TILE : C2;
  const int64_t d1 = e < N ? e : N;  // the end of the tile's real lanes
  if (d0 < d1) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp < 2) {
      const int64_t i = merge_split(key, n, rc_key, nb, warp == 0 ? d0 : d1);
      if (lane == 0) s_split[warp] = i;
    }
    __syncthreads();
    const int64_t a0 = s_split[0], b0 = d0 - a0;
    const int la = (int)(s_split[1] - a0), L = (int)(d1 - d0), lb = L - la;
    for (int p = threadIdx.x; p < L; p += THREADS) {
      if (p < la) {
        s_key[p] = key[a0 + p];
        s_count[p] = count[a0 + p];
      } else {
        const int64_t j = b0 + (p - la);
        s_key[p] = rc_key[j];
        s_count[p] = count[rc_lane[j]];
      }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < L; p += THREADS) {
      // key's lanes among the tile's first p (the lists share no key)
      int lo = p > lb ? p - lb : 0, hi = p < la ? p : la;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_key[mid] < s_key[la + p - 1 - mid]) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const int bi = p - lo;
      const int slot = lo < la && (bi >= lb || s_key[lo] < s_key[la + bi]) ? lo : la + bi;
      node_key[d0 + p] = s_key[slot];
      node_count[d0 + p] = s_count[slot];
    }
  }
  for (int64_t p = (d1 > d0 ? d1 : d0) + threadIdx.x; p < e; p += THREADS) {
    node_key[p] = PAD_KEY;
    node_count[p] = 0;
  }
}

// ---------------------------------------------------------------------------
// K12: mergeable links and the successor directory from one (k-1)-mer group
// join.  Replaces shannon_tpu/ops/condense.py:109 _links_stage, which sorted
// 2*C2 records, each node's (k-1)-suffix as a source and its (k-1)-prefix as
// a target, by ((k-1)-mer, side, lane): a group is its sources, then its
// targets, each in lane order, and rec_lane is the records' lanes in that
// order.  A group with one source and one target is a mergeable link
// (prev_link); each source's group gives its successor run (first_p, p_cnt).
// The node table is sorted, PAD past its n real lanes, so that order needs no
// sort: it is the merge of five sorted runs.  The targets in lane order are
// sorted by prefix (v >> 2).  Run b of the sources, the lanes [seg_b,
// seg_b+1) whose key starts with base b, is sorted by suffix (the low 2(k-1)
// bits), strictly; in a group the source of run b comes before that of run
// b + 1, as in lane order.
// Design.
//  - Key-range tiles: tile t owns the (k-1)-mers [x_t, x_t+1), x_t the
//    prefix of target lane t * tile (x_0 = 0; from the first tile edge past
//    the real lanes the range runs to the end), so no group crosses a tile.
//    Its targets are the lanes [lb(x_t << 2), lb(x_t+1 << 2)), its sources
//    of run b the lanes [lb(b << 2(k-1) | x_t), lb(b << 2(k-1) | x_t+1)),
//    lb the lower bound on node_key itself (link_bounds_kernel: a thread a
//    bound, 5 a tile edge, seg_b and n among them).  Its records fill the
//    sorted order's slots from lb(x_t << 2) + sum_b (lb(b << 2(k-1) | x_t) -
//    seg_b) on, contiguously.
//  - link_tiles_kernel, a block a tile, loads the five stretches into shared
//    memory coalesced and merges them there by ((k-1)-mer << 3 | run), the
//    targets as run 4: runs 0 with 1 and 2 with 3, then the two results,
//    then those with the targets (merge path: a thread takes LINK_ITEMS
//    outputs from a binary search of its diagonal; no two runs share an
//    order key, and a run keeps its own order).  rec_lane is written
//    contiguously.  Then the group join: a record finds its group's first
//    slot, first target and end by stepping over its neighbours in the
//    merged order (a group holds at most 4 sources and 4 targets), with no
//    halo, since the group lies in the tile.  prev_link goes to the tile's
//    stretch of target lanes, first_p and p_cnt to its four stretches of
//    source lanes, each written in lane order.  first_p is the group's first
//    target slot, g0 + s_cnt, even where p_cnt = 0, as in the reference.
//  - A traffic jam: a tile's sources are not bounded by its width (a key
//    range rich in tips and poor in targets).  A chunk takes at most
//    LINK_SRC_CAP records of each source run and LINK_TGT_CAP targets; where
//    a run has more left, the chunk ends below the smallest (k-1)-mer of the
//    first records past the caps, so no group is cut, each chunk takes at
//    least LINK_SRC_CAP - 3 records of one run, and the block loops.  Shared
//    memory holds one chunk, whatever the data.
//  - Pads: lanes past n get prev_link -1 and first_p = p_cnt = 0, and their
//    records rec_lane[2n:] = [n..C2-1, n..C2-1], where the stable sort left
//    the PAD records (sources, then targets).  Block t writes those of its
//    own lanes [t * tile, (t + 1) * tile).
// No sort, no 2*C2 key or index array, no scatter through an order array and
// no host read.
// Bound: memory.  The function must read node_key (8 bytes a lane) and write
// rec_lane (16 bytes a lane), prev_link, first_p and p_cnt (24); the design
// reads each real node key twice, as a target and as a source.
// ---------------------------------------------------------------------------
#define LINK_SRC_SHIFT 9
#define LINK_SRC_CAP (1 << LINK_SRC_SHIFT)  // records of a source run a chunk takes
#define LINK_TGT_CAP 1056                   // targets a chunk takes (a tile's width + 3 fit)
#define LINK_SLOTS (4 * LINK_SRC_CAP + LINK_TGT_CAP)
#define LINK_ITEMS 8
// The chunk's node keys by slot (source run b from b * LINK_SRC_CAP, the
// targets from 4 * LINK_SRC_CAP), then two merged orders of slots.
#define LINK_SMEM (LINK_SLOTS * (sizeof(int64_t) + 2 * sizeof(uint16_t)))

// A slot's run: 0-3 the sources by first base, 4 the targets.
static __device__ __forceinline__ int link_run(int slot) {
  const int r = slot >> LINK_SRC_SHIFT;
  return r < 4 ? r : 4;
}

// A record's (k-1)-mer: a target's prefix, a source's suffix.
static __device__ __forceinline__ uint64_t link_kmer(int64_t v, int run, uint64_t mask) {
  return run == 4 ? (uint64_t)v >> 2 : (uint64_t)v & mask;
}

// A slot's order key: its (k-1)-mer (< 2^60), then its run.
static __device__ __forceinline__ uint64_t link_order(const int64_t* s_key, int slot,
                                                      uint64_t mask) {
  const int r = link_run(slot);
  return link_kmer(s_key[slot], r, mask) << 3 | (uint64_t)r;
}

// A sorted list of slots: idx[0, len), or with no idx the slots base, base + 1, ...
struct LinkList {
  const uint16_t* idx;
  int base, len;
  __device__ __forceinline__ int at(int i) const { return idx ? idx[i] : base + i; }
};

// out[d] for d in [d0, d1) of the merge of a and b (no order key in both).
static __device__ __forceinline__ void link_merge(const int64_t* s_key, uint64_t mask,
                                                  LinkList a, LinkList b, uint16_t* out,
                                                  int d0, int d1) {
  int lo = d0 > b.len ? d0 - b.len : 0, hi = d0 < a.len ? d0 : a.len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (link_order(s_key, a.at(mid), mask) < link_order(s_key, b.at(d0 - 1 - mid), mask)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo, j = d0 - lo;
  uint64_t ka = i < a.len ? link_order(s_key, a.at(i), mask) : ~0ull;
  uint64_t kb = j < b.len ? link_order(s_key, b.at(j), mask) : ~0ull;
  for (int d = d0; d < d1; ++d) {
    if (ka < kb) {
      out[d] = (uint16_t)a.at(i++);
      ka = i < a.len ? link_order(s_key, a.at(i), mask) : ~0ull;
    } else {
      out[d] = (uint16_t)b.at(j++);
      kb = j < b.len ? link_order(s_key, b.at(j), mask) : ~0ull;
    }
  }
}

// bounds[5 t + r] for the tile edge t in [0, n_tiles]: r < 4 the first lane
// of source run r at or past x_t, r = 4 the first target lane at or past it.
// Edge 0 gives seg_0..seg_3 and 0; an edge at or past the real lanes gives
// seg_1..seg_3, n and n.
__global__ void link_bounds_kernel(const int64_t* __restrict__ node_key, int64_t C2, int k,
                                   int64_t tile, int64_t n_tiles, int64_t* __restrict__ bounds) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 5 * (n_tiles + 1)) return;
  const int64_t t = i / 5;
  const int r = (int)(i - 5 * t), hs = 2 * (k - 1);
  const int64_t lane = t * tile;
  const int64_t v = lane < C2 ? node_key[lane] : PAD_KEY;
  int64_t q;
  if (v != PAD_KEY) {
    const int64_t x = t == 0 ? 0 : v >> 2;
    q = r == 4 ? x << 2 : ((int64_t)r << hs) | x;
  } else {  // (4 << 2(k-1)) = 4^k is above every real key, below PAD
    q = r == 4 ? PAD_KEY : (int64_t)(r + 1) << hs;
  }
  bounds[i] = lower_bound(node_key, 0, C2, q);
}

__global__ void __launch_bounds__(THREADS) link_tiles_kernel(
    const int64_t* __restrict__ node_key, int64_t C2, int k, int64_t tile,
    const int64_t* __restrict__ bounds, int64_t n_tiles, int64_t* __restrict__ prev_link,
    int64_t* __restrict__ rec_lane, int64_t* __restrict__ first_p,
    int64_t* __restrict__ p_cnt) {
  extern __shared__ int64_t s_key[];
  uint16_t* s_a = (uint16_t*)(s_key + LINK_SLOTS);
  uint16_t* s_b = s_a + LINK_SLOTS;
  __shared__ int64_t s_pos[5], s_end[5];  // each run's next and last lane + 1
  __shared__ int s_cnt[5], s_len[5];      // each run's loaded and taken records
  __shared__ uint64_t s_y[5];             // the (k-1)-mer past each run's cap
  __shared__ int64_t s_out;               // the chunk's first slot of rec_lane
  const int64_t t = blockIdx.x;
  const int64_t n = bounds[5 * n_tiles + 4];
  const uint64_t mask = (1ull << (2 * (k - 1))) - 1;

  const int64_t lo0 = t * tile, hi0 = lo0 + tile < C2 ? lo0 + tile : C2;
  for (int64_t lane = (lo0 > n ? lo0 : n) + threadIdx.x; lane < hi0; lane += THREADS) {
    prev_link[lane] = -1;
    first_p[lane] = 0;
    p_cnt[lane] = 0;
    rec_lane[n + lane] = lane;
    rec_lane[C2 + lane] = lane;
  }
  if (threadIdx.x < 5) {
    s_pos[threadIdx.x] = bounds[5 * t + threadIdx.x];
    s_end[threadIdx.x] = bounds[5 * t + 5 + threadIdx.x];
  }
  if (threadIdx.x == 0) {
    int64_t out = bounds[5 * t + 4];
    for (int b = 0; b < 4; ++b) out += bounds[5 * t + b] - bounds[b];
    s_out = out;
  }
  for (;;) {
    __syncthreads();
    if (threadIdx.x < 5) {
      const int r = threadIdx.x, cap = r < 4 ? LINK_SRC_CAP : LINK_TGT_CAP;
      const int64_t left = s_end[r] - s_pos[r];
      s_cnt[r] = (int)(left < cap ? left : cap);
      s_y[r] = left > cap ? link_kmer(node_key[s_pos[r] + cap], r, mask) : ~0ull;
    }
    __syncthreads();
    int total = 0;
    uint64_t y = ~0ull;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      total += s_cnt[r];
      y = s_y[r] < y ? s_y[r] : y;
    }
    if (total == 0) break;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const int64_t p0 = s_pos[r];
      for (int q = threadIdx.x; q < s_cnt[r]; q += THREADS) {
        s_key[r * LINK_SRC_CAP + q] = node_key[p0 + q];
      }
    }
    __syncthreads();
    if (threadIdx.x < 5) {  // each run's records below y
      const int r = threadIdx.x, base = r * LINK_SRC_CAP;
      int lo = 0, hi = s_cnt[r];
      if (y == ~0ull) {
        lo = hi;
      }
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (link_kmer(s_key[base + mid], r, mask) < y) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      s_len[r] = lo;
    }
    __syncthreads();
    const int n01 = s_len[0] + s_len[1], S = n01 + s_len[2] + s_len[3], M = S + s_len[4];
    for (int d = threadIdx.x * LINK_ITEMS; d < S; d += THREADS * LINK_ITEMS) {
      const int e = d + LINK_ITEMS < S ? d + LINK_ITEMS : S;
      if (d < n01) {
        link_merge(s_key, mask, LinkList{nullptr, 0, s_len[0]},
                   LinkList{nullptr, LINK_SRC_CAP, s_len[1]}, s_a, d, e < n01 ? e : n01);
      }
      if (e > n01) {
        link_merge(s_key, mask, LinkList{nullptr, 2 * LINK_SRC_CAP, s_len[2]},
                   LinkList{nullptr, 3 * LINK_SRC_CAP, s_len[3]}, s_a + n01,
                   (d > n01 ? d : n01) - n01, e - n01);
      }
    }
    __syncthreads();
    for (int d = threadIdx.x * LINK_ITEMS; d < S; d += THREADS * LINK_ITEMS) {
      link_merge(s_key, mask, LinkList{s_a, 0, n01}, LinkList{s_a + n01, 0, S - n01}, s_b, d,
                 d + LINK_ITEMS < S ? d + LINK_ITEMS : S);
    }
    __syncthreads();
    for (int d = threadIdx.x * LINK_ITEMS; d < M; d += THREADS * LINK_ITEMS) {
      link_merge(s_key, mask, LinkList{s_b, 0, S}, LinkList{nullptr, 4 * LINK_SRC_CAP, M - S},
                 s_a, d, d + LINK_ITEMS < M ? d + LINK_ITEMS : M);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < M; j += THREADS) s_b[s_a[j]] = (uint16_t)j;  // slot -> place
    __syncthreads();

    const int64_t out = s_out;
    auto lane_of = [&](int slot) {
      const int r = link_run(slot);
      return s_pos[r] + (slot - r * LINK_SRC_CAP);
    };
    auto kmer_at = [&](int j) {
      const int slot = s_a[j];
      return link_kmer(s_key[slot], link_run(slot), mask);
    };
    for (int j = threadIdx.x; j < M; j += THREADS) rec_lane[out + j] = lane_of(s_a[j]);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      for (int q = threadIdx.x; q < s_len[r]; q += THREADS) {
        const int slot = r * LINK_SRC_CAP + q, j = s_b[slot];
        const uint64_t x = link_kmer(s_key[slot], r, mask);
        const int64_t lane = s_pos[r] + q;
        if (r == 4) {
          int g0 = j;
          while (g0 > 0 && kmer_at(g0 - 1) == x) --g0;
          int fp = g0;  // sources lead the group, and j is a target
          while (link_run(s_a[fp]) < 4) ++fp;
          int end = j + 1;
          while (end < M && kmer_at(end) == x) ++end;
          prev_link[lane] = fp - g0 == 1 && end - fp == 1 ? lane_of(s_a[g0]) : -1;
        } else {
          int fp = j + 1;
          while (fp < M && link_run(s_a[fp]) < 4 && kmer_at(fp) == x) ++fp;
          int end = fp;
          while (end < M && kmer_at(end) == x) ++end;
          first_p[lane] = out + fp;
          p_cnt[lane] = end - fp;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < 5) s_pos[threadIdx.x] += s_len[threadIdx.x];
    if (threadIdx.x == 0) s_out = out + M;
  }
}

// ---------------------------------------------------------------------------
// K13, label stage: every round of pointer doubling to the chain heads in one
// enqueue, over a frontier.
// Replaces shannon_tpu/ops/condense.py:232 _label_stage: Jacobi rounds from
// ptr = prev >= 0 ? prev : lane, dist = prev >= 0, each round ptr' = ptr[ptr],
// dist' = dist + dist[ptr], stopping after the first round in which no
// pointer moves (keeping that round's values) or after R = bit_length(C2)
// rounds; has_cycle = any lane whose final pointer still has prev >= 0.
// Bound: memory.  The least work reads prev once and writes ptr and dist
// once; each round of the design adds, for each lane still in the frontier,
// its own word, one random 8-byte gather (a 32-byte sector) and one store,
// and the tail reads every lane's word once.
// Design.
//  - Packed state: a lane's (ptr, dist) is one 64-bit word: ptr in bits
//    0-30 (C2 < 2^31, which the wrapper enforces), bit 31 set when ptr is a
//    chain head (LABEL_HEAD), dist in bits 32-63, unsigned: dist counts the
//    steps a lane has taken, at most 2^t after round t, so at most 2^R <=
//    2^31.  A jump is one gather, and the target's word carries the head
//    bit of the pointer the lane takes over, so no round looks a head up.
//  - Two buffers: round t reads words[(t - 1) % 2] and writes words[t % 2].
//  - Final lanes leave.  A head's state never changes (ptr = itself, dist
//    0), so a lane whose pointer is a head is final.  Round t reads lane i's
//    word: with the head bit set the lane writes it unchanged to the output
//    buffer (the input buffer holds it already), so both buffers hold it for
//    any later reader, and leaves.  Otherwise it gathers its target's word,
//    steps, and stays.  "Final" is not "did not move": a lane on a cycle of
//    length 2^a points at itself once 2^t >= 2^a but its dist doubles every
//    round, so it stays.  "Moved" (ptr' != ptr, the loop's exit test) is
//    counted over the frontier; lanes that left cannot move.  So every round
//    equals the reference's, cycle lanes included.  Heads are never
//    gathered, so their words are never written.
//  - ptr and dist are written once, by the tail, in lane order: a lane that
//    leaves writes only its 8-byte word (scattered 8-byte stores into the
//    int64 outputs cost more than the rounds' own work).
//  - label_heads_kernel writes the head bitmap (prev < 0, C2 / 8 bytes,
//    inside L2).  Round 1 (label_first_kernel, every lane) builds the start
//    from prev in registers and takes one step, to (prev[prev], 2) or, where
//    prev's prev is -1, (prev, 1), its head bit from the bitmap.  Round 1
//    reads no buffer, so a lane whose word is final already writes it to
//    both buffers and leaves at once.  A warp takes 32 consecutive lanes
//    (grid-stride) and its ballot writes one word of round 2's frontier.
//  - Later rounds (label_round_kernel): a warp takes a chunk of 32 frontier
//    words (1,024 lanes), lane j loading word j, and lists the chunk's set
//    lanes in shared memory in lane order (a warp scan of the words' bit
//    counts gives each word's place); then its lanes take the list two
//    entries at a time, so each has two gathers in flight.  Every lane of
//    the warp has work whatever the frontier's density, and a dense chunk's
//    own loads and stores coalesce.  The lanes that stay set their bits in
//    the chunk's 32 words in shared memory, which lane j stores to the other
//    bitmap (every word, so no clearing).  The grid is the resident blocks,
//    so a small frontier does not wait on empty waves.
//  - No counter every warp of a dense grid hits: a thread counts in
//    registers, and a warp adds its counts to ctl once, after its last
//    chunk (a count from each warp of a one-warp-a-word grid serializes on
//    its address).
//  - No host read between rounds: the wrapper enqueues all R rounds and the
//    tail at once.  ctl holds, for each round, the lanes that moved and the
//    lanes that stay; a round after one in which nothing moved (the loop
//    has stopped) or nothing stayed returns at once.  The tail
//    (label_tail_kernel) finds the last round run, unpacks every lane's word
//    from its buffer (a head: (lane, 0)) and sets has_cycle where a pointer
//    is no head; then one host read of ctl.
// ---------------------------------------------------------------------------
#define LABEL_PTR_MASK 0x7fffffffull
#define LABEL_HEAD (1ull << 31)  // the word's pointer is a head
#define LABEL_FULL_MASK 0xffffffffu
#define LABEL_WARPS (THREADS / 32)
// Blocks a kernel of the stage asks for at most (grid-stride); the wrapper
// takes the resident count below it.
#define LABEL_GRID 2112

static __device__ __forceinline__ bool label_is_head(const uint32_t* __restrict__ heads,
                                                     int64_t p) {
  return (heads[p >> 5] >> (p & 31)) & 1u;
}

// ctl: [0] has_cycle; [t] the lanes that moved in round t, [R + t] the lanes
// that stay after it, for t in 1..R.
static __device__ __forceinline__ void label_add(int32_t* ctl, int t, int R, unsigned moved,
                                                 unsigned stay) {
  moved = __reduce_add_sync(LABEL_FULL_MASK, moved);
  stay = __reduce_add_sync(LABEL_FULL_MASK, stay);
  if ((threadIdx.x & 31) == 0) {
    if (moved) atomicAdd(&ctl[t], (int32_t)moved);
    if (stay) atomicAdd(&ctl[R + t], (int32_t)stay);
  }
}

// The head bitmap: bit i set where prev[i] < 0, a warp a word.
__global__ void label_heads_kernel(const int64_t* __restrict__ prev, int64_t C2,
                                   uint32_t* __restrict__ heads) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < C2;
       base += stride) {
    const int64_t i = base + (threadIdx.x & 31);
    const unsigned bits = __ballot_sync(LABEL_FULL_MASK, i < C2 && prev[i] < 0);
    if ((threadIdx.x & 31) == 0) heads[base >> 5] = bits;
  }
}

__global__ void label_first_kernel(const int64_t* __restrict__ prev, int64_t C2, int R,
                                   const uint32_t* __restrict__ heads,
                                   uint64_t* __restrict__ words0, uint64_t* __restrict__ words1,
                                   uint32_t* __restrict__ bits, int32_t* ctl) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned moved = 0, stay = 0;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < C2;
       base += stride) {
    const int64_t i = base + lane;
    const int64_t pv = i < C2 ? prev[i] : -1;
    bool go = false;
    if (pv >= 0) {
      const int64_t pp = prev[pv];
      const uint64_t w = pp < 0 ? (1ull << 32) | LABEL_HEAD | (uint64_t)pv
                                : (2ull << 32) | (label_is_head(heads, pp) ? LABEL_HEAD : 0ull) |
                                      (uint64_t)pp;
      moved += pp >= 0 && pp != pv;
      words1[i] = w;
      if (w & LABEL_HEAD) {
        words0[i] = w;  // final: in both buffers, and out of the frontier
      } else {
        go = true;
      }
    }
    const unsigned go_bits = __ballot_sync(LABEL_FULL_MASK, go);
    if (lane == 0) {
      bits[base >> 5] = go_bits;
      stay += __popc(go_bits);
    }
  }
  label_add(ctl, 1, R, moved, stay);
}

// One round's step of frontier lane i with word w: leave (its pointer is a
// head: the word goes to words_out unchanged) or gather the target's word
// wp and step.  Returns whether the lane stays.
static __device__ __forceinline__ bool label_step(int64_t i, uint64_t w, uint64_t wp,
                                                  uint64_t* __restrict__ words_out,
                                                  unsigned* moved) {
  if (w & LABEL_HEAD) {
    words_out[i] = w;
    return false;
  }
  const uint64_t np = wp & LABEL_PTR_MASK;
  words_out[i] = (((w >> 32) + (wp >> 32)) << 32) | (wp & LABEL_HEAD) | np;
  *moved += np != (w & LABEL_PTR_MASK);
  return true;
}

// Lists the set lanes of frontier chunk `chunk` (32 words of the bitmap
// `bits`, 1,024 lanes; lane j of the warp loads word j) in `list`, in lane
// order: a warp scan of the words' bit counts gives each word's place.
// Returns their number, the same in every lane.  The caller syncs the warp
// before it reads the list.
static __device__ __forceinline__ int frontier_list(const uint32_t* __restrict__ bits,
                                                    int64_t chunk, int64_t n_words, int lane,
                                                    uint16_t* list) {
  const int64_t wi = (chunk << 5) + lane;
  const uint32_t m = wi < n_words ? bits[wi] : 0u;
  const int c = __popc(m);
  int at = c;  // inclusive warp scan of the words' bit counts
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(LABEL_FULL_MASK, at, d);
    if (lane >= d) at += u;
  }
  const int total = __shfl_sync(LABEL_FULL_MASK, at, 31);
  at -= c;
  for (uint32_t mm = m; mm != 0; mm &= mm - 1) list[at++] = (uint16_t)(lane * 32 + __ffs(mm) - 1);
  return total;
}

__global__ void __launch_bounds__(THREADS) label_round_kernel(
    int64_t C2, int t, int R, const uint64_t* __restrict__ words_in,
    uint64_t* __restrict__ words_out, const uint32_t* __restrict__ bits_in,
    uint32_t* __restrict__ bits_out, int32_t* ctl) {
  // the loop stopped after round t - 1, or its frontier is empty
  if (ctl[t - 1] == 0 || ctl[R + t - 1] == 0) return;
  __shared__ uint16_t s_list[LABEL_WARPS][1024];
  __shared__ uint32_t s_keep[LABEL_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint16_t* list = s_list[warp];
  uint32_t* keep = s_keep[warp];
  const int64_t n_words = (C2 + 31) >> 5;
  const int64_t n_chunks = (n_words + 31) >> 5;
  const int64_t warps = (int64_t)gridDim.x * LABEL_WARPS;
  unsigned moved = 0, stay = 0;
  for (int64_t chunk = (int64_t)blockIdx.x * LABEL_WARPS + warp; chunk < n_chunks;
       chunk += warps) {
    const int64_t wi = (chunk << 5) + lane;
    const int total = frontier_list(bits_in, chunk, n_words, lane, list);
    keep[lane] = 0u;
    __syncwarp();
    const int64_t lane0 = chunk << 10;
    // two list entries a lane at a time, so each lane has two gathers in
    // flight
    for (int q = lane; q < total; q += 64) {
      const bool two = q + 32 < total;
      const int ja = list[q], jb = two ? list[q + 32] : ja;
      const uint64_t wa = words_in[lane0 + ja];
      const uint64_t wb = two ? words_in[lane0 + jb] : LABEL_HEAD;
      const uint64_t wpa = wa & LABEL_HEAD ? 0ull : words_in[wa & LABEL_PTR_MASK];
      const uint64_t wpb = wb & LABEL_HEAD ? 0ull : words_in[wb & LABEL_PTR_MASK];
      if (label_step(lane0 + ja, wa, wpa, words_out, &moved)) {
        atomicOr(&keep[ja >> 5], 1u << (ja & 31));
      }
      if (two && label_step(lane0 + jb, wb, wpb, words_out, &moved)) {
        atomicOr(&keep[jb >> 5], 1u << (jb & 31));
      }
    }
    __syncwarp();
    if (wi < n_words) {
      bits_out[wi] = keep[lane];
      stay += __popc(keep[lane]);
    }
    __syncwarp();  // the next chunk rewrites the list and the words
  }
  label_add(ctl, t, R, moved, stay);
}

// After the last round run: every lane's word from that round's buffer
// unpacked into ptr and dist (a head's is (lane, 0)), and has_cycle where a
// pointer is no head.
__global__ void label_tail_kernel(const uint32_t* __restrict__ heads, int64_t C2, int R,
                                  const uint64_t* __restrict__ words, int32_t* ctl,
                                  int64_t* __restrict__ ptr, int64_t* __restrict__ dist) {
  __shared__ int last;
  if (threadIdx.x == 0) {
    last = R;
    for (int t = 1; t < R; ++t) {
      if (ctl[t] == 0) {
        last = t;
        break;
      }
    }
  }
  __syncthreads();
  const uint64_t* w_last = words + (last & 1) * C2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  bool cyc = false;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < C2; i += stride) {
    int64_t p = i, d = 0;
    if (!label_is_head(heads, i)) {
      const uint64_t w = w_last[i];
      p = (int64_t)(w & LABEL_PTR_MASK);
      d = (int64_t)(w >> 32);
      cyc |= !(w & LABEL_HEAD);
    }
    ptr[i] = p;
    dist[i] = d;
  }
  if (__syncthreads_or(cyc) && threadIdx.x == 0) ctl[0] = 1;
}

// ---------------------------------------------------------------------------
// K13, cycle cut: every round of the reference's min-propagating pointer
// doubling in one enqueue, over the cycle lanes alone, with an early stop.
// Replaces shannon_tpu/ops/condense.py:264 _cycle_fix: R = bit_length(C2)
// Jacobi rounds from ptr = prev >= 0 ? prev : lane, mn = lane, each round
// mn' = min(mn, mn[ptr]), ptr' = ptr[ptr]; then a lane is cut (prev -1)
// where prev[ptr_R] >= 0 and mn_R == lane.
// Three facts let the cut skip most of that work:
//  - Only lanes of S can be cut, where S is the set of lanes whose walk
//    along prev reaches a cycle (rho shapes' tails included).  A walk that
//    reaches a head (prev -1) takes fewer than C2 < 2^R steps, and a head
//    is its own pointer, so there ptr_R is the head and prev[ptr_R] = -1.
//    A walk that reaches a cycle passes no head, so prev[ptr_R] >= 0.
//  - The label stage names S exactly: S = {i : prev[head_ptr[i]] >= 0} for
//    its pointers head_ptr (the test !(w & LABEL_HEAD) of
//    label_tail_kernel).  Its pointer is P^(2^t)(i) after its last round t,
//    P the start pointer: on a walk into a cycle it is no head, whatever t;
//    on a walk to a head it is the head both at the round cap (2^R > C2) and
//    at the early stop (every pointer is then a fixed point of P^(2^t), and
//    on such a walk only the head is one).
//  - S is closed under ptr, and the minima can stop early.  After round t,
//    mn_t(i) is the least lane of the 2^t lanes of i's walk from i.  Let
//    round t + 1 change no minimum on S: mn_t(i) <= mn_t(P^(2^t)(i)) for
//    every i in S.  Applied to i and to P^(2^t)(i) (in S), mn_t(i) <=
//    mn_t(P^(2^(t+1))(i)), so round t + 2 changes none either, and by
//    induction no later round does.  So the minima after the first round
//    that changes none are the reference's after R rounds, exactly, for
//    any prev in [-1, C2).  The pointers themselves are not needed at the
//    end: on S, prev[ptr_R] >= 0 always.
// Design.
//  - Packed state: a lane's (ptr, mn) is one 64-bit word, ptr in bits 0-30
//    and mn in bits 32-62 (C2 < 2^31, which the wrapper enforces), so a
//    round is one 8-byte gather a lane, not two.  Two buffers: round t
//    reads words[(t - 1) % 2] and writes words[t % 2]; only lanes of S are
//    ever written or read (S is closed under ptr).
//  - cycle_first_kernel, every lane (a warp takes 32 consecutive lanes,
//    grid-stride): i is in S where prev[head_ptr[i]] >= 0; a warp's ballot
//    writes one word of the S bitmap.  A lane of S takes round 1 at once
//    from prev in registers: ptr = prev[prev[i]] (prev[i] is in S, so no
//    head), mn = min(i, prev[i]).  Both gathers are issued before either
//    is used (prev[prev[i]] for every lane with a predecessor).
//  - cycle_round_kernel, rounds 2..R, over S as label_round_kernel walks its
//    frontier: a warp takes a chunk of 32 bitmap words (1,024 lanes), lists
//    its set lanes in shared memory (frontier_list) and takes the list two
//    entries a lane at a time, so each lane has two gathers in flight.  S
//    does not shrink, so the bitmap is read, never written.
//  - No host read: the wrapper enqueues all R rounds and the tail at once.
//    ctl[t] counts the lanes whose minimum changed in round t (a warp adds
//    its count once, after its last chunk); a round after one that changed
//    none returns at once.
//  - cycle_tail_kernel, every lane: finds the last round run (the first t
//    with ctl[t] == 0, else R) and writes prev_out = prev, except -1 on a
//    lane of S whose minimum in that round's buffer is itself.
// Bound: memory.  The least work reads prev and head_ptr once and writes
// prev_out once; each round of the design adds, for each lane of S, its own
// word, one random 8-byte gather (a 32-byte sector) and one store.
// ---------------------------------------------------------------------------

// ctl: [0] |S|; [t] the lanes of S whose minimum changed in round t, t in
// 1..R.
static __device__ __forceinline__ void cycle_add(int32_t* ctl, int at, unsigned n) {
  n = __reduce_add_sync(LABEL_FULL_MASK, n);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(&ctl[at], (int32_t)n);
}

__global__ void cycle_first_kernel(const int64_t* __restrict__ prev,
                                   const int64_t* __restrict__ head_ptr, int64_t C2,
                                   uint64_t* __restrict__ words1, uint32_t* __restrict__ bits,
                                   int32_t* ctl) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned changed = 0, in_s = 0;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < C2;
       base += stride) {
    const int64_t i = base + lane;
    bool s = false;
    if (i < C2) {
      const int64_t pv = prev[i], h = head_ptr[i];
      // both gathers in flight; prev[pv] is used only on S, where pv >= 0
      const int64_t ph = prev[h], pp = pv >= 0 ? prev[pv] : -1;
      s = ph >= 0;  // a head is its own pointer: never in S
      if (s) {
        const int64_t m = pv < i ? pv : i;
        words1[i] = ((uint64_t)m << 32) | (uint64_t)pp;
        changed += pv < i;
      }
    }
    const unsigned s_bits = __ballot_sync(LABEL_FULL_MASK, s);
    if (lane == 0) {
      bits[base >> 5] = s_bits;
      in_s += __popc(s_bits);
    }
  }
  cycle_add(ctl, 0, in_s);
  cycle_add(ctl, 1, changed);
}

// One round's step of lane i of S with word w and its target's word wp.
// Returns whether the lane's minimum changed.
static __device__ __forceinline__ unsigned cycle_step(int64_t i, uint64_t w, uint64_t wp,
                                                      uint64_t* __restrict__ words_out) {
  const uint64_t m = w >> 32, mp = wp >> 32;
  words_out[i] = ((mp < m ? mp : m) << 32) | (wp & LABEL_PTR_MASK);
  return mp < m;
}

__global__ void __launch_bounds__(THREADS) cycle_round_kernel(
    int64_t C2, int t, const uint64_t* __restrict__ words_in, uint64_t* __restrict__ words_out,
    const uint32_t* __restrict__ bits, int32_t* ctl) {
  if (ctl[t - 1] == 0) return;  // round t - 1 changed no minimum: the loop has stopped
  __shared__ uint16_t s_list[LABEL_WARPS][1024];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint16_t* list = s_list[warp];
  const int64_t n_words = (C2 + 31) >> 5;
  const int64_t n_chunks = (n_words + 31) >> 5;
  const int64_t warps = (int64_t)gridDim.x * LABEL_WARPS;
  unsigned changed = 0;
  for (int64_t chunk = (int64_t)blockIdx.x * LABEL_WARPS + warp; chunk < n_chunks;
       chunk += warps) {
    const int total = frontier_list(bits, chunk, n_words, lane, list);
    __syncwarp();
    const int64_t lane0 = chunk << 10;
    // two list entries a lane at a time, so each lane has two gathers in
    // flight
    for (int q = lane; q < total; q += 64) {
      const bool two = q + 32 < total;
      const int64_t ia = lane0 + list[q], ib = lane0 + (two ? list[q + 32] : list[q]);
      const uint64_t wa = words_in[ia];
      const uint64_t wb = two ? words_in[ib] : 0ull;
      const uint64_t wpa = words_in[wa & LABEL_PTR_MASK];
      const uint64_t wpb = two ? words_in[wb & LABEL_PTR_MASK] : 0ull;
      changed += cycle_step(ia, wa, wpa, words_out);
      if (two) changed += cycle_step(ib, wb, wpb, words_out);
    }
    __syncwarp();  // the next chunk rewrites the list
  }
  cycle_add(ctl, t, changed);
}

__global__ void cycle_tail_kernel(const int64_t* __restrict__ prev, int64_t C2, int R,
                                  const uint64_t* __restrict__ words,
                                  const uint32_t* __restrict__ bits, const int32_t* ctl,
                                  int64_t* __restrict__ prev_out) {
  __shared__ int last;
  if (threadIdx.x == 0) {
    last = R;
    for (int t = 1; t < R; ++t) {
      if (ctl[t] == 0) {
        last = t;
        break;
      }
    }
  }
  __syncthreads();
  const uint64_t* w_last = words + (last & 1) * C2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < C2; i += stride) {
    int64_t pv = prev[i];
    if (((bits[i >> 5] >> (i & 31)) & 1u) && (int64_t)(w_last[i] >> 32) == i) pv = -1;
    prev_out[i] = pv;
  }
}

// ---------------------------------------------------------------------------
// K14: per-contig reduction, contig edges and reverse-complement twins.
// Replaces shannon_tpu/ops/condense.py:287 _reduce_stage.  The reference
// sorted the nodes by (cid, offset) and compacted run starts and ends with two
// more sorts.  A contig's id is the rank of its head lane (real, prev2 < 0)
// among the heads, and the labels give each member its head (head_ptr) and
// its offset (dist): the head 0, the members 0..klen-1, all distinct.  So the
// reductions need no order.  Three launches:
//  - contig_heads_kernel, one pass on scan.cuh (tiles of 4,096 lanes, 16 a
//    thread, striped so every load is coalesced; each half of a thread's
//    rows loads its keys and links before any is used): each lane's head
//    flag, the tile's ranks from a warp ballot a row and a scan of the 128
//    (row, warp) counts, the tile's first id by decoupled look-back.  It
//    writes ids, an int32 a lane (the contig id of a head, -1 on another
//    real lane, -2 on a pad), and sets up each contig's slots from its one
//    head lane: head_lane, count_sum = the head's count, and tail_pack = the
//    head lane (offset 0).  No flag array, no torch.cumsum, no C2-wide
//    memset.
//  - contig_lanes_kernel, a thread a lane: a real lane's cid is one gather,
//    ids[head_ptr]; it writes node_cid and node_off, and a member that is
//    not a head adds its count to count_sum and folds (offset << 32) | lane
//    into tail_pack with a 64-bit atomicMax, so the largest offset leaves
//    each contig both its tail lane and klen = that offset + 1.  Integer
//    sums and maxima, so exact whatever the order.
//  - contig_slots_kernel, a thread a contig slot, reads n_contigs on the
//    card (the scan's last status word).  A slot c < n_contigs unpacks
//    tail_pack into klen and tail_lane and writes the float32 abundance
//    (count_sum / klen, each converted and divided with round-to-nearest
//    intrinsics, so it is bit-equal to the plain version's and the host's
//    recomputation), the successor run of the tail node in the link records
//    and the reverse-complement twin (lower_bound_hit: one binary search a
//    contig, 355,800 on the main path); a slot past n_contigs (95% of them
//    on the main path, most of the stage's bytes) takes the fill values.
//    (Measured slower on the main path: the fill in the lane pass, beside
//    its atomics; two groups of resident blocks striding over the real
//    slots and the fill side by side; and tiles taken in a prime-stride
//    order to spread the real slots' blocks among the fill's.)
// The wrapper reads n_contigs once, at the end.
// Bound: memory: the labeled node table in, the contig arrays (C2 slots of
// 76 bytes) out; the twin search is bounded by the latency of its dependent
// loads.
// ---------------------------------------------------------------------------
#define CONTIG_PAD_ID (-2)
#define CONTIG_HALF (SCAN_ITEMS / 2)  // rows a thread loads before it uses them

__global__ void __launch_bounds__(SCAN_THREADS) contig_heads_kernel(
    const int64_t* __restrict__ node_key, const int32_t* __restrict__ node_count,
    const int64_t* __restrict__ prev2, int64_t C2, unsigned long long* __restrict__ scratch,
    int32_t* __restrict__ ids, int64_t* __restrict__ count_sum,
    int64_t* __restrict__ head_lane, unsigned long long* __restrict__ tail_pack) {
  __shared__ ScanShared sh;
  __shared__ unsigned s_off[SCAN_ITEMS * SCAN_WARPS];  // heads before each (row, warp)
  __shared__ unsigned s_total;
  unsigned long long* status = scratch + 1;
  const long long tile = scan_ticket(scratch, &sh);
  const int64_t base = (int64_t)tile * SCAN_TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned heads[SCAN_ITEMS];  // each row's ballot of its warp's heads
  unsigned real = 0;           // bit j: this thread's lane of row j is real
#pragma unroll
  for (int half = 0; half < SCAN_ITEMS; half += CONTIG_HALF) {
    int64_t key[CONTIG_HALF], prev[CONTIG_HALF];
#pragma unroll
    for (int q = 0; q < CONTIG_HALF; ++q) {
      const int64_t i = base + (half + q) * SCAN_THREADS + threadIdx.x;
      key[q] = i < C2 ? node_key[i] : PAD_KEY;
      prev[q] = i < C2 ? prev2[i] : 0;
    }
#pragma unroll
    for (int q = 0; q < CONTIG_HALF; ++q) {
      const int j = half + q;
      const bool r = key[q] != PAD_KEY;
      heads[j] = __ballot_sync(SCAN_FULL_MASK, r && prev[q] < 0);
      if (r) real |= 1u << j;
      if (lane == 0) s_off[j * SCAN_WARPS + warp] = __popc(heads[j]);
    }
  }
  __syncthreads();
  if (warp == 0) {
    // the 128 counts in lane order (row-major, then warp), 4 a lane
    constexpr int per = SCAN_ITEMS * SCAN_WARPS / 32;
    unsigned v[per], sum = 0;
#pragma unroll
    for (int q = 0; q < per; ++q) {
      v[q] = s_off[lane * per + q];
      sum += v[q];
    }
    const unsigned inc = warp_inclusive_scan(sum);
    unsigned run = inc - sum;
#pragma unroll
    for (int q = 0; q < per; ++q) {
      s_off[lane * per + q] = run;
      run += v[q];
    }
    if (lane == 31) s_total = inc;
  }
  __syncthreads();
  const unsigned total = s_total;
  scan_publish_aggregate(status, tile, total);
  const int64_t prefix = (int64_t)scan_tile_prefix(status, tile, total, &sh);
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const int64_t i = base + j * SCAN_THREADS + threadIdx.x;
    if (i >= C2) break;
    if ((heads[j] >> lane) & 1) {
      const int64_t cid = prefix + s_off[j * SCAN_WARPS + warp] + __popc(heads[j] & below);
      ids[i] = (int32_t)cid;
      head_lane[cid] = i;
      count_sum[cid] = node_count[i];
      tail_pack[cid] = (unsigned long long)i;  // offset 0
    } else {
      ids[i] = (real >> j) & 1 ? -1 : CONTIG_PAD_ID;
    }
  }
}

// n_contigs: the value of the scan's last inclusive status word.
static __device__ __forceinline__ int64_t contig_count(const unsigned long long* last_status) {
  return (int64_t)(*last_status & SCAN_VALUE_MASK);
}

__global__ void contig_lanes_kernel(const int32_t* __restrict__ ids,
                                    const int32_t* __restrict__ node_count,
                                    const int64_t* __restrict__ head_ptr,
                                    const int64_t* __restrict__ dist, int64_t C2,
                                    int64_t* __restrict__ node_cid,
                                    int64_t* __restrict__ node_off,
                                    unsigned long long* __restrict__ count_sum,
                                    unsigned long long* __restrict__ tail_pack) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  const int32_t own = ids[i];
  const int64_t hp = head_ptr[i], off = dist[i];
  const int32_t count = node_count[i];
  if (own == CONTIG_PAD_ID) {
    node_cid[i] = -1;
    node_off[i] = -1;
    return;
  }
  const int32_t h = ids[hp];
  const int64_t cid = h >= 0 ? h : -1;
  node_cid[i] = cid;
  node_off[i] = off;
  if (own >= 0 || cid < 0) return;  // a head set its contig's slots up
  atomicAdd(count_sum + cid, (unsigned long long)(int64_t)count);
  atomicMax(tail_pack + cid, ((unsigned long long)off << 32) | (unsigned long long)i);
}

__global__ void contig_slots_kernel(const int64_t* __restrict__ node_key,
                                    const int64_t* __restrict__ dist,
                                    const int64_t* __restrict__ rec_lane,
                                    const int64_t* __restrict__ first_p,
                                    const int64_t* __restrict__ p_cnt,
                                    const int64_t* __restrict__ node_cid,
                                    const unsigned long long* __restrict__ last_status,
                                    int64_t C2, int k, int canonical,
                                    int64_t* __restrict__ klen,
                                    int64_t* __restrict__ count_sum,
                                    int64_t* __restrict__ head_lane,
                                    int64_t* __restrict__ tail_lane,
                                    float* __restrict__ abundance,
                                    int64_t* __restrict__ out_edges,
                                    int64_t* __restrict__ rc_pair) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C2) return;
  if (c >= contig_count(last_status)) {  // contig slot c holds no contig
    klen[c] = 0;
    count_sum[c] = 0;
    head_lane[c] = -1;
    tail_lane[c] = -1;
    abundance[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) out_edges[j * C2 + c] = -1;
    rc_pair[c] = c;
    return;
  }
  // tail_lane holds the contig's tail_pack until here
  const unsigned long long packed = (unsigned long long)tail_lane[c];
  const int64_t tl = (int64_t)(packed & 0xFFFFFFFFull);
  const int64_t kl = (int64_t)(packed >> 32) + 1;
  klen[c] = kl;
  tail_lane[c] = tl;
  abundance[c] = __fdiv_rn(__ll2float_rn(count_sum[c]), __ll2float_rn(kl));
  const int64_t fp = first_p[tl], pc = p_cnt[tl];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out_edges[j * C2 + c] = j < pc ? node_cid[rec_lane[fp + j]] : -1;
  }
  int64_t rc = c;
  if (canonical) {
    int64_t idx;
    const int64_t q = (int64_t)revcomp_bits((uint64_t)node_key[tl], k);
    if (lower_bound_hit(node_key, C2, q, &idx) && dist[idx] == 0) rc = node_cid[idx];
  }
  rc_pair[c] = rc;
}

// ---------------------------------------------------------------------------
// K15: the contig base streams.
// Replaces shannon_tpu/ops/condense.py:417 contig_base_streams, which sorted
// the nodes by (cid, offset) to lay out their last bases.  Offsets within a
// contig are 0..klen-1, so each node's slot is its contig's tail start plus
// its offset.  The real nodes fill the node table's first n_tails lanes, each
// with a contig id, so the tails' length sum(klen) is n_tails, known on the
// host: nothing is read back and nothing is scanned over the C2 lanes.  Two
// launches:
//  - stream_heads_kernel, one pass on scan.cuh's look-back over the n_contigs
//    contigs, a thread a contig and STREAM_TILE contigs a tile (the
//    library's 4,096-lane tiles gave the 355,800 contigs of the main path
//    only 87 blocks, whose serial head writes took 53 us on an H100, against
//    25 for tiles of 256): each contig's exclusive tail start (tstart, an
//    int64 a contig) from the tile's block scan of klen and its look-back;
//    and the heads, each thread gathering its contig's head key once
//    (node_key[head_lane], into shared memory) and the block writing the
//    tile's k-1 bases a contig as one contiguous stretch of 4-byte words.
//  - tails_stream_kernel, a thread a real lane i < n_tails: one gather of
//    tstart[cid] (the 2.8 MB start array sits in L2) and one byte stored at
//    tstart[cid] + off.
// Bound: memory: the real lanes' key, cid and offset (24 bytes a node), klen
// and head_lane and a head key gather a contig (24 bytes), one byte out a
// base.  The tails pass's byte stores are scattered, one L2 request a lane
// that no neighbour shares: on an H100 they take 89 of its 158 us (the same
// pass storing each byte at its own lane takes 70), and loading the lanes
// evict-first changed nothing.
// ---------------------------------------------------------------------------
#define STREAM_TILE 256  // contigs a tile, a thread each
#define STREAM_WORD_BYTES 4

__global__ void __launch_bounds__(STREAM_TILE) stream_heads_kernel(
    const int64_t* __restrict__ node_key, int64_t C2, const int64_t* __restrict__ klen,
    const int64_t* __restrict__ head_lane, int64_t n_contigs, int k,
    unsigned long long* __restrict__ scratch, int64_t* __restrict__ tstart,
    uint8_t* __restrict__ heads) {
  __shared__ ScanShared sh;
  __shared__ unsigned long long s_warp[STREAM_TILE / 32];
  __shared__ int64_t s_key[STREAM_TILE];  // the tile's head keys
  unsigned long long* status = scratch + 1;
  const long long tile = scan_ticket(scratch, &sh);
  const int64_t base = (int64_t)tile * STREAM_TILE, c = base + threadIdx.x;
  const int64_t end = base + STREAM_TILE < n_contigs ? base + STREAM_TILE : n_contigs;
  unsigned long long len = 0;
  if (c < end) {
    int64_t hl = head_lane[c];
    len = (unsigned long long)klen[c];
    hl = hl < 0 ? 0 : (hl > C2 - 1 ? C2 - 1 : hl);
    s_key[threadIdx.x] = node_key[hl];
  }
  unsigned long long total;
  const unsigned long long before = block_exclusive_scan(len, s_warp, &total);
  scan_publish_aggregate(status, tile, total);
  // scan_tile_prefix ends with a barrier, which also publishes s_key
  const unsigned long long prefix = scan_tile_prefix(status, tile, total, &sh);
  if (c < end) tstart[c] = (int64_t)(prefix + before);
  // the tile's heads: bytes [base * w, end * w) of the [n_contigs, w] array,
  // a 4-byte word a thread at a time (base * w is a multiple of 4)
  const int w = k - 1;
  const int bytes = (int)(end - base) * w;  // at most 256 * 31
  uint8_t* out = heads + base * w;
  for (int t = threadIdx.x * STREAM_WORD_BYTES; t < bytes; t += STREAM_TILE * STREAM_WORD_BYTES) {
    uint32_t word = 0;
    int q = t / w, j = t - q * w;
    const int n = bytes - t < STREAM_WORD_BYTES ? bytes - t : STREAM_WORD_BYTES;
    for (int b = 0; b < n; ++b) {
      word |= (uint32_t)((s_key[q] >> (2 * (w - j))) & 3) << (8 * b);
      if (++j == w) {
        j = 0;
        ++q;
      }
    }
    if (n == STREAM_WORD_BYTES) {
      *reinterpret_cast<uint32_t*>(out + t) = word;
    } else {
      for (int b = 0; b < n; ++b) out[t + b] = (uint8_t)(word >> (8 * b));
    }
  }
}

__global__ void tails_stream_kernel(const int64_t* __restrict__ node_key,
                                    const int64_t* __restrict__ node_cid,
                                    const int64_t* __restrict__ node_off,
                                    const int64_t* __restrict__ tstart, int64_t n_tails,
                                    uint8_t* __restrict__ tails) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_tails) return;
  const int64_t cid = node_cid[i], off = node_off[i], key = node_key[i];
  if (cid < 0) return;
  const int64_t slot = tstart[cid] + off;
  if (slot >= 0 && slot < n_tails) tails[slot] = (uint8_t)(key & 3);
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
extern "C" {

// K11.  rc [n]: the reverse complements of key[0, n), PAD on palindromes;
// n_pal: one uint64, zeroed here, the palindromes.
int shannon_node_strands(const void* key, int64_t n, int k, void* rc, void* n_pal,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(n_pal, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess || n <= 0) return (int)err;
  node_rc_kernel<<<blocks_for(n), THREADS, 0, s>>>((const int64_t*)key, n, k, (int64_t*)rc,
                                                   (unsigned long long*)n_pal);
  return (int)cudaGetLastError();
}

// K11.  key, count [>= n]: the spectrum, its n real lanes first; rc_key [n]
// sorted (PAD last), rc_lane [n] the spectrum lane of each; node_key,
// node_count [C2].
int shannon_node_merge(const void* key, const void* count, int64_t n, const void* rc_key,
                       const void* rc_lane, const void* n_pal, int64_t C2, void* node_key,
                       void* node_count, void* stream) {
  if (n < 0 || C2 < 2 * n) return (int)cudaErrorInvalidValue;
  if (C2 > 0) {
    node_merge_kernel<<<(unsigned int)((C2 + NODE_TILE - 1) / NODE_TILE), THREADS, 0,
                        (cudaStream_t)stream>>>(
        (const int64_t*)key, (const int32_t*)count, n, (const int64_t*)rc_key,
        (const int64_t*)rc_lane, (const unsigned long long*)n_pal, C2, (int64_t*)node_key,
        (int32_t*)node_count);
  }
  return (int)cudaGetLastError();
}

// K12.  node_key [C2] sorted, PAD past its real lanes; tile >= 1 target lanes
// a tile; bounds: 5 * (ceil(C2 / tile) + 1) int64 of scratch; prev_link,
// first_p, p_cnt [C2]; rec_lane [2 * C2].
int shannon_link_tiles(const void* node_key, int64_t C2, int k, int64_t tile, void* bounds,
                       int64_t bounds_words, void* prev_link, void* rec_lane, void* first_p,
                       void* p_cnt, void* stream) {
  if (C2 < 0 || tile < 1 || k < 1 || k > 31) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = (C2 + tile - 1) / tile;
  if (bounds_words != 5 * (n_tiles + 1)) return (int)cudaErrorInvalidValue;
  if (C2 == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  link_bounds_kernel<<<blocks_for(bounds_words), THREADS, 0, s>>>(
      (const int64_t*)node_key, C2, k, tile, n_tiles, (int64_t*)bounds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  link_tiles_kernel<<<(unsigned int)n_tiles, THREADS, LINK_SMEM, s>>>(
      (const int64_t*)node_key, C2, k, tile, (const int64_t*)bounds, n_tiles,
      (int64_t*)prev_link, (int64_t*)rec_lane, (int64_t*)first_p, (int64_t*)p_cnt);
  return (int)cudaGetLastError();
}

// Scratch words (8 bytes each) shannon_label_rounds takes for C2 lanes: the
// two buffers of packed words (C2 each), then the head bitmap and the two
// frontier bitmaps (ceil(C2 / 32) uint32 words each).
int64_t shannon_label_rounds_words(int64_t C2) {
  return 2 * C2 + (3 * ((C2 + 31) / 32) + 1) / 2;
}

// prev [C2] in [-1, C2), C2 < 2^31; scratch: shannon_label_rounds_words(C2)
// words; ctl: 2R + 1 int32, zeroed here, R = max(bit_length(C2), 1) the
// round cap: [0] has_cycle, [t] the lanes that moved in round t, [R + t]
// the lanes that stay after it.
int shannon_label_rounds(const void* prev, int64_t C2, void* scratch, int64_t scratch_words,
                         void* ctl, int ctl_words, void* ptr, void* dist, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int R = 1;
  while (R < 63 && (C2 >> R) != 0) ++R;
  if (C2 < 0 || C2 >= (1ll << 31) || ctl_words != 2 * R + 1 ||
      scratch_words != shannon_label_rounds_words(C2)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t bit_words = (C2 + 31) / 32;
  cudaError_t err = cudaMemsetAsync(ctl, 0, sizeof(int32_t) * (size_t)(2 * R + 1), s);
  if (err != cudaSuccess || C2 == 0) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, label_round_kernel, THREADS, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const unsigned int first_grid = blocks_for(C2) < LABEL_GRID ? blocks_for(C2) : LABEL_GRID;
  const unsigned int chunk_warps = (unsigned int)((bit_words + 31) / 32);
  const unsigned int wanted = (chunk_warps + LABEL_WARPS - 1) / LABEL_WARPS;
  const unsigned int resident = (unsigned int)(sms * per_sm);
  const unsigned int grid = resident < wanted ? (resident > 0 ? resident : 1) : wanted;
  uint64_t* w = (uint64_t*)scratch;
  uint32_t* heads = (uint32_t*)(w + 2 * C2);
  uint32_t* front = heads + bit_words;  // round t's frontier: front + (t % 2) * bit_words
  label_heads_kernel<<<first_grid, THREADS, 0, s>>>((const int64_t*)prev, C2, heads);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    label_first_kernel<<<first_grid, THREADS, 0, s>>>((const int64_t*)prev, C2, R, heads, w,
                                                       w + C2, front, (int32_t*)ctl);
    err = cudaGetLastError();
  }
  for (int t = 2; t <= R && err == cudaSuccess; ++t) {
    label_round_kernel<<<grid, THREADS, 0, s>>>(
        C2, t, R, w + ((t - 1) & 1) * C2, w + (t & 1) * C2, front + (t & 1) * bit_words,
        front + ((t + 1) & 1) * bit_words, (int32_t*)ctl);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    label_tail_kernel<<<first_grid, THREADS, 0, s>>>(heads, C2, R, w, (int32_t*)ctl,
                                                      (int64_t*)ptr, (int64_t*)dist);
    err = cudaGetLastError();
  }
  return (int)err;
}

// Scratch words (8 bytes each) shannon_cycle_rounds takes for C2 lanes: the
// two buffers of packed words (C2 each), then the S bitmap (ceil(C2 / 32)
// uint32 words).
int64_t shannon_cycle_rounds_words(int64_t C2) { return 2 * C2 + ((C2 + 31) / 32 + 1) / 2; }

// prev [C2] in [-1, C2), C2 < 2^31; head_ptr [C2]: the label stage's
// pointers on prev; scratch: shannon_cycle_rounds_words(C2) words; ctl: R + 1
// int32, zeroed here, R = max(bit_length(C2), 1): [0] |S|, [t] the lanes
// whose minimum changed in round t; prev_out [C2] the cut links.
int shannon_cycle_rounds(const void* prev, const void* head_ptr, int64_t C2, void* scratch,
                         int64_t scratch_words, void* ctl, int ctl_words, void* prev_out,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int R = 1;
  while (R < 63 && (C2 >> R) != 0) ++R;
  if (C2 < 0 || C2 >= (1ll << 31) || ctl_words != R + 1 ||
      scratch_words != shannon_cycle_rounds_words(C2)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t bit_words = (C2 + 31) / 32;
  cudaError_t err = cudaMemsetAsync(ctl, 0, sizeof(int32_t) * (size_t)(R + 1), s);
  if (err != cudaSuccess || C2 == 0) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cycle_round_kernel, THREADS, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const unsigned int lane_grid = blocks_for(C2) < LABEL_GRID ? blocks_for(C2) : LABEL_GRID;
  const unsigned int chunk_warps = (unsigned int)((bit_words + 31) / 32);
  const unsigned int wanted = (chunk_warps + LABEL_WARPS - 1) / LABEL_WARPS;
  const unsigned int resident = (unsigned int)(sms * per_sm);
  const unsigned int grid = resident < wanted ? (resident > 0 ? resident : 1) : wanted;
  uint64_t* w = (uint64_t*)scratch;
  const uint32_t* bits = (const uint32_t*)(w + 2 * C2);
  cycle_first_kernel<<<lane_grid, THREADS, 0, s>>>((const int64_t*)prev,
                                                   (const int64_t*)head_ptr, C2, w + C2,
                                                   (uint32_t*)(w + 2 * C2), (int32_t*)ctl);
  err = cudaGetLastError();
  for (int t = 2; t <= R && err == cudaSuccess; ++t) {
    cycle_round_kernel<<<grid, THREADS, 0, s>>>(C2, t, w + ((t - 1) & 1) * C2, w + (t & 1) * C2,
                                                bits, (int32_t*)ctl);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    cycle_tail_kernel<<<lane_grid, THREADS, 0, s>>>((const int64_t*)prev, C2, R, w, bits,
                                                    (const int32_t*)ctl, (int64_t*)prev_out);
    err = cudaGetLastError();
  }
  return (int)err;
}

// scratch: exactly tiles + 1 zeroed words (scan.cuh), tiles = ceil(C2 /
// SCAN_TILE), or the call is refused; ids: C2 int32.  n_contigs is the
// scan's total (kernels.scan_total).  tail_lane holds each contig's packed
// tail until the last launch unpacks it.
int shannon_contig_reduce(const void* node_key, const void* node_count,
                          const void* prev2, const void* head_ptr,
                          const void* dist, const void* rec_lane,
                          const void* first_p, const void* p_cnt, int64_t C2, int k,
                          int canonical, void* scratch, int64_t scratch_words, void* ids,
                          void* node_cid, void* node_off, void* klen,
                          void* count_sum, void* head_lane, void* tail_lane,
                          void* abundance, void* out_edges, void* rc_pair,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = scan_tiles(C2);
  if (scratch_words != tiles + 1 || C2 >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (C2 == 0) return (int)cudaGetLastError();
  unsigned long long* sc = (unsigned long long*)scratch;
  contig_heads_kernel<<<(unsigned int)tiles, SCAN_THREADS, 0, s>>>(
      (const int64_t*)node_key, (const int32_t*)node_count, (const int64_t*)prev2, C2, sc,
      (int32_t*)ids, (int64_t*)count_sum, (int64_t*)head_lane,
      (unsigned long long*)tail_lane);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  contig_lanes_kernel<<<blocks_for(C2), THREADS, 0, s>>>(
      (const int32_t*)ids, (const int32_t*)node_count, (const int64_t*)head_ptr,
      (const int64_t*)dist, C2, (int64_t*)node_cid, (int64_t*)node_off,
      (unsigned long long*)count_sum, (unsigned long long*)tail_lane);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  contig_slots_kernel<<<blocks_for(C2), THREADS, 0, s>>>(
      (const int64_t*)node_key, (const int64_t*)dist, (const int64_t*)rec_lane,
      (const int64_t*)first_p, (const int64_t*)p_cnt, (const int64_t*)node_cid, sc + tiles,
      C2, k, canonical, (int64_t*)klen, (int64_t*)count_sum, (int64_t*)head_lane,
      (int64_t*)tail_lane, (float*)abundance, (int64_t*)out_edges, (int64_t*)rc_pair);
  return (int)cudaGetLastError();
}

int64_t shannon_base_streams_words(int64_t n_contigs) {
  return (n_contigs + STREAM_TILE - 1) / STREAM_TILE + 1;
}

// n_tails: the real lanes, [0, n_tails), each with a contig id, so sum(klen)
// over the n_contigs contigs; C2 below 2^31 (as K14 requires); scratch:
// exactly shannon_base_streams_words(n_contigs) zeroed words (a ticket and a
// status word a tile, scan.cuh), or the call is refused; tstart: n_contigs
// int64.
int shannon_base_streams(const void* node_key, const void* node_cid,
                         const void* node_off, int64_t C2, int64_t n_tails,
                         const void* klen, const void* head_lane, int64_t n_contigs, int k,
                         void* scratch, int64_t scratch_words, void* tstart, void* tails,
                         void* heads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (scratch_words != shannon_base_streams_words(n_contigs) || n_tails > C2 ||
      C2 >= (1ll << 31) || k < 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_contigs == 0) return (int)cudaGetLastError();
  stream_heads_kernel<<<(unsigned int)(scratch_words - 1), STREAM_TILE, 0, s>>>(
      (const int64_t*)node_key, C2, (const int64_t*)klen, (const int64_t*)head_lane, n_contigs,
      k, (unsigned long long*)scratch, (int64_t*)tstart, (uint8_t*)heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tails == 0) return (int)err;
  tails_stream_kernel<<<blocks_for(n_tails), THREADS, 0, s>>>(
      (const int64_t*)node_key, (const int64_t*)node_cid, (const int64_t*)node_off,
      (const int64_t*)tstart, n_tails, (uint8_t*)tails);
  return (int)cudaGetLastError();
}

}  // extern "C"
