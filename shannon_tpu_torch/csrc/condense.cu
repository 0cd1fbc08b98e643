// de Bruijn condensation kernels K11-K15 of the shannon_tpu_torch port (plain
// C interface; see kernels.cu for the conventions every entry point follows).
//
// The node table is C2 sorted int64 keys, PAD past its real nodes.  Lanes,
// pointers, contig ids and offsets are int64; counts int32.  Every output is
// written over its full capacity, pads included, with exactly the values the
// plain versions in shannon_tpu_torch/ops/condense.py leave there.

#include "common.cuh"

// ---------------------------------------------------------------------------
// K11: oriented node table (both strands of each canonical k-mer).
// Replaces shannon_tpu/ops/condense.py:82 _nodes_stage.  The reference sorted
// (key, count) pairs of both strands and kept each run's first payload.  Here
// node_strands_kernel writes the keys alone, torch.sort sorts them, K2 dedupes
// the palindromes (a palindrome is its own reverse complement, so it appears
// twice), and node_counts_kernel gives each node the count of its canonical
// k-mer by K3's binary search in the spectrum: the payload sort and the two
// payload gathers of the plain version are never needed.
// Bound: memory for the strands pass (8 bytes read, 16 written a lane); the
// count pass is a binary search per node, bounded by the latency of its
// dependent loads (the spectrum of a few million keys stays in the 50 MB L2).
// ---------------------------------------------------------------------------
__global__ void node_strands_kernel(const int64_t* __restrict__ key, int64_t C,
                                    int k, int64_t* __restrict__ both) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int64_t v = key[i];
  both[i] = v;
  both[C + i] = v == PAD_KEY ? PAD_KEY : (int64_t)revcomp_bits((uint64_t)v, k);
}

// The spectrum holds canonical keys, so a node and its reverse complement
// share the spectrum entry min(v, revcomp(v)).
__global__ void node_counts_kernel(const int64_t* __restrict__ node_key,
                                   int64_t C2, const int64_t* __restrict__ table,
                                   const int32_t* __restrict__ table_count,
                                   int64_t C, int k,
                                   int32_t* __restrict__ node_count) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  const int64_t v = node_key[i];
  int32_t c = 0;
  if (v != PAD_KEY) {
    const int64_t rc = (int64_t)revcomp_bits((uint64_t)v, k);
    int64_t lane;
    if (lower_bound_hit(table, C, rc < v ? rc : v, &lane)) c = table_count[lane];
  }
  node_count[i] = c;
}

// ---------------------------------------------------------------------------
// K12: mergeable links and the successor directory from one (k-1)-mer group
// join.  Replaces shannon_tpu/ops/condense.py:109 _links_stage.
// Every node gives a source record (its (k-1)-suffix) and a target record (its
// (k-1)-prefix); link_records_kernel writes their sort keys (k-1)-mer * 2 +
// side, PAD for pad nodes, and torch.sort(stable=True) orders them, so a group
// is its sources then its targets, each in lane order (the order prev_link and
// the successor runs are read in).  group_links_kernel runs one thread per
// sorted record.  Node keys are distinct, so a group holds at most 4 sources
// and 4 targets, and the thread finds its group's start, first target and end
// by stepping over its neighbours (at most 7 loads, from cache) instead of the
// reference's cummax/cumsum passes.  Each lane has exactly one source and one
// target record, so the scatters to node order never collide: they replace the
// reference's unsort sort.
// Bound: memory (the records' 16 bytes read, 8 written a record, and 24 bytes
// of node-order outputs a lane).
// ---------------------------------------------------------------------------
__global__ void link_records_kernel(const int64_t* __restrict__ node_key,
                                    int64_t C2, int k,
                                    int64_t* __restrict__ sort_key) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  const int64_t v = node_key[i];
  if (v == PAD_KEY) {
    sort_key[i] = PAD_KEY;
    sort_key[C2 + i] = PAD_KEY;
    return;
  }
  const int64_t suf = v & (int64_t)((1ull << (2 * (k - 1))) - 1);
  sort_key[i] = suf * 2;
  sort_key[C2 + i] = (v >> 2) * 2 + 1;
}

__global__ void group_links_kernel(const int64_t* __restrict__ skey,
                                   const int64_t* __restrict__ order,
                                   int64_t C2, int64_t* __restrict__ prev_link,
                                   int64_t* __restrict__ rec_lane,
                                   int64_t* __restrict__ first_p,
                                   int64_t* __restrict__ p_cnt) {
  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t m = 2 * C2;
  if (r >= m) return;
  const int64_t o = order[r];
  const bool target = o >= C2;
  const int64_t lane = target ? o - C2 : o;
  rec_lane[r] = lane;
  const int64_t s = skey[r];
  if (s == PAD_KEY) {  // pad records form no group
    if (target) {
      prev_link[lane] = -1;
    } else {
      first_p[lane] = 0;
      p_cnt[lane] = 0;
    }
    return;
  }
  // (PAD >> 1) is above every real (k-1)-mer, so the scans stop at the pads
  const int64_t g = s >> 1;
  int64_t g0 = r;
  while (g0 > 0 && (skey[g0 - 1] >> 1) == g) --g0;
  int64_t end = r + 1;
  while (end < m && (skey[end] >> 1) == g) ++end;
  int64_t fp = g0;
  while (fp < end && (skey[fp] & 1) == 0) ++fp;
  if (target) {
    const bool single = fp - g0 == 1 && end - fp == 1;
    const int64_t o0 = order[g0];
    prev_link[lane] = single ? (o0 >= C2 ? o0 - C2 : o0) : -1;
  } else {
    first_p[lane] = fp;
    p_cnt[lane] = end - fp;
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
    const uint32_t m = wi < n_words ? bits_in[wi] : 0u;
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

__global__ void cycle_round_kernel(const int64_t* __restrict__ prev,
                                   const int64_t* __restrict__ ptr_in,
                                   const int64_t* __restrict__ mn_in,
                                   int64_t C2, int last,
                                   int64_t* __restrict__ ptr_out,
                                   int64_t* __restrict__ mn_out,
                                   int64_t* __restrict__ prev_out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  int64_t p, mn, np, mp;
  if (ptr_in == nullptr) {
    const int64_t pv = prev[i];
    p = pv >= 0 ? pv : i;
    mn = i;
    const int64_t pp = prev[p];
    np = pp >= 0 ? pp : p;
    mp = p;
  } else {
    p = ptr_in[i];
    mn = mn_in[i];
    np = ptr_in[p];
    mp = mn_in[p];
  }
  mn = mp < mn ? mp : mn;
  if (last) {
    prev_out[i] = (prev[np] >= 0 && mn == i) ? -1 : prev[i];
  } else {
    ptr_out[i] = np;
    mn_out[i] = mn;
  }
}

// ---------------------------------------------------------------------------
// K14: per-contig reduction, contig edges and reverse-complement twins.
// Replaces shannon_tpu/ops/condense.py:287 _reduce_stage.  The reference
// sorted the nodes by (cid, offset) and compacted run starts and ends with two
// more sorts.  Here contig ids come from one torch.cumsum of head_flags_kernel's
// flags (cid = rank of the chain head), and the reductions need no order:
// contig_lanes_kernel adds each node into its contig's klen and count sum with
// int64 atomics (integer sums, so exact whatever the order) and writes the
// head lane (offset 0); contig_tails_kernel writes the tail lane (offset
// klen - 1); contig_edges_kernel runs one thread per contig for the float32
// abundance (count_sum / klen, each converted and divided with round-to-nearest
// intrinsics, so it is bit-equal to the plain version's and the host's
// recomputation), the successor run of the tail node in the link records, and
// the reverse-complement twin by K3's binary search.  Every head and tail slot
// is written by exactly one lane; the entry point zeroes klen and count_sum and
// fills head_lane and tail_lane with -1 first.
// Bound: memory for the lane passes; the twin search, one per contig, is
// bounded by the latency of its dependent loads.
// ---------------------------------------------------------------------------
__global__ void head_flags_kernel(const int64_t* __restrict__ node_key,
                                  const int64_t* __restrict__ prev2, int64_t C2,
                                  int32_t* __restrict__ flags) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  flags[i] = (node_key[i] != PAD_KEY && prev2[i] < 0) ? 1 : 0;
}

__global__ void contig_lanes_kernel(const int64_t* __restrict__ node_key,
                                    const int32_t* __restrict__ node_count,
                                    const int64_t* __restrict__ prev2,
                                    const int64_t* __restrict__ head_ptr,
                                    const int64_t* __restrict__ dist,
                                    const int32_t* __restrict__ scan, int64_t C2,
                                    int64_t* __restrict__ node_cid,
                                    int64_t* __restrict__ node_off,
                                    int64_t* __restrict__ klen,
                                    int64_t* __restrict__ count_sum,
                                    int64_t* __restrict__ head_lane) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  if (node_key[i] == PAD_KEY) {
    node_cid[i] = -1;
    node_off[i] = -1;
    return;
  }
  const int64_t h = head_ptr[i];
  const bool h_is_head = node_key[h] != PAD_KEY && prev2[h] < 0;
  const int64_t cid = h_is_head ? (int64_t)scan[h] - 1 : -1;
  const int64_t off = dist[i];
  node_cid[i] = cid;
  node_off[i] = off;
  if (cid < 0) return;
  atomicAdd(reinterpret_cast<unsigned long long*>(klen + cid), 1ull);
  atomicAdd(reinterpret_cast<unsigned long long*>(count_sum + cid),
            (unsigned long long)(int64_t)node_count[i]);
  if (off == 0) head_lane[cid] = i;
}

__global__ void contig_tails_kernel(const int64_t* __restrict__ node_cid,
                                    const int64_t* __restrict__ node_off,
                                    const int64_t* __restrict__ klen, int64_t C2,
                                    int64_t* __restrict__ tail_lane) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  const int64_t cid = node_cid[i];
  if (cid >= 0 && node_off[i] == klen[cid] - 1) tail_lane[cid] = i;
}

__global__ void contig_edges_kernel(const int64_t* __restrict__ node_key,
                                    const int64_t* __restrict__ dist,
                                    const int64_t* __restrict__ rec_lane,
                                    const int64_t* __restrict__ first_p,
                                    const int64_t* __restrict__ p_cnt,
                                    const int64_t* __restrict__ node_cid,
                                    const int64_t* __restrict__ klen,
                                    const int64_t* __restrict__ count_sum,
                                    const int64_t* __restrict__ tail_lane,
                                    int64_t C2, int k, int canonical,
                                    float* __restrict__ abundance,
                                    int64_t* __restrict__ out_edges,
                                    int64_t* __restrict__ rc_pair) {
  int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C2) return;
  const int64_t kl = klen[c];
  abundance[c] = kl > 0 ? __fdiv_rn(__ll2float_rn(count_sum[c]), __ll2float_rn(kl))
                        : 0.0f;
  const int64_t tl = tail_lane[c];
  int64_t fp = 0, pc = 0;
  if (tl >= 0) {
    fp = first_p[tl];
    pc = p_cnt[tl];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out_edges[j * C2 + c] = j < pc ? node_cid[rec_lane[fp + j]] : -1;
  }
  int64_t rc = c;
  if (canonical && tl >= 0) {
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
// contig are 0..klen-1, so each node's slot is known: tails_stream_kernel
// writes key & 3 of every real node to tstart[cid] + off, where tstart is the
// exclusive prefix sum of klen (incl - klen from a torch.cumsum), and
// heads_stream_kernel unpacks the k-1 leading bases of each contig's head key,
// one thread per (contig, base).
// Bound: memory (24 bytes read a node lane, one byte written a base).
// ---------------------------------------------------------------------------
__global__ void tails_stream_kernel(const int64_t* __restrict__ node_key,
                                    const int64_t* __restrict__ node_cid,
                                    const int64_t* __restrict__ node_off,
                                    int64_t C2, const int64_t* __restrict__ klen,
                                    const int64_t* __restrict__ incl,
                                    uint8_t* __restrict__ tails) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  const int64_t cid = node_cid[i];
  if (cid < 0) return;
  tails[incl[cid] - klen[cid] + node_off[i]] = (uint8_t)(node_key[i] & 3);
}

__global__ void heads_stream_kernel(const int64_t* __restrict__ node_key,
                                    int64_t C2,
                                    const int64_t* __restrict__ head_lane,
                                    int64_t n_contigs, int k,
                                    uint8_t* __restrict__ heads) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int w = k - 1;
  if (t >= n_contigs * w) return;
  const int64_t c = t / w;
  const int j = (int)(t - c * w);
  int64_t hl = head_lane[c];
  hl = hl < 0 ? 0 : (hl > C2 - 1 ? C2 - 1 : hl);
  heads[t] = (uint8_t)((node_key[hl] >> (2 * (w - j))) & 3);
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
extern "C" {

int shannon_node_strands(const void* key, int64_t C, int k, void* both,
                         void* stream) {
  if (C > 0) {
    node_strands_kernel<<<blocks_for(C), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)key, C, k, (int64_t*)both);
  }
  return (int)cudaGetLastError();
}

int shannon_node_counts(const void* node_key, int64_t C2, const void* table,
                        const void* table_count, int64_t C, int k,
                        void* node_count, void* stream) {
  if (C2 > 0) {
    node_counts_kernel<<<blocks_for(C2), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)node_key, C2, (const int64_t*)table,
        (const int32_t*)table_count, C, k, (int32_t*)node_count);
  }
  return (int)cudaGetLastError();
}

int shannon_link_records(const void* node_key, int64_t C2, int k,
                         void* sort_key, void* stream) {
  if (C2 > 0) {
    link_records_kernel<<<blocks_for(C2), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)node_key, C2, k, (int64_t*)sort_key);
  }
  return (int)cudaGetLastError();
}

int shannon_group_links(const void* skey, const void* order, int64_t C2,
                        void* prev_link, void* rec_lane, void* first_p,
                        void* p_cnt, void* stream) {
  if (C2 > 0) {
    group_links_kernel<<<blocks_for(2 * C2), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)skey, (const int64_t*)order, C2, (int64_t*)prev_link,
        (int64_t*)rec_lane, (int64_t*)first_p, (int64_t*)p_cnt);
  }
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

int shannon_cycle_round(const void* prev, const void* ptr_in, const void* mn_in,
                        int64_t C2, int last, void* ptr_out, void* mn_out,
                        void* prev_out, void* stream) {
  if (C2 > 0) {
    cycle_round_kernel<<<blocks_for(C2), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)prev, (const int64_t*)ptr_in, (const int64_t*)mn_in, C2,
        last, (int64_t*)ptr_out, (int64_t*)mn_out, (int64_t*)prev_out);
  }
  return (int)cudaGetLastError();
}

int shannon_head_flags(const void* node_key, const void* prev2, int64_t C2,
                       void* flags, void* stream) {
  if (C2 > 0) {
    head_flags_kernel<<<blocks_for(C2), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)node_key, (const int64_t*)prev2, C2, (int32_t*)flags);
  }
  return (int)cudaGetLastError();
}

int shannon_contig_reduce(const void* node_key, const void* node_count,
                          const void* prev2, const void* head_ptr,
                          const void* dist, const void* rec_lane,
                          const void* first_p, const void* p_cnt,
                          const void* scan, int64_t C2, int k, int canonical,
                          void* node_cid, void* node_off, void* klen,
                          void* count_sum, void* head_lane, void* tail_lane,
                          void* abundance, void* out_edges, void* rc_pair,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t bytes = (size_t)C2 * sizeof(int64_t);
  cudaError_t err = cudaSuccess;
  if (C2 == 0) return (int)cudaGetLastError();
  if ((err = cudaMemsetAsync(klen, 0, bytes, s)) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(count_sum, 0, bytes, s)) != cudaSuccess) return (int)err;
  // all-ones bytes: -1 in every int64 lane
  if ((err = cudaMemsetAsync(head_lane, 0xFF, bytes, s)) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(tail_lane, 0xFF, bytes, s)) != cudaSuccess) return (int)err;
  contig_lanes_kernel<<<blocks_for(C2), THREADS, 0, s>>>(
      (const int64_t*)node_key, (const int32_t*)node_count,
      (const int64_t*)prev2, (const int64_t*)head_ptr, (const int64_t*)dist,
      (const int32_t*)scan, C2, (int64_t*)node_cid, (int64_t*)node_off,
      (int64_t*)klen, (int64_t*)count_sum, (int64_t*)head_lane);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  contig_tails_kernel<<<blocks_for(C2), THREADS, 0, s>>>(
      (const int64_t*)node_cid, (const int64_t*)node_off, (const int64_t*)klen,
      C2, (int64_t*)tail_lane);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  contig_edges_kernel<<<blocks_for(C2), THREADS, 0, s>>>(
      (const int64_t*)node_key, (const int64_t*)dist, (const int64_t*)rec_lane,
      (const int64_t*)first_p, (const int64_t*)p_cnt, (const int64_t*)node_cid,
      (const int64_t*)klen, (const int64_t*)count_sum,
      (const int64_t*)tail_lane, C2, k, canonical, (float*)abundance,
      (int64_t*)out_edges, (int64_t*)rc_pair);
  return (int)cudaGetLastError();
}

int shannon_base_streams(const void* node_key, const void* node_cid,
                         const void* node_off, int64_t C2, const void* klen,
                         const void* incl, const void* head_lane,
                         int64_t n_contigs, int k, void* tails, void* heads,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C2 > 0) {
    tails_stream_kernel<<<blocks_for(C2), THREADS, 0, s>>>(
        (const int64_t*)node_key, (const int64_t*)node_cid,
        (const int64_t*)node_off, C2, (const int64_t*)klen,
        (const int64_t*)incl, (uint8_t*)tails);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t n_heads = n_contigs * (int64_t)(k - 1);
  if (n_heads > 0 && C2 > 0) {
    heads_stream_kernel<<<blocks_for(n_heads), THREADS, 0, s>>>(
        (const int64_t*)node_key, C2, (const int64_t*)head_lane, n_contigs, k,
        (uint8_t*)heads);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
