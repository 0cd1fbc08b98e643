// Error-correction kernels K7, K9, K10, K16, K20 and K23 of the
// shannon_tpu_torch port (plain C interface; see kernels.cu for the
// conventions every entry point follows).  K8, the dead-end rescue, is in
// rescue.cu.
//
// The spectrum is a sorted table of C int64 keys with int32 counts, PAD past
// its real entries.  A probe table is [8, C], entry i of probe row p at
// p * C + i: row 2b is the right probe with base b, row 2b + 1 the left one
// (the row order of probe_keys in shannon_tpu_torch/ops/spectrum.py).  Its
// idx is meaningful only where hit, so K8 (rescue.cu) and K9 read idx only
// there.

#include "common.cuh"
#include "scan.cuh"
#include "search.cuh"

// ---------------------------------------------------------------------------
// K7: probe lookup.
// Replaces shannon_tpu/ops/correction.py:78 _probe_resolve (with
// ops/kmers.py:69 canonical_hilo and ops/spectrum.py:137 lookup_hilo).
// Bound: scattered-load passes and their latency, as K3 (search.cuh), and a
// table (12,582,912 lanes, 100 MB on the main path) that does not fit in L2;
// the bytes it must move are the keys read once and the [8, C] idx and hit
// written once (906 MB there), which no search can come near.
// Design.  The entry point builds the table's 16-ary index; persistent
// blocks walk it (search.cuh).  A warp takes 32 consecutive lanes, each lane
// its 8 probes together, so the stores of every probe row stay coalesced
// (streaming stores, so the answers do not push the table out of L2).  The
// probe is built in registers with the plain version's exact bit operations
// (probe_key, shared with K22), and three shortcuts cut the walks:
//  - PAD lanes.  Their probes depend only on PAD, so the 8 answers are
//    walked once per block (warp 0, before the lanes) and copied to every
//    PAD lane.
//  - A lane's own group.  A probe x with x & ~3 == v & ~3 (a right sibling
//    kept in forward form, (v & ~3) | b) has its lower bound within lanes
//    i - 3 .. i + 3 of a table of distinct keys (or C): stepped to from i.
//  - Shared groups.  sib's four left siblings in reverse-complement form,
//    (rc(v) & ~3) | comp(b), share one group; so do ext's four right
//    extensions in forward form, ((v << 2) | b) & mask, and its four left
//    extensions in reverse-complement form, ((rc(v) << 2) & mask) | comp(b).
//    One walk per group gives lb(g); a member x steps up from it past the
//    keys in [g, x), at most 3.
// Which form a probe takes is the plain version's per-probe choice (key =
// min(q, rc(q)) when canonical), and a probe takes a shortcut only where its
// key lies in that group, so every answer is the exact lower bound for any
// sorted table; the steps are few only because a spectrum's keys are
// distinct.  Every other probe walks: on a canonical spectrum 37% of sib's
// probes and half of ext's, plus about one group walk a lane (sib) or two
// (ext).  Each lane leaves its probe keys in its group's job slots (shared
// memory, slot p of lane l for job p: probes 0-7, the shared groups 8 and
// 9) with the node below the top of each of its walks (search_top); each
// group of 8 lanes queues its walks as one 80-bit mask (bit 8 p + l) and
// walks them PROBE_Q at a time in job order, so the forward probes of
// consecutive lanes, which are sorted in lane order, walk one after another
// through the same nodes; each answer goes back to its slot.
// ---------------------------------------------------------------------------
#define PROBE_JOBS 10
#define PROBE_HIT (1ll << 62)  // beside a lower bound (<= C < 2^62)

// Group job g of lane key v (its low two bits 0): g = 0 is sib's
// reverse-complement left-sibling group rc(v) & ~3 or ext's forward
// right-extension group (v << 2) & mask, g = 1 ext's reverse-complement
// left-extension group (rc(v) << 2) & mask.
static __device__ __forceinline__ int64_t probe_group(uint64_t v, int k, int side_ext, int g) {
  const uint64_t mask = (1ull << (2 * k)) - 1;
  const uint64_t rc = revcomp_bits(v, k);
  if (g == 0) return (int64_t)(side_ext ? ((v << 2) & mask) : (rc & ~3ull));
  return (int64_t)((rc << 2) & mask);
}

// How a real lane of key v resolves probe key x: 0 in its own group, 1 or 2
// from group job 8 (ga) or 9 (gb, ext only), 3 by its own walk.
static __device__ __forceinline__ int probe_route(int64_t x, int64_t v, int64_t ga,
                                                  int64_t gb, int side_ext) {
  const int64_t g = x & ~3ll;
  if (g == (v & ~3ll)) return 0;
  if (g == ga) return 1;
  if (side_ext && g == gb) return 2;
  return 3;
}

// The lower bound of x in table[0, C), stepping up from lane j (at or below
// it); *hit whether that lane holds x.
static __device__ __forceinline__ int64_t step_up(const int64_t* __restrict__ table, int64_t C,
                                                  int64_t j, int64_t x, bool* hit) {
  int64_t t = x;
  while (j < C) {
    t = table[j];
    if (t >= x) break;
    ++j;
  }
  *hit = j < C && t == x;
  return j;
}

// The lower bound of x, stepping down from lane j, whose key t is >= x.
static __device__ __forceinline__ int64_t step_down(const int64_t* __restrict__ table, int64_t j,
                                                    int64_t t, int64_t x, bool* hit) {
  while (j > 0) {
    const int64_t u = table[j - 1];
    if (u < x) break;
    --j;
    t = u;
  }
  *hit = t == x;
  return j;
}

// The lowest queued job, removed from the mask; -1 when none is left.  Job
// p of lane l of a group is bit 8 p + l: probes 0-7 in jobs[0], the shared
// groups 8-9 in jobs[1].
static __device__ __forceinline__ int take_job(uint64_t (&jobs)[2]) {
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (jobs[w] != 0) {
      const int b = __ffsll((long long)jobs[w]) - 1;
      jobs[w] &= jobs[w] - 1;
      return 64 * w + b;
    }
  }
  return -1;
}

#define PROBE_Q 4
#define PROBE_GROUPS (SEARCH_THREADS / SEARCH_GROUP)

__global__ void __launch_bounds__(SEARCH_THREADS)
    probe_lookup_kernel(const int64_t* __restrict__ table, int C,
                        const int64_t* __restrict__ index, SearchIndex ix, int k,
                        int side_ext, int canonical, int64_t* __restrict__ idx,
                        uint8_t* __restrict__ hit) {
  extern __shared__ int64_t top[];
  __shared__ int64_t s_pad[8];  // the PAD lanes' answers, lower bound | PROBE_HIT
  // each group's job slots: the key, then the answer (lower bound |
  // PROBE_HIT), and the node below the top
  __shared__ int64_t s_key[PROBE_GROUPS][PROBE_JOBS][SEARCH_GROUP];
  __shared__ int s_node[PROBE_GROUPS][PROBE_JOBS][SEARCH_GROUP];
  search_load_top(ix, index, top);
  const int lane = threadIdx.x & 31;
  const int gl = lane & (SEARCH_GROUP - 1), gbase = lane & ~(SEARCH_GROUP - 1);
  const int group = threadIdx.x / SEARCH_GROUP;
  const bool table_vec = ((uintptr_t)table & 15) == 0;
  if (threadIdx.x < 32) {  // warp 0 walks PAD's 8 probes, 2 a group
    int64_t q[2];
    int node[2], lb[2];
    bool h[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      q[j] = probe_key((uint64_t)PAD_KEY, k, 2 * (lane >> 3) + j, side_ext, canonical);
      node[j] = search_top(ix, top, q[j]);
    }
    search_walk<2>(ix, index, table, C, table_vec, q, node, lb, h);
    if (gl == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) s_pad[2 * (lane >> 3) + j] = lb[j] | (h[j] ? PROBE_HIT : 0);
    }
  }
  __syncthreads();
  int64_t(*key_slot)[SEARCH_GROUP] = s_key[group];
  int(*node_slot)[SEARCH_GROUP] = s_node[group];
  const int64_t chunks = (C + 31) / 32;
  const int64_t warp = (int64_t)blockIdx.x * (SEARCH_THREADS / 32) + (threadIdx.x >> 5);
  const int64_t warps = (int64_t)gridDim.x * (SEARCH_THREADS / 32);
  for (int64_t c = warp; c < chunks; c += warps) {
    const int64_t i64 = c * 32 + lane;
    const bool live = i64 < C;
    const int i = (int)i64;
    const int64_t v = live ? table[i] : PAD_KEY;
    const bool real = v != PAD_KEY;
    const int64_t ga = probe_group((uint64_t)v, k, side_ext, 0);
    const int64_t gb = probe_group((uint64_t)v, k, side_ext, 1);
    unsigned routes = 0;  // 2 bits a probe
    unsigned mine = 0;    // the jobs this lane walks: bit p
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int64_t x = probe_key((uint64_t)v, k, p, side_ext, canonical);
      const int route = real ? probe_route(x, v, ga, gb, side_ext) : 0;
      routes |= (unsigned)route << (2 * p);
      key_slot[p][gl] = x;
      if (real) mine |= route == 3 ? 1u << p : route == 1 ? 1u << 8 : route == 2 ? 1u << 9 : 0u;
    }
    key_slot[8][gl] = ga;
    key_slot[9][gl] = gb;
    // each job's node below the top, all lanes in step over their own jobs
    for (unsigned left = mine; left != 0; left &= left - 1) {
      const int p = __ffs(left) - 1;
      node_slot[p][gl] = search_top(ix, top, key_slot[p][gl]);
    }
    uint64_t jobs[2] = {0, 0};
#pragma unroll
    for (int p = 0; p < PROBE_JOBS; ++p) {
      const uint64_t m = (__ballot_sync(SEARCH_FULL_MASK, (mine >> p) & 1u) >> gbase) & 0xffu;
      jobs[p >> 3] |= m << (8 * (p & 7));
    }
    __syncwarp();
    while (__any_sync(SEARCH_FULL_MASK, (jobs[0] | jobs[1]) != 0)) {
      int pick[PROBE_Q], node[PROBE_Q], lb[PROBE_Q];
      int64_t q[PROBE_Q];
      bool h[PROBE_Q];
#pragma unroll
      for (int j = 0; j < PROBE_Q; ++j) {
        pick[j] = take_job(jobs);
        // a group with no job left walks key 0 from node 0
        q[j] = pick[j] < 0 ? 0 : key_slot[pick[j] >> 3][pick[j] & 7];
        node[j] = pick[j] < 0 ? 0 : node_slot[pick[j] >> 3][pick[j] & 7];
      }
      search_walk<PROBE_Q>(ix, index, table, C, table_vec, q, node, lb, h);
#pragma unroll
      for (int j = 0; j < PROBE_Q; ++j) {
        if (pick[j] >= 0 && gl == 0) {
          key_slot[pick[j] >> 3][pick[j] & 7] = (int64_t)lb[j] | (h[j] ? PROBE_HIT : 0);
        }
      }
    }
    __syncwarp();
    if (!live) continue;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      int64_t lb;
      bool found;
      const int route = (routes >> (2 * p)) & 3;
      if (!real) {
        lb = s_pad[p] & ~PROBE_HIT;
        found = (s_pad[p] & PROBE_HIT) != 0;
      } else if (route == 3) {
        lb = key_slot[p][gl] & ~PROBE_HIT;
        found = (key_slot[p][gl] & PROBE_HIT) != 0;
      } else {
        const int64_t x = key_slot[p][gl];
        if (route == 0) {
          lb = x <= v ? step_down(table, i, v, x, &found) : step_up(table, C, i + 1, x, &found);
        } else {
          lb = step_up(table, C, key_slot[route == 1 ? 8 : 9][gl] & ~PROBE_HIT, x, &found);
        }
      }
      // streaming stores: the 906 MB of answers should not push the table
      // out of L2
      __stcs(reinterpret_cast<long long*>(idx) + (int64_t)p * C + i, (long long)(lb < C ? lb : C - 1));
      __stcs(hit + (int64_t)p * C + i, (uint8_t)(found ? 1 : 0));
    }
  }
}

// The error cap of a sibling maximum F: max(3, (lam + 4 sqrt(lam)) + 1) with
// lam = eps3 * F, in the reference's order.  Every operation is an explicit
// round-to-nearest intrinsic, so nvcc cannot contract a multiply and an add
// into an FMA and the sqrt is the correctly rounded one.
static __device__ __forceinline__ float error_cap(float F, float eps3) {
  const float lam = __fmul_rn(eps3, F);
  const float t = __fadd_rn(__fadd_rn(lam, __fmul_rn(4.0f, __fsqrt_rn(lam))), 1.0f);
  return fmaxf(3.0f, t);
}

// ---------------------------------------------------------------------------
// K9: one sibling-prune round.
// Replaces one round of shannon_tpu/ops/correction.py:184 _prune_chunk (the
// loop body, lines 205-217).  A Jacobi round: it reads only the previous
// round's counts and writes a second buffer.  A lane with count c > 0 takes
// the largest sibling count where hit on the right rows (0, 2, 4, 6) and on
// the left rows (1, 3, 5, 7) and is pruned when, on either side,
// f32(c) < ratio * f32(max) and, when use_cap, f32(c) <= error_cap(f32(max)).
// ratio and eps3 arrive as the float32 values the plain version uses.
// Bound: memory.  Lanes with count 0 copy through without touching the probe
// rows; the others read 8 hit bytes and gather the counts of their hits.
// ---------------------------------------------------------------------------
__global__ void prune_round_kernel(const int32_t* __restrict__ counts,
                                   const int64_t* __restrict__ sidx,
                                   const uint8_t* __restrict__ shit, int64_t C,
                                   float ratio, float eps3, int use_cap,
                                   int32_t* __restrict__ out,
                                   int32_t* __restrict__ changed) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int32_t c = counts[i];
  bool doomed = false;
  if (c > 0) {
    int32_t rmax = 0, lmax = 0;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int64_t l = (int64_t)p * C + i;
      if (shit[l]) {
        const int32_t v = counts[sidx[l]];
        if (p & 1) {
          lmax = v > lmax ? v : lmax;
        } else {
          rmax = v > rmax ? v : rmax;
        }
      }
    }
    const float cf = __int2float_rn(c);
    const float rf = __int2float_rn(rmax);
    const float lf = __int2float_rn(lmax);
    bool dr = cf < __fmul_rn(ratio, rf);
    bool dl = cf < __fmul_rn(ratio, lf);
    if (use_cap) {
      dr = dr && cf <= error_cap(rf, eps3);
      dl = dl && cf <= error_cap(lf, eps3);
    }
    doomed = dr || dl;
  }
  out[i] = doomed ? 0 : c;
  if (doomed) *changed = 1;
}

// ---------------------------------------------------------------------------
// K10: compaction of the kept entries.
// Replaces shannon_tpu/ops/correction.py:19 _compact (a 3-key sort of the
// whole table that moved the dropped lanes to the back).  A kept lane moves to
// slot = the number of kept lanes before it, so the kept entries stay in table
// order and the table stays sorted without a sort; lanes from n on get PAD / 0.
// Bound: memory.  The function must read the C keep flags and the key and
// count of each kept lane and write all C lanes of the output (12 bytes each):
// C + 12 n + 12 C bytes.  One pass over the flags with the single-pass scan of
// scan.cuh: a tile of 4,096 lanes reads its flags 16 to a thread as one
// uint4, counts them in registers, publishes its count, compacts its kept
// lanes' offsets into shared memory while its first warp looks back for the
// tile's first slot, then copies the kept keys and counts out, consecutive
// threads on consecutive slots (coalesced stores, gathers in lane order).  No
// C-length scan array exists and no flag is read twice.  The PAD / 0 tail
// [n, C) is the second launch (scan_fill_tail), which reads n from the last
// tile's status word; it cannot be fused into the tiles (scan.cuh).
// ---------------------------------------------------------------------------

// Bit j of the result is lane first + j's keep flag (lanes past C read 0).
static __device__ __forceinline__ unsigned keep_bits(const uint8_t* __restrict__ keep,
                                                     int64_t first, int64_t C) {
  unsigned bits = 0;
  if (first + SCAN_ITEMS <= C && ((uintptr_t)(keep + first) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(keep + first);
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // one bit a nonzero byte: byte b of the word to bit b
      const unsigned t = __vcmpne4(words[q], 0u) & 0x08040201u;
      bits |= ((t | (t >> 8) | (t >> 16) | (t >> 24)) & 0xFu) << (4 * q);
    }
  } else {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      if (first + j < C && keep[first + j]) bits |= 1u << j;
    }
  }
  return bits;
}

__global__ void __launch_bounds__(SCAN_THREADS)
    compact_keep_kernel(const int64_t* __restrict__ key, const int32_t* __restrict__ count,
                        const uint8_t* __restrict__ keep, int64_t C,
                        unsigned long long* __restrict__ scratch,
                        int64_t* __restrict__ out_key, int32_t* __restrict__ out_count) {
  __shared__ ScanShared sh;
  __shared__ unsigned s_warp[SCAN_WARPS];
  __shared__ uint16_t s_lane[SCAN_TILE];  // tile offsets of the kept lanes, in order
  unsigned long long* status = scratch + 1;
  const long long tile = scan_ticket(scratch, &sh);
  const int64_t base = (int64_t)tile * SCAN_TILE;
  const int first = threadIdx.x * SCAN_ITEMS;
  unsigned bits = keep_bits(keep, base + first, C);
  unsigned kept;
  unsigned r = block_exclusive_scan((unsigned)__popc(bits), s_warp, &kept);
  scan_publish_aggregate(status, tile, kept);
  while (bits) {
    const int j = __ffs(bits) - 1;
    bits &= bits - 1;
    s_lane[r++] = (uint16_t)(first + j);
  }
  const int64_t prefix = (int64_t)scan_tile_prefix(status, tile, kept, &sh);
  for (unsigned q = threadIdx.x; q < kept; q += SCAN_THREADS) {
    const int64_t i = base + s_lane[q];
    out_key[prefix + q] = key[i];
    out_count[prefix + q] = count[i];
  }
}

// ---------------------------------------------------------------------------
// K16: histogram of entry counts (the auto abundance cut's input).
// Replaces shannon_tpu/ops/correction.py:32 count_histogram, which sorted the
// clamped counts and found max_count + 2 bin boundaries by searchsorted to keep
// a contended scatter off the TPU.  h[c] counts the real lanes with
// clamp(count, 0, max_count) == c; pads and counts <= 0 fall in bin 0, which is
// never counted, so h[0] stays 0 from the entry point's memset.
// Bound: memory, one pass over keys and counts (12 bytes a lane).  A grid of a
// few blocks per SM strides over the table; each block keeps a private
// histogram of max_count + 1 bins in shared memory and adds its nonzero bins to
// the global one once.  Most lanes hold count 1 (at 1M reads the cut drops two
// thirds of the table), so the lanes of one warp mostly share a bin:
// __match_any_sync groups the warp's lanes by bin and one lane of each group
// adds the group's size, one shared atomic per distinct bin instead of 32 to
// one address.  Above HIST_KERNEL_MAX_COUNT the block histogram would not fit
// the 48 KB of shared memory a launch gets without opting in, so the global
// variant below counts straight into the global bins instead, with the same
// warp aggregation: one global atomic per distinct bin of each warp.
// ---------------------------------------------------------------------------
#define HIST_KERNEL_MAX_COUNT 8192

// The bin of lane i, 0 for lanes past C, pads and counts <= 0 (bin 0 is never
// counted); counts above max_count clamp into the top bin.
static __device__ __forceinline__ int hist_bin(const int64_t* __restrict__ key,
                                               const int32_t* __restrict__ count,
                                               int64_t C, int64_t i, int64_t max_count) {
  if (i >= C || key[i] == PAD_KEY) return 0;
  const int32_t v = count[i];
  return v < 0 ? 0 : (v > max_count ? (int)max_count : v);
}

__global__ void count_histogram_kernel(const int64_t* __restrict__ key,
                                       const int32_t* __restrict__ count,
                                       int64_t C, int max_count,
                                       int32_t* __restrict__ hist) {
  extern __shared__ int32_t bins[];
  for (int b = threadIdx.x; b <= max_count; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // base is the same for every thread of the block, so all 32 lanes of a warp
  // reach __match_any_sync together
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < C; base += stride) {
    const int c = hist_bin(key, count, C, base + threadIdx.x, max_count);
    const unsigned same = __match_any_sync(0xffffffffu, c);
    if (c > 0 && lane == __ffs(same) - 1) atomicAdd(&bins[c], __popc(same));
  }
  __syncthreads();
  for (int b = threadIdx.x + 1; b <= max_count; b += blockDim.x) {
    if (bins[b] != 0) atomicAdd(&hist[b], bins[b]);
  }
}

// K16's global variant, for max_count > HIST_KERNEL_MAX_COUNT: the same
// strided walk and warp aggregation, with the group's size added to the
// global bin (zeroed by the entry point's memset).
__global__ void count_histogram_global_kernel(const int64_t* __restrict__ key,
                                              const int32_t* __restrict__ count,
                                              int64_t C, int64_t max_count,
                                              int32_t* __restrict__ hist) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < C; base += stride) {
    const int c = hist_bin(key, count, C, base + threadIdx.x, max_count);
    const unsigned same = __match_any_sync(0xffffffffu, c);
    if (c > 0 && lane == __ffs(same) - 1) atomicAdd(&hist[c], __popc(same));
  }
}

// ---------------------------------------------------------------------------
// K20: the abundance cut.
// Replaces shannon_tpu/ops/correction.py:134 _cut_counts and the keep mask of
// :54 abundance_filter.  One streaming pass over key and count, given the cut
// m; it writes whichever outputs the caller passes non-null:
//   raw  = key == PAD ? 0 : count        (int32)
//   cut  = raw < m ? 0 : raw             (int32)
//   keep = key != PAD && count >= m      (bool)
// keep is not cut > 0: with m <= 0 a real lane of count 0 is kept, as the
// reference keeps it.
// Bound: memory; 12 bytes a lane in, up to 9 out.
// ---------------------------------------------------------------------------
__global__ void abundance_cut_kernel(const int64_t* __restrict__ key,
                                     const int32_t* __restrict__ count,
                                     int64_t C, int32_t m,
                                     int32_t* __restrict__ raw,
                                     int32_t* __restrict__ cut,
                                     uint8_t* __restrict__ keep) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const bool real = key[i] != PAD_KEY;
  const int32_t c = count[i];
  const int32_t r = real ? c : 0;
  if (raw) raw[i] = r;
  if (cut) cut[i] = r < m ? 0 : r;
  if (keep) keep[i] = (real && c >= m) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K23: the keep flags of one sibling-prune round.
// Replaces the decision of shannon_tpu/ops/correction.py:61
// sibling_prune_round (lines 68-74); K22 gives the sibling maxima, and
// torch.cumsum and K10 compact the kept lanes.  A lane is kept iff it is not
// PAD and neither f < ratio * R nor f < ratio * L, with f, R, L the float32
// values of its count and of its right and left sibling maxima.  Unlike K9
// there is no count > 0 guard and no error cap: a real lane of count 0 beside
// a positive sibling is dropped, as in the reference.  Each product is
// __fmul_rn, so nvcc cannot contract it; ratio arrives as the float32 value
// prune_constants rounds once.
// Bound: memory; 16 bytes a lane in, one out.
// ---------------------------------------------------------------------------
__global__ void prune_keep_kernel(const int64_t* __restrict__ key,
                                  const int32_t* __restrict__ count,
                                  const int32_t* __restrict__ rmax,
                                  const int32_t* __restrict__ lmax, int64_t C,
                                  float ratio, uint8_t* __restrict__ keep) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const float f = __int2float_rn(count[i]);
  const bool doomed = f < __fmul_rn(ratio, __int2float_rn(rmax[i])) ||
                      f < __fmul_rn(ratio, __int2float_rn(lmax[i]));
  keep[i] = (key[i] != PAD_KEY && !doomed) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
extern "C" {

// layout: SEARCH_LAYOUT_WORDS host words (ops/spectrum.py search_layout);
// scratch: exactly the index's words, or the call is refused.
int shannon_probe_lookup(const void* table, int64_t C, int k, int side_ext, int canonical,
                         void* scratch, int64_t scratch_words, const void* layout, void* idx,
                         void* hit, void* stream) {
  SearchIndex ix;
  if (!search_index_from((const int64_t*)layout, C, scratch_words, &ix)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = search_build((const int64_t*)table, C, ix, scratch_words,
                                 (int64_t*)scratch, (cudaStream_t)stream);
  // the top goes beside the job slots' 30 KB of static shared memory, past
  // the 48 KB a block gets without opting in
  const size_t smem = sizeof(int64_t) * (size_t)ix.top_size;
  unsigned int grid = 0;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute((const void*)probe_lookup_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (err == cudaSuccess) {
    err = search_grid((const void*)probe_lookup_kernel, smem,
                      (C + SEARCH_THREADS - 1) / SEARCH_THREADS, &grid);
  }
  if (err != cudaSuccess) return (int)err;
  probe_lookup_kernel<<<grid, SEARCH_THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)table, (int)C, (const int64_t*)scratch, ix, k, side_ext, canonical,
      (int64_t*)idx, (uint8_t*)hit);
  return (int)cudaGetLastError();
}

int shannon_prune_round(const void* counts, const void* sidx, const void* shit,
                        int64_t C, float ratio, float eps3, int use_cap,
                        void* out, void* changed, void* stream) {
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int32_t), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (C > 0) {
    prune_round_kernel<<<blocks_for(C), THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)counts, (const int64_t*)sidx, (const uint8_t*)shit, C,
        ratio, eps3, use_cap, (int32_t*)out, (int32_t*)changed);
  }
  return (int)cudaGetLastError();
}

int shannon_count_histogram(const void* key, const void* count, int64_t C,
                            int64_t max_count, void* hist, void* stream) {
  if (max_count < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int32_t) * (size_t)(max_count + 1),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (C > 0) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return (int)err;
    const int64_t want = blocks_for(C);
    const unsigned int grid = (unsigned int)(want < 8 * sms ? want : 8 * sms);
    if (max_count <= HIST_KERNEL_MAX_COUNT) {
      count_histogram_kernel<<<grid, THREADS, sizeof(int32_t) * (max_count + 1),
                               (cudaStream_t)stream>>>(
          (const int64_t*)key, (const int32_t*)count, C, (int)max_count, (int32_t*)hist);
    } else {
      count_histogram_global_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const int64_t*)key, (const int32_t*)count, C, max_count, (int32_t*)hist);
    }
  }
  return (int)cudaGetLastError();
}

// scratch: exactly tiles + 1 zeroed words (scan.cuh), tiles = ceil(C /
// SCAN_TILE); any other size means the caller's tile is not SCAN_TILE, and
// the call is refused.
int shannon_compact_keep(const void* key, const void* count, const void* keep, int64_t C,
                         void* scratch, int64_t scratch_words, void* out_key,
                         void* out_count, void* stream) {
  const long long tiles = scan_tiles(C);
  if (scratch_words != tiles + 1) return (int)cudaErrorInvalidValue;
  if (tiles > 0) {
    compact_keep_kernel<<<(unsigned int)tiles, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)key, (const int32_t*)count, (const uint8_t*)keep, C,
        (unsigned long long*)scratch, (int64_t*)out_key, (int32_t*)out_count);
  }
  scan_fill_tail((const unsigned long long*)scratch, tiles, C, (int64_t*)out_key,
                 (int32_t*)out_count, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int shannon_abundance_cut(const void* key, const void* count, int64_t C, int m,
                          void* raw, void* cut, void* keep, void* stream) {
  if (C > 0) {
    abundance_cut_kernel<<<blocks_for(C), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)key, (const int32_t*)count, C, (int32_t)m, (int32_t*)raw,
        (int32_t*)cut, (uint8_t*)keep);
  }
  return (int)cudaGetLastError();
}

int shannon_prune_keep(const void* key, const void* count, const void* rmax,
                       const void* lmax, int64_t C, float ratio, void* keep,
                       void* stream) {
  if (C > 0) {
    prune_keep_kernel<<<blocks_for(C), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)key, (const int32_t*)count, (const int32_t*)rmax,
        (const int32_t*)lmax, C, ratio, (uint8_t*)keep);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
