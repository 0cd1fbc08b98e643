// Error-correction kernels K7, K9, K10, K16, K20 (with the abundance filter
// on K10's tile) and K23 (the sibling-prune filter, on K10's tile too) of the
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
#include "probe.cuh"
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
// through the same nodes; each answer goes back to its slot.  The group
// rule and the steps (probe_group, probe_route, step_up, step_down) are in
// probe.cuh, shared with K22 and K28.
// ---------------------------------------------------------------------------
#define PROBE_JOBS 10
#define PROBE_HIT (1ll << 62)  // beside a lower bound (<= C < 2^62)

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
// K9: the sibling-prune loop.
// Replaces shannon_tpu/ops/correction.py:184 _prune_chunk: up to `rounds`
// Jacobi rounds (the loop body, lines 205-217), stopping after the first
// round that prunes nothing.  A lane with count c > 0 takes the largest
// sibling count where hit on the right rows (0, 2, 4, 6) and on the left rows
// (1, 3, 5, 7) and is pruned when, on either side, f32(c) < ratio * f32(max)
// and, when use_cap, f32(c) <= error_cap(f32(max)).  ratio and eps3 arrive
// as the float32 values the plain version uses.
// Why one round is the whole loop.  A round only sets counts to 0, so from
// round to round every count, and with it every side's sibling maximum M,
// can only fall.  With ratio >= 0 and eps3 >= 0 both halves of the test grow
// with M: ratio * f32(M) and every step of error_cap (a product, a correctly
// rounded square root, sums, a max) are round-to-nearest operations, which
// are monotone, and f32 of an integer is too.  A lane that survives round t
// keeps its count, and its maxima in round t + 1 are no larger, so no side
// that failed the test in round t passes it in round t + 1: every round
// after the first prunes nothing.  So the loop's counts are round 1's, and
// its last changed flag is round 1's when rounds == 1 and false for any
// rounds >= 2 (round 2 runs and finds nothing).  The wrapper refuses
// rounds >= 2 with a negative ratio or eps3, where the argument fails.
// Design.  One launch computes round 1: it reads the input counts and writes
// a new buffer.  A grid of as many blocks as the card holds at once strides
// over the lanes; each thread counts its pruned lanes in registers and a
// warp adds them once, after its last lane, to one counter that the wrapper
// reads only for rounds == 1 or when asked for the rounds' counts (no word
// every pruned lane stores to).  So the main path's loop is one launch and
// no host read.
// Bound: memory.  Lanes with count 0 copy through without touching the probe
// rows; the others read 8 hit bytes and gather the counts of their hits.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) prune_round_kernel(
    const int32_t* __restrict__ counts, const int64_t* __restrict__ sidx,
    const uint8_t* __restrict__ shit, int64_t C, float ratio, float eps3, int use_cap,
    int32_t* __restrict__ out, unsigned long long* __restrict__ pruned) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned n = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < C; i += stride) {
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
    n += doomed ? 1u : 0u;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(0xffffffffu, n, d);
  if ((threadIdx.x & 31) == 0 && n != 0) atomicAdd(pruned, (unsigned long long)n);
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

#define COMPACT_GATHER 4

// One tile of a compaction: bits_of(first) gives the keep bits of the
// thread's SCAN_ITEMS lanes from tile lane `first` on; the kept lanes' keys
// and counts go out in order from the tile's prefix.  K10 takes its bits from
// a keep array, the fused abundance filter (K20) from the counts, the
// sibling-prune filter (K23) from the counts and both sibling maxima.
template <typename BitsOf>
static __device__ __forceinline__ void compact_tile(const int64_t* __restrict__ key,
                                                    const int32_t* __restrict__ count,
                                                    unsigned long long* __restrict__ scratch,
                                                    int64_t* __restrict__ out_key,
                                                    int32_t* __restrict__ out_count,
                                                    BitsOf bits_of) {
  __shared__ ScanShared sh;
  __shared__ unsigned s_warp[SCAN_WARPS];
  __shared__ uint16_t s_lane[SCAN_TILE];  // tile offsets of the kept lanes, in order
  unsigned long long* status = scratch + 1;
  const long long tile = scan_ticket(scratch, &sh);
  const int64_t base = (int64_t)tile * SCAN_TILE;
  const int first = threadIdx.x * SCAN_ITEMS;
  unsigned bits = bits_of(base + first);
  unsigned kept;
  unsigned r = block_exclusive_scan((unsigned)__popc(bits), s_warp, &kept);
  scan_publish_aggregate(status, tile, kept);
  scan_record_lanes(bits, first, r, s_lane);
  const int64_t prefix = (int64_t)scan_tile_prefix(status, tile, kept, &sh);
  // COMPACT_GATHER kept lanes a thread gathered before any is stored, so
  // their loads are in flight together: one at a time, a thread waited out
  // an L2 round trip for each of its up to 16 lanes, and K23's tile took
  // 9.2-9.8 us on an H100 against 6.9-7.8 (the first gathers issued during
  // the look-back, behind one more barrier, saved only 0.3 us more)
  for (unsigned q0 = threadIdx.x; q0 < kept; q0 += COMPACT_GATHER * SCAN_THREADS) {
    int64_t k[COMPACT_GATHER];
    int32_t c[COMPACT_GATHER];
#pragma unroll
    for (int u = 0; u < COMPACT_GATHER; ++u) {
      const unsigned q = q0 + u * SCAN_THREADS;
      if (q < kept) {
        const int64_t i = base + s_lane[q];
        k[u] = key[i];
        c[u] = count[i];
      }
    }
#pragma unroll
    for (int u = 0; u < COMPACT_GATHER; ++u) {
      const unsigned q = q0 + u * SCAN_THREADS;
      if (q < kept) {
        out_key[prefix + q] = k[u];
        out_count[prefix + q] = c[u];
      }
    }
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
    compact_keep_kernel(const int64_t* __restrict__ key, const int32_t* __restrict__ count,
                        const uint8_t* __restrict__ keep, int64_t C,
                        unsigned long long* __restrict__ scratch,
                        int64_t* __restrict__ out_key, int32_t* __restrict__ out_count) {
  compact_tile(key, count, scratch, out_key, out_count,
               [&](int64_t first) { return keep_bits(keep, first, C); });
}

// ---------------------------------------------------------------------------
// K16: histogram of entry counts (the auto abundance cut's input).
// Replaces shannon_tpu/ops/correction.py:32 count_histogram, which sorted the
// clamped counts and found max_count + 2 bin boundaries by searchsorted to keep
// a contended scatter off the TPU.  h[c] counts the real lanes with
// clamp(count, 0, max_count) == c; counts <= 0 fall in bin 0, which is never
// counted, so h[0] stays 0.
// Reads only count[0, n), n = min(spectrum n, C), and no key: under the
// Spectrum contract (ops/count.py) those are the real lanes, and every lane
// past them is PAD with count 0, which bin 0 would take.
// Bound: memory, 4 bytes a real lane.
// Design.
//  - Loads: a grid of HIST_BLOCKS_PER_SM blocks an SM strides over the
//    counts 16 bytes a load, two loads in flight a thread (a scalar head
//    and tail where the view is not 16-byte aligned).
//  - Bins: most real lanes hold count 1 (8.26M of 10.69M at 1M reads), so
//    bins 1-4 are counters in each thread's registers, summed by warp
//    reductions into the block's bins once at the end; bins 5 to
//    HIST_SMEM_BINS - 1 are a private histogram a block in shared memory;
//    higher bins (max_count >= HIST_SMEM_BINS; rare lanes: 1,241 nonzero
//    bins at max_count 65,536) take a global atomic each.  One design for
//    every max_count.
//  - Zeroing: the entry point's memset, a 1 us launch.  Zeroing in the
//    kernel's own launch (the first block to start zeroes, the others wait
//    on a flag before their first global atomic) took the same device time
//    on an H100 (memset 1.0 + kernel 19.6 us against 20.4-20.7 at max_count
//    1,024) and needs a state that outlives the call, so it is not kept.
// ---------------------------------------------------------------------------
#define HIST_THREADS 1024
#define HIST_BLOCKS_PER_SM 2
// Bins a block counts in shared memory (32 KB), and bins a thread counts in
// registers (1 to HIST_REG_BINS).
#define HIST_SMEM_BINS 8192
#define HIST_REG_BINS 4

__global__ void __launch_bounds__(HIST_THREADS, HIST_BLOCKS_PER_SM)
    count_histogram_kernel(const int32_t* __restrict__ count, int64_t n, int64_t max_count,
                           int smem_bins, int32_t* __restrict__ hist) {
  extern __shared__ int32_t bins[];
  for (int b = threadIdx.x; b < smem_bins; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  // counts above INT32_MAX never clamp
  const int top = max_count < INT32_MAX ? (int)max_count : INT32_MAX;
  unsigned r1 = 0, r2 = 0, r3 = 0, r4 = 0;
  auto add = [&](int32_t v) {
    const int b = v < 1 ? 0 : (v > top ? top : v);
    r1 += b == 1;
    r2 += b == 2;
    r3 += b == 3;
    r4 += b == 4;
    if (b > HIST_REG_BINS) {
      atomicAdd(b < smem_bins ? &bins[b] : &hist[b], 1);
    }
  };
  // count is 4-byte aligned: the lanes before its first 16-byte boundary
  const int64_t head_lanes = (int64_t)(((16 - ((uintptr_t)count & 15)) & 15) >> 2);
  const int64_t head = head_lanes < n ? head_lanes : n;
  const int64_t n4 = (n - head) >> 2, tail = head + 4 * n4;
  const int4* __restrict__ vec = (const int4*)(count + head);
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t j = t;
  for (; j + stride < n4; j += 2 * stride) {  // two loads in flight a thread
    const int4 x = __ldcs(vec + j), y = __ldcs(vec + j + stride);
    add(x.x);
    add(x.y);
    add(x.z);
    add(x.w);
    add(y.x);
    add(y.y);
    add(y.z);
    add(y.w);
  }
  if (j < n4) {
    const int4 x = __ldcs(vec + j);
    add(x.x);
    add(x.y);
    add(x.z);
    add(x.w);
  }
  if (t < head) add(count[t]);
  if (t < n - tail) add(count[tail + t]);
  // the registers' bins: a warp's sums, one shared atomic each
  r1 = __reduce_add_sync(0xffffffffu, r1);
  r2 = __reduce_add_sync(0xffffffffu, r2);
  r3 = __reduce_add_sync(0xffffffffu, r3);
  r4 = __reduce_add_sync(0xffffffffu, r4);
  if ((threadIdx.x & 31) == 0) {  // a nonzero sum's bin is <= max_count < smem_bins
    if (r1) atomicAdd(&bins[1], (int)r1);
    if (r2) atomicAdd(&bins[2], (int)r2);
    if (r3) atomicAdd(&bins[3], (int)r3);
    if (r4) atomicAdd(&bins[4], (int)r4);
  }
  __syncthreads();
  for (int b = threadIdx.x + 1; b < smem_bins; b += blockDim.x) {
    if (bins[b] != 0) atomicAdd(&hist[b], bins[b]);
  }
}

// ---------------------------------------------------------------------------
// K20: the abundance cut, and the abundance filter on it.
// Replaces shannon_tpu/ops/correction.py:134 _cut_counts and the keep mask of
// :54 abundance_filter, given the cut m.  Under the Spectrum contract
// (ops/count.py) the first n_real = min(n, C) lanes are the real ones and
// every lane past them is PAD with count 0, so neither kernel reads a key.
//
// abundance_cut_kernel writes whichever outputs the caller passes non-null:
//   raw  = i < n_real ? count : 0        (int32)
//   cut  = raw < m ? 0 : raw             (int32)
// Bound: memory, the real lanes' counts in (4 bytes a lane) and every lane's
// outputs out (up to 8 bytes).  A block takes CUT_TILE lanes, a thread
// CUT_LANES of them: four 16-byte count loads (none past n_real) and four
// 16-byte stores of each output, a warp's accesses on 512 contiguous bytes.
// Lanes past n_real are written in the same launch.  A view that is not
// 16-byte aligned and the table's last partial block take one lane at a
// time.  The keep flags of the reference's abundance_filter (count >= m on
// a real lane; with m <= 0 a real lane of count 0 is kept) have no kernel of
// their own: the filter below tests them in its tiles, and torch.ge(count,
// m) gives them where m >= 1 (a keep mode here lost to it, 0.0433 against
// 0.0170 ms on an H100).
//
// abundance_filter (filter_count_kernel, then scan_fill_tail): K10's
// compaction tile with its keep bits taken from count >= m over the real
// lanes (tiles over [0, n_real) alone), so no keep array is written or read
// and no K20 pass runs before it.  Bound: memory, the real lanes' counts in,
// the kept lanes' keys and counts gathered, every output lane written once.
// ---------------------------------------------------------------------------
#define CUT_LANES 16
#define CUT_TILE (THREADS * CUT_LANES)  // 4,096 lanes a block

__global__ void __launch_bounds__(THREADS)
    abundance_cut_kernel(const int32_t* __restrict__ count, int64_t n_real, int64_t C,
                         int32_t m, int vec, int32_t* __restrict__ raw,
                         int32_t* __restrict__ cut) {
  const int64_t base = (int64_t)blockIdx.x * CUT_TILE;
  if (vec && base + CUT_TILE <= C) {
    // striped: quad q of thread t is lanes base + 4 (q THREADS + t), so each
    // warp's load and stores cover 512 contiguous bytes (whole sectors: a
    // thread's own 64 contiguous bytes would leave each store of a warp half
    // a sector)
#pragma unroll
    for (int q = 0; q < CUT_LANES / 4; ++q) {
      const int64_t i = base + 4 * (q * THREADS + threadIdx.x);
      int c[4] = {0, 0, 0, 0};
      if (i < n_real) {
        const int4 v = *reinterpret_cast<const int4*>(count + i);
        c[0] = v.x;
        c[1] = i + 1 < n_real ? v.y : 0;
        c[2] = i + 2 < n_real ? v.z : 0;
        c[3] = i + 3 < n_real ? v.w : 0;
      }
      if (raw) *reinterpret_cast<int4*>(raw + i) = make_int4(c[0], c[1], c[2], c[3]);
      if (cut) {
        *reinterpret_cast<int4*>(cut + i) =
            make_int4(c[0] < m ? 0 : c[0], c[1] < m ? 0 : c[1], c[2] < m ? 0 : c[2],
                      c[3] < m ? 0 : c[3]);
      }
    }
    return;
  }
  // an unaligned view, or the table's last partial block: lane by lane
  for (int64_t i = base + threadIdx.x; i < base + CUT_TILE && i < C; i += THREADS) {
    const int32_t r = i < n_real ? count[i] : 0;
    if (raw) raw[i] = r;
    if (cut) cut[i] = r < m ? 0 : r;
  }
}

// Bit j of the result is lane first + j's test count >= m (lanes at or past
// n_real read 0).
static __device__ __forceinline__ unsigned count_bits(const int32_t* __restrict__ count,
                                                      int64_t first, int64_t n_real, int32_t m) {
  unsigned bits = 0;
  if (first + SCAN_ITEMS <= n_real && ((uintptr_t)(count + first) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS / 4; ++q) {
      const int4 v = reinterpret_cast<const int4*>(count + first)[q];
      bits |= ((unsigned)(v.x >= m) | (unsigned)(v.y >= m) << 1 | (unsigned)(v.z >= m) << 2 |
               (unsigned)(v.w >= m) << 3) << (4 * q);
    }
  } else {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      if (first + j < n_real && count[first + j] >= m) bits |= 1u << j;
    }
  }
  return bits;
}

__global__ void __launch_bounds__(SCAN_THREADS)
    filter_count_kernel(const int64_t* __restrict__ key, const int32_t* __restrict__ count,
                        int64_t n_real, int32_t m, unsigned long long* __restrict__ scratch,
                        int64_t* __restrict__ out_key, int32_t* __restrict__ out_count) {
  compact_tile(key, count, scratch, out_key, out_count,
               [&](int64_t first) { return count_bits(count, first, n_real, m); });
}

// ---------------------------------------------------------------------------
// K23: one sibling-prune round's decision and compaction.
// Replaces shannon_tpu/ops/correction.py:61 sibling_prune_round after its
// sibling maxima (K22): the decision (lines 68-74) and the compaction of the
// kept lanes.  A lane is kept iff it is real and neither f < ratio * R nor
// f < ratio * L, with f, R, L the float32 values of its count and of its
// right and left sibling maxima.  Unlike K9 there is no count > 0 guard and
// no error cap: a real lane of count 0 beside a positive sibling is dropped,
// as in the reference, and at ratio 0 every real lane is kept.  Each product
// is __fmul_rn, so nvcc cannot contract it; ratio arrives as the float32
// value prune_constants rounds once.
// Reads only lanes [0, n_real), n_real = min(spectrum n, C), and no key for
// the decision: under the Spectrum contract (ops/count.py) those are the
// real lanes, and every lane past them is PAD, which no round keeps.  K22
// gives the maxima of those lanes alone (the round's wrapper sizes its
// outputs to n_real, so it writes no zeros past them).
// Bound: memory, the real lanes' counts and maxima in (12 bytes a lane), the
// kept lanes' keys gathered (8) and every output lane written once (12, the
// PAD / 0 tail included): about 30 MB on the flagship table, 9 us at 3.35
// TB/s.
// Design.  prune_filter_kernel is K10's compaction tile (compact_tile) over
// [0, n_real) alone, its keep bits the decision: 16-byte loads of count,
// rmax and lmax where a thread's 16 lanes are below n_real and all three are
// aligned, lane by lane elsewhere.  Then scan_fill_tail writes PAD / 0 from
// the kept count on.  No keep array is written or read and no K10 pass runs,
// as in the abundance filter (K20).
// ---------------------------------------------------------------------------
static __device__ __forceinline__ bool prune_kept(int32_t c, int32_t r, int32_t l, float ratio) {
  const float f = __int2float_rn(c);
  return !(f < __fmul_rn(ratio, __int2float_rn(r)) || f < __fmul_rn(ratio, __int2float_rn(l)));
}

// Bit j of the result is lane first + j's keep decision (lanes at or past
// n_real read 0).
static __device__ __forceinline__ unsigned prune_bits(const int32_t* __restrict__ count,
                                                      const int32_t* __restrict__ rmax,
                                                      const int32_t* __restrict__ lmax,
                                                      int64_t first, int64_t n_real,
                                                      float ratio) {
  unsigned bits = 0;
  const uintptr_t at =
      (uintptr_t)(count + first) | (uintptr_t)(rmax + first) | (uintptr_t)(lmax + first);
  if (first + SCAN_ITEMS <= n_real && (at & 15) == 0) {
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS / 4; ++q) {
      const int4 c = reinterpret_cast<const int4*>(count + first)[q];
      const int4 r = reinterpret_cast<const int4*>(rmax + first)[q];
      const int4 l = reinterpret_cast<const int4*>(lmax + first)[q];
      bits |= ((unsigned)prune_kept(c.x, r.x, l.x, ratio) |
               (unsigned)prune_kept(c.y, r.y, l.y, ratio) << 1 |
               (unsigned)prune_kept(c.z, r.z, l.z, ratio) << 2 |
               (unsigned)prune_kept(c.w, r.w, l.w, ratio) << 3)
              << (4 * q);
    }
  } else {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int64_t i = first + j;
      if (i < n_real && prune_kept(count[i], rmax[i], lmax[i], ratio)) bits |= 1u << j;
    }
  }
  return bits;
}

__global__ void __launch_bounds__(SCAN_THREADS)
    prune_filter_kernel(const int64_t* __restrict__ key, const int32_t* __restrict__ count,
                        const int32_t* __restrict__ rmax, const int32_t* __restrict__ lmax,
                        int64_t n_real, float ratio, unsigned long long* __restrict__ scratch,
                        int64_t* __restrict__ out_key, int32_t* __restrict__ out_count) {
  compact_tile(key, count, scratch, out_key, out_count, [&](int64_t first) {
    return prune_bits(count, rmax, lmax, first, n_real, ratio);
  });
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

// pruned: one uint64 word, zeroed here, that the round's pruned lanes are
// added to.
int shannon_prune_round(const void* counts, const void* sidx, const void* shit,
                        int64_t C, float ratio, float eps3, int use_cap,
                        void* out, void* pruned, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(pruned, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess || C == 0) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prune_round_kernel, THREADS, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t resident = (int64_t)sms * per_sm;
  const int64_t grid = blocks_for(C) < resident ? blocks_for(C) : resident;
  prune_round_kernel<<<(unsigned int)(grid > 0 ? grid : 1), THREADS, 0, s>>>(
      (const int32_t*)counts, (const int64_t*)sidx, (const uint8_t*)shit, C, ratio, eps3,
      use_cap, (int32_t*)out, (unsigned long long*)pruned);
  return (int)cudaGetLastError();
}

// count: the real lanes' counts, count[0, n); hist: max_count + 1 words;
// sms: the card's SM count.
int shannon_count_histogram(const void* count, int64_t n, int64_t max_count, int sms, void* hist,
                            void* stream) {
  if (max_count < 0 || n < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int32_t) * (size_t)(max_count + 1),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int smem_bins = max_count < HIST_SMEM_BINS ? (int)max_count + 1 : HIST_SMEM_BINS;
  const int64_t want = (n / 4 + HIST_THREADS - 1) / HIST_THREADS;
  const int64_t full = (int64_t)sms * HIST_BLOCKS_PER_SM;
  const unsigned int grid = (unsigned int)(want < 1 ? 1 : (want < full ? want : full));
  count_histogram_kernel<<<grid, HIST_THREADS, sizeof(int32_t) * smem_bins,
                           (cudaStream_t)stream>>>((const int32_t*)count, n, max_count,
                                                   smem_bins, (int32_t*)hist);
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

// count: the table's counts, its real lanes [0, n_real) first; raw, cut: C
// lanes each, or null.
int shannon_abundance_cut(const void* count, int64_t n_real, int64_t C, int m, void* raw,
                          void* cut, void* stream) {
  if (n_real < 0 || n_real > C) return (int)cudaErrorInvalidValue;
  const int vec = ((uintptr_t)count & 15) == 0 && ((uintptr_t)raw & 15) == 0 &&
                  ((uintptr_t)cut & 15) == 0;
  const int64_t blocks = (C + CUT_TILE - 1) / CUT_TILE;
  if (blocks > 0 && (raw || cut)) {
    abundance_cut_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)count, n_real, C, (int32_t)m, vec, (int32_t*)raw, (int32_t*)cut);
  }
  return (int)cudaGetLastError();
}

// The abundance filter: the real lanes [0, n_real) of count >= m compacted
// into out_key / out_count (C lanes, PAD / 0 past them).  scratch: exactly
// scan_tiles(n_real) + 1 zeroed words (scan.cuh); any other size is refused.
int shannon_abundance_filter(const void* key, const void* count, int64_t n_real, int64_t C,
                             int m, void* scratch, int64_t scratch_words, void* out_key,
                             void* out_count, void* stream) {
  if (n_real < 0 || n_real > C) return (int)cudaErrorInvalidValue;
  const long long tiles = scan_tiles(n_real);
  if (scratch_words != tiles + 1) return (int)cudaErrorInvalidValue;
  if (tiles > 0) {
    filter_count_kernel<<<(unsigned int)tiles, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)key, (const int32_t*)count, n_real, (int32_t)m,
        (unsigned long long*)scratch, (int64_t*)out_key, (int32_t*)out_count);
  }
  scan_fill_tail((const unsigned long long*)scratch, tiles, C, (int64_t*)out_key,
                 (int32_t*)out_count, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// One sibling-prune round's filter: the real lanes [0, n_real) that K23's
// decision keeps, given their sibling maxima rmax[0, n_real) and lmax[0,
// n_real), compacted into out_key / out_count (C lanes, PAD / 0 past them).
// scratch: exactly scan_tiles(n_real) + 1 zeroed words (scan.cuh); any other
// size is refused.
int shannon_prune_filter(const void* key, const void* count, const void* rmax,
                         const void* lmax, int64_t n_real, int64_t C, float ratio,
                         void* scratch, int64_t scratch_words, void* out_key, void* out_count,
                         void* stream) {
  if (n_real < 0 || n_real > C) return (int)cudaErrorInvalidValue;
  const long long tiles = scan_tiles(n_real);
  if (scratch_words != tiles + 1) return (int)cudaErrorInvalidValue;
  if (tiles > 0) {
    prune_filter_kernel<<<(unsigned int)tiles, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)key, (const int32_t*)count, (const int32_t*)rmax,
        (const int32_t*)lmax, n_real, ratio, (unsigned long long*)scratch, (int64_t*)out_key,
        (int32_t*)out_count);
  }
  scan_fill_tail((const unsigned long long*)scratch, tiles, C, (int64_t*)out_key,
                 (int32_t*)out_count, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
