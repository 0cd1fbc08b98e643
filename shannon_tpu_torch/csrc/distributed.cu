// Owner bucketing of the sharded count: kernel K25 of the shannon_tpu_torch
// port (plain C interface; see kernels.cu for the conventions every entry
// point follows).
//
// Replaces shannon_tpu/parallel/distributed.py:37 _hash_dev and the bucketing
// of :126 _sharded_tail (:133-160).  The reference sorts the shard's local
// spectrum by (owner, hi, lo) with a 4-operand sort and scatters each lane to
// owner * bucket_cap + (its place among its owner's lanes), over buckets
// filled with PAD / 0 first.  The local spectrum is already sorted by key,
// and under the Spectrum contract (ops/count.py) its first n_real = min(n, C)
// lanes are its real keys and every lane past them is PAD: a stable
// partition of those n_real lanes by owner gives the same order inside each
// bucket, and no sort is needed.
//
// Bound: memory.  The function must read the real lanes' keys and counts (12
// bytes a lane: 1.1 MB for shard 0's table of the first 1M-read batch) and
// write every bucket lane once (12 bytes a lane: 100.7 MB for 8 owners x
// 2^20).  The fill of the empty bucket lanes is nearly all of it.
// A tile is OB_TILE lanes, 45 tiles at the main path's 91,692 real lanes.
// Tiles of 1,024 lanes cut the count pass from 5.0 to 3.6 us on an H100, but
// the write pass, at 61 registers a thread against 80, then took 38 us
// against 35 with the same fill grid.
//
// Design: three launches, no memset, no torch.cumsum, no fill before the
// scatter; the outputs are allocated uninitialised.
//  1. owner_tile_counts_kernel: tiles of OB_TILE lanes over [0, n_real) only.
//     A warp takes OB_WARP_LANES consecutive lanes, 64 a round, two a lane
//     (one 16-byte key load); a round's peers of each owner come from
//     log2(D) ballots of the owners' bits (owner_masks), and the first lane
//     of each owner in the round adds the round's count to the tile's bins
//     in shared memory.  Each tile writes its column of a [D, tiles] count
//     matrix.
//  2. owner_offsets_kernel (one block): a warp an owner scans that owner's
//     row in place into each tile's start in the bucket, and writes the
//     owner's total; the block writes the overflow flag (a total above
//     bucket_cap).  A separate launch rather than a last-block-done step of
//     pass 1: that step needs a ticket counter zeroed before every call (a
//     memset, or state that outlives the call), and a one-block launch
//     costs no more device time than the memset would.
//  3. owner_write_kernel: the first `tiles` blocks re-read their tile (the
//     same lanes, L2-resident), rank each lane inside its warp's segment
//     (the ballots of pass 1 plus a running count a warp and owner in
//     shared memory), turn the warps' counts into each warp's start with a
//     scan over the 8 warps and the tile's start, and store each lane at
//     its owner's start plus its stable rank, if below bucket_cap.  The
//     other blocks fill each bucket's lanes from min(total, bucket_cap) to
//     bucket_cap with PAD / 0, four lanes a thread with 16-byte stores, in
//     a grid-stride loop over the flat buckets (a few blocks a bucket row
//     took 48-53 us against this loop's 34-35 on an H100).  Each bucket
//     lane is written exactly once.
// A lane below n_real that holds PAD (which the contract rules out) takes
// owner D, as in the reference, and is neither counted nor placed.

#include "common.cuh"
#include "scan.cuh"

#define MAX_OWNERS 1024
#define OB_MAX_BITS 10  // bits of an owner below MAX_OWNERS
#define OB_WARPS (THREADS / 32)
#define OB_ROUNDS 4                                 // rounds of 64 lanes a warp
#define OB_WARP_LANES (64 * OB_ROUNDS)              // 256
#define OB_TILE (OB_WARPS * OB_WARP_LANES)          // 2,048 lanes
#define OB_OFFSET_THREADS 1024
// Blocks of the fill's grid-stride loop, beside the tile blocks.
#define OB_FILL_BLOCKS 2048

// Owner of a key among n_dev shards: the reference's multiplicative hash of
// the key's (hi, lo) uint32 halves, in uint32 arithmetic; PAD goes to n_dev.
static __device__ __forceinline__ int owner_of(int64_t key, int n_dev) {
  if (key == PAD_KEY) return n_dev;
  const uint32_t hi = (uint32_t)((uint64_t)key >> 32);
  const uint32_t lo = (uint32_t)key;
  uint32_t h = lo * 2654435761u + hi * 0x9E3779B9u;
  h ^= h >> 16;
  return (int)(h % (uint32_t)n_dev);
}

// Lanes i and i + 1 of the table, PAD at or past n_real.  With vec (key
// 16-byte aligned) an even i inside the real lanes is one 16-byte load.
static __device__ __forceinline__ void load_key_pair(const int64_t* __restrict__ key, int64_t i,
                                                     int64_t n_real, int vec, int64_t* a,
                                                     int64_t* b) {
  if (vec && i + 1 < n_real) {
    const longlong2 v = *reinterpret_cast<const longlong2*>(key + i);
    *a = v.x;
    *b = v.y;
  } else {
    *a = i < n_real ? key[i] : PAD_KEY;
    *b = i + 1 < n_real ? key[i + 1] : PAD_KEY;
  }
}

// One round of a warp: lane l holds items a (lane 2l of the round) and b
// (lane 2l + 1), with owners oa and ob, valid where va / vb.  For each item:
// its rank among the round's earlier items of its owner (a before b in each
// lane, lanes in order), and the round's count of that owner.  The masks of
// the lanes whose item a (item b) has owner o are the AND over o's bits of
// the warp's ballots of that bit or their complements.
struct OwnerRound {
  int rank_a, rank_b, total_a, total_b;
};

static __device__ __forceinline__ unsigned owner_masks(const unsigned* bits, unsigned valid, int o,
                                                       int nbits) {
  unsigned m = valid;
#pragma unroll
  for (int b = 0; b < OB_MAX_BITS; ++b) {
    if (b < nbits) m &= ((o >> b) & 1) ? bits[b] : ~bits[b];
  }
  return m;
}

static __device__ __forceinline__ OwnerRound owner_round(int oa, int ob, bool va, bool vb,
                                                         int nbits) {
  unsigned ba[OB_MAX_BITS], bb[OB_MAX_BITS];
#pragma unroll
  for (int b = 0; b < OB_MAX_BITS; ++b) {
    if (b < nbits) {
      ba[b] = __ballot_sync(0xffffffffu, (oa >> b) & 1);
      bb[b] = __ballot_sync(0xffffffffu, (ob >> b) & 1);
    }
  }
  const unsigned vma = __ballot_sync(0xffffffffu, va), vmb = __ballot_sync(0xffffffffu, vb);
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u, le = lt | (1u << lane);
  const unsigned aa = owner_masks(ba, vma, oa, nbits), ab = owner_masks(bb, vmb, oa, nbits);
  const unsigned ba_ = owner_masks(ba, vma, ob, nbits), bb_ = owner_masks(bb, vmb, ob, nbits);
  OwnerRound r;
  r.rank_a = __popc(aa & lt) + __popc(ab & lt);
  r.total_a = __popc(aa) + __popc(ab);
  r.rank_b = __popc(ba_ & le) + __popc(bb_ & lt);
  r.total_b = __popc(ba_) + __popc(bb_);
  return r;
}

// counts[d * gridDim.x + t] = real lanes of tile t owned by d.
__global__ void __launch_bounds__(THREADS)
    owner_tile_counts_kernel(const int64_t* __restrict__ key, int64_t n_real, int n_dev,
                             int nbits, int vec, int32_t* __restrict__ counts) {
  extern __shared__ int32_t bins[];  // n_dev
  for (int d = threadIdx.x; d < n_dev; d += blockDim.x) bins[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t seg = (int64_t)blockIdx.x * OB_TILE + warp * OB_WARP_LANES;
  int64_t ka[OB_ROUNDS], kb[OB_ROUNDS];
#pragma unroll
  for (int r = 0; r < OB_ROUNDS; ++r) {  // every load in flight before the first vote
    load_key_pair(key, seg + 64 * r + 2 * lane, n_real, vec, &ka[r], &kb[r]);
  }
#pragma unroll
  for (int r = 0; r < OB_ROUNDS; ++r) {
    const int oa = owner_of(ka[r], n_dev), ob = owner_of(kb[r], n_dev);
    const bool va = oa < n_dev, vb = ob < n_dev;
    const OwnerRound q = owner_round(oa, ob, va, vb, nbits);
    if (va && q.rank_a == 0) atomicAdd(&bins[oa], q.total_a);
    if (vb && q.rank_b == 0) atomicAdd(&bins[ob], q.total_b);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n_dev; d += blockDim.x) {
    counts[(int64_t)d * gridDim.x + blockIdx.x] = bins[d];
  }
}

// In place: each owner's row of counts [n_dev, tiles] becomes each tile's
// start in the owner's bucket (an exclusive scan, a warp an owner);
// totals[d] = owner d's real lanes; flag[0] = true where a total is above
// bucket_cap, else false.
__global__ void __launch_bounds__(OB_OFFSET_THREADS)
    owner_offsets_kernel(int32_t* __restrict__ counts, int64_t tiles, int n_dev,
                         int64_t bucket_cap, int32_t* __restrict__ totals,
                         bool* __restrict__ flag) {
  __shared__ int s_over;
  if (threadIdx.x == 0) s_over = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = warp; d < n_dev; d += OB_OFFSET_THREADS / 32) {
    int32_t* row = counts + (int64_t)d * tiles;
    int32_t run = 0;
    for (int64_t c = 0; c < tiles; c += 32) {
      const int64_t t = c + lane;
      const int32_t v = t < tiles ? row[t] : 0;
      const int32_t inc = warp_inclusive_scan(v);
      if (t < tiles) row[t] = run + inc - v;
      run += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) {
      totals[d] = run;
      if (run > bucket_cap) s_over = 1;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) flag[0] = s_over != 0;
}

// Blocks [0, tiles): place the tile's real lanes.  Blocks from tiles on:
// fill each bucket's lanes [min(total, bucket_cap), bucket_cap) with PAD /
// 0, a grid-stride loop over groups of 4 lanes of the flat [n_dev *
// bucket_cap] buckets, 16-byte stores where the outputs are aligned
// (vec_out).  starts: owner_offsets_kernel's [n_dev, tiles] starts;
// totals: its [n_dev] totals.
__global__ void __launch_bounds__(THREADS)
    owner_write_kernel(const int64_t* __restrict__ key, const int32_t* __restrict__ count,
                       int64_t n_real, int n_dev, int nbits, int vec, int64_t tiles,
                       int64_t bucket_cap, const int32_t* __restrict__ starts,
                       const int32_t* __restrict__ totals, int vec_out,
                       int64_t* __restrict__ out_key, int32_t* __restrict__ out_count) {
  if (blockIdx.x >= tiles) {
    // the fill: 4 lanes a thread of the flat [n_dev * bucket_cap] buckets
    const int64_t lanes = (int64_t)n_dev * bucket_cap, groups = (lanes + 3) / 4;
    const int64_t stride = (int64_t)(gridDim.x - tiles) * blockDim.x;
    for (int64_t g = (int64_t)(blockIdx.x - tiles) * blockDim.x + threadIdx.x; g < groups;
         g += stride) {
      const int64_t a = 4 * g;
      int64_t d = a / bucket_cap, w = a - d * bucket_cap;
      bool fill[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j > 0 && ++w == bucket_cap) {
          ++d;
          w = 0;
        }
        // a bucket's lanes end at min(total, bucket_cap); w < bucket_cap
        fill[j] = a + j < lanes && w >= (int64_t)__ldg(totals + d);
      }
      if (vec_out && fill[0] && fill[1] && fill[2] && fill[3]) {
        const longlong2 pad = make_longlong2(PAD_KEY, PAD_KEY);
        *reinterpret_cast<longlong2*>(out_key + a) = pad;
        *reinterpret_cast<longlong2*>(out_key + a + 2) = pad;
        *reinterpret_cast<int4*>(out_count + a) = make_int4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (fill[j]) {
            out_key[a + j] = PAD_KEY;
            out_count[a + j] = 0;
          }
        }
      }
    }
    return;
  }
  extern __shared__ int32_t run[];  // [OB_WARPS][n_dev]: counts, then starts
  for (int x = threadIdx.x; x < OB_WARPS * n_dev; x += blockDim.x) run[x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* mine = run + warp * n_dev;
  const int64_t seg = (int64_t)blockIdx.x * OB_TILE + warp * OB_WARP_LANES;
  int64_t k[2 * OB_ROUNDS];
  int32_t c[2 * OB_ROUNDS], o[2 * OB_ROUNDS], rank[2 * OB_ROUNDS];
#pragma unroll
  for (int r = 0; r < OB_ROUNDS; ++r) {  // every load in flight before the first vote
    const int64_t i = seg + 64 * r + 2 * lane;
    load_key_pair(key, i, n_real, vec, &k[2 * r], &k[2 * r + 1]);
    if (vec && i + 1 < n_real) {
      const int2 v = *reinterpret_cast<const int2*>(count + i);
      c[2 * r] = v.x;
      c[2 * r + 1] = v.y;
    } else {
      c[2 * r] = i < n_real ? count[i] : 0;
      c[2 * r + 1] = i + 1 < n_real ? count[i + 1] : 0;
    }
  }
#pragma unroll
  for (int r = 0; r < OB_ROUNDS; ++r) {
    const int oa = owner_of(k[2 * r], n_dev), ob = owner_of(k[2 * r + 1], n_dev);
    const bool va = oa < n_dev, vb = ob < n_dev;
    const OwnerRound q = owner_round(oa, ob, va, vb, nbits);
    const int32_t base_a = va ? mine[oa] : 0, base_b = vb ? mine[ob] : 0;
    __syncwarp();
    if (va && q.rank_a == 0) mine[oa] += q.total_a;
    if (vb && q.rank_b == 0) mine[ob] += q.total_b;
    __syncwarp();
    o[2 * r] = oa;
    o[2 * r + 1] = ob;
    rank[2 * r] = va ? base_a + q.rank_a : -1;
    rank[2 * r + 1] = vb ? base_b + q.rank_b : -1;
  }
  __syncthreads();
  // each warp's start for each owner: the tile's start plus the earlier
  // warps' counts
  for (int d = threadIdx.x; d < n_dev; d += blockDim.x) {
    int32_t s = starts[(int64_t)d * tiles + blockIdx.x];
#pragma unroll
    for (int w = 0; w < OB_WARPS; ++w) {
      const int32_t x = run[w * n_dev + d];
      run[w * n_dev + d] = s;
      s += x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2 * OB_ROUNDS; ++j) {
    if (rank[j] >= 0) {
      const int64_t place = (int64_t)mine[o[j]] + rank[j];
      if (place < bucket_cap) {
        const int64_t at = (int64_t)o[j] * bucket_cap + place;
        out_key[at] = k[j];
        out_count[at] = c[j];
      }
    }
  }
}

// The int32 words of scratch K25 takes for n_real real lanes and n_dev
// owners: the [n_dev, tiles] counts (then starts), then n_dev totals.
static inline int64_t owner_scratch_words(int64_t n_real, int64_t n_dev) {
  return n_dev * ((n_real + OB_TILE - 1) / OB_TILE) + n_dev;
}

extern "C" {

// key, count: the table, sorted, its real lanes [0, n_real) first; scratch:
// owner_scratch_words(n_real, n_dev) int32 words, any contents; any other
// size means the caller's tile is not OB_TILE, and the call is refused.
// out_key, out_count: [n_dev, bucket_cap], any contents; overflow: one
// bool, any contents, the overflow flag after the call.
int shannon_owner_buckets(const void* key, const void* count, int64_t n_real, int n_dev,
                          int64_t bucket_cap, void* scratch, int64_t scratch_words,
                          void* out_key, void* out_count, void* overflow, void* stream) {
  if (n_dev < 1 || n_dev > MAX_OWNERS || bucket_cap < 1 || n_real < 0 ||
      n_real >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (scratch_words != owner_scratch_words(n_real, n_dev)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t tiles = (n_real + OB_TILE - 1) / OB_TILE;
  int32_t* counts = (int32_t*)scratch;
  int32_t* totals = counts + n_dev * tiles;
  const int nbits = n_dev > 1 ? 32 - __builtin_clz((unsigned)(n_dev - 1)) : 0;
  const int vec = ((uintptr_t)key & 15) == 0 && ((uintptr_t)count & 7) == 0;
  const int vec_out = ((uintptr_t)out_key & 15) == 0 && ((uintptr_t)out_count & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (tiles > 0) {
    owner_tile_counts_kernel<<<(unsigned int)tiles, THREADS, n_dev * sizeof(int32_t), s>>>(
        (const int64_t*)key, n_real, n_dev, nbits, vec, counts);
  }
  owner_offsets_kernel<<<1, OB_OFFSET_THREADS, 0, s>>>(counts, tiles, n_dev, bucket_cap, totals,
                                                        (bool*)overflow);
  // fill blocks a bucket: enough for a group of 4 lanes a thread, at most
  // about OB_FILL_BLOCKS in all
  const int64_t groups = ((int64_t)n_dev * bucket_cap + 3) / 4;
  const int64_t want = (groups + THREADS - 1) / THREADS;
  const int64_t fill = want < OB_FILL_BLOCKS ? want : OB_FILL_BLOCKS;
  owner_write_kernel<<<(unsigned int)(tiles + fill), THREADS,
                       OB_WARPS * n_dev * sizeof(int32_t), s>>>(
      (const int64_t*)key, (const int32_t*)count, n_real, n_dev, nbits, vec, tiles, bucket_cap,
      counts, totals, vec_out, (int64_t*)out_key, (int32_t*)out_count);
  return (int)cudaGetLastError();
}

}  // extern "C"
