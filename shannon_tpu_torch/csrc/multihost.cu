// Evidence-ownership pack and unpack of the multi-process back half: kernels
// K26 and K27 of the shannon_tpu_torch port (plain C interface; see
// kernels.cu for the conventions every entry point follows).
//
// Replace the host pack (:153-209) and unpack (:227-248) of
// shannon_tpu/parallel/multihost.py:115 route_evidence_ownership, around its
// device all_to_all (:211-225), which becomes
// torch.distributed.all_to_all_single.  Each path of a rank's evidence (flat
// node ids, row offsets, weights) goes to the rank that owns its head node's
// component.  Row p of the [H, cap] int32 send buffer is the bucket bound for
// rank p: [n_paths, n_flat, lens..., weights..., flat...] of its paths in
// source-local order, zero-padded to cap.
//
// K26 ownership_pack: three launches around the wrapper's one host read (the
// H bucket sizes, from which the caller's all_reduce(MAX) fixes cap); no
// memset, no torch.cumsum, and send is allocated uninitialised.
//  1. pack_counts_kernel: tiles of PACK_TILE paths, PACK_WARP_PATHS
//     consecutive paths a warp in rounds of 64, two consecutive paths a
//     lane.  A lane reads its paths' offsets and head owners
//     owner[flat[offs[i]]]; a round's paths of each destination come from
//     two ballots a destination present in the round (a warp-uniform loop),
//     and the destination's first lane adds their count and their summed
//     lengths (__reduce_add_sync) to the tile's bins in shared memory.  Each
//     tile writes its whole column of two [H, tiles] count matrices (paths,
//     flat ids), and each path's destination (a uint16 a path in the
//     scratch: the write pass reads it back in order rather than gather the
//     owner table again).
//  2. pack_offsets_kernel: a block a destination scans its two rows in place
//     into each tile's start in the bucket (block_exclusive_scan of
//     scan.cuh, PACK_OFFSET_ITEMS tiles a thread) and writes the bucket's
//     n_paths, n_flat and size 2 + 2 n_paths + n_flat (the int64 sizes
//     output).
//  3. pack_write_kernel, tile blocks: each re-reads its tile's offsets and
//     destinations and ranks each path among the warp's earlier paths of its
//     destination (the same ballots, a running count a warp and destination
//     in shared memory, and a warp scan of the lengths for the flat ids
//     before it), turns the warps' counts into each warp's start with a scan
//     over the warps and the tile's start, and stores each path's length and
//     weight at its place.  The tile's flat ids are one contiguous input
//     range, and those of one bucket land in one contiguous range of its
//     row, so the block copies them word by word, neighbouring threads on
//     neighbouring words, PACK_COPY loads a thread in flight: a thread finds
//     its word's path in a map of the tile's words to their paths (uint16,
//     in shared memory, written by each path for its words), or, where the
//     tile holds more than PACK_MAP_WORDS words, by a binary search of the
//     tile's offsets.  The other blocks write each row's two header words
//     and zero its words [size, cap): the pad words of every row are
//     enumerated in 4-word groups aligned on the buffer (a group's row by a
//     search of the rows' first groups, scanned in shared memory), a whole
//     group in one 16-byte store.  Each word of send is written exactly
//     once.
// K27 ownership_unpack: the wrapper reads the H headers (one strided copy to
// pinned host memory, the call's one host read), sizes and allocates the
// outputs, and zeroes the scan's scratch.  One launch of
// ownership_unpack_kernel then covers the received real words alone, in two
// kinds of blocks.  Each block first scans the H headers in shared memory
// into each source's first path, first flat id and first weight-or-flat
// word.  The first blocks take the lengths, the rows' n_p lengths laid end
// to end, SCAN_TILE a tile taken by ticket: they widen them and scan them
// into the offsets with scan.cuh's decoupled look-back, offs[0] = 0 and
// offs[g + 1] = lens[0] + ... + lens[g] (the plain version's definition).
// The other blocks copy the rows' weights and flat ids (n_p + n_f words a
// row, laid end to end), widened to int64, to their places in the
// source-rank-order concatenation, with no scan and no wait: only the
// lengths, a third of the words, pass through the look-back.  Both take 16
// words a lane, neighbouring lanes on neighbouring words, every load in
// flight before the first store; a warp whose words lie in one source's row
// (all but the warps on a row's edge) takes that row's constants once, the
// others find each word's source by a binary search of the first words.
// Bound: memory.  K26 reads each path's offsets, weight and head owner and
// its flat ids once and writes the [H, cap] buffer once; K27 reads the
// headers and the real words (4 (2H + sum(2 n_p + n_f)) bytes) and writes
// its int64 outputs once.

#include "common.cuh"
#include "scan.cuh"

#define WARPS (THREADS / 32)
// Ranks K26 and K27 take: a destination's bins and a row's header scan fit
// a block (two rows a thread).
#define MAX_RANKS 512
#define PACK_ROUNDS 4                                 // rounds of 64 paths a warp
#define PACK_WARP_PATHS (64 * PACK_ROUNDS)            // 256
#define PACK_TILE (WARPS * PACK_WARP_PATHS)           // 2,048 paths
#define PACK_OFFSET_ITEMS 4
#define PACK_COPY 8  // flat ids a thread a chunk of the write pass's copy
#define PACK_MAP_WORDS (2 * PACK_TILE)  // a tile's words a word-to-path map holds
#define PACK_FILL_BLOCKS 1024
#define UNPACK_ITEMS (SCAN_TILE / SCAN_THREADS)       // 16 words a lane
#define FULL_MASK 0xffffffffu
// The key of a path whose head owner lies outside [0, H): it goes nowhere.
#define DROPPED 0xffffffffu

static inline int64_t pack_tiles(int64_t P) { return (P + PACK_TILE - 1) / PACK_TILE; }

// The int32 words of scratch K26 takes for P paths and H ranks: the
// [H, tiles] path counts (then starts), the [H, tiles] flat counts (then
// starts), n_paths [H], n_flat [H], then each path's destination (uint16,
// two a word).
static inline int64_t pack_scratch_words(int64_t P, int64_t H) {
  return 2 * H * pack_tiles(P) + 2 * H + (P + 1) / 2;
}

// Bytes of pack_write_kernel's dynamic shared memory: a tile block's
// [2][WARPS][H] running counts, its starts [2][H] and n_paths [H], the
// tile's offsets [PACK_TILE + 1], keys [PACK_TILE], flat places [PACK_TILE]
// and word map [PACK_MAP_WORDS] (uint16); a fill block's [2][H + 1] int64
// fit in it.
static inline size_t pack_write_smem(int H) {
  return sizeof(int32_t) * ((2 * WARPS + 3) * (size_t)H + 3 * PACK_TILE + 1) +
         sizeof(uint16_t) * PACK_MAP_WORDS;
}

// The destination of the path whose flat ids start at `at`: its head node's
// owner, or H where that owner lies outside [0, H) (the path is dropped, as
// the plain version's selection by rank drops it).
static __device__ __forceinline__ int path_dest(const int32_t* __restrict__ flat,
                                                const int32_t* __restrict__ owner, int32_t at,
                                                int H) {
  const int p = owner[flat[at]];
  return (unsigned)p < (unsigned)H ? p : H;
}

// counts[d * gridDim.x + t] = tile t's paths bound for rank d, and
// counts[(H + d) * gridDim.x + t] their flat ids; dest[i] = path i's
// destination (H where it has none).
__global__ void __launch_bounds__(THREADS)
    pack_counts_kernel(const int32_t* __restrict__ flat, const int32_t* __restrict__ offs,
                       int64_t P, const int32_t* __restrict__ owner, int H,
                       int32_t* __restrict__ counts, uint16_t* __restrict__ dest) {
  extern __shared__ int32_t bins[];  // [2][H]: paths, flat ids
  for (int d = threadIdx.x; d < 2 * H; d += blockDim.x) bins[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t seg = (int64_t)blockIdx.x * PACK_TILE + warp * PACK_WARP_PATHS;
  int pa[PACK_ROUNDS], pb[PACK_ROUNDS];
  int32_t la[PACK_ROUNDS], lb[PACK_ROUNDS];
#pragma unroll
  for (int r = 0; r < PACK_ROUNDS; ++r) {  // every load in flight before the first vote
    const int64_t i = seg + 64 * r + 2 * lane;  // the lane's paths i (a) and i + 1 (b)
    pa[r] = pb[r] = H;
    la[r] = lb[r] = 0;
    if (i < P) {
      const int32_t o = offs[i], o1 = offs[i + 1];
      la[r] = o1 - o;
      pa[r] = path_dest(flat, owner, o, H);
      if (i + 1 < P) {
        lb[r] = offs[i + 2] - o1;
        pb[r] = path_dest(flat, owner, o1, H);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < PACK_ROUNDS; ++r) {
    const int64_t i = seg + 64 * r + 2 * lane;
    if (i < P) dest[i] = (uint16_t)pa[r];
    if (i + 1 < P) dest[i + 1] = (uint16_t)pb[r];
    unsigned ta = __ballot_sync(FULL_MASK, pa[r] < H), tb = __ballot_sync(FULL_MASK, pb[r] < H);
    while (ta | tb) {  // one pass a destination present in the round
      const int first = __ffs(ta | tb) - 1;
      const int d = __shfl_sync(FULL_MASK, (ta >> lane) & 1u ? pa[r] : pb[r], first);
      const unsigned ma = __ballot_sync(FULL_MASK, pa[r] == d);
      const unsigned mb = __ballot_sync(FULL_MASK, pb[r] == d);
      ta &= ~ma;
      tb &= ~mb;
      const int32_t ids = __reduce_add_sync(FULL_MASK, (pa[r] == d ? la[r] : 0) +
                                                           (pb[r] == d ? lb[r] : 0));
      if (lane == first) {
        atomicAdd(&bins[d], __popc(ma) + __popc(mb));
        atomicAdd(&bins[H + d], ids);
      }
    }
  }
  __syncthreads();
  const int64_t tiles = gridDim.x;
  for (int d = threadIdx.x; d < H; d += blockDim.x) {
    counts[d * tiles + blockIdx.x] = bins[d];
    counts[(H + d) * tiles + blockIdx.x] = bins[H + d];
  }
}

// Block d: rows d and H + d of counts [2H, tiles] scanned in place into each
// tile's start in bucket d (paths, flat ids); n_paths[d], n_flat[d] and
// sizes[d] = 2 + 2 n_paths + n_flat.
__global__ void __launch_bounds__(THREADS)
    pack_offsets_kernel(int32_t* __restrict__ counts, int64_t tiles, int H,
                        int32_t* __restrict__ n_paths, int32_t* __restrict__ n_flat,
                        int64_t* __restrict__ sizes) {
  __shared__ int32_t s_warp_p[WARPS], s_warp_f[WARPS];
  const int d = blockIdx.x;
  int32_t* row_p = counts + d * tiles;
  int32_t* row_f = counts + (H + d) * tiles;
  int32_t run_p = 0, run_f = 0;
  for (int64_t base = 0; base < tiles; base += THREADS * PACK_OFFSET_ITEMS) {
    const int64_t t0 = base + threadIdx.x * PACK_OFFSET_ITEMS;
    int32_t vp[PACK_OFFSET_ITEMS], vf[PACK_OFFSET_ITEMS], sp = 0, sf = 0;
#pragma unroll
    for (int k = 0; k < PACK_OFFSET_ITEMS; ++k) {
      const bool in = t0 + k < tiles;
      vp[k] = in ? row_p[t0 + k] : 0;
      vf[k] = in ? row_f[t0 + k] : 0;
      sp += vp[k];
      sf += vf[k];
    }
    int32_t total_p, total_f;
    int32_t ep = run_p + block_exclusive_scan(sp, s_warp_p, &total_p);
    int32_t ef = run_f + block_exclusive_scan(sf, s_warp_f, &total_f);
#pragma unroll
    for (int k = 0; k < PACK_OFFSET_ITEMS; ++k) {
      if (t0 + k < tiles) {
        row_p[t0 + k] = ep;
        row_f[t0 + k] = ef;
      }
      ep += vp[k];
      ef += vf[k];
    }
    run_p += total_p;
    run_f += total_f;
    __syncthreads();  // s_warp_p and s_warp_f serve the next chunk
  }
  if (threadIdx.x == 0) {
    n_paths[d] = run_p;
    n_flat[d] = run_f;
    sizes[d] = 2 + 2 * (int64_t)run_p + run_f;
  }
}

// The pad words of row d are [d * cap + sizes[d], (d + 1) * cap): the 4-word
// groups (aligned on the buffer) that hold one of them.
static __host__ __device__ __forceinline__ int64_t pad_groups(int64_t lo, int64_t hi) {
  return lo < hi ? ((hi - 1) >> 2) - (lo >> 2) + 1 : 0;
}

// Blocks [0, tiles): place the tile's paths.  Blocks from tiles on: the
// headers and the pad, grid-stride.  starts: pack_offsets_kernel's [2H,
// tiles] starts; n_paths, n_flat [H]; sizes [H], each at most cap; vec: send
// is 16-byte aligned.
__global__ void __launch_bounds__(THREADS)
    pack_write_kernel(const int32_t* __restrict__ flat, const int32_t* __restrict__ offs,
                      const int32_t* __restrict__ weights, int64_t P,
                      const uint16_t* __restrict__ dest, int H, int64_t tiles,
                      const int32_t* __restrict__ starts, const int32_t* __restrict__ n_paths,
                      const int32_t* __restrict__ n_flat, const int64_t* __restrict__ sizes,
                      int64_t cap, int vec, int32_t* __restrict__ send) {
  extern __shared__ __align__(16) int32_t smem[];
  if (blockIdx.x >= tiles) {
    // the fill: each row's first pad group in the enumeration of every
    // row's pad groups (an exclusive scan over the rows, two a thread), and
    // its first pad word
    int64_t* s_group = (int64_t*)smem;  // [H + 1]
    int64_t* s_lo = s_group + H + 1;    // [H]
    __shared__ int64_t s_warp[WARPS];
    const int a = 2 * threadIdx.x, b = a + 1;
    const int64_t lo_a = a < H ? a * cap + sizes[a] : 0, lo_b = b < H ? b * cap + sizes[b] : 0;
    const int64_t ga = a < H ? pad_groups(lo_a, (a + 1) * cap) : 0;
    const int64_t gb = b < H ? pad_groups(lo_b, (b + 1) * cap) : 0;
    int64_t total;
    const int64_t before = block_exclusive_scan(ga + gb, s_warp, &total);
    if (a < H) {
      s_group[a] = before;
      s_lo[a] = lo_a;
    }
    if (b < H) {
      s_group[b] = before + ga;
      s_lo[b] = lo_b;
    }
    if (threadIdx.x == 0) s_group[H] = total;
    __syncthreads();
    const int64_t first = (int64_t)(blockIdx.x - tiles) * blockDim.x + threadIdx.x;
    const int64_t stride = (int64_t)(gridDim.x - tiles) * blockDim.x;
    for (int64_t d = first; d < H; d += stride) {
      send[d * cap] = n_paths[d];
      send[d * cap + 1] = n_flat[d];
    }
    int row = 0;
    for (int64_t g = first; g < total; g += stride) {
      // the last row whose first group is at or before g: rows without pad
      // share their successor's first group and are passed over
      int hi = H;
      while (hi - row > 1) {
        const int mid = (row + hi) >> 1;
        if (s_group[mid] <= g) {
          row = mid;
        } else {
          hi = mid;
        }
      }
      const int64_t lo = s_lo[row], end = (row + 1) * cap;
      const int64_t at = 4 * ((lo >> 2) + (g - s_group[row]));
      if (vec && at >= lo && at + 4 <= end) {
        *reinterpret_cast<int4*>(send + at) = make_int4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (at + j >= lo && at + j < end) send[at + j] = 0;
        }
      }
    }
    return;
  }
  int32_t* s_run = smem;                                   // [2][WARPS][H]
  int32_t* s_head = s_run + 2 * WARPS * H;                 // [3][H]: starts, n_paths
  int32_t* s_offs = s_head + 3 * H;                        // [PACK_TILE + 1]
  uint32_t* s_key = (uint32_t*)(s_offs + PACK_TILE + 1);   // [PACK_TILE]
  int32_t* s_place = (int32_t*)(s_key + PACK_TILE);        // [PACK_TILE]
  uint16_t* s_wpath = (uint16_t*)(s_place + PACK_TILE);    // [PACK_MAP_WORDS]
  const int64_t t0 = (int64_t)blockIdx.x * PACK_TILE;
  const int n = (int)(P - t0 < PACK_TILE ? P - t0 : PACK_TILE);
  const int32_t o0 = offs[t0];
  for (int x = threadIdx.x; x < 2 * WARPS * H; x += blockDim.x) s_run[x] = 0;
  for (int d = threadIdx.x; d < H; d += blockDim.x) {  // read long before they are used
    s_head[d] = starts[d * tiles + blockIdx.x];
    s_head[H + d] = starts[(H + d) * tiles + blockIdx.x];
    s_head[2 * H + d] = n_paths[d];
  }
  for (int j = threadIdx.x; j <= n; j += blockDim.x) s_offs[j] = offs[t0 + j] - o0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int32_t* run_p = s_run + warp * H;
  int32_t* run_f = s_run + (WARPS + warp) * H;
  const int seg = warp * PACK_WARP_PATHS;
  int pa[PACK_ROUNDS], pb[PACK_ROUNDS];
  int32_t la[PACK_ROUNDS], lb[PACK_ROUNDS];
#pragma unroll
  for (int r = 0; r < PACK_ROUNDS; ++r) {  // the lane's paths li (a) and li + 1 (b)
    const int li = seg + 64 * r + 2 * lane;
    pa[r] = li < n ? dest[t0 + li] : H;
    pb[r] = li + 1 < n ? dest[t0 + li + 1] : H;
    la[r] = li < n ? s_offs[li + 1] - s_offs[li] : 0;
    lb[r] = li + 1 < n ? s_offs[li + 2] - s_offs[li + 1] : 0;
  }
  // each path's rank among the warp's earlier paths of its destination
  // (key: destination | rank << 16) and the flat ids of those paths (place);
  // a lane's path a comes before its path b
  const unsigned upto = below | (1u << lane);
#pragma unroll
  for (int r = 0; r < PACK_ROUNDS; ++r) {
    const int li = seg + 64 * r + 2 * lane;
    unsigned ta = __ballot_sync(FULL_MASK, pa[r] < H), tb = __ballot_sync(FULL_MASK, pb[r] < H);
    while (ta | tb) {
      const int first = __ffs(ta | tb) - 1;
      const int d = __shfl_sync(FULL_MASK, (ta >> lane) & 1u ? pa[r] : pb[r], first);
      const bool a = pa[r] == d, b = pb[r] == d;
      const unsigned ma = __ballot_sync(FULL_MASK, a), mb = __ballot_sync(FULL_MASK, b);
      ta &= ~ma;
      tb &= ~mb;
      const int32_t va = a ? la[r] : 0, vb = b ? lb[r] : 0;
      const int32_t inc = warp_inclusive_scan(va + vb);
      const int32_t base_p = run_p[d], base_f = run_f[d];
      if (a) {
        s_key[li] = (uint32_t)d | ((uint32_t)(base_p + __popc(ma & below) + __popc(mb & below))
                                   << 16);
        s_place[li] = base_f + inc - va - vb;
      }
      if (b) {
        s_key[li + 1] = (uint32_t)d | ((uint32_t)(base_p + __popc(ma & upto) +
                                                  __popc(mb & below)) << 16);
        s_place[li + 1] = base_f + inc - vb;
      }
      __syncwarp();
      if (lane == 31) {  // its inclusive scan is the round's ids of d
        run_p[d] = base_p + __popc(ma) + __popc(mb);
        run_f[d] = base_f + inc;
      }
      __syncwarp();
    }
    if (li < n && pa[r] == H) s_key[li] = DROPPED;
    if (li + 1 < n && pb[r] == H) s_key[li + 1] = DROPPED;
  }
  __syncthreads();
  // each warp's start in each bucket: the tile's start plus the earlier
  // warps' counts
  for (int d = threadIdx.x; d < H; d += blockDim.x) {
    int32_t sp = s_head[d], sf = s_head[H + d];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int32_t xp = s_run[w * H + d], xf = s_run[(WARPS + w) * H + d];
      s_run[w * H + d] = sp;
      s_run[(WARPS + w) * H + d] = sf;
      sp += xp;
      sf += xf;
    }
  }
  __syncthreads();
  // lengths and weights at their places; place becomes the row index of the
  // path's first flat id less its tile offset
  int32_t wt[PACK_TILE / THREADS];
#pragma unroll
  for (int k = 0; k < PACK_TILE / THREADS; ++k) {  // every load in flight before the stores
    const int li = threadIdx.x + k * THREADS;
    wt[k] = li < n ? weights[t0 + li] : 0;
  }
#pragma unroll
  for (int k = 0; k < PACK_TILE / THREADS; ++k) {
    const int li = threadIdx.x + k * THREADS;
    const uint32_t key = li < n ? s_key[li] : DROPPED;
    if (key != DROPPED) {
      const int d = (int)(key & 0xffffu), w = li / PACK_WARP_PATHS;
      const int32_t at = s_run[w * H + d] + (int32_t)(key >> 16), np = s_head[2 * H + d];
      int32_t* row = send + d * cap;
      row[2 + at] = s_offs[li + 1] - s_offs[li];
      row[2 + np + at] = wt[k];
      s_place[li] += 2 + 2 * np + s_run[(WARPS + w) * H + d] - s_offs[li];
    }
  }
  const int32_t words = s_offs[n];
  const bool mapped = words <= PACK_MAP_WORDS;
  if (mapped) {
#pragma unroll
    for (int k = 0; k < PACK_TILE / THREADS; ++k) {
      const int li = threadIdx.x + k * THREADS;
      if (li < n) {
        for (int32_t j = s_offs[li]; j < s_offs[li + 1]; ++j) s_wpath[j] = (uint16_t)li;
      }
    }
  }
  __syncthreads();
  // the flat ids, a word a thread, PACK_COPY words a thread a chunk (their
  // loads in flight before the searches): word j of the tile is in the path
  // li with s_offs[li] <= j < s_offs[li + 1] (a path of length 0 holds none)
  int li = 0;
  for (int32_t base = 0; base < words; base += PACK_COPY * THREADS) {
    int32_t x[PACK_COPY];
#pragma unroll
    for (int k = 0; k < PACK_COPY; ++k) {
      const int32_t j = base + k * THREADS + threadIdx.x;
      x[k] = j < words ? flat[o0 + j] : 0;
    }
#pragma unroll
    for (int k = 0; k < PACK_COPY; ++k) {
      const int32_t j = base + k * THREADS + threadIdx.x;
      if (j < words) {
        if (mapped) li = s_wpath[j];
        int hi = mapped ? li : n;  // s_offs[li] <= j < s_offs[hi]; li only grows with j
        while (hi - li > 1) {
          const int mid = (li + hi) >> 1;
          if (s_offs[mid] <= j) {
            li = mid;
          } else {
            hi = mid;
          }
        }
        const uint32_t key = s_key[li];
        if (key != DROPPED) send[(int64_t)(key & 0xffffu) * cap + s_place[li] + j] = x[k];
      }
    }
  }
}

// The source of word v: the last row r in [lo, H) with first[r] <= v (rows
// holding none of these words share their successor's first word and are
// passed over); first[lo] <= v < first[H].
static __device__ __forceinline__ int source_of(const int64_t* first, int lo, int H, int64_t v) {
  int hi = H;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= v) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Blocks [0, len_tiles): the n_paths lengths in concatenation order,
// SCAN_TILE a tile taken by ticket (scratch: scan.cuh's len_tiles + 1
// words, zeroed), scanned into offs.  The other blocks: the n_paths + n_flat
// weights and flat ids, SCAN_TILE a block.  Block 0 writes offs[0].
__global__ void __launch_bounds__(SCAN_THREADS)
    ownership_unpack_kernel(const int32_t* __restrict__ recv, int H, int64_t cap,
                            int64_t n_paths, int64_t n_flat, int64_t len_tiles,
                            unsigned long long* __restrict__ scratch, int64_t* __restrict__ flat,
                            int64_t* __restrict__ offs, int64_t* __restrict__ weights) {
  extern __shared__ int64_t s_rows[];  // [3][H + 1]: first path, flat id, weight-or-flat word
  __shared__ int64_t s_warp_p[SCAN_WARPS], s_warp_f[SCAN_WARPS];
  __shared__ unsigned long long s_warp_l[SCAN_WARPS];
  __shared__ ScanShared sh;
  int64_t* s_path = s_rows;
  int64_t* s_flat = s_rows + H + 1;
  int64_t* s_other = s_rows + 2 * (H + 1);
  {
    const int a = 2 * threadIdx.x, b = a + 1;
    const int64_t pa = a < H ? recv[a * cap] : 0, fa = a < H ? recv[a * cap + 1] : 0;
    const int64_t pb = b < H ? recv[b * cap] : 0, fb = b < H ? recv[b * cap + 1] : 0;
    int64_t total_p, total_f;
    const int64_t ep = block_exclusive_scan(pa + pb, s_warp_p, &total_p);
    const int64_t ef = block_exclusive_scan(fa + fb, s_warp_f, &total_f);
    if (a < H) {
      s_path[a] = ep;
      s_flat[a] = ef;
      s_other[a] = ep + ef;
    }
    if (b < H) {
      s_path[b] = ep + pa;
      s_flat[b] = ef + fa;
      s_other[b] = ep + pa + ef + fa;
    }
    if (threadIdx.x == 0) {
      s_path[H] = total_p;
      s_flat[H] = total_f;
      s_other[H] = total_p + total_f;
      if (blockIdx.x == 0) offs[0] = 0;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x[UNPACK_ITEMS];
  if (blockIdx.x >= len_tiles) {
    // weights and flat ids: word u of the rows' [n_p weights, n_f flat ids]
    // laid end to end; a warp whose words lie in one source's row takes that
    // row's constants once, the others search each word's source
    const int64_t words = n_paths + n_flat;
    const int64_t seg = (blockIdx.x - len_tiles) * SCAN_TILE + warp * (32 * UNPACK_ITEMS);
    if (seg >= words) return;
    const int64_t last = (seg + 32 * UNPACK_ITEMS < words ? seg + 32 * UNPACK_ITEMS : words) - 1;
    const int r0 = source_of(s_other, 0, H, seg);
    if (source_of(s_other, r0, H, last) == r0) {
      const int64_t u0 = s_other[r0], p0 = s_path[r0], f0 = s_flat[r0];
      const int64_t np0 = s_path[r0 + 1] - p0;
      const int64_t at = r0 * cap + 2 + np0 - u0;  // word u of row r0 is recv[at + u]
#pragma unroll
      for (int j = 0; j < UNPACK_ITEMS; ++j) {  // every load in flight before the first store
        const int64_t u = seg + 32 * j + lane;
        x[j] = u < words ? recv[at + u] : 0;
      }
#pragma unroll
      for (int j = 0; j < UNPACK_ITEMS; ++j) {
        const int64_t c = seg + 32 * j + lane - u0;
        if (seg + 32 * j + lane < words) {
          if (c < np0) {
            weights[p0 + c] = x[j];
          } else {
            flat[f0 + c - np0] = x[j];
          }
        }
      }
    } else {
      int r = r0;
#pragma unroll
      for (int j = 0; j < UNPACK_ITEMS; ++j) {
        const int64_t u = seg + 32 * j + lane;
        if (u < words) {
          r = source_of(s_other, r, H, u);
          const int64_t c = u - s_other[r], n_p = s_path[r + 1] - s_path[r];
          const int32_t y = recv[r * cap + 2 + n_p + c];
          if (c < n_p) {
            weights[s_path[r] + c] = y;
          } else {
            flat[s_flat[r] + c - n_p] = y;
          }
        }
      }
    }
    return;
  }
  // the lengths: length g is word g - s_path[r] of source r's row
  const long long tile = scan_ticket(scratch, &sh);
  unsigned long long* status = scratch + 1;
  const int64_t seg = tile * SCAN_TILE + warp * (32 * UNPACK_ITEMS);
  const int64_t last = (seg + 32 * UNPACK_ITEMS < n_paths ? seg + 32 * UNPACK_ITEMS : n_paths) - 1;
  const int r0 = seg < n_paths ? source_of(s_path, 0, H, seg) : 0;
  if (seg >= n_paths || source_of(s_path, r0, H, last) == r0) {
    const int64_t at = r0 * cap + 2 - s_path[r0];  // length g of row r0 is recv[at + g]
#pragma unroll
    for (int j = 0; j < UNPACK_ITEMS; ++j) {  // every load in flight before the first use
      const int64_t g = seg + 32 * j + lane;
      x[j] = g < n_paths ? recv[at + g] : 0;
    }
  } else {
    int r = r0;
#pragma unroll
    for (int j = 0; j < UNPACK_ITEMS; ++j) {
      const int64_t g = seg + 32 * j + lane;
      if (g < n_paths) r = source_of(s_path, r, H, g);
      x[j] = g < n_paths ? recv[r * cap + 2 + (g - s_path[r])] : 0;
    }
  }
  unsigned long long mine = 0;  // the lane's lengths
#pragma unroll
  for (int j = 0; j < UNPACK_ITEMS; ++j) mine += (uint32_t)x[j];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) mine += __shfl_xor_sync(FULL_MASK, mine, d);
  if (lane == 0) s_warp_l[warp] = mine;
  __syncthreads();
  unsigned long long before = 0, aggregate = 0;
#pragma unroll
  for (int w = 0; w < SCAN_WARPS; ++w) {
    const unsigned long long y = s_warp_l[w];
    if (w < warp) before += y;
    aggregate += y;
  }
  scan_publish_aggregate(status, tile, aggregate);
  before += scan_tile_prefix(status, tile, aggregate, &sh);
  // the lengths' inclusive scan in order (item-major, then lanes) from the
  // prefix: offs[g + 1] after length g
#pragma unroll
  for (int j = 0; j < UNPACK_ITEMS; ++j) {
    const unsigned long long i = warp_inclusive_scan((unsigned long long)(uint32_t)x[j]);
    const int64_t g = seg + 32 * j + lane;
    if (g < n_paths) offs[g + 1] = (int64_t)(before + i);
    before += __shfl_sync(FULL_MASK, i, 31);
  }
}

extern "C" {

// flat, offs, weights, owner: the evidence (offs [P + 1]) and the owner
// table; scratch: pack_scratch_words(P, H) int32 words, any contents (any
// other size means the caller's tile is not PACK_TILE, and the call is
// refused); sizes: [H] int64, any contents, each bucket's size after the
// call.
int shannon_ownership_counts(const void* flat, const void* offs, int64_t P, const void* owner,
                             int H, void* scratch, int64_t scratch_words, void* sizes,
                             void* stream) {
  if (H < 1 || H > MAX_RANKS || P < 0) return (int)cudaErrorInvalidValue;
  if (scratch_words != pack_scratch_words(P, H)) return (int)cudaErrorInvalidValue;
  const int64_t tiles = pack_tiles(P);
  int32_t* counts = (int32_t*)scratch;
  int32_t* totals = counts + 2 * H * tiles;
  cudaStream_t s = (cudaStream_t)stream;
  if (tiles > 0) {
    pack_counts_kernel<<<(unsigned int)tiles, THREADS, 2 * H * sizeof(int32_t), s>>>(
        (const int32_t*)flat, (const int32_t*)offs, P, (const int32_t*)owner, H, counts,
        (uint16_t*)(totals + 2 * H));
  }
  pack_offsets_kernel<<<H, THREADS, 0, s>>>(counts, tiles, H, totals, totals + H,
                                            (int64_t*)sizes);
  return (int)cudaGetLastError();
}

// After shannon_ownership_counts on the same evidence and scratch (which
// holds each path's destination): sizes its device output, host_sizes a host copy of it (it sizes the fill's
// grid), cap at least every size; send: [H, cap] int32, any contents.
int shannon_ownership_scatter(const void* flat, const void* offs, const void* weights, int64_t P,
                              int H, const void* scratch,
                              int64_t scratch_words, const void* sizes,
                              const int64_t* host_sizes, int64_t cap, void* send, void* stream) {
  if (H < 1 || H > MAX_RANKS || P < 0) return (int)cudaErrorInvalidValue;
  if (scratch_words != pack_scratch_words(P, H)) return (int)cudaErrorInvalidValue;
  int64_t groups = 0;
  for (int64_t d = 0; d < H; ++d) {
    if (host_sizes[d] < 2 || host_sizes[d] > cap) return (int)cudaErrorInvalidValue;
    groups += pad_groups(d * cap + host_sizes[d], (d + 1) * cap);
  }
  const int64_t tiles = pack_tiles(P);
  const int32_t* starts = (const int32_t*)scratch;
  const int32_t* totals = starts + 2 * H * tiles;
  const uint16_t* dest = (const uint16_t*)(totals + 2 * H);
  const int64_t fill_threads = groups > H ? groups : H;
  const int64_t want = (fill_threads + THREADS - 1) / THREADS;
  const int64_t fill = want < PACK_FILL_BLOCKS ? want : PACK_FILL_BLOCKS;
  const size_t smem = pack_write_smem(H);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)pack_write_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = ((uintptr_t)send & 15) == 0;
  pack_write_kernel<<<(unsigned int)(tiles + fill), THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)flat, (const int32_t*)offs, (const int32_t*)weights, P, dest, H, tiles,
      starts, totals, totals + H, (const int64_t*)sizes, cap, vec, (int32_t*)send);
  return (int)cudaGetLastError();
}

// The [H, 2] int32 headers of the received [H, cap] buffer into host memory
// (pinned, so the copy is ordered on the stream; the caller synchronises).
int shannon_ownership_headers(const void* recv, int H, int64_t cap, void* host, void* stream) {
  if (H < 1 || H > MAX_RANKS || cap < 2) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpy2DAsync(host, 2 * sizeof(int32_t), recv, cap * sizeof(int32_t),
                                2 * sizeof(int32_t), H, cudaMemcpyDeviceToHost,
                                (cudaStream_t)stream);
}

// recv: [H, cap] int32 with checked headers summing to n_paths and n_flat;
// scratch: scan_tiles(n_paths) + 1 int64 words, zeroed; flat, offs, weights:
// [n_flat], [n_paths + 1], [n_paths] int64, any contents.
int shannon_ownership_unpack(const void* recv, int H, int64_t cap, int64_t n_paths,
                             int64_t n_flat, void* scratch, int64_t scratch_words, void* flat,
                             void* offs, void* weights, void* stream) {
  if (H < 1 || H > MAX_RANKS || cap < 2 || n_paths < 0 || n_flat < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long len_tiles = scan_tiles(n_paths);
  if (scratch_words != len_tiles + 1) return (int)cudaErrorInvalidValue;
  const int64_t copy = (n_paths + n_flat + SCAN_TILE - 1) / SCAN_TILE;
  const int64_t blocks = len_tiles + copy;
  ownership_unpack_kernel<<<(unsigned int)(blocks > 0 ? blocks : 1), SCAN_THREADS,
                            3 * (H + 1) * sizeof(int64_t), (cudaStream_t)stream>>>(
      (const int32_t*)recv, H, cap, n_paths, n_flat, len_tiles, (unsigned long long*)scratch,
      (int64_t*)flat, (int64_t*)offs, (int64_t*)weights);
  return (int)cudaGetLastError();
}

}  // extern "C"
