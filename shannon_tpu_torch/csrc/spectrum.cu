// Count lookups in the sorted spectrum: kernels K21 (lookup_counts), K22
// (sibling_maxes) and K28 (neighbor_counts) of the shannon_tpu_torch port (plain C interface; see
// kernels.cu for the conventions every entry point follows).
//
// The spectrum is a sorted table of C int64 keys with int32 counts, PAD (with
// count 0) past its real entries.  K21, K22 and K28 walk the 16-ary index of
// search.cuh over the real lanes (K22 and K28 with K7's probe-group steps,
// probe.cuh's probe_lane, which the two share).

#include "probe.cuh"
#include "search.cuh"

// ---------------------------------------------------------------------------
// K21: the count of each query key.
// Replaces shannon_tpu/ops/spectrum.py:60 lookup_counts (with :137
// lookup_hilo).  The wrapper passes n = min(spectrum n, C), and the kernel
// searches key[0, n) alone: under the Spectrum contract (ops/count.py) those
// lanes hold the real keys, strictly increasing, and every lane past them is
// PAD with count 0, so a query that misses key[0, n), a PAD query included,
// has the count the reference gives it, 0.
// Bound: the bytes of the queries in and the counts out (12 bytes a query)
// and the real lanes' keys and counts; a search is latency, which the index
// cuts to a few L2 lines a query.
// Design.  The entry point builds search.cuh's index of key[0, n) (at the
// flagship table's 174,607 real lanes, levels of 10,913 and 683 entries: a
// 5.4 KB top in shared memory, then one index line and one leaf line a
// query), then this kernel searches it a lane a query (search_top, then
// search_lane: a binary search of 16 entries a level, no warp collective):
// persistent blocks, COUNTS_BLOCKS_PER_SM an SM, a warp takes 32
// consecutive queries (one coalesced load, issued while the warp resolves
// its previous 32, and one coalesced store of the counts).  A query outside
// [key[0], key[n - 1]] misses (PAD is above every real key), resolved
// against the table's two ends with no search.  A warp whose 32 queries are
// one value (the pad lanes' probes, 92% of the flagship table's 8 x C)
// searches once: its lanes walk in lock step, one address a load.
// Answering such a warp from the previous chunk's result with no search
// (a carried query and count) was measured on an H100: 89.4-90.6 us against
// 125.5-130.9 on the flagship probes, but 0.3-0.8 us slower on the real
// lanes' probes, which never repeat a whole warp, so it is not kept.
// ---------------------------------------------------------------------------
#define COUNTS_BLOCKS_PER_SM 6

__global__ void __launch_bounds__(SEARCH_THREADS, COUNTS_BLOCKS_PER_SM)
    lookup_counts_kernel(const int64_t* __restrict__ table, const int32_t* __restrict__ count,
                         int n, const int64_t* __restrict__ index, SearchIndex ix,
                         const int64_t* __restrict__ query, int64_t n_query,
                         int32_t* __restrict__ out) {
  extern __shared__ int64_t top[];
  search_load_top(ix, index, top);
  const int lane = threadIdx.x & 31;
  const int64_t lo_key = __ldg(table), hi_key = __ldg(table + n - 1);
  const int64_t chunks = (n_query + 31) / 32;
  const int64_t warp = (int64_t)blockIdx.x * (SEARCH_THREADS / 32) + (threadIdx.x >> 5);
  const int64_t warps = (int64_t)gridDim.x * (SEARCH_THREADS / 32);
  int64_t next = warp * 32 + lane < n_query ? __ldg(query + warp * 32 + lane) : PAD_KEY;
  for (int64_t c = warp; c < chunks; c += warps) {
    const int64_t i = c * 32 + lane;
    const int64_t q = next;
    const int64_t ahead = i + 32 * warps;
    next = ahead < n_query ? __ldg(query + ahead) : PAD_KEY;
    if (i >= n_query) continue;
    int32_t v = 0;
    if (q >= lo_key && q <= hi_key) {
      bool hit;
      const int lb = search_lane(ix, index, table, n, q, search_top(ix, top, q), &hit);
      if (hit) v = __ldg(count + lb);
    }
    out[i] = v;
  }
}

// ---------------------------------------------------------------------------
// K22: the largest count of each entry's right siblings (prefix.b) and of
// its left siblings (b.suffix).
// Replaces shannon_tpu/ops/spectrum.py:166 sibling_maxes (its [8, C] probe
// tensor, canonical_hilo and the lookup_counts of the probes).  The wrapper
// passes n = min(spectrum n, C): under the Spectrum contract key[0, n) holds
// the real keys, strictly increasing, and every lane past them is PAD with
// count 0, whose maxima are 0; so the kernel resolves the real lanes' probes
// in key[0, n) alone, and writes lanes [n, C) as zeros in the same launch.
// Bound: the bytes of the real lanes' keys and counts in (12 a lane) and
// both maxima of every lane out (8 a lane): at the flagship table's 174,607
// real lanes of 2,097,152, 18.9 MB, 0.0056 ms at 3.35 TB/s.  The probes'
// searches cost far more: the L1 passes of their scattered loads.
// Design.  The entry point builds search.cuh's index of key[0, n) (at
// 174,607 lanes, levels of 10,913 and 683 entries: a 5.4 KB top in shared
// memory, then one index line and one leaf line a walk); where the index is
// one level (n <= 65,536: a dry run's 24,556 real lanes give a top of 1,535
// keys) each block gathers that top from the table itself, so the call is
// one launch (1.4 us less device time there on an H100).  Then persistent
// blocks, SIB_BLOCKS_PER_SM an SM, first fill their share of [n, C) with
// 16-byte stores and then take a real lane a thread.  A lane builds its 8
// probes in registers with the plain version's choice of form (probe_key,
// shared with K7 and K28) and resolves them with K7's group rule
// (probe.cuh), a lane a query as K21 walks, no warp collective:
//  - a right sibling kept in forward form lies in the lane's own group: a
//    step from lane i (i - 3 .. i + 3);
//  - the left siblings kept in reverse-complement form share the group
//    rc(v) & ~3: one walk gives its lower bound, and each steps up from it;
//  - every other probe walks the index (search_top, search_lane), one walk
//    at a time; a probe above the last real key misses with no search of
//    its own (it walks the last key instead), and one below the first key
//    ends at lane 0 as the walk finds it.
// Each answer's count (0 on a miss) goes straight into the lane's two maxima
// in registers; no [8, C] probe table is stored.  The lane's resolution is
// probe.cuh's probe_lane, which K28 runs on the same probes.  About 3.7
// walks a real lane remain of the 8 searches.  The walks' scattered loads
// bound the kernel by their L1 passes (search.cuh), not by a lane's chain
// of loads: on an H100 two walks a round (the odd one walked twice) took 5%
// longer on the flagship table, four in lock step 16% longer.  K7's job queue, which
// walks a query with 8 lanes, took 56 us on the same probes of the flagship
// table's real lanes (its [8, n] answers stored) against this kernel's 30.
// ---------------------------------------------------------------------------
#define SIB_BLOCKS_PER_SM 6

// Folds probe p's count (0 on a miss) into the maxima: even p right, odd left.
static __device__ __forceinline__ void sib_fold(const int32_t* __restrict__ count, int p,
                                                int64_t lb, bool hit, int32_t* r, int32_t* l) {
  const int32_t c = hit ? __ldg(count + lb) : 0;
  if (p & 1) {
    *l = c > *l ? c : *l;
  } else {
    *r = c > *r ? c : *r;
  }
}

// Zeros in lanes [n, C) of both maxima: 16-byte stores between the first and
// the last 16-byte boundary where both outputs are 16-byte aligned, a lane a
// store elsewhere.
static __device__ __forceinline__ void sib_fill(int64_t n, int64_t C, int32_t* __restrict__ rmax,
                                                int32_t* __restrict__ lmax) {
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const bool vec = (((uintptr_t)rmax | (uintptr_t)lmax) & 15) == 0;
  const int64_t a = vec ? ((n + 3) & ~3ll) : C, b = vec ? (C & ~3ll) : C;
  if (a < b) {
    const int4 zero = make_int4(0, 0, 0, 0);
    for (int64_t w = a / 4 + t0; w < b / 4; w += stride) {
      reinterpret_cast<int4*>(rmax)[w] = zero;
      reinterpret_cast<int4*>(lmax)[w] = zero;
    }
    for (int64_t i = n + t0; i < a; i += stride) rmax[i] = lmax[i] = 0;
    for (int64_t i = b + t0; i < C; i += stride) rmax[i] = lmax[i] = 0;
  } else {
    for (int64_t i = n + t0; i < C; i += stride) rmax[i] = lmax[i] = 0;
  }
}

__global__ void __launch_bounds__(SEARCH_THREADS, SIB_BLOCKS_PER_SM)
    sibling_maxes_kernel(const int64_t* __restrict__ key, const int32_t* __restrict__ count,
                         int n, int64_t C, const int64_t* __restrict__ index, SearchIndex ix,
                         int k, int canonical, int32_t* __restrict__ rmax,
                         int32_t* __restrict__ lmax) {
  extern __shared__ int64_t top[];
  sib_fill(n, C, rmax, lmax);
  if (n == 0) return;
  probe_load_top(ix, index, key, n, top);
  const int64_t hi_key = __ldg(key + n - 1);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t v = __ldg(key + i);
    int32_t r = INT32_MIN, l = INT32_MIN;
    probe_lane(ix, index, top, key, n, hi_key, i, v, k, 0, canonical,
               [&](int p, int64_t lb, bool hit) { sib_fold(count, p, lb, hit, &r, &l); });
    rmax[i] = r;
    lmax[i] = l;
  }
}

// ---------------------------------------------------------------------------
// K28: the counts of each entry's 4 right extensions (suffix.b) and 4 left
// extensions (b.prefix), and K22's two sibling maxima.
// Replaces shannon_tpu/ops/spectrum.py:212 neighbor_counts (its [16, C] probe
// tensor, canonical_hilo and the lookup_counts of the probes).  The wrapper
// passes n = min(spectrum n, C): under the Spectrum contract key[0, n) holds
// the real keys, strictly increasing, and every lane past them is PAD with
// count 0, whose ten outputs are 0; so the kernel resolves the real lanes'
// probes in key[0, n) alone, and writes lanes [n, C) of its ten rows as
// zeros in the same launch.
// Bound: the bytes of the real lanes' keys and counts in (12 a lane) and the
// ten rows of every lane out (40 a lane); the probes' walks cost far more,
// the L1 passes of their scattered loads (search.cuh).
// Design: K22's kernel, extended to the extension probes.  The entry point
// builds search.cuh's index of key[0, n) (each block gathers a one-level top
// from the table, as K22's does); persistent blocks, NBR_BLOCKS_PER_SM an SM,
// first zero their share of [n, C) in all ten rows with 16-byte stores
// (sib_fill, a row pair at a time) and then take a real lane a thread.  The
// lane resolves its 8 sibling probes exactly as K22 does and its 8
// extension probes with K7's ext routes (probe_lane with side_ext: the right
// extensions kept in forward form share group job 8, (v << 2) & mask, the
// left ones kept in reverse-complement form group job 9, (rc(v) << 2) &
// mask; one walk finds each group's lower bound and its probes step up from
// it; a probe in the lane's own group steps from the lane; every other probe
// walks).  Each answer's count goes to registers, and the 8 extension
// counts are stored at b * C + i, so consecutive threads store consecutive
// words.  No [16, C] probe table is stored.  On the counted 1M-read
// spectrum (10,689,722 real lanes) an H100 took 4.11-4.13 ms at 6 blocks an
// SM (40 registers, 116 bytes of spills) against 4.75-4.77 at 4 (56
// registers, none) and 5.77-5.78 at 8.
// ---------------------------------------------------------------------------
#define NBR_BLOCKS_PER_SM 6

__global__ void __launch_bounds__(SEARCH_THREADS, NBR_BLOCKS_PER_SM)
    neighbor_counts_kernel(const int64_t* __restrict__ key, const int32_t* __restrict__ count,
                           int n, int64_t C, const int64_t* __restrict__ index, SearchIndex ix,
                           int k, int canonical, int32_t* __restrict__ rext,
                           int32_t* __restrict__ lext, int32_t* __restrict__ rmax,
                           int32_t* __restrict__ lmax) {
  extern __shared__ int64_t top[];
#pragma unroll
  for (int b = 0; b < 4; ++b) sib_fill(n, C, rext + b * C, lext + b * C);
  sib_fill(n, C, rmax, lmax);
  if (n == 0) return;
  probe_load_top(ix, index, key, n, top);
  const int64_t hi_key = __ldg(key + n - 1);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t v = __ldg(key + i);
    int32_t r = INT32_MIN, l = INT32_MIN;
    probe_lane(ix, index, top, key, n, hi_key, i, v, k, 0, canonical,
               [&](int p, int64_t lb, bool hit) { sib_fold(count, p, lb, hit, &r, &l); });
    int32_t e[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    probe_lane(ix, index, top, key, n, hi_key, i, v, k, 1, canonical,
               [&](int p, int64_t lb, bool hit) {
                 const int32_t c = hit ? __ldg(count + lb) : 0;
#pragma unroll
                 for (int q = 0; q < 8; ++q) {  // a register each, for any p
                   if (q == p) e[q] = c;
                 }
               });
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      rext[b * C + i] = e[2 * b];
      lext[b * C + i] = e[2 * b + 1];
    }
    rmax[i] = r;
    lmax[i] = l;
  }
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
extern "C" {

// n: the real lanes, min(spectrum n, C), at least 1; layout:
// SEARCH_LAYOUT_WORDS host words for a table of n lanes (ops/spectrum.py
// search_layout); scratch: exactly the index's words, or the call is refused;
// sms: the card's SM count.
int shannon_lookup_counts(const void* table, const void* count, int64_t n, const void* query,
                          int64_t n_query, void* scratch, int64_t scratch_words,
                          const void* layout, int sms, void* out, void* stream) {
  SearchIndex ix;
  if (sms < 1 || !search_index_from((const int64_t*)layout, n, scratch_words, &ix)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_query == 0) return (int)cudaGetLastError();
  cudaError_t err = search_build((const int64_t*)table, n, ix, scratch_words,
                                 (int64_t*)scratch, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  // at most SEARCH_TOP_WORDS keys of top a block, so COUNTS_BLOCKS_PER_SM
  // blocks fit an SM's shared memory
  const size_t smem = sizeof(int64_t) * (size_t)ix.top_size;
  const int64_t want = (n_query + SEARCH_THREADS - 1) / SEARCH_THREADS;
  const int64_t full = (int64_t)sms * COUNTS_BLOCKS_PER_SM;
  const unsigned int grid = (unsigned int)(want < full ? want : full);
  lookup_counts_kernel<<<grid, SEARCH_THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)table, (const int32_t*)count, (int)n, (const int64_t*)scratch, ix,
      (const int64_t*)query, n_query, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The launch of a kernel that walks the index of the real lanes key[0, n)
// of a table of C lanes with a lane a query and fills [n, C) of its outputs
// (K22, K28): the checks of both entry points, the index build where it has
// two levels or more, and the grid, persistent blocks of SEARCH_THREADS,
// at most per_sm an SM, enough for the walks and for fill_rows rows' zeros.
static cudaError_t lane_walk_setup(const int64_t* key, int64_t n, int64_t C, void* scratch,
                                   int64_t scratch_words, const void* layout, int sms,
                                   int per_sm, int fill_rows, cudaStream_t stream,
                                   SearchIndex* ix, size_t* smem, unsigned int* grid) {
  *ix = SearchIndex{};
  if (sms < 1 || n < 0 || n > C ||
      (n > 0 && !search_index_from((const int64_t*)layout, n, scratch_words, ix)) ||
      (ix->levels > 1 && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (n > 0 && ix->levels > 1) {
    cudaError_t err = search_build(key, n, *ix, scratch_words, (int64_t*)scratch, stream);
    if (err != cudaSuccess) return err;
  }
  // a block walks SEARCH_THREADS lanes at a time and fills 4 * SEARCH_THREADS
  // lanes of each row pair; at most SEARCH_TOP_WORDS keys of top a block, so
  // per_sm blocks fit an SM's shared memory
  *smem = sizeof(int64_t) * (size_t)ix->top_size;
  const int64_t walk = (n + SEARCH_THREADS - 1) / SEARCH_THREADS;
  const int64_t fill = ((C - n) * (fill_rows / 2) + 4 * SEARCH_THREADS - 1) / (4 * SEARCH_THREADS);
  const int64_t want = walk > fill ? walk : fill;
  const int64_t full = (int64_t)sms * per_sm;
  *grid = (unsigned int)(want < 1 ? 1 : (want < full ? want : full));
  return cudaSuccess;
}

// n: the real lanes, min(spectrum n, C); layout: SEARCH_LAYOUT_WORDS host
// words for a table of n lanes (ops/spectrum.py search_layout) and
// scratch_words exactly the index's words, or the call is refused (both
// unused, and may be null, at n = 0); scratch: those words, where the index
// has two levels or more (the kernel gathers a one-level top from the table
// itself, and reads no scratch); sms: the card's SM count.
int shannon_sibling_maxes(const void* key, const void* count, int64_t n, int64_t C, int k,
                          int canonical, void* scratch, int64_t scratch_words,
                          const void* layout, int sms, void* rmax, void* lmax, void* stream) {
  SearchIndex ix;
  size_t smem;
  unsigned int grid;
  cudaError_t err = lane_walk_setup((const int64_t*)key, n, C, scratch, scratch_words, layout,
                                    sms, SIB_BLOCKS_PER_SM, 2, (cudaStream_t)stream, &ix,
                                    &smem, &grid);
  if (err != cudaSuccess || C == 0) return (int)err;
  sibling_maxes_kernel<<<grid, SEARCH_THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)key, (const int32_t*)count, (int)n, C, (const int64_t*)scratch, ix, k,
      canonical, (int32_t*)rmax, (int32_t*)lmax);
  return (int)cudaGetLastError();
}

// The same arguments as shannon_sibling_maxes; rext, lext: [4, C] each, base
// b's row at b * C.
int shannon_neighbor_counts(const void* key, const void* count, int64_t n, int64_t C, int k,
                            int canonical, void* scratch, int64_t scratch_words,
                            const void* layout, int sms, void* rext, void* lext, void* rmax,
                            void* lmax, void* stream) {
  SearchIndex ix;
  size_t smem;
  unsigned int grid;
  cudaError_t err = lane_walk_setup((const int64_t*)key, n, C, scratch, scratch_words, layout,
                                    sms, NBR_BLOCKS_PER_SM, 10, (cudaStream_t)stream, &ix,
                                    &smem, &grid);
  if (err != cudaSuccess || C == 0) return (int)err;
  neighbor_counts_kernel<<<grid, SEARCH_THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)key, (const int32_t*)count, (int)n, C, (const int64_t*)scratch, ix, k,
      canonical, (int32_t*)rext, (int32_t*)lext, (int32_t*)rmax, (int32_t*)lmax);
  return (int)cudaGetLastError();
}

}  // extern "C"
