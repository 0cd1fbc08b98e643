// Count lookups in the sorted spectrum: kernels K21 (lookup_counts), K22
// (sibling_maxes) and K28 (neighbor_counts) of the shannon_tpu_torch port (plain C interface; see
// kernels.cu for the conventions every entry point follows).
//
// The spectrum is a sorted table of C int64 keys with int32 counts, PAD (with
// count 0) past its real entries.  K21 and K22 walk the 16-ary index of
// search.cuh over the real lanes (K22 with K7's probe-group steps,
// probe.cuh); K28 searches the whole table with K3's lower_bound_hit
// (common.cuh), so a key is found exactly where K3 finds it.

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
// in registers; no [8, C] probe table is stored.  About 3.7 walks a real
// lane remain of the 8 searches.  The walks' scattered loads bound the
// kernel by their L1 passes (search.cuh), not by a lane's chain of loads:
// on an H100 two walks a round (the odd one walked twice) took 5% longer on
// the flagship table, four in lock step 16% longer.  K7's job queue, which
// walks a query with 8 lanes, took 56 us on the same probes of the flagship
// table's real lanes (its [8, n] answers stored) against this kernel's 30.
// ---------------------------------------------------------------------------
#define SIB_BLOCKS_PER_SM 6

// The lower bound of q in table[0, n) and whether that lane holds q, for any
// q: a q above the table's last key (hi_key) gives n and a miss from a walk
// of hi_key (search_lane takes no query above it).
static __device__ __forceinline__ int sib_find(const SearchIndex& ix,
                                               const int64_t* __restrict__ index,
                                               const int64_t* top,
                                               const int64_t* __restrict__ table, int n,
                                               int64_t hi_key, int64_t q, bool* hit) {
  const bool above = q > hi_key;
  const int64_t w = above ? hi_key : q;
  bool h;
  const int lb = search_lane(ix, index, table, n, w, search_top(ix, top, w), &h);
  *hit = h && !above;
  return above ? n : lb;
}

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
  if (ix.levels == 1) {  // the top is level 1: each block gathers it from the table
    for (int w = threadIdx.x; w < ix.top_size; w += blockDim.x) {
      top[w] = __ldg(key + min(SEARCH_FANOUT * (w + 1), n) - 1);
    }
    __syncthreads();
  } else {
    search_load_top(ix, index, top);
  }
  const int64_t hi_key = __ldg(key + n - 1);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t v = __ldg(key + i);
    int32_t r = INT32_MIN, l = INT32_MIN;
    const int64_t ga = probe_group((uint64_t)v, k, 0, 0);
    unsigned walks = 0, shared = 0;  // bit p: probe p walks / steps from ga; bit 8: ga walks
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int64_t x = probe_key((uint64_t)v, k, p, 0, canonical);
      const int route = probe_route(x, v, ga, 0, 0);
      if (route == 0) {
        bool hit;
        const int64_t lb = x <= v ? step_down(key, i, v, x, &hit) : step_up(key, n, i + 1, x, &hit);
        sib_fold(count, p, lb, hit, &r, &l);
      } else if (route == 1) {
        shared |= 1u << p;
      } else {
        walks |= 1u << p;
      }
    }
    if (shared != 0) walks |= 1u << 8;
    int64_t lb_ga = 0;
    while (walks != 0) {  // job 8 is ga, the others probes
      const int a = __ffs(walks) - 1;
      walks &= walks - 1;
      const int64_t qa = a == 8 ? ga : probe_key((uint64_t)v, k, a, 0, canonical);
      bool ha;
      const int la = sib_find(ix, index, top, key, n, hi_key, qa, &ha);
      if (a == 8) {
        lb_ga = la;
      } else {
        sib_fold(count, a, la, ha, &r, &l);
      }
    }
    for (; shared != 0; shared &= shared - 1) {
      const int p = __ffs(shared) - 1;
      bool hit;
      const int64_t lb = step_up(key, n, lb_ga, probe_key((uint64_t)v, k, p, 0, canonical), &hit);
      sib_fold(count, p, lb, hit, &r, &l);
    }
    rmax[i] = r;
    lmax[i] = l;
  }
}

// ---------------------------------------------------------------------------
// K28: the counts of each entry's 4 right extensions (suffix.b) and 4 left
// extensions (b.prefix), and K22's two sibling maxima.
// Replaces shannon_tpu/ops/spectrum.py:212 neighbor_counts (its [16, C] probe
// tensor, canonical_hilo and the lookup_counts of the probes).  One thread
// per entry builds its 8 extension probes in registers
// (probe_key with side_ext), searches each with lower_bound_hit, then takes
// the sibling maxima with sibling_maxes_of, so no [16, C] tensor is stored.
// Row b of each [4, C] output is written at b * C + i: consecutive threads
// store consecutive words.  A PAD lane writes zeros without searching.
// Bound: the latency of 16 binary searches per real lane, not bandwidth
// (12 bytes read and 40 written a lane).
// ---------------------------------------------------------------------------
__global__ void neighbor_counts_kernel(const int64_t* __restrict__ key,
                                       const int32_t* __restrict__ count,
                                       int64_t C, int k, int canonical,
                                       int32_t* __restrict__ rext,
                                       int32_t* __restrict__ lext,
                                       int32_t* __restrict__ rmax,
                                       int32_t* __restrict__ lmax) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int64_t v = key[i];
  int32_t e[8];
  int32_t r = 0, l = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p) e[p] = 0;
  if (v != PAD_KEY) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      int64_t lane;
      if (lower_bound_hit(key, C, probe_key((uint64_t)v, k, p, 1, canonical), &lane)) {
        e[p] = count[lane];
      }
    }
    sibling_maxes_of(key, count, C, (uint64_t)v, k, canonical, &r, &l);
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    rext[b * C + i] = e[2 * b];
    lext[b * C + i] = e[2 * b + 1];
  }
  rmax[i] = r;
  lmax[i] = l;
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

// n: the real lanes, min(spectrum n, C); layout: SEARCH_LAYOUT_WORDS host
// words for a table of n lanes (ops/spectrum.py search_layout) and
// scratch_words exactly the index's words, or the call is refused (both
// unused, and may be null, at n = 0); scratch: those words, where the index
// has two levels or more (the kernel gathers a one-level top from the table
// itself, and reads no scratch); sms: the card's SM count.
int shannon_sibling_maxes(const void* key, const void* count, int64_t n, int64_t C, int k,
                          int canonical, void* scratch, int64_t scratch_words,
                          const void* layout, int sms, void* rmax, void* lmax, void* stream) {
  SearchIndex ix = {};
  if (sms < 1 || n < 0 || n > C ||
      (n > 0 && !search_index_from((const int64_t*)layout, n, scratch_words, &ix)) ||
      (ix.levels > 1 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (C == 0) return (int)cudaGetLastError();
  if (n > 0 && ix.levels > 1) {
    cudaError_t err = search_build((const int64_t*)key, n, ix, scratch_words,
                                   (int64_t*)scratch, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  // a block walks SEARCH_THREADS lanes at a time and fills 4 * SEARCH_THREADS
  // of the zeros; at most SEARCH_TOP_WORDS keys of top a block, so
  // SIB_BLOCKS_PER_SM blocks fit an SM's shared memory
  const size_t smem = sizeof(int64_t) * (size_t)ix.top_size;
  const int64_t walk = (n + SEARCH_THREADS - 1) / SEARCH_THREADS;
  const int64_t fill = (C - n + 4 * SEARCH_THREADS - 1) / (4 * SEARCH_THREADS);
  const int64_t want = walk > fill ? walk : fill;
  const int64_t full = (int64_t)sms * SIB_BLOCKS_PER_SM;
  const unsigned int grid = (unsigned int)(want < 1 ? 1 : (want < full ? want : full));
  sibling_maxes_kernel<<<grid, SEARCH_THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)key, (const int32_t*)count, (int)n, C, (const int64_t*)scratch, ix, k,
      canonical, (int32_t*)rmax, (int32_t*)lmax);
  return (int)cudaGetLastError();
}

int shannon_neighbor_counts(const void* key, const void* count, int64_t C, int k,
                            int canonical, void* rext, void* lext, void* rmax,
                            void* lmax, void* stream) {
  if (C > 0) {
    neighbor_counts_kernel<<<blocks_for(C), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)key, (const int32_t*)count, C, k, canonical,
        (int32_t*)rext, (int32_t*)lext, (int32_t*)rmax, (int32_t*)lmax);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
