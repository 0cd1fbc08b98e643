// Count lookups in the sorted spectrum: kernels K21 (lookup_counts), K22
// (sibling_maxes) and K28 (neighbor_counts) of the shannon_tpu_torch port (plain C interface; see
// kernels.cu for the conventions every entry point follows).
//
// The spectrum is a sorted table of C int64 keys with int32 counts, PAD (with
// count 0) past its real entries.  K21 walks the 16-ary index of
// search.cuh over the real lanes; K22 and K28 search the whole table with
// K3's lower_bound_hit (common.cuh), so a key is found exactly where K3
// finds it.

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
// tensor, canonical_hilo and the lookup_counts of the probes).  One thread
// per entry builds its eight probes in registers (probe_key, K7's bit
// operations), searches each and keeps the two maxima (sibling_maxes_of in
// common.cuh), so no [8, C] tensor is stored.  A PAD lane writes (0, 0)
// without searching.
// Bound: the latency of 8 binary searches per real lane (the loop keeps them
// in flight together), not bandwidth.
// ---------------------------------------------------------------------------
__global__ void sibling_maxes_kernel(const int64_t* __restrict__ key,
                                     const int32_t* __restrict__ count,
                                     int64_t C, int k, int canonical,
                                     int32_t* __restrict__ rmax,
                                     int32_t* __restrict__ lmax) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int64_t v = key[i];
  int32_t r = 0, l = 0;
  if (v != PAD_KEY) sibling_maxes_of(key, count, C, (uint64_t)v, k, canonical, &r, &l);
  rmax[i] = r;
  lmax[i] = l;
}

// ---------------------------------------------------------------------------
// K28: the counts of each entry's 4 right extensions (suffix.b) and 4 left
// extensions (b.prefix), and K22's two sibling maxima.
// Replaces shannon_tpu/ops/spectrum.py:212 neighbor_counts (its [16, C] probe
// tensor, canonical_hilo and the lookup_counts of the probes).  K22's design:
// one thread per entry builds its 8 extension probes in registers
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

int shannon_sibling_maxes(const void* key, const void* count, int64_t C, int k,
                          int canonical, void* rmax, void* lmax, void* stream) {
  if (C > 0) {
    sibling_maxes_kernel<<<blocks_for(C), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)key, (const int32_t*)count, C, k, canonical,
        (int32_t*)rmax, (int32_t*)lmax);
  }
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
