// Count lookups in the sorted spectrum: kernels K21 (lookup_counts), K22
// (sibling_maxes) and K28 (neighbor_counts) of the shannon_tpu_torch port (plain C interface; see
// kernels.cu for the conventions every entry point follows).
//
// The spectrum is a sorted table of C int64 keys with int32 counts, PAD (with
// count 0) past its real entries.  Both kernels search it with K3's
// lower_bound_hit (common.cuh), so a key is found exactly where K3 finds it.

#include "common.cuh"

// ---------------------------------------------------------------------------
// K21: the count of each query key.
// Replaces shannon_tpu/ops/spectrum.py:60 lookup_counts (with :137
// lookup_hilo).  One thread per query, in the query's own order, so the
// query loads and the count stores are coalesced: a binary search, then the
// count of the lane where it hits, 0 on a miss.  A PAD query hits a PAD lane
// and returns its count, 0, as the reference's SENTINEL query does.
// Bound: the latency of the dependent loads of a binary search (log2(C)
// steps per query), not bandwidth.
// ---------------------------------------------------------------------------
__global__ void lookup_counts_kernel(const int64_t* __restrict__ table,
                                     const int32_t* __restrict__ count,
                                     int64_t C, const int64_t* __restrict__ query,
                                     int64_t n_query, int32_t* __restrict__ out) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_query) return;
  int64_t lane;
  out[t] = lower_bound_hit(table, C, query[t], &lane) ? count[lane] : 0;
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

int shannon_lookup_counts(const void* table, const void* count, int64_t C,
                          const void* query, int64_t n_query, void* out,
                          void* stream) {
  if (C > 0 && n_query > 0) {
    lookup_counts_kernel<<<blocks_for(n_query), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)table, (const int32_t*)count, C, (const int64_t*)query,
        n_query, (int32_t*)out);
  }
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
