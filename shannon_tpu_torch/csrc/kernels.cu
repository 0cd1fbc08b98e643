// Hand-written Hopper (sm_90a) kernels of the shannon_tpu_torch port: the
// k-mer kernels K1-K3 (threading's K4-K5 are in thread.cu, the sparse-flow
// solver K6 in sparseflow.cu, correction's K7-K10 in correction.cu).
//
// Plain C interface, built with nvcc into build/kernels/libshannon_kernels.so
// and bound with ctypes (shannon_tpu_torch/kernels.py).  Every entry point
// launches on the stream it is given, allocates nothing (the Python wrapper
// allocates every output and scratch buffer with torch.empty) and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// A k-mer is one int64 key: 2k bits, base i of the window at bits
// [2(k-1-i), 2(k-1-i)+2).  k <= 31, so real keys are below 2^62 and the pad
// key 2^63-1 sorts after every real key under signed comparison.

#include "common.cuh"

// ---------------------------------------------------------------------------
// K1: k-mer extraction from 2-bit packed reads.
// Replaces shannon_tpu/ops/kmers.py:151 extract_kmers_packed (with
// unpack_words_device :131, unpack_mask_device :142, _windows_from_c32 :78,
// revcomp_hilo :49, canonical_hilo :69).
// Bound: memory.  Each window writes 9 bytes (key + valid) and reads a few
// words of its read row, which neighbouring threads share through L1.  One
// thread per (read, window), consecutive threads on consecutive windows of a
// row, so the key and valid stores are coalesced; the forward key and its
// reverse complement are built in the same k-step loop, so canonical mode
// costs no second pass.
// ---------------------------------------------------------------------------
__global__ void extract_kmers_kernel(const uint32_t* __restrict__ words,
                                     const int32_t* __restrict__ lengths,
                                     const uint32_t* __restrict__ mask,
                                     int64_t n_reads, int words_per_row,
                                     int mask_words_per_row, int n_windows,
                                     int k, int canonical,
                                     int64_t* __restrict__ keys,
                                     uint8_t* __restrict__ valid) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_reads * (int64_t)n_windows) return;
  int64_t r = t / n_windows;
  int j = (int)(t - r * n_windows);
  const uint32_t* row = words + r * words_per_row;
  bool ok = j + k <= lengths[r];
  uint64_t fwd = 0, rc = 0;
  for (int i = 0; i < k; ++i) {
    int p = j + i;
    uint64_t c = (row[p >> 4] >> (2 * (p & 15))) & 3u;
    fwd = (fwd << 2) | c;
    rc |= (3ull - c) << (2 * i);
    if (mask != nullptr &&
        ((mask[r * mask_words_per_row + (p >> 5)] >> (p & 31)) & 1u)) {
      ok = false;
    }
  }
  uint64_t v = (canonical && rc < fwd) ? rc : fwd;
  keys[t] = ok ? (int64_t)v : PAD_KEY;
  valid[t] = ok ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K2: run reduction of a sorted key array into a capacity-padded table.
// Replaces shannon_tpu/ops/count.py:196-211 _spectrum_from_windows ->
// :158 _unique_reduce_unit (unit counts) and :110 _unique_reduce (merge:
// counts as prefix-sum differences).  The sort itself stays torch.sort.
// Bound: memory; three streaming passes over the sorted keys with a
// torch.cumsum of the run-start flags between the first two.  The TPU
// compacted with a second sort because scatters were slow there; here the
// run starts scatter straight to their slot (slot = inclusive scan - 1).
// ---------------------------------------------------------------------------
__global__ void run_start_flags_kernel(const int64_t* __restrict__ keys,
                                       int64_t m, int32_t* __restrict__ flags) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int64_t key = keys[i];
  flags[i] = (key != PAD_KEY && (i == 0 || keys[i - 1] != key)) ? 1 : 0;
}

// start has capacity + 1 lanes: start[s] is the first lane of run s, and
// start[n] (when n <= capacity) is one past the last real lane.
__global__ void scatter_runs_kernel(const int64_t* __restrict__ keys,
                                    const int32_t* __restrict__ scan,
                                    int64_t m, int64_t capacity,
                                    int64_t* __restrict__ out_key,
                                    int64_t* __restrict__ start) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int64_t key = keys[i];
  if (key == PAD_KEY) return;
  int64_t slot = (int64_t)scan[i] - 1;
  if (i == 0 || keys[i - 1] != key) {
    if (slot < capacity) out_key[slot] = key;
    if (slot <= capacity) start[slot] = i;
  }
  if ((i == m - 1 || keys[i + 1] == PAD_KEY) && slot + 1 <= capacity) {
    start[slot + 1] = i + 1;
  }
}

// prefix: exclusive prefix sum of the per-lane counts, m + 1 lanes, or
// null for unit counts (every real lane counts one).
__global__ void finalize_runs_kernel(const int32_t* __restrict__ scan,
                                     int64_t m,
                                     const int64_t* __restrict__ prefix,
                                     int64_t capacity,
                                     const int64_t* __restrict__ start,
                                     int64_t* __restrict__ out_key,
                                     int32_t* __restrict__ out_count) {
  int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= capacity) return;
  int64_t n = m > 0 ? (int64_t)scan[m - 1] : 0;
  if (s < n) {
    int64_t a = start[s], b = start[s + 1];
    out_count[s] = (int32_t)(prefix != nullptr ? prefix[b] - prefix[a] : b - a);
  } else {
    out_key[s] = PAD_KEY;
    out_count[s] = 0;
  }
}

// ---------------------------------------------------------------------------
// K3: exact-hit lookup of query keys in a sorted table.
// Replaces shannon_tpu/ops/spectrum.py:137 lookup_hilo (:71 join_lookup_hilo,
// :28 lower_bound_hilo).  Bound: latency of the dependent loads of a binary
// search (log2(C) steps of 8 bytes).  One thread per query; the first steps
// of every search read the same few lanes, which stay in L1/L2, and the
// 50 MB L2 holds a table of a few million keys whole.  idx is the lower bound
// clamped to C - 1, so a miss still returns a valid lane (lower_bound_hit in
// common.cuh, shared with K7).
// ---------------------------------------------------------------------------
__global__ void lookup_sorted_kernel(const int64_t* __restrict__ table,
                                     int64_t table_len,
                                     const int64_t* __restrict__ query,
                                     int64_t n_query, int64_t* __restrict__ idx,
                                     uint8_t* __restrict__ hit) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_query) return;
  int64_t i;
  bool found = lower_bound_hit(table, table_len, query[t], &i);
  idx[t] = i;
  hit[t] = found ? 1 : 0;
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
extern "C" {

const char* shannon_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int shannon_extract_kmers(const void* words, const void* lengths,
                          const void* mask, int64_t n_reads, int words_per_row,
                          int mask_words_per_row, int n_windows, int k,
                          int canonical, void* keys, void* valid,
                          void* stream) {
  int64_t total = n_reads * (int64_t)n_windows;
  if (total > 0) {
    extract_kmers_kernel<<<blocks_for(total), THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const int32_t*)lengths,
        (const uint32_t*)mask, n_reads, words_per_row, mask_words_per_row,
        n_windows, k, canonical, (int64_t*)keys, (uint8_t*)valid);
  }
  return (int)cudaGetLastError();
}

int shannon_run_start_flags(const void* keys, int64_t m, void* flags,
                            void* stream) {
  if (m > 0) {
    run_start_flags_kernel<<<blocks_for(m), THREADS, 0,
                             (cudaStream_t)stream>>>((const int64_t*)keys, m,
                                                     (int32_t*)flags);
  }
  return (int)cudaGetLastError();
}

int shannon_reduce_runs(const void* keys, const void* scan, int64_t m,
                        const void* prefix, int64_t capacity, void* out_key,
                        void* out_count, void* start, void* stream) {
  if (m > 0) {
    scatter_runs_kernel<<<blocks_for(m), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)keys, (const int32_t*)scan, m, capacity,
        (int64_t*)out_key, (int64_t*)start);
  }
  if (capacity > 0) {
    finalize_runs_kernel<<<blocks_for(capacity), THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)scan, m, (const int64_t*)prefix, capacity,
        (const int64_t*)start, (int64_t*)out_key, (int32_t*)out_count);
  }
  return (int)cudaGetLastError();
}

int shannon_lookup_sorted(const void* table, int64_t table_len,
                          const void* query, int64_t n_query, void* idx,
                          void* hit, void* stream) {
  if (n_query > 0) {
    lookup_sorted_kernel<<<blocks_for(n_query), THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const int64_t*)table, table_len, (const int64_t*)query, n_query,
        (int64_t*)idx, (uint8_t*)hit);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
