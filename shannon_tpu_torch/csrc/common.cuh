// Definitions shared by the port's kernel sources (shannon_tpu_torch/csrc).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PAD_KEY 0x7FFFFFFFFFFFFFFFLL
#define THREADS 256

static inline unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + THREADS - 1) / THREADS);
}

// Binary search of `key` in the sorted table[0, table_len) (table_len >= 1):
// the lower bound clamped to table_len - 1 goes to *idx, and the result says
// whether that lane holds the key.  K3 (lookup_sorted) and K7 (probe_lookup)
// share it, so both give the same (idx, hit) for the same query.
static __device__ __forceinline__ bool lower_bound_hit(
    const int64_t* __restrict__ table, int64_t table_len, int64_t key,
    int64_t* idx) {
  int64_t lo = 0, hi = table_len;
  while (lo < hi) {
    int64_t mid = lo + ((hi - lo) >> 1);
    if (table[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int64_t i = lo < table_len ? lo : table_len - 1;
  *idx = i;
  return table[i] == key;
}
