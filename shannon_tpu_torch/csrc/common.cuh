// Definitions shared by the port's kernel sources (shannon_tpu_torch/csrc).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PAD_KEY 0x7FFFFFFFFFFFFFFFLL
#define THREADS 256

static inline unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + THREADS - 1) / THREADS);
}

// Reverse complement of the low 2k bits of a key (k <= 31): complement,
// reverse the 64 bits, swap the two bits of each base back, shift down.  Bits
// above 2k are ignored, as ops/kmers.revcomp_key ignores them.  K7
// (probe_lookup) and K11/K14 (node_strands, contig_reduce) share it.
static __device__ __forceinline__ uint64_t revcomp_bits(uint64_t key, int k) {
  const uint64_t mask = (1ull << (2 * k)) - 1;
  uint64_t r = __brevll(~key & mask);
  r = ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
  return r >> (64 - 2 * k);
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
