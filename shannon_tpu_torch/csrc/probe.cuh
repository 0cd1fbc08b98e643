// The probe-group shortcuts of K7 (probe_lookup, correction.cu) and K22
// (sibling_maxes, spectrum.cu): which probes of a lane of a sorted table of
// distinct keys resolve without a search of their own, and the steps that
// resolve them.  A probe x whose group x & ~3 is its lane's own (a right
// sibling kept in forward form) has its lower bound within lanes i - 3 ..
// i + 3; one whose group is a shared one (sib's left siblings in
// reverse-complement form share rc(v) & ~3) lies within 3 lanes above that
// group's lower bound.  Both steps are exact on any sorted table; they are
// short because a spectrum's keys are distinct.
#pragma once

#include "common.cuh"

// Group job g of lane key v (its low two bits 0): g = 0 is sib's
// reverse-complement left-sibling group rc(v) & ~3 or ext's forward
// right-extension group (v << 2) & mask, g = 1 ext's reverse-complement
// left-extension group (rc(v) << 2) & mask.
static __device__ __forceinline__ int64_t probe_group(uint64_t v, int k, int side_ext, int g) {
  const uint64_t mask = (1ull << (2 * k)) - 1;
  const uint64_t rc = revcomp_bits(v, k);
  if (g == 0) return (int64_t)(side_ext ? ((v << 2) & mask) : (rc & ~3ull));
  return (int64_t)((rc << 2) & mask);
}

// How a real lane of key v resolves probe key x: 0 in its own group, 1 or 2
// from group job 8 (ga) or 9 (gb, ext only), 3 by its own walk.
static __device__ __forceinline__ int probe_route(int64_t x, int64_t v, int64_t ga,
                                                  int64_t gb, int side_ext) {
  const int64_t g = x & ~3ll;
  if (g == (v & ~3ll)) return 0;
  if (g == ga) return 1;
  if (side_ext && g == gb) return 2;
  return 3;
}

// The lower bound of x in table[0, C), stepping up from lane j (at or below
// it); *hit whether that lane holds x.
static __device__ __forceinline__ int64_t step_up(const int64_t* __restrict__ table, int64_t C,
                                                  int64_t j, int64_t x, bool* hit) {
  int64_t t = x;
  while (j < C) {
    t = table[j];
    if (t >= x) break;
    ++j;
  }
  *hit = j < C && t == x;
  return j;
}

// The lower bound of x, stepping down from lane j, whose key t is >= x.
static __device__ __forceinline__ int64_t step_down(const int64_t* __restrict__ table, int64_t j,
                                                    int64_t t, int64_t x, bool* hit) {
  while (j > 0) {
    const int64_t u = table[j - 1];
    if (u < x) break;
    --j;
    t = u;
  }
  *hit = t == x;
  return j;
}

