// The probe-group shortcuts of K7 (probe_lookup, correction.cu), K22
// (sibling_maxes) and K28 (neighbor_counts, spectrum.cu): which probes of a
// lane of a sorted table of distinct keys resolve without a search of their
// own, and the steps that resolve them.  A probe x whose group x & ~3 is its
// lane's own (a right sibling kept in forward form) has its lower bound
// within lanes i - 3 .. i + 3; one whose group is a shared one (sib's left
// siblings in reverse-complement form share rc(v) & ~3; ext's right
// extensions in forward form share (v << 2) & mask, its left extensions in
// reverse-complement form (rc(v) << 2) & mask) lies within 3 lanes above
// that group's lower bound.  Both steps are exact on any sorted table; they
// are short because a spectrum's keys are distinct.  probe_lane resolves
// one real lane's 8 probes of a side with them, a lane a query on the
// search index of search.cuh: K22 and K28 share it, so the two cannot drift
// apart.
#pragma once

#include "common.cuh"
#include "search.cuh"

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


// The lower bound of q in table[0, n) and whether that lane holds q, for any
// q: a q above the table's last key (hi_key) gives n and a miss from a walk
// of hi_key (search_lane takes no query above it).
static __device__ __forceinline__ int probe_find(const SearchIndex& ix,
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

// Resolves the 8 probes of side side_ext (probe_key's rows) of real lane i,
// key v, of the sorted table key[0, n) of distinct keys (hi_key = key[n -
// 1]), on its search index (ix, index, top: search_top's top in shared
// memory), and calls sink(p, lb, hit) once for each probe p with its lower
// bound in [0, n] and whether that lane holds it.  The routes of K7's group
// rule (probe_route):
//  - a probe in the lane's own group steps from lane i (down from i where
//    it is <= v, else up from i + 1);
//  - a probe in group job 8 (ga) or 9 (gb, ext only) steps up from that
//    group's lower bound, which one walk gives;
//  - every other probe walks (probe_find), one walk at a time: the walks'
//    scattered loads bound the search by their L1 passes (search.cuh), and
//    walks in lock step were slower on an H100 (K22, 5-67%).
// At most 8 walks a side: a probe that walks takes no group walk.
template <typename Sink>
static __device__ __forceinline__ void probe_lane(const SearchIndex& ix,
                                                  const int64_t* __restrict__ index,
                                                  const int64_t* top,
                                                  const int64_t* __restrict__ key, int n,
                                                  int64_t hi_key, int64_t i, int64_t v, int k,
                                                  int side_ext, int canonical, Sink sink) {
  const int64_t ga = probe_group((uint64_t)v, k, side_ext, 0);
  const int64_t gb = side_ext ? probe_group((uint64_t)v, k, side_ext, 1) : ga;
  // bit p: probe p walks, steps from ga or steps from gb; walk bits 8 and 9:
  // ga and gb
  unsigned walks = 0, via_a = 0, via_b = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int64_t x = probe_key((uint64_t)v, k, p, side_ext, canonical);
    const int route = probe_route(x, v, ga, gb, side_ext);
    if (route == 0) {
      bool hit;
      const int64_t lb = x <= v ? step_down(key, i, v, x, &hit) : step_up(key, n, i + 1, x, &hit);
      sink(p, lb, hit);
    } else if (route == 1) {
      via_a |= 1u << p;
    } else if (route == 2) {
      via_b |= 1u << p;
    } else {
      walks |= 1u << p;
    }
  }
  if (via_a != 0) walks |= 1u << 8;
  if (via_b != 0) walks |= 1u << 9;
  int64_t lb_ga = 0, lb_gb = 0;
  while (walks != 0) {
    const int a = __ffs(walks) - 1;
    walks &= walks - 1;
    const int64_t qa = a == 8 ? ga : a == 9 ? gb : probe_key((uint64_t)v, k, a, side_ext, canonical);
    bool ha;
    const int la = probe_find(ix, index, top, key, n, hi_key, qa, &ha);
    if (a == 8) {
      lb_ga = la;
    } else if (a == 9) {
      lb_gb = la;
    } else {
      sink(a, la, ha);
    }
  }
  for (unsigned left = via_a | via_b << 8; left != 0; left &= left - 1) {
    const int b = __ffs(left) - 1, p = b & 7;
    bool hit;
    const int64_t lb = step_up(key, n, b < 8 ? lb_ga : lb_gb,
                               probe_key((uint64_t)v, k, p, side_ext, canonical), &hit);
    sink(p, lb, hit);
  }
}

// The top level of a lane walk's index in shared memory: the built index's
// (search_load_top) or, where the index has one level (n <= SEARCH_FANOUT x
// SEARCH_TOP_WORDS), the last key of each 16-lane line gathered from the
// table itself, so no build launch runs.  Every thread calls it; it ends
// with __syncthreads().
static __device__ __forceinline__ void probe_load_top(const SearchIndex& ix,
                                                      const int64_t* __restrict__ index,
                                                      const int64_t* __restrict__ key, int n,
                                                      int64_t* top) {
  if (ix.levels == 1) {
    for (int w = threadIdx.x; w < ix.top_size; w += blockDim.x) {
      top[w] = __ldg(key + min(SEARCH_FANOUT * (w + 1), n) - 1);
    }
    __syncthreads();
  } else {
    search_load_top(ix, index, top);
  }
}
