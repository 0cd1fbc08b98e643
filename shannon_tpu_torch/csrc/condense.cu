// de Bruijn condensation kernels K11-K15 of the shannon_tpu_torch port (plain
// C interface; see kernels.cu for the conventions every entry point follows).
//
// The node table is C2 sorted int64 keys, PAD past its real nodes.  Lanes,
// pointers, contig ids and offsets are int64; counts int32.  Every output is
// written over its full capacity, pads included, with exactly the values the
// plain versions in shannon_tpu_torch/ops/condense.py leave there.

#include "common.cuh"

// ---------------------------------------------------------------------------
// K11: oriented node table (both strands of each canonical k-mer).
// Replaces shannon_tpu/ops/condense.py:82 _nodes_stage.  The reference sorted
// (key, count) pairs of both strands and kept each run's first payload.  Here
// node_strands_kernel writes the keys alone, torch.sort sorts them, K2 dedupes
// the palindromes (a palindrome is its own reverse complement, so it appears
// twice), and node_counts_kernel gives each node the count of its canonical
// k-mer by K3's binary search in the spectrum: the payload sort and the two
// payload gathers of the plain version are never needed.
// Bound: memory for the strands pass (8 bytes read, 16 written a lane); the
// count pass is a binary search per node, bounded by the latency of its
// dependent loads (the spectrum of a few million keys stays in the 50 MB L2).
// ---------------------------------------------------------------------------
__global__ void node_strands_kernel(const int64_t* __restrict__ key, int64_t C,
                                    int k, int64_t* __restrict__ both) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int64_t v = key[i];
  both[i] = v;
  both[C + i] = v == PAD_KEY ? PAD_KEY : (int64_t)revcomp_bits((uint64_t)v, k);
}

// The spectrum holds canonical keys, so a node and its reverse complement
// share the spectrum entry min(v, revcomp(v)).
__global__ void node_counts_kernel(const int64_t* __restrict__ node_key,
                                   int64_t C2, const int64_t* __restrict__ table,
                                   const int32_t* __restrict__ table_count,
                                   int64_t C, int k,
                                   int32_t* __restrict__ node_count) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  const int64_t v = node_key[i];
  int32_t c = 0;
  if (v != PAD_KEY) {
    const int64_t rc = (int64_t)revcomp_bits((uint64_t)v, k);
    int64_t lane;
    if (lower_bound_hit(table, C, rc < v ? rc : v, &lane)) c = table_count[lane];
  }
  node_count[i] = c;
}

// ---------------------------------------------------------------------------
// K12: mergeable links and the successor directory from one (k-1)-mer group
// join.  Replaces shannon_tpu/ops/condense.py:109 _links_stage.
// Every node gives a source record (its (k-1)-suffix) and a target record (its
// (k-1)-prefix); link_records_kernel writes their sort keys (k-1)-mer * 2 +
// side, PAD for pad nodes, and torch.sort(stable=True) orders them, so a group
// is its sources then its targets, each in lane order (the order prev_link and
// the successor runs are read in).  group_links_kernel runs one thread per
// sorted record.  Node keys are distinct, so a group holds at most 4 sources
// and 4 targets, and the thread finds its group's start, first target and end
// by stepping over its neighbours (at most 7 loads, from cache) instead of the
// reference's cummax/cumsum passes.  Each lane has exactly one source and one
// target record, so the scatters to node order never collide: they replace the
// reference's unsort sort.
// Bound: memory (the records' 16 bytes read, 8 written a record, and 24 bytes
// of node-order outputs a lane).
// ---------------------------------------------------------------------------
__global__ void link_records_kernel(const int64_t* __restrict__ node_key,
                                    int64_t C2, int k,
                                    int64_t* __restrict__ sort_key) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  const int64_t v = node_key[i];
  if (v == PAD_KEY) {
    sort_key[i] = PAD_KEY;
    sort_key[C2 + i] = PAD_KEY;
    return;
  }
  const int64_t suf = v & (int64_t)((1ull << (2 * (k - 1))) - 1);
  sort_key[i] = suf * 2;
  sort_key[C2 + i] = (v >> 2) * 2 + 1;
}

__global__ void group_links_kernel(const int64_t* __restrict__ skey,
                                   const int64_t* __restrict__ order,
                                   int64_t C2, int64_t* __restrict__ prev_link,
                                   int64_t* __restrict__ rec_lane,
                                   int64_t* __restrict__ first_p,
                                   int64_t* __restrict__ p_cnt) {
  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t m = 2 * C2;
  if (r >= m) return;
  const int64_t o = order[r];
  const bool target = o >= C2;
  const int64_t lane = target ? o - C2 : o;
  rec_lane[r] = lane;
  const int64_t s = skey[r];
  if (s == PAD_KEY) {  // pad records form no group
    if (target) {
      prev_link[lane] = -1;
    } else {
      first_p[lane] = 0;
      p_cnt[lane] = 0;
    }
    return;
  }
  // (PAD >> 1) is above every real (k-1)-mer, so the scans stop at the pads
  const int64_t g = s >> 1;
  int64_t g0 = r;
  while (g0 > 0 && (skey[g0 - 1] >> 1) == g) --g0;
  int64_t end = r + 1;
  while (end < m && (skey[end] >> 1) == g) ++end;
  int64_t fp = g0;
  while (fp < end && (skey[fp] & 1) == 0) ++fp;
  if (target) {
    const bool single = fp - g0 == 1 && end - fp == 1;
    const int64_t o0 = order[g0];
    prev_link[lane] = single ? (o0 >= C2 ? o0 - C2 : o0) : -1;
  } else {
    first_p[lane] = fp;
    p_cnt[lane] = end - fp;
  }
}

// ---------------------------------------------------------------------------
// K13: one round of pointer doubling to the chain heads, and one round of the
// min-propagating cycle cut.
// Replaces shannon_tpu/ops/condense.py:232 _label_stage (one while_loop round)
// and :264 _cycle_fix (one fori_loop round).  Jacobi rounds: each launch reads
// the previous round's buffers and writes new ones, so every lane steps from
// the same state, as the reference does.  The first round (ptr_in null) builds
// the starting pointers from prev_link in registers, so no init pass runs.
// label_round sets *changed when any pointer moved (the host loop stops at the
// first round that moves none); after the last round label_roots sets
// *has_cycle when any root still has a predecessor, the reference's has_cycle.
// Each block votes (__syncthreads_or) and stores the flag once: a store from
// every lane that moved would put millions of stores on one word.  The entry
// points zero the flags first.  The last cycle round writes the cut links
// (prev = -1 at each cycle's minimum lane) instead of its pointers.
// Bound: memory; a lane reads its own pointer and value and gathers those of
// its target, then writes 16 bytes.  The gathers are random over C2 lanes.
// ---------------------------------------------------------------------------
__global__ void label_round_kernel(const int64_t* __restrict__ prev,
                                   const int64_t* __restrict__ ptr_in,
                                   const int64_t* __restrict__ dist_in,
                                   int64_t C2, int64_t* __restrict__ ptr_out,
                                   int64_t* __restrict__ dist_out,
                                   int32_t* __restrict__ changed) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool moved = false;
  if (i < C2) {
    int64_t p, d, np, dp;
    if (ptr_in == nullptr) {
      const int64_t pv = prev[i];
      p = pv >= 0 ? pv : i;
      d = pv >= 0 ? 1 : 0;
      const int64_t pp = prev[p];
      np = pp >= 0 ? pp : p;
      dp = pp >= 0 ? 1 : 0;
    } else {
      p = ptr_in[i];
      d = dist_in[i];
      np = ptr_in[p];
      dp = dist_in[p];
    }
    ptr_out[i] = np;
    dist_out[i] = d + dp;
    moved = np != p;
  }
  if (__syncthreads_or(moved) && threadIdx.x == 0) *changed = 1;
}

__global__ void label_roots_kernel(const int64_t* __restrict__ prev,
                                   const int64_t* __restrict__ ptr, int64_t C2,
                                   int32_t* __restrict__ has_cycle) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool cyc = i < C2 && prev[ptr[i]] >= 0;
  if (__syncthreads_or(cyc) && threadIdx.x == 0) *has_cycle = 1;
}

__global__ void cycle_round_kernel(const int64_t* __restrict__ prev,
                                   const int64_t* __restrict__ ptr_in,
                                   const int64_t* __restrict__ mn_in,
                                   int64_t C2, int last,
                                   int64_t* __restrict__ ptr_out,
                                   int64_t* __restrict__ mn_out,
                                   int64_t* __restrict__ prev_out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  int64_t p, mn, np, mp;
  if (ptr_in == nullptr) {
    const int64_t pv = prev[i];
    p = pv >= 0 ? pv : i;
    mn = i;
    const int64_t pp = prev[p];
    np = pp >= 0 ? pp : p;
    mp = p;
  } else {
    p = ptr_in[i];
    mn = mn_in[i];
    np = ptr_in[p];
    mp = mn_in[p];
  }
  mn = mp < mn ? mp : mn;
  if (last) {
    prev_out[i] = (prev[np] >= 0 && mn == i) ? -1 : prev[i];
  } else {
    ptr_out[i] = np;
    mn_out[i] = mn;
  }
}

// ---------------------------------------------------------------------------
// K14: per-contig reduction, contig edges and reverse-complement twins.
// Replaces shannon_tpu/ops/condense.py:287 _reduce_stage.  The reference
// sorted the nodes by (cid, offset) and compacted run starts and ends with two
// more sorts.  Here contig ids come from one torch.cumsum of head_flags_kernel's
// flags (cid = rank of the chain head), and the reductions need no order:
// contig_lanes_kernel adds each node into its contig's klen and count sum with
// int64 atomics (integer sums, so exact whatever the order) and writes the
// head lane (offset 0); contig_tails_kernel writes the tail lane (offset
// klen - 1); contig_edges_kernel runs one thread per contig for the float32
// abundance (count_sum / klen, each converted and divided with round-to-nearest
// intrinsics, so it is bit-equal to the plain version's and the host's
// recomputation), the successor run of the tail node in the link records, and
// the reverse-complement twin by K3's binary search.  Every head and tail slot
// is written by exactly one lane; the entry point zeroes klen and count_sum and
// fills head_lane and tail_lane with -1 first.
// Bound: memory for the lane passes; the twin search, one per contig, is
// bounded by the latency of its dependent loads.
// ---------------------------------------------------------------------------
__global__ void head_flags_kernel(const int64_t* __restrict__ node_key,
                                  const int64_t* __restrict__ prev2, int64_t C2,
                                  int32_t* __restrict__ flags) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  flags[i] = (node_key[i] != PAD_KEY && prev2[i] < 0) ? 1 : 0;
}

__global__ void contig_lanes_kernel(const int64_t* __restrict__ node_key,
                                    const int32_t* __restrict__ node_count,
                                    const int64_t* __restrict__ prev2,
                                    const int64_t* __restrict__ head_ptr,
                                    const int64_t* __restrict__ dist,
                                    const int32_t* __restrict__ scan, int64_t C2,
                                    int64_t* __restrict__ node_cid,
                                    int64_t* __restrict__ node_off,
                                    int64_t* __restrict__ klen,
                                    int64_t* __restrict__ count_sum,
                                    int64_t* __restrict__ head_lane) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  if (node_key[i] == PAD_KEY) {
    node_cid[i] = -1;
    node_off[i] = -1;
    return;
  }
  const int64_t h = head_ptr[i];
  const bool h_is_head = node_key[h] != PAD_KEY && prev2[h] < 0;
  const int64_t cid = h_is_head ? (int64_t)scan[h] - 1 : -1;
  const int64_t off = dist[i];
  node_cid[i] = cid;
  node_off[i] = off;
  if (cid < 0) return;
  atomicAdd(reinterpret_cast<unsigned long long*>(klen + cid), 1ull);
  atomicAdd(reinterpret_cast<unsigned long long*>(count_sum + cid),
            (unsigned long long)(int64_t)node_count[i]);
  if (off == 0) head_lane[cid] = i;
}

__global__ void contig_tails_kernel(const int64_t* __restrict__ node_cid,
                                    const int64_t* __restrict__ node_off,
                                    const int64_t* __restrict__ klen, int64_t C2,
                                    int64_t* __restrict__ tail_lane) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  const int64_t cid = node_cid[i];
  if (cid >= 0 && node_off[i] == klen[cid] - 1) tail_lane[cid] = i;
}

__global__ void contig_edges_kernel(const int64_t* __restrict__ node_key,
                                    const int64_t* __restrict__ dist,
                                    const int64_t* __restrict__ rec_lane,
                                    const int64_t* __restrict__ first_p,
                                    const int64_t* __restrict__ p_cnt,
                                    const int64_t* __restrict__ node_cid,
                                    const int64_t* __restrict__ klen,
                                    const int64_t* __restrict__ count_sum,
                                    const int64_t* __restrict__ tail_lane,
                                    int64_t C2, int k, int canonical,
                                    float* __restrict__ abundance,
                                    int64_t* __restrict__ out_edges,
                                    int64_t* __restrict__ rc_pair) {
  int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C2) return;
  const int64_t kl = klen[c];
  abundance[c] = kl > 0 ? __fdiv_rn(__ll2float_rn(count_sum[c]), __ll2float_rn(kl))
                        : 0.0f;
  const int64_t tl = tail_lane[c];
  int64_t fp = 0, pc = 0;
  if (tl >= 0) {
    fp = first_p[tl];
    pc = p_cnt[tl];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out_edges[j * C2 + c] = j < pc ? node_cid[rec_lane[fp + j]] : -1;
  }
  int64_t rc = c;
  if (canonical && tl >= 0) {
    int64_t idx;
    const int64_t q = (int64_t)revcomp_bits((uint64_t)node_key[tl], k);
    if (lower_bound_hit(node_key, C2, q, &idx) && dist[idx] == 0) rc = node_cid[idx];
  }
  rc_pair[c] = rc;
}

// ---------------------------------------------------------------------------
// K15: the contig base streams.
// Replaces shannon_tpu/ops/condense.py:417 contig_base_streams, which sorted
// the nodes by (cid, offset) to lay out their last bases.  Offsets within a
// contig are 0..klen-1, so each node's slot is known: tails_stream_kernel
// writes key & 3 of every real node to tstart[cid] + off, where tstart is the
// exclusive prefix sum of klen (incl - klen from a torch.cumsum), and
// heads_stream_kernel unpacks the k-1 leading bases of each contig's head key,
// one thread per (contig, base).
// Bound: memory (24 bytes read a node lane, one byte written a base).
// ---------------------------------------------------------------------------
__global__ void tails_stream_kernel(const int64_t* __restrict__ node_key,
                                    const int64_t* __restrict__ node_cid,
                                    const int64_t* __restrict__ node_off,
                                    int64_t C2, const int64_t* __restrict__ klen,
                                    const int64_t* __restrict__ incl,
                                    uint8_t* __restrict__ tails) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C2) return;
  const int64_t cid = node_cid[i];
  if (cid < 0) return;
  tails[incl[cid] - klen[cid] + node_off[i]] = (uint8_t)(node_key[i] & 3);
}

__global__ void heads_stream_kernel(const int64_t* __restrict__ node_key,
                                    int64_t C2,
                                    const int64_t* __restrict__ head_lane,
                                    int64_t n_contigs, int k,
                                    uint8_t* __restrict__ heads) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int w = k - 1;
  if (t >= n_contigs * w) return;
  const int64_t c = t / w;
  const int j = (int)(t - c * w);
  int64_t hl = head_lane[c];
  hl = hl < 0 ? 0 : (hl > C2 - 1 ? C2 - 1 : hl);
  heads[t] = (uint8_t)((node_key[hl] >> (2 * (w - j))) & 3);
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
extern "C" {

int shannon_node_strands(const void* key, int64_t C, int k, void* both,
                         void* stream) {
  if (C > 0) {
    node_strands_kernel<<<blocks_for(C), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)key, C, k, (int64_t*)both);
  }
  return (int)cudaGetLastError();
}

int shannon_node_counts(const void* node_key, int64_t C2, const void* table,
                        const void* table_count, int64_t C, int k,
                        void* node_count, void* stream) {
  if (C2 > 0) {
    node_counts_kernel<<<blocks_for(C2), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)node_key, C2, (const int64_t*)table,
        (const int32_t*)table_count, C, k, (int32_t*)node_count);
  }
  return (int)cudaGetLastError();
}

int shannon_link_records(const void* node_key, int64_t C2, int k,
                         void* sort_key, void* stream) {
  if (C2 > 0) {
    link_records_kernel<<<blocks_for(C2), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)node_key, C2, k, (int64_t*)sort_key);
  }
  return (int)cudaGetLastError();
}

int shannon_group_links(const void* skey, const void* order, int64_t C2,
                        void* prev_link, void* rec_lane, void* first_p,
                        void* p_cnt, void* stream) {
  if (C2 > 0) {
    group_links_kernel<<<blocks_for(2 * C2), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)skey, (const int64_t*)order, C2, (int64_t*)prev_link,
        (int64_t*)rec_lane, (int64_t*)first_p, (int64_t*)p_cnt);
  }
  return (int)cudaGetLastError();
}

int shannon_label_round(const void* prev, const void* ptr_in,
                        const void* dist_in, int64_t C2, void* ptr_out,
                        void* dist_out, void* changed, void* stream) {
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int32_t), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (C2 > 0) {
    label_round_kernel<<<blocks_for(C2), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)prev, (const int64_t*)ptr_in, (const int64_t*)dist_in, C2,
        (int64_t*)ptr_out, (int64_t*)dist_out, (int32_t*)changed);
  }
  return (int)cudaGetLastError();
}

int shannon_label_roots(const void* prev, const void* ptr, int64_t C2,
                        void* has_cycle, void* stream) {
  cudaError_t err = cudaMemsetAsync(has_cycle, 0, sizeof(int32_t), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (C2 > 0) {
    label_roots_kernel<<<blocks_for(C2), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)prev, (const int64_t*)ptr, C2, (int32_t*)has_cycle);
  }
  return (int)cudaGetLastError();
}

int shannon_cycle_round(const void* prev, const void* ptr_in, const void* mn_in,
                        int64_t C2, int last, void* ptr_out, void* mn_out,
                        void* prev_out, void* stream) {
  if (C2 > 0) {
    cycle_round_kernel<<<blocks_for(C2), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)prev, (const int64_t*)ptr_in, (const int64_t*)mn_in, C2,
        last, (int64_t*)ptr_out, (int64_t*)mn_out, (int64_t*)prev_out);
  }
  return (int)cudaGetLastError();
}

int shannon_head_flags(const void* node_key, const void* prev2, int64_t C2,
                       void* flags, void* stream) {
  if (C2 > 0) {
    head_flags_kernel<<<blocks_for(C2), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)node_key, (const int64_t*)prev2, C2, (int32_t*)flags);
  }
  return (int)cudaGetLastError();
}

int shannon_contig_reduce(const void* node_key, const void* node_count,
                          const void* prev2, const void* head_ptr,
                          const void* dist, const void* rec_lane,
                          const void* first_p, const void* p_cnt,
                          const void* scan, int64_t C2, int k, int canonical,
                          void* node_cid, void* node_off, void* klen,
                          void* count_sum, void* head_lane, void* tail_lane,
                          void* abundance, void* out_edges, void* rc_pair,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t bytes = (size_t)C2 * sizeof(int64_t);
  cudaError_t err = cudaSuccess;
  if (C2 == 0) return (int)cudaGetLastError();
  if ((err = cudaMemsetAsync(klen, 0, bytes, s)) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(count_sum, 0, bytes, s)) != cudaSuccess) return (int)err;
  // all-ones bytes: -1 in every int64 lane
  if ((err = cudaMemsetAsync(head_lane, 0xFF, bytes, s)) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(tail_lane, 0xFF, bytes, s)) != cudaSuccess) return (int)err;
  contig_lanes_kernel<<<blocks_for(C2), THREADS, 0, s>>>(
      (const int64_t*)node_key, (const int32_t*)node_count,
      (const int64_t*)prev2, (const int64_t*)head_ptr, (const int64_t*)dist,
      (const int32_t*)scan, C2, (int64_t*)node_cid, (int64_t*)node_off,
      (int64_t*)klen, (int64_t*)count_sum, (int64_t*)head_lane);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  contig_tails_kernel<<<blocks_for(C2), THREADS, 0, s>>>(
      (const int64_t*)node_cid, (const int64_t*)node_off, (const int64_t*)klen,
      C2, (int64_t*)tail_lane);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  contig_edges_kernel<<<blocks_for(C2), THREADS, 0, s>>>(
      (const int64_t*)node_key, (const int64_t*)dist, (const int64_t*)rec_lane,
      (const int64_t*)first_p, (const int64_t*)p_cnt, (const int64_t*)node_cid,
      (const int64_t*)klen, (const int64_t*)count_sum,
      (const int64_t*)tail_lane, C2, k, canonical, (float*)abundance,
      (int64_t*)out_edges, (int64_t*)rc_pair);
  return (int)cudaGetLastError();
}

int shannon_base_streams(const void* node_key, const void* node_cid,
                         const void* node_off, int64_t C2, const void* klen,
                         const void* incl, const void* head_lane,
                         int64_t n_contigs, int k, void* tails, void* heads,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C2 > 0) {
    tails_stream_kernel<<<blocks_for(C2), THREADS, 0, s>>>(
        (const int64_t*)node_key, (const int64_t*)node_cid,
        (const int64_t*)node_off, C2, (const int64_t*)klen,
        (const int64_t*)incl, (uint8_t*)tails);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t n_heads = n_contigs * (int64_t)(k - 1);
  if (n_heads > 0 && C2 > 0) {
    heads_stream_kernel<<<blocks_for(n_heads), THREADS, 0, s>>>(
        (const int64_t*)node_key, C2, (const int64_t*)head_lane, n_contigs, k,
        (uint8_t*)heads);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
