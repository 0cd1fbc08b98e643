// Tip-clip kernels K18-K19 of the shannon_tpu_torch port (plain C interface;
// see kernels.cu for the conventions every entry point follows).
//
// The clip's host rounds decide which contigs go and how the survivors merge;
// these kernels apply that decision to the k-mer table (K18) and to the node
// table of the condensation that preceded the clip (K19).  The node table is
// C2 sorted int64 keys, PAD past its real nodes; contig ids, lanes and offsets
// are int64, counts int32.

#include "common.cuh"

// ---------------------------------------------------------------------------
// K18: keep flags of the k-mers that survive the clip.
// Replaces shannon_tpu/ops/tipclip.py:407 _drop_contigs (its lookup, contig
// gather and doom test; the compaction after it is K10).  One thread per
// spectrum lane finds the lane's key in the node table by K3's binary search
// (lower_bound_hit), reads the contig id at the hit and tests that contig's
// doom flag with the reference's clamp of the id to [0, C2 - 1]; a pad lane or
// a doomed contig's k-mer is dropped.  The keep flags then go through K10's
// compact_keep_kernel, so no idx / hit / cid array of the plain version is
// ever stored.
// Bound: latency of the dependent loads of the binary search (log2(C2) steps
// of 8 bytes); the spectrum is sorted, so neighbouring threads walk nearly
// the same path through the node table and share its cache lines.
// ---------------------------------------------------------------------------
__global__ void drop_keep_kernel(const int64_t* __restrict__ key, int64_t C,
                                 const int64_t* __restrict__ node_key,
                                 const int64_t* __restrict__ node_cid,
                                 int64_t C2, const uint8_t* __restrict__ doomed,
                                 uint8_t* __restrict__ keep) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= C) return;
  const int64_t v = key[s];
  bool kept = false;
  if (v != PAD_KEY) {
    int64_t i;
    kept = true;
    if (lower_bound_hit(node_key, C2, v, &i)) {
      const int64_t cid = node_cid[i];
      kept = !(cid >= 0 && doomed[cid < C2 ? cid : C2 - 1]);
    }
  }
  keep[s] = kept ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K19: the node table renumbered to the merged contigs and front-compacted.
// Replaces shannon_tpu/ops/tipclip.py:423 _device_clip_remap, which moved the
// kept lanes to the front with a sort of (position key, iota) and gathered
// every field through the permutation.  Three steps around one torch.cumsum:
//   remap_keep_kernel   per node lane: keep = the lane's contig survives
//                       (new_cid_d at the reference's clamp of node_cid to
//                       [0, npad - 1] is >= 0);
//   torch.cumsum        new_lane = scan - 1 (the kept lanes stay in table
//                       order, so the table stays sorted without a sort);
//   remap_scatter_kernel  each kept lane with new_lane < out_cap writes its
//                       key, count, new contig id and shifted offset to its
//                       new lane; lanes [min(n_keep, out_cap), out_cap) get
//                       PAD / 0 / -1 / -1 (the two writes never meet);
//   remap_contigs_kernel  per new contig: head and tail lane through
//                       new_lane, and the float32 abundance
//                       __fdiv_rn(__ll2float_rn(sum), __ll2float_rn(klen)),
//                       bit-equal to the plain float division (K14 does the
//                       same; the intrinsics keep nvcc from approximating).
// Bound: memory.  The keep pass reads node_cid (8 bytes a lane) and gathers
// new_cid_d; the scatter reads the keep flags and scan (5 bytes a lane) and,
// for a kept lane only, its 28 bytes of fields and its contig's two maps.
// ---------------------------------------------------------------------------
static __device__ __forceinline__ int64_t clamp_lane(int64_t v, int64_t len) {
  return v < 0 ? 0 : (v < len ? v : len - 1);
}

__global__ void remap_keep_kernel(const int64_t* __restrict__ node_cid,
                                  int64_t C2, const int64_t* __restrict__ new_cid,
                                  int64_t npad, uint8_t* __restrict__ keep) {
  const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= C2) return;
  const int64_t cid = node_cid[l];
  keep[l] = (cid >= 0 && new_cid[clamp_lane(cid, npad)] >= 0) ? 1 : 0;
}

__global__ void remap_scatter_kernel(
    const int64_t* __restrict__ node_key, const int32_t* __restrict__ node_count,
    const int64_t* __restrict__ node_cid, const int64_t* __restrict__ node_off,
    const uint8_t* __restrict__ keep, const int32_t* __restrict__ scan, int64_t C2,
    const int64_t* __restrict__ new_cid, const int64_t* __restrict__ off_shift,
    int64_t npad, int64_t out_cap, int64_t* __restrict__ out_key,
    int32_t* __restrict__ out_count, int64_t* __restrict__ out_cid,
    int64_t* __restrict__ out_off) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < C2 && keep[t]) {
    const int64_t slot = (int64_t)scan[t] - 1;
    if (slot < out_cap) {
      const int64_t oc = clamp_lane(node_cid[t], npad);
      out_key[slot] = node_key[t];
      out_count[slot] = node_count[t];
      out_cid[slot] = new_cid[oc];
      out_off[slot] = node_off[t] + off_shift[oc];
    }
  }
  const int64_t n_keep = C2 > 0 ? (int64_t)scan[C2 - 1] : 0;
  if (t < out_cap && t >= n_keep) {
    out_key[t] = PAD_KEY;
    out_count[t] = 0;
    out_cid[t] = -1;
    out_off[t] = -1;
  }
}

__global__ void remap_contigs_kernel(const int32_t* __restrict__ scan, int64_t C2,
                                     const int64_t* __restrict__ hlane,
                                     const int64_t* __restrict__ tlane,
                                     const int64_t* __restrict__ klen,
                                     const int64_t* __restrict__ csum, int64_t M,
                                     int64_t* __restrict__ head,
                                     int64_t* __restrict__ tail,
                                     float* __restrict__ abundance) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M) return;
  const int64_t h = hlane[j], tl = tlane[j];
  head[j] = h >= 0 ? (int64_t)scan[clamp_lane(h, C2)] - 1 : -1;
  tail[j] = tl >= 0 ? (int64_t)scan[clamp_lane(tl, C2)] - 1 : -1;
  const int64_t kl = klen[j];
  abundance[j] = kl > 0 ? __fdiv_rn(__ll2float_rn(csum[j]), __ll2float_rn(kl)) : 0.0f;
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
extern "C" {

int shannon_drop_keep(const void* key, int64_t C, const void* node_key,
                      const void* node_cid, int64_t C2, const void* doomed,
                      void* keep, void* stream) {
  if (C > 0 && C2 > 0) {
    drop_keep_kernel<<<blocks_for(C), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)key, C, (const int64_t*)node_key, (const int64_t*)node_cid,
        C2, (const uint8_t*)doomed, (uint8_t*)keep);
  }
  return (int)cudaGetLastError();
}

int shannon_remap_keep(const void* node_cid, int64_t C2, const void* new_cid,
                       int64_t npad, void* keep, void* stream) {
  if (C2 > 0 && npad > 0) {
    remap_keep_kernel<<<blocks_for(C2), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)node_cid, C2, (const int64_t*)new_cid, npad, (uint8_t*)keep);
  }
  return (int)cudaGetLastError();
}

int shannon_clip_remap(const void* node_key, const void* node_count,
                       const void* node_cid, const void* node_off, const void* keep,
                       const void* scan, int64_t C2, const void* new_cid,
                       const void* off_shift, int64_t npad, int64_t out_cap,
                       void* out_key, void* out_count, void* out_cid, void* out_off,
                       const void* hlane, const void* tlane, const void* klen,
                       const void* csum, int64_t M, void* head, void* tail,
                       void* abundance, void* stream) {
  const int64_t lanes = C2 > out_cap ? C2 : out_cap;
  if (lanes > 0) {
    remap_scatter_kernel<<<blocks_for(lanes), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)node_key, (const int32_t*)node_count,
        (const int64_t*)node_cid, (const int64_t*)node_off, (const uint8_t*)keep,
        (const int32_t*)scan, C2, (const int64_t*)new_cid,
        (const int64_t*)off_shift, npad, out_cap, (int64_t*)out_key,
        (int32_t*)out_count, (int64_t*)out_cid, (int64_t*)out_off);
  }
  if (M > 0) {
    remap_contigs_kernel<<<blocks_for(M), THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)scan, C2, (const int64_t*)hlane, (const int64_t*)tlane,
        (const int64_t*)klen, (const int64_t*)csum, M, (int64_t*)head,
        (int64_t*)tail, (float*)abundance);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
