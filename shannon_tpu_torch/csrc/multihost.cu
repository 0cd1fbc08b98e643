// Evidence-ownership pack and unpack of the multi-process back half: kernels
// K26 and K27 of the shannon_tpu_torch port (plain C interface; see
// kernels.cu for the conventions every entry point follows).
//
// Replace the host pack (:153-209) and unpack (:227-248) of
// shannon_tpu/parallel/multihost.py:115 route_evidence_ownership, around its
// device all_to_all (:211-225), which becomes
// torch.distributed.all_to_all_single.  Each path of a rank's evidence (flat
// node ids, row offsets, weights) goes to the rank that owns its head node's
// component.  Row p of the [H, cap] int32 send buffer is the bucket bound for
// rank p: [n_paths, n_flat, lens..., weights..., flat...] of its paths in
// source-local order, zero-padded to cap.
//
// K26 ownership_pack, two launches around a cumsum and the caller's
// all_reduce(MAX) of the widest bucket (which fixes cap):
//   1. ownership_counts_kernel: one thread a path writes its destination
//      owner[flat[offs[i]]]; each block counts its paths and its flat
//      elements per destination in shared memory and writes one column of
//      two [H, blocks] matrices;
//   2. torch.cumsum along each destination's row (the inner dimension: a scan
//      over the outer one runs serially down each column) gives each block's
//      end in each bucket, and the row's last entry the bucket's n_paths and
//      n_flat;
//   3. ownership_scatter_kernel: a path's place among its bucket's paths is
//      its rank among the lower lanes of its warp bound for the same rank
//      (__match_any_sync, __popc), plus the paths of the block's lower warps
//      (shared memory), plus its block's start, so the order inside a bucket
//      is source-local order, as the reference's boolean selection keeps it;
//      its place among the flat elements adds up the lengths of those same
//      paths (warp shuffles).  It writes its length, its weight and its flat
//      segment; block 0 writes the headers.
// K27 ownership_unpack: the received buffer's headers are scanned on the
// device (torch.cumsum over the H sources, in the wrapper) into each
// source's first path and first flat element; one thread a received word
// (a row of blocks a source: blockIdx.y is the source) copies the lengths,
// weights and flat ids of source s, widened to int64, to their places in the
// source-rank-order concatenation; torch.cumsum of the lengths then gives the
// offsets.
// Bound: memory.  K26 reads each path's offsets, weight and head owner and
// its flat segment once and writes them once into the buckets; K27 reads the
// H x cap buffer (padding included) and writes its real words at 8 bytes.

#include "common.cuh"

#define WARPS (THREADS / 32)
// Ranks K26 bins in shared memory: 2 x WARPS x MAX_RANKS int32 = 32 KB.
#define MAX_RANKS 512

// path_counts / flat_counts[d * blocks + b]: the paths of block b (THREADS
// paths) bound for rank d, and their flat elements.
__global__ void ownership_counts_kernel(const int32_t* __restrict__ flat,
                                        const int32_t* __restrict__ offs, int64_t P,
                                        const int32_t* __restrict__ owner, int H,
                                        int32_t* __restrict__ dest,
                                        int32_t* __restrict__ path_counts,
                                        int32_t* __restrict__ flat_counts) {
  extern __shared__ int32_t bins[];  // [2][H]: paths, flat elements
  for (int d = threadIdx.x; d < 2 * H; d += blockDim.x) bins[d] = 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < P) {
    const int32_t o = offs[i];
    const int p = owner[flat[o]];
    dest[i] = p;
    atomicAdd(&bins[p], 1);
    atomicAdd(&bins[H + p], offs[i + 1] - o);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < H; d += blockDim.x) {
    const int64_t at = (int64_t)d * gridDim.x + blockIdx.x;
    path_counts[at] = bins[d];
    flat_counts[at] = bins[H + d];
  }
}

// path_ends / flat_ends: the inclusive cumsums of path_counts / flat_counts
// along each destination's row.
__global__ void ownership_scatter_kernel(
    const int32_t* __restrict__ flat, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ weights, int64_t P, const int32_t* __restrict__ dest,
    int H, int64_t cap, const int32_t* __restrict__ path_counts,
    const int32_t* __restrict__ path_ends, const int32_t* __restrict__ flat_counts,
    const int32_t* __restrict__ flat_ends, int32_t* __restrict__ send) {
  extern __shared__ int32_t warp_sums[];  // [2][WARPS][H]: paths, flat elements
  const int64_t blocks = gridDim.x;
  if (blockIdx.x == 0) {
    for (int d = threadIdx.x; d < H; d += blockDim.x) {
      send[d * cap] = path_ends[d * blocks + blocks - 1];
      send[d * cap + 1] = flat_ends[d * blocks + blocks - 1];
    }
  }
  for (int x = threadIdx.x; x < 2 * WARPS * H; x += blockDim.x) warp_sums[x] = 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // lanes past P take destination H and length 0; every thread stays for
  // the warp votes and the barrier
  const bool real = i < P;
  const int p = real ? dest[i] : H;
  const int32_t o = real ? offs[i] : 0;
  const int32_t len = real ? offs[i + 1] - o : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned peers = __match_any_sync(0xffffffffu, p);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  int32_t flat_before = 0, flat_total = 0;
  for (int j = 0; j < 32; ++j) {
    const int32_t v = __shfl_sync(0xffffffffu, len, j);
    if ((peers >> j) & 1u) {
      flat_total += v;
      if (j < lane) flat_before += v;
    }
  }
  if (p < H && rank == 0) {
    warp_sums[warp * H + p] = __popc(peers);
    warp_sums[(WARPS + warp) * H + p] = flat_total;
  }
  __syncthreads();
  if (!real) return;
  int32_t path_at = rank, flat_at = flat_before;
  for (int w = 0; w < warp; ++w) {
    path_at += warp_sums[w * H + p];
    flat_at += warp_sums[(WARPS + w) * H + p];
  }
  const int64_t row = (int64_t)p * blocks + blockIdx.x;
  path_at += path_ends[row] - path_counts[row];
  flat_at += flat_ends[row] - flat_counts[row];
  const int64_t n_paths = path_ends[(int64_t)p * blocks + blocks - 1];
  int32_t* bucket = send + (int64_t)p * cap;
  bucket[2 + path_at] = len;
  bucket[2 + n_paths + path_at] = weights[i];
  int32_t* seg = bucket + 2 + 2 * n_paths + flat_at;
  for (int32_t t = 0; t < len; ++t) seg[t] = flat[o + t];
}

// path_start / flat_start[s]: where source s's paths and flat ids begin in
// the concatenation (exclusive scans of the headers).
__global__ void ownership_unpack_kernel(const int32_t* __restrict__ recv, int64_t cap,
                                        const int64_t* __restrict__ path_start,
                                        const int64_t* __restrict__ flat_start,
                                        int64_t* __restrict__ lens,
                                        int64_t* __restrict__ weights,
                                        int64_t* __restrict__ flat) {
  const int s = blockIdx.y;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - 2;  // past the header
  if (c < 0 || c + 2 >= cap) return;
  const int32_t* row = recv + s * cap;
  const int64_t n_paths = row[0], n_flat = row[1];
  const int32_t v = row[c + 2];
  if (c < n_paths) {
    lens[path_start[s] + c] = v;
  } else if (c < 2 * n_paths) {
    weights[path_start[s] + c - n_paths] = v;
  } else if (c < 2 * n_paths + n_flat) {
    flat[flat_start[s] + c - 2 * n_paths] = v;
  }
}

extern "C" {

int shannon_ownership_counts(const void* flat, const void* offs, int64_t P, const void* owner,
                             int H, void* dest, void* path_counts, void* flat_counts,
                             void* stream) {
  if (H < 1 || H > MAX_RANKS) return (int)cudaErrorInvalidValue;
  if (P > 0) {
    ownership_counts_kernel<<<blocks_for(P), THREADS, 2 * H * sizeof(int32_t),
                              (cudaStream_t)stream>>>(
        (const int32_t*)flat, (const int32_t*)offs, P, (const int32_t*)owner, H,
        (int32_t*)dest, (int32_t*)path_counts, (int32_t*)flat_counts);
  }
  return (int)cudaGetLastError();
}

int shannon_ownership_scatter(const void* flat, const void* offs, const void* weights,
                              int64_t P, const void* dest, int H, int64_t cap,
                              const void* path_counts, const void* path_ends,
                              const void* flat_counts, const void* flat_ends, void* send,
                              void* stream) {
  if (H < 1 || H > MAX_RANKS) return (int)cudaErrorInvalidValue;
  if (P > 0) {
    ownership_scatter_kernel<<<blocks_for(P), THREADS, 2 * WARPS * H * sizeof(int32_t),
                               (cudaStream_t)stream>>>(
        (const int32_t*)flat, (const int32_t*)offs, (const int32_t*)weights, P,
        (const int32_t*)dest, H, cap, (const int32_t*)path_counts,
        (const int32_t*)path_ends, (const int32_t*)flat_counts, (const int32_t*)flat_ends,
        (int32_t*)send);
  }
  return (int)cudaGetLastError();
}

int shannon_ownership_unpack(const void* recv, int H, int64_t cap, const void* path_start,
                             const void* flat_start, void* lens, void* weights, void* flat,
                             void* stream) {
  if (H < 1 || H > 65535) return (int)cudaErrorInvalidValue;
  if (cap > 0) {
    const dim3 grid(blocks_for(cap), H);
    ownership_unpack_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)recv, cap, (const int64_t*)path_start, (const int64_t*)flat_start,
        (int64_t*)lens, (int64_t*)weights, (int64_t*)flat);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
