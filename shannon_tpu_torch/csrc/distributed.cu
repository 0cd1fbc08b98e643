// Owner bucketing of the sharded count: kernel K25 of the shannon_tpu_torch
// port (plain C interface; see kernels.cu for the conventions every entry
// point follows).
//
// Replaces shannon_tpu/parallel/distributed.py:37 _hash_dev and the bucketing
// of :126 _sharded_tail (:133-160).  The reference sorts the shard's local
// spectrum by (owner, hi, lo) with a 4-operand sort and scatters each lane to
// owner * bucket_cap + (its place among its owner's lanes).  The local
// spectrum is already sorted by key with PAD last, so a stable partition by
// owner gives the same order inside each bucket, and no sort is needed:
//   1. owner_counts_kernel: each block counts its lanes per owner in shared
//      memory and writes one column of a [D, blocks] count matrix;
//   2. torch.cumsum along each owner's row (in the wrapper: the innermost
//      dimension, a parallel scan; a scan over the outer dimension runs
//      serially down each column) gives each block's end in each bucket,
//      and so its start;
//   3. owner_scatter_kernel: each lane's stable rank inside its block and
//      owner (per warp __match_any_sync on the owner and __popc of the lower
//      lanes; per block a prefix over the warps in shared memory) plus its
//      block's start is its place in the bucket.  A place below bucket_cap
//      gets the key and count; a real lane at or past it sets the overflow
//      flag.  PAD lanes (owner D) write nothing; the wrapper fills the
//      buckets with PAD / 0 first.
// Bound: memory (12 bytes read a real lane, 12 written a bucket lane); the
// scatter's stores are scattered across D buckets, but consecutive lanes of
// one owner land on consecutive places.

#include "common.cuh"

#define WARPS (THREADS / 32)
#define MAX_OWNERS 1024

// Owner of a key among n_dev shards: the reference's multiplicative hash of
// the key's (hi, lo) uint32 halves, in uint32 arithmetic; PAD goes to n_dev.
static __device__ __forceinline__ int owner_of(int64_t key, int n_dev) {
  if (key == PAD_KEY) return n_dev;
  const uint32_t hi = (uint32_t)((uint64_t)key >> 32);
  const uint32_t lo = (uint32_t)key;
  uint32_t h = lo * 2654435761u + hi * 0x9E3779B9u;
  h ^= h >> 16;
  return (int)(h % (uint32_t)n_dev);
}

// block_counts[d * blocks + b] = lanes of block b (THREADS lanes) owned by d.
__global__ void owner_counts_kernel(const int64_t* __restrict__ key, int64_t C,
                                    int n_dev, int32_t* __restrict__ block_counts) {
  extern __shared__ int32_t bins[];  // n_dev
  for (int d = threadIdx.x; d < n_dev; d += blockDim.x) bins[d] = 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < C) {
    const int owner = owner_of(key[i], n_dev);
    if (owner < n_dev) atomicAdd(&bins[owner], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n_dev; d += blockDim.x) {
    block_counts[(int64_t)d * gridDim.x + blockIdx.x] = bins[d];
  }
}

// block_ends: the inclusive cumsum of block_counts along each owner's row.
__global__ void owner_scatter_kernel(const int64_t* __restrict__ key,
                                     const int32_t* __restrict__ count, int64_t C,
                                     int n_dev, int64_t bucket_cap,
                                     const int32_t* __restrict__ block_counts,
                                     const int32_t* __restrict__ block_ends,
                                     int64_t* __restrict__ out_key,
                                     int32_t* __restrict__ out_count,
                                     int32_t* __restrict__ overflow) {
  extern __shared__ int32_t warp_counts[];  // [WARPS][n_dev]
  for (int x = threadIdx.x; x < WARPS * n_dev; x += blockDim.x) warp_counts[x] = 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // lanes past C take owner n_dev, as PAD does; every thread stays for the
  // warp vote and the barriers
  const int64_t v = i < C ? key[i] : PAD_KEY;
  const int owner = owner_of(v, n_dev);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned peers = __match_any_sync(0xffffffffu, owner);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (owner < n_dev && rank == 0) warp_counts[warp * n_dev + owner] = __popc(peers);
  __syncthreads();
  if (owner == n_dev) return;
  int32_t within = rank;
  for (int w = 0; w < warp; ++w) within += warp_counts[w * n_dev + owner];
  const int64_t row = (int64_t)owner * gridDim.x + blockIdx.x;
  within += block_ends[row] - block_counts[row];
  if (within < bucket_cap) {
    const int64_t at = (int64_t)owner * bucket_cap + within;
    out_key[at] = v;
    out_count[at] = count[i];
  } else {
    overflow[0] = 1;
  }
}

extern "C" {

int shannon_owner_counts(const void* key, int64_t C, int n_dev, void* block_counts,
                         void* stream) {
  if (n_dev < 1 || n_dev > MAX_OWNERS) return (int)cudaErrorInvalidValue;
  if (C > 0) {
    owner_counts_kernel<<<blocks_for(C), THREADS, n_dev * sizeof(int32_t),
                          (cudaStream_t)stream>>>((const int64_t*)key, C, n_dev,
                                                  (int32_t*)block_counts);
  }
  return (int)cudaGetLastError();
}

int shannon_owner_scatter(const void* key, const void* count, int64_t C, int n_dev,
                          int64_t bucket_cap, const void* block_counts,
                          const void* block_ends, void* out_key, void* out_count,
                          void* overflow, void* stream) {
  if (n_dev < 1 || n_dev > MAX_OWNERS) return (int)cudaErrorInvalidValue;
  if (C > 0) {
    owner_scatter_kernel<<<blocks_for(C), THREADS, WARPS * n_dev * sizeof(int32_t),
                           (cudaStream_t)stream>>>(
        (const int64_t*)key, (const int32_t*)count, C, n_dev, bucket_cap,
        (const int32_t*)block_counts, (const int32_t*)block_ends, (int64_t*)out_key,
        (int32_t*)out_count, (int32_t*)overflow);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
