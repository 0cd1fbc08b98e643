// Sparse-flow kernels K6 and K29 of the shannon_tpu_torch port (plain C
// interface; see kernels.cu for the conventions every entry point follows).

#include <math.h>

#include "common.cuh"

#define MAXD 8
#define CELLS (MAXD * MAXD)

// ---------------------------------------------------------------------------
// The tie hash and eps of the greedy max-min transport step that K6 and K29
// share (shannon_tpu/ops/sparseflow.py:49 _greedy_core, :27 _tie_hash_dev).
// Bit-exactness with the oracle: the margin totals are summed left to right,
// and every add, subtract and multiply is an explicit round-to-nearest
// intrinsic, so nvcc cannot contract any of them into an FMA.  A flow cell is
// set once (a pick empties its row or its column), so F[i][j] = 0 + f = f.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t tie_hash(uint32_t i, uint32_t j,
                                             uint32_t seed) {
  uint32_t h = (i * 2654435761u) ^ (j * 40503u) ^ seed;
  h = (h ^ (h >> 16)) * 2246822519u;
  return h ^ (h >> 13);
}

// 1e-6 * max(sum a, sum b, 1), the sums taken left to right.
__device__ __forceinline__ float greedy_eps(const float (&a)[MAXD],
                                            const float (&b)[MAXD]) {
  float sa = a[0], sb = b[0];
#pragma unroll
  for (int c = 1; c < MAXD; ++c) {
    sa = __fadd_rn(sa, a[c]);
    sb = __fadd_rn(sb, b[c]);
  }
  return __fmul_rn(1e-6f, fmaxf(fmaxf(sa, sb), 1.0f));
}

// ---------------------------------------------------------------------------
// The greedy step of K6 and K29: one greedy run a warp.
// The chain of dependent steps (at most max_steps a run) bounds a run; one
// thread a run scanning the 64 cells twice a step made that chain 128 serial
// min/max/compare links long.  So a warp takes a run and its lanes the 64
// cells of the zero-padded 8 x 8 grid, two a lane: lane l holds cells 2l and
// 2l + 1 (row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1), keeps only the
// three margins they touch (a[row], b[c0], b[c1]) in registers, and updates
// them from the broadcast pick with the same round-to-nearest subtraction in
// every lane that holds a margin.  A padded cell is min(x, 0) <= 0, never
// above eps > 0, so it is never picked, and the real cells' row-major order
// at stride 8 is their order at the reference's stride N.  A step is a few
// warp collectives:
//  - the max: __reduce_max_sync of an order-preserving uint32 key of each
//    lane's larger cell (the sign-flip key orders every finite float; with
//    best > eps > 0 no zero of either sign can win, so the max equals the
//    serial fmaxf chain's wherever it is used);
//  - the ties, cells >= best, by two __ballot_sync (one a cell of the
//    lane), the first in row-major order from the lowest set bit (lane l's
//    cell 2l before 2l + 1);
//  - with hashed ties, where more than one cell ties, the largest tie hash
//    by a second __reduce_max_sync (each lane's two hashes are fixed for
//    the run), then the first tie that holds it (a lone tie is its own
//    largest hash).
// A step is about 45 warp instructions.  K29 measured the warp against
// groups of 16 and 8 lanes a run (4 and 8 cells a lane, two and four runs
// a warp): the warp was fastest at 20,480 and at 327,680 runs (PERF.md).
// ---------------------------------------------------------------------------
#define SF_FULL 0xffffffffu

// uint32 key with the order of the float it encodes (finite floats).
__device__ __forceinline__ uint32_t sf_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float sf_unkey(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A greedy step of the warp's run is sf_best, then, where its value is above
// eps, sf_pick; below it every later step of the reference adds zero, and
// the caller's loop stops (the same in every lane).  The caller holds the
// test, so the loop's only exit is its own break (an exit inside a step
// cost K6 10-16% more time a call).
// The best cell's value: lane `lane` holds row `row`'s margin ar and the
// margins b0, b1 of columns c0 and c0 + 1.
__device__ __forceinline__ float sf_best(float ar, float b0, float b1) {
  return sf_unkey(__reduce_max_sync(SF_FULL, sf_key(fmaxf(fminf(ar, b0), fminf(ar, b1)))));
}

// The step's pick, given best > eps: returns the picked cell (flat,
// row-major at stride MAXD) and takes best from its margins and into its
// flow (f0, f1: the lane's two cells' flows; h0, h1: their tie hashes).
__device__ __forceinline__ int sf_pick(float best, float& ar, float& b0, float& b1, float& f0,
                                       float& f1, uint32_t h0, uint32_t h1, int lane, int row,
                                       int c0, bool use_hash) {
  const float m0 = fminf(ar, b0), m1 = fminf(ar, b1);
  const bool t0 = m0 >= best, t1 = m1 >= best;
  uint32_t e0 = __ballot_sync(SF_FULL, t0), e1 = __ballot_sync(SF_FULL, t1);
  if (use_hash && __popc(e0) + __popc(e1) > 1) {  // a lone tie needs no hash
    const uint32_t hm = __reduce_max_sync(SF_FULL, max(t0 ? h0 : 0u, t1 ? h1 : 0u));
    e0 = __ballot_sync(SF_FULL, t0 && h0 == hm);
    e1 = __ballot_sync(SF_FULL, t1 && h1 == hm);
  }
  const int L = __ffs(e0 | e1) - 1;
  const int flat = 2 * L + (((e0 >> L) & 1u) ? 0 : 1);
  const int pi = flat >> 3, pj = flat & (MAXD - 1);
  if (row == pi) ar = __fsub_rn(ar, best);
  if (c0 == pj) b0 = __fsub_rn(b0, best);
  if (c0 + 1 == pj) b1 = __fsub_rn(b1, best);
  if (flat == 2 * lane) f0 = best;
  if (flat == 2 * lane + 1) f1 = best;
  return flat;
}

// ---------------------------------------------------------------------------
// K6: seeded greedy max-min transport per job, and the restart selection.
// Replaces shannon_tpu/ops/sparseflow.py:88 batched_greedy_packed (with :49
// _greedy_core and :27 _tie_hash_dev).
// Bound: the latency of a short chain of dependent steps (at most max_steps
// a restart) per (job, restart); the data is 17 words in and 64 + max_steps
// words out per job.  A warp takes a (job, restart) and runs the step.  A
// lane records its cells' flows (a cell is set once) and the pick of step
// `lane`, and the warp's pairing count and 64-bit support mask.  A step is
// about 45 warp instructions, against about 19 a restart for a thread a
// restart (a warp of those holds 32), so at tens of thousands of jobs the
// card's instruction rate bounds this design (65,536 jobs on an H100 at
// 700 W: 325 us against that one's 246, both kernels in one call); the main
// path's calls hold at most a few hundred jobs, where the chain's latency
// bounds it.
// A block takes J = SF_WARPS / W jobs, W = min(K, SF_WARPS) warps a job
// (at K = 5: one job, 5 warps, 12 blocks an SM; 47 registers, no spill),
// warp w of a job running restarts w, w + W, ... and keeping the least
// (count, mask), earliest first, in registers.  Each warp posts its best to
// shared memory; after one barrier every warp of a job reads its group's W
// posts, finds the least (count, mask, restart), and the warp that holds it
// writes F (two cells a lane, one coalesced 8-byte store each) and its
// picks straight to the outputs.  One launch, no global scratch.
// ---------------------------------------------------------------------------
#define SF_WARPS 8  // warps a block

// (count, mask, restart) a is below b.
__device__ __forceinline__ bool sf_less(int na, uint64_t ma, int ra, int nb, uint64_t mb,
                                        int rb) {
  if (na != nb) return na < nb;
  if (ma != mb) return ma < mb;
  return ra < rb;
}

__global__ void __launch_bounds__(SF_WARPS * 32) sf_greedy_kernel(
    const int32_t* __restrict__ buf, int64_t n_jobs, int K, int W, int jobs_per_block,
    int max_steps, float* __restrict__ F, int64_t* __restrict__ out_picks) {
  __shared__ int s_count[SF_WARPS];
  __shared__ int s_restart[SF_WARPS];
  __shared__ uint64_t s_mask[SF_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / W, rw = warp - group * W;
  const int64_t job = (int64_t)blockIdx.x * jobs_per_block + group;
  const bool live = job < n_jobs;
  const int row = lane >> 2, c0 = 2 * (lane & 3);
  // the warp's best restart: count, mask, index, its two cells and its pick
  int best_n = 0x7fffffff, best_r = 0x7fffffff, best_pick = -1;
  uint64_t best_mask = ~0ull;
  float best_f0 = 0.0f, best_f1 = 0.0f;
  if (live) {
    const int32_t* job_row = buf + job * (2 * MAXD + 1);
    float a[MAXD], b[MAXD];
#pragma unroll
    for (int c = 0; c < MAXD; ++c) {
      a[c] = __int_as_float(job_row[c]);
      b[c] = __int_as_float(job_row[MAXD + c]);
    }
    const float eps = greedy_eps(a, b);
    const float a_row = __int_as_float(job_row[row]);
    const float b_c0 = __int_as_float(job_row[MAXD + c0]);
    const float b_c1 = __int_as_float(job_row[MAXD + c0 + 1]);
    const uint32_t node_seed = (uint32_t)job_row[2 * MAXD];
    for (int r = rw; r < K; r += W) {
      const bool use_hash = r > 0;
      const uint32_t seed = use_hash ? node_seed + (uint32_t)r : 0u;
      const uint32_t h0 = use_hash ? tie_hash(row, c0, seed) : 0u;
      const uint32_t h1 = use_hash ? tie_hash(row, c0 + 1, seed) : 0u;
      float ar = a_row, b0 = b_c0, b1 = b_c1, f0 = 0.0f, f1 = 0.0f;
      int n = 0, pick = -1;
      uint64_t mask = 0;
      for (int step = 0; step < max_steps; ++step) {
        const float best = sf_best(ar, b0, b1);
        if (!(best > eps)) break;  // the same in every lane
        const int flat = sf_pick(best, ar, b0, b1, f0, f1, h0, h1, lane, row, c0, use_hash);
        if (lane == step) pick = flat;
        mask |= 1ull << flat;
        ++n;
      }
      if (sf_less(n, mask, r, best_n, best_mask, best_r)) {
        best_n = n;
        best_mask = mask;
        best_r = r;
        best_pick = pick;
        best_f0 = f0;
        best_f1 = f1;
      }
    }
  }
  if (lane == 0) {
    s_count[warp] = best_n;
    s_mask[warp] = best_mask;
    s_restart[warp] = best_r;
  }
  __syncthreads();
  if (!live) return;
  int win = group * W;
  for (int w = group * W + 1; w < group * W + W; ++w) {
    if (sf_less(s_count[w], s_mask[w], s_restart[w], s_count[win], s_mask[win],
                s_restart[win])) {
      win = w;
    }
  }
  if (win != warp) return;
  reinterpret_cast<float2*>(F + job * CELLS)[lane] = make_float2(best_f0, best_f1);
  if (lane < max_steps) out_picks[job * max_steps + lane] = best_pick;
}

// ---------------------------------------------------------------------------
// K29: one greedy decomposition a row, no restarts and no selection.
// Replaces shannon_tpu/ops/sparseflow.py:38 batched_greedy (with :49
// _greedy_core and :27 _tie_hash_dev).  A warp takes a row and runs K6's
// step, sf_best and sf_pick: its M and N margins (M, N <= MAXD) zero-padded, its own
// seed and tie rule (the hashes fixed for the row), until it stops or
// max_steps.  Each lane then writes its two cells of the row's [M, N] flow
// tensor at stride N: at N = MAXD one 8-byte store (the row's 64 cells
// contiguous, so the warp's stores coalesce), else a store a real cell.  No
// zeroing pass: every cell is written once, a cell never picked with 0.
// Bound: the latency of at most 2 * MAXD dependent steps a row, and at
// hundreds of thousands of rows the card's instruction rate.
// ---------------------------------------------------------------------------
#define SF_JOB_THREADS 256

__global__ void __launch_bounds__(SF_JOB_THREADS) sf_jobs_kernel(
    const float* __restrict__ a_in, const float* __restrict__ b_in,
    const int64_t* __restrict__ seeds, const bool* __restrict__ use_hash_in, int64_t n_jobs,
    int M, int N, int max_steps, float* __restrict__ F) {
  const int64_t t = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (t >= n_jobs) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int row = lane >> 2, c0 = 2 * (lane & 3);
  float a[MAXD], b[MAXD];
#pragma unroll
  for (int c = 0; c < MAXD; ++c) {
    a[c] = c < M ? a_in[t * M + c] : 0.0f;
    b[c] = c < N ? b_in[t * N + c] : 0.0f;
  }
  const float eps = greedy_eps(a, b);
  float ar = row < M ? a_in[t * M + row] : 0.0f;
  float b0 = c0 < N ? b_in[t * N + c0] : 0.0f;
  float b1 = c0 + 1 < N ? b_in[t * N + c0 + 1] : 0.0f;
  float f0 = 0.0f, f1 = 0.0f;
  const bool use_hash = use_hash_in[t];
  const uint32_t seed = (uint32_t)seeds[t];
  const uint32_t h0 = use_hash ? tie_hash(row, c0, seed) : 0u;
  const uint32_t h1 = use_hash ? tie_hash(row, c0 + 1, seed) : 0u;
  for (int step = 0; step < max_steps; ++step) {
    const float best = sf_best(ar, b0, b1);
    if (!(best > eps)) break;  // the same in every lane
    sf_pick(best, ar, b0, b1, f0, f1, h0, h1, lane, row, c0, use_hash);
  }
  if (row >= M) return;
  float* out = F + (t * M + row) * N + c0;
  if (N == MAXD) {
    *reinterpret_cast<float2*>(out) = make_float2(f0, f1);
  } else {
    if (c0 < N) out[0] = f0;
    if (c0 + 1 < N) out[1] = f1;
  }
}

extern "C" {

// buf: [n_jobs, 2 * MAXD + 1] int32 (a bits | b bits | node seed); K >= 1
// restarts a job, 0 < max_steps <= 2 * MAXD.  Outputs: F [n_jobs, MAXD,
// MAXD] float32, out_picks [n_jobs, max_steps] int64.
int shannon_sf_greedy(const void* buf, int64_t n_jobs, int K, int max_steps, void* F,
                      void* out_picks, void* stream) {
  if (K < 1 || max_steps < 1 || max_steps > 2 * MAXD) return (int)cudaErrorInvalidValue;
  if (n_jobs > 0) {
    const int W = K < SF_WARPS ? K : SF_WARPS;  // warps a job
    const int J = SF_WARPS / W;                 // jobs a block
    sf_greedy_kernel<<<(unsigned int)((n_jobs + J - 1) / J), J * W * 32, 0,
                       (cudaStream_t)stream>>>((const int32_t*)buf, n_jobs, K, W, J, max_steps,
                                               (float*)F, (int64_t*)out_picks);
  }
  return (int)cudaGetLastError();
}

// a: [n_jobs, M], b: [n_jobs, N] float32, 0 < M, N <= MAXD; seeds: [n_jobs]
// int64 (the low 32 bits are the seed); use_hash: [n_jobs] bool;
// 0 < max_steps <= 2 * MAXD.  Output: F [n_jobs, M, N].
int shannon_sf_jobs(const void* a, const void* b, const void* seeds,
                    const void* use_hash, int64_t n_jobs, int M, int N,
                    int max_steps, void* F, void* stream) {
  if (M < 1 || M > MAXD || N < 1 || N > MAXD || max_steps < 1 || max_steps > 2 * MAXD) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_jobs > 0) {
    const int64_t threads = n_jobs * 32;  // a warp a row
    sf_jobs_kernel<<<(unsigned int)((threads + SF_JOB_THREADS - 1) / SF_JOB_THREADS),
                     SF_JOB_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const int64_t*)seeds, (const bool*)use_hash, n_jobs,
        M, N, max_steps, (float*)F);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
