// Sparse-flow kernels K6 and K29 of the shannon_tpu_torch port (plain C
// interface; see kernels.cu for the conventions every entry point follows).

#include <math.h>

#include "common.cuh"

#define MAXD 8
#define CELLS (MAXD * MAXD)
#define SF_THREADS 128

// ---------------------------------------------------------------------------
// The greedy max-min transport step that K6 and K29 share
// (shannon_tpu/ops/sparseflow.py:49 _greedy_core, :27 _tie_hash_dev).
// The margins are zero-padded to MAXD and stay in registers: every loop over
// them is unrolled, so no index is dynamic.  A padded cell is min(x, 0) <= 0,
// never above eps, so it is never picked.
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

// One greedy step: false, with nothing changed, when the best cell is <= eps
// (every later step of the reference then adds zero); else the picked cell's
// flat index (row-major at stride MAXD) and flow, with both margins reduced.
// Ties are the cells at the max; lexicographic: the first of them in
// row-major order; hashed: the largest tie hash, then the first.
__device__ __forceinline__ bool greedy_step(float (&a)[MAXD], float (&b)[MAXD],
                                            float eps, bool use_hash,
                                            uint32_t seed, int* flat_out,
                                            float* best_out) {
  float best = fminf(a[0], b[0]);
#pragma unroll
  for (int i = 0; i < MAXD; ++i) {
#pragma unroll
    for (int j = 0; j < MAXD; ++j) best = fmaxf(best, fminf(a[i], b[j]));
  }
  if (!(best > eps)) return false;
  int flat = -1;
  uint32_t h_best = 0;
#pragma unroll
  for (int i = 0; i < MAXD; ++i) {
#pragma unroll
    for (int j = 0; j < MAXD; ++j) {
      if (fminf(a[i], b[j]) >= best) {
        uint32_t h = use_hash ? tie_hash(i, j, seed) : 0u;
        if (flat < 0 || h > h_best) {
          flat = i * MAXD + j;
          h_best = h;
        }
      }
    }
  }
  const int pi = flat / MAXD, pj = flat % MAXD;
#pragma unroll
  for (int c = 0; c < MAXD; ++c) {
    if (c == pi) a[c] = __fsub_rn(a[c], best);
    if (c == pj) b[c] = __fsub_rn(b[c], best);
  }
  *flat_out = flat;
  *best_out = best;
  return true;
}

// ---------------------------------------------------------------------------
// K6: seeded greedy max-min transport per job, and the restart selection.
// Replaces shannon_tpu/ops/sparseflow.py:88 batched_greedy_packed (with :49
// _greedy_core and :27 _tie_hash_dev).
// Bound: latency of a short dependent loop (at most 15 active steps of 64
// min/compare lanes) per (job, restart); the data is 17 words per job.
// sf_restarts_kernel gives one thread each (job, restart): it runs
// greedy_step until it stops, and writes its picks, their flows, its pairing
// count and its 64-bit support mask to scratch.  sf_select_kernel gives one
// thread each job: it picks the restart with the least (count, support
// mask) and the earliest index, and writes that restart's flow tensor and
// picks.
// ---------------------------------------------------------------------------
__global__ void sf_restarts_kernel(const int32_t* __restrict__ buf,
                                   int64_t n_jobs, int K, int max_steps,
                                   int32_t* __restrict__ picks,
                                   float* __restrict__ flows,
                                   int32_t* __restrict__ nnz,
                                   uint64_t* __restrict__ support) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_jobs * K) return;
  int64_t job = t / K;
  int r = (int)(t - job * K);
  const int32_t* row = buf + job * (2 * MAXD + 1);
  float a[MAXD], b[MAXD];
#pragma unroll
  for (int c = 0; c < MAXD; ++c) {
    a[c] = __int_as_float(row[c]);
    b[c] = __int_as_float(row[MAXD + c]);
  }
  const float eps = greedy_eps(a, b);
  const bool use_hash = r > 0;
  const uint32_t seed = use_hash ? (uint32_t)row[2 * MAXD] + (uint32_t)r : 0u;
  int32_t* my_picks = picks + t * max_steps;
  float* my_flows = flows + t * max_steps;
  int n = 0;
  uint64_t mask = 0;
  int step = 0;
  for (; step < max_steps; ++step) {
    int flat;
    float best;
    if (!greedy_step(a, b, eps, use_hash, seed, &flat, &best)) break;
    my_picks[step] = flat;
    my_flows[step] = best;
    ++n;
    mask |= 1ull << flat;
  }
  for (; step < max_steps; ++step) {
    my_picks[step] = -1;
    my_flows[step] = 0.0f;
  }
  nnz[t] = n;
  support[t] = mask;
}

__global__ void sf_select_kernel(int64_t n_jobs, int K, int max_steps,
                                 const int32_t* __restrict__ picks,
                                 const float* __restrict__ flows,
                                 const int32_t* __restrict__ nnz,
                                 const uint64_t* __restrict__ support,
                                 float* __restrict__ F,
                                 int64_t* __restrict__ out_picks) {
  int64_t job = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (job >= n_jobs) return;
  const int64_t t0 = job * K;
  int best = 0;
  for (int r = 1; r < K; ++r) {
    int32_t c = nnz[t0 + r], cb = nnz[t0 + best];
    if (c < cb || (c == cb && support[t0 + r] < support[t0 + best])) best = r;
  }
  float* f = F + job * CELLS;
  for (int c = 0; c < CELLS; ++c) f[c] = 0.0f;
  const int32_t* p = picks + (t0 + best) * max_steps;
  const float* v = flows + (t0 + best) * max_steps;
  for (int s = 0; s < max_steps; ++s) {
    if (p[s] >= 0) f[p[s]] = v[s];
    out_picks[job * max_steps + s] = p[s];
  }
}

// ---------------------------------------------------------------------------
// K29: one greedy decomposition per job, no restarts and no selection.
// Replaces shannon_tpu/ops/sparseflow.py:38 batched_greedy (with :49
// _greedy_core and :27 _tie_hash_dev).  One thread per job: its M and N
// margins (M, N <= MAXD) zero-padded in registers, its own seed and tie rule,
// greedy_step until it stops; it zeroes its [M, N] flow tensor and writes
// each pick's flow into its cell.
// Bound: as K6, the latency of at most 2 * MAXD dependent steps a job.
// ---------------------------------------------------------------------------
__global__ void sf_jobs_kernel(const float* __restrict__ a_in,
                               const float* __restrict__ b_in,
                               const int64_t* __restrict__ seeds,
                               const bool* __restrict__ use_hash_in,
                               int64_t n_jobs, int M, int N, int max_steps,
                               float* __restrict__ F) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_jobs) return;
  float a[MAXD], b[MAXD];
#pragma unroll
  for (int c = 0; c < MAXD; ++c) {
    a[c] = c < M ? a_in[t * M + c] : 0.0f;
    b[c] = c < N ? b_in[t * N + c] : 0.0f;
  }
  const float eps = greedy_eps(a, b);
  const bool use_hash = use_hash_in[t];
  const uint32_t seed = (uint32_t)seeds[t];
  float* f = F + t * M * N;
  for (int c = 0; c < M * N; ++c) f[c] = 0.0f;
  for (int step = 0; step < max_steps; ++step) {
    int flat;
    float best;
    if (!greedy_step(a, b, eps, use_hash, seed, &flat, &best)) break;
    f[(flat / MAXD) * N + flat % MAXD] = best;
  }
}

extern "C" {

// buf: [n_jobs, 2 * MAXD + 1] int32 (a bits | b bits | node seed).
// Scratch: picks/flows [n_jobs * K, max_steps], nnz/support [n_jobs * K].
// Outputs: F [n_jobs, MAXD, MAXD] float32, out_picks [n_jobs, max_steps].
int shannon_sf_greedy(const void* buf, int64_t n_jobs, int K, int max_steps,
                      void* picks, void* flows, void* nnz, void* support,
                      void* F, void* out_picks, void* stream) {
  if (n_jobs > 0) {
    int64_t lanes = n_jobs * K;
    sf_restarts_kernel<<<(unsigned int)((lanes + SF_THREADS - 1) / SF_THREADS),
                         SF_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)buf, n_jobs, K, max_steps, (int32_t*)picks,
        (float*)flows, (int32_t*)nnz, (uint64_t*)support);
    sf_select_kernel<<<(unsigned int)((n_jobs + SF_THREADS - 1) / SF_THREADS),
                       SF_THREADS, 0, (cudaStream_t)stream>>>(
        n_jobs, K, max_steps, (const int32_t*)picks, (const float*)flows,
        (const int32_t*)nnz, (const uint64_t*)support, (float*)F,
        (int64_t*)out_picks);
  }
  return (int)cudaGetLastError();
}

// a: [n_jobs, M], b: [n_jobs, N] float32; seeds: [n_jobs] int64 (the low 32
// bits are the seed); use_hash: [n_jobs] bool.  Output: F [n_jobs, M, N].
int shannon_sf_jobs(const void* a, const void* b, const void* seeds,
                    const void* use_hash, int64_t n_jobs, int M, int N,
                    int max_steps, void* F, void* stream) {
  if (n_jobs > 0) {
    sf_jobs_kernel<<<(unsigned int)((n_jobs + SF_THREADS - 1) / SF_THREADS),
                     SF_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const int64_t*)seeds,
        (const bool*)use_hash, n_jobs, M, N, max_steps, (float*)F);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
