// Read-threading kernels K4 and K5 of the shannon_tpu_torch port (plain C
// interface; see kernels.cu for the conventions every entry point follows).

#include "common.cuh"

// ---------------------------------------------------------------------------
// K4: per-row run scan and row compaction of the threading windows.
// Replaces shannon_tpu/ops/thread.py:104 _thread_windows after its lookup
// (lines 115-174): hit mask, (cid, off) gather, run starts and ends, run
// ids, events, and the three flat compaction sorts that moved each row's
// events and runs to its front.
// Bound: memory.  Each window is read once (8 + 2 bytes) and each output
// lane written once.  One thread walks one read row in window order and keeps
// the run state in registers, so the row compaction is a running counter
// instead of a sort; the thread's loads walk consecutive addresses, which L1
// serves a cache line at a time.  idx is read only where the window hits (the
// lookup's contract: idx is meaningful only there).
// ---------------------------------------------------------------------------
__global__ void thread_rows_kernel(
    const int64_t* __restrict__ idx, const uint8_t* __restrict__ hit,
    const uint8_t* __restrict__ valid, const int64_t* __restrict__ node_cid,
    const int64_t* __restrict__ node_off, int64_t n_rows, int W, int R,
    int64_t* __restrict__ ev_cid, int64_t* __restrict__ ev_run,
    int64_t* __restrict__ n_events, int64_t* __restrict__ run_p0,
    int64_t* __restrict__ run_p1, int64_t* __restrict__ run_o0,
    int64_t* __restrict__ run_o1) {
  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int64_t base = r * W;
  const int64_t rbase = r * R;
  int n_ev = 0, n_start = 0, n_end = 0;
  bool prev = false;
  bool cur = W > 0 && hit[base] && valid[base];
  for (int j = 0; j < W; ++j) {
    bool next = j + 1 < W && hit[base + j + 1] && valid[base + j + 1];
    if (cur) {
      int64_t lane = idx[base + j];
      int64_t cid = node_cid[lane];
      int64_t off = node_off[lane];
      bool start = !prev;
      if (start) {
        if (n_start < R) {
          run_p0[rbase + n_start] = j;
          run_o0[rbase + n_start] = off;
        }
        ++n_start;
      }
      if (start || off == 0) {
        ev_cid[base + n_ev] = cid;
        ev_run[base + n_ev] = n_start - 1;
        ++n_ev;
      }
      if (!next) {
        if (n_end < R) {
          run_p1[rbase + n_end] = j;
          run_o1[rbase + n_end] = off;
        }
        ++n_end;
      }
    }
    prev = cur;
    cur = next;
  }
  for (int j = n_ev; j < W; ++j) {
    ev_cid[base + j] = -1;
    ev_run[base + j] = -1;
  }
  for (int q = min(n_start, R); q < R; ++q) {
    run_p0[rbase + q] = -1;
    run_o0[rbase + q] = -1;
  }
  for (int q = min(n_end, R); q < R; ++q) {
    run_p1[rbase + q] = -1;
    run_o1[rbase + q] = -1;
  }
  n_events[r] = n_ev;
}

// ---------------------------------------------------------------------------
// K5: across-read compaction of the threading rows.
// Replaces shannon_tpu/ops/thread.py:178 compact_thread_outputs (two flat
// position-key sorts).  Bound: memory, one pass over the [N, W] and [N, R]
// rows.  row_counts_kernel counts each row's real runs (one thread per row);
// between the two launches a torch.cumsum turns the counts into row ends;
// compact_rows_kernel then gives each (row, slot) lane one thread, which
// copies the slot to row_end - count + slot if the slot is below the row's
// count.  Consecutive threads read consecutive lanes and write consecutive
// destinations, so both sides coalesce; no sort, no atomics.
// ---------------------------------------------------------------------------
__global__ void row_counts_kernel(const int64_t* __restrict__ rows,
                                  int64_t n_rows, int width,
                                  int64_t* __restrict__ counts) {
  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  int64_t c = 0;
  for (int j = 0; j < width; ++j) c += rows[r * width + j] >= 0;
  counts[r] = c;
}

struct Payloads {
  const int64_t* in[4];
  int64_t* out[4];
};

__global__ void compact_rows_kernel(const int64_t* __restrict__ counts,
                                    const int64_t* __restrict__ row_end,
                                    int64_t n_rows, int width, int n_payloads,
                                    Payloads p) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rows * (int64_t)width) return;
  int64_t r = t / width;
  int64_t j = t - r * width;
  int64_t c = counts[r];
  if (j >= c) return;
  int64_t dst = row_end[r] - c + j;
  for (int q = 0; q < n_payloads; ++q) p.out[q][dst] = p.in[q][t];
}

extern "C" {

int shannon_thread_rows(const void* idx, const void* hit, const void* valid,
                        const void* node_cid, const void* node_off,
                        int64_t n_rows, int W, int R, void* ev_cid,
                        void* ev_run, void* n_events, void* run_p0,
                        void* run_p1, void* run_o0, void* run_o1,
                        void* stream) {
  if (n_rows > 0) {
    thread_rows_kernel<<<blocks_for(n_rows), THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const int64_t*)idx, (const uint8_t*)hit, (const uint8_t*)valid,
        (const int64_t*)node_cid, (const int64_t*)node_off, n_rows, W, R,
        (int64_t*)ev_cid, (int64_t*)ev_run, (int64_t*)n_events,
        (int64_t*)run_p0, (int64_t*)run_p1, (int64_t*)run_o0,
        (int64_t*)run_o1);
  }
  return (int)cudaGetLastError();
}

int shannon_row_counts(const void* rows, int64_t n_rows, int width,
                       void* counts, void* stream) {
  if (n_rows > 0) {
    row_counts_kernel<<<blocks_for(n_rows), THREADS, 0,
                        (cudaStream_t)stream>>>((const int64_t*)rows, n_rows,
                                                width, (int64_t*)counts);
  }
  return (int)cudaGetLastError();
}

// in0..in3 are [n_rows, width] int64 rows and out0..out3 their flat
// destinations; the first n_payloads of each are used.
int shannon_compact_rows(const void* counts, const void* row_end,
                         int64_t n_rows, int width, int n_payloads,
                         const void* in0, const void* in1, const void* in2,
                         const void* in3, void* out0, void* out1, void* out2,
                         void* out3, void* stream) {
  int64_t total = n_rows * (int64_t)width;
  if (total > 0) {
    Payloads p = {{(const int64_t*)in0, (const int64_t*)in1,
                   (const int64_t*)in2, (const int64_t*)in3},
                  {(int64_t*)out0, (int64_t*)out1, (int64_t*)out2,
                   (int64_t*)out3}};
    compact_rows_kernel<<<blocks_for(total), THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const int64_t*)counts, (const int64_t*)row_end, n_rows, width,
        n_payloads, p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
