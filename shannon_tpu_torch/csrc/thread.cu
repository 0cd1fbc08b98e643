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
// lane written once; most of the output is -1 padding (about 4 events in a
// row of 105 windows on the main path).
// Design.  One warp takes one read row (THREAD_ROWS_PER_BLOCK rows a block)
// and walks it in chunks of 32 windows, lane j on window j of the chunk, so
// every load and store of the row is coalesced.  __ballot_sync turns the
// chunk's hits into a mask; the previous chunk's last bit and the next
// chunk's first bit (loaded one chunk ahead) give each window's prev and
// next, hence the run starts (cur & ~prev) and ends (cur & ~next).  Only hit
// lanes load idx and gather node_cid / node_off (the lookup's contract: idx
// is meaningful only where the window hits), 32 independent gathers a warp.
// An event is a hit at a run start or at contig offset 0; its slot is the
// row's running count plus the events of the lower lanes (__popc of the
// event mask below the lane), and a run's start and end slots come the same
// way from the start and end masks, kept below R.  So the compacted entries
// of a chunk land on consecutive addresses, and the -1 tails of the five
// padded rows are written by the whole warp, lane q on slot q.
// ---------------------------------------------------------------------------
#define THREAD_ROWS_PER_BLOCK (THREADS / 32)
#define THREAD_FULL_MASK 0xffffffffu

static __device__ __forceinline__ bool window_hits(const uint8_t* __restrict__ hit,
                                                   const uint8_t* __restrict__ valid,
                                                   int64_t base, int j, int W) {
  return j < W && hit[base + j] && valid[base + j];
}

__global__ void thread_rows_kernel(
    const int64_t* __restrict__ idx, const uint8_t* __restrict__ hit,
    const uint8_t* __restrict__ valid, const int64_t* __restrict__ node_cid,
    const int64_t* __restrict__ node_off, int64_t n_rows, int W, int R,
    int64_t* __restrict__ ev_cid, int64_t* __restrict__ ev_run,
    int64_t* __restrict__ n_events, int64_t* __restrict__ run_p0,
    int64_t* __restrict__ run_p1, int64_t* __restrict__ run_o0,
    int64_t* __restrict__ run_o1) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * THREAD_ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= n_rows) return;  // the whole warp
  const int64_t base = r * W;
  const int64_t rbase = r * R;
  const unsigned me = 1u << lane;
  const unsigned below = me - 1;
  int n_ev = 0, n_start = 0, n_end = 0;
  unsigned carry = 0;  // hit bit of the window before the chunk
  unsigned cur = __ballot_sync(THREAD_FULL_MASK, window_hits(hit, valid, base, lane, W));
  for (int j0 = 0; j0 < W; j0 += 32) {
    const int j = j0 + lane;
    const unsigned nxt =
        __ballot_sync(THREAD_FULL_MASK, window_hits(hit, valid, base, j + 32, W));
    const unsigned start = cur & ~((cur << 1) | carry);
    const unsigned end = cur & ~((cur >> 1) | (nxt << 31));
    const bool h = (cur & me) != 0;
    int64_t cid = 0, off = 0;
    if (h) {
      const int64_t lane_of = idx[base + j];
      cid = node_cid[lane_of];
      off = node_off[lane_of];
    }
    const unsigned ev = __ballot_sync(THREAD_FULL_MASK, h && ((start & me) || off == 0));
    if (ev & me) {
      const int64_t slot = base + n_ev + __popc(ev & below);
      ev_cid[slot] = cid;
      ev_run[slot] = n_start + __popc(start & (below | me)) - 1;
    }
    if (start & me) {
      const int q = n_start + __popc(start & below);
      if (q < R) {
        run_p0[rbase + q] = j;
        run_o0[rbase + q] = off;
      }
    }
    if (end & me) {
      const int q = n_end + __popc(end & below);
      if (q < R) {
        run_p1[rbase + q] = j;
        run_o1[rbase + q] = off;
      }
    }
    n_ev += __popc(ev);
    n_start += __popc(start);
    n_end += __popc(end);
    carry = cur >> 31;
    cur = nxt;
  }
  for (int q = n_ev + lane; q < W; q += 32) {
    ev_cid[base + q] = -1;
    ev_run[base + q] = -1;
  }
  for (int q = min(n_start, R) + lane; q < R; q += 32) {
    run_p0[rbase + q] = -1;
    run_o0[rbase + q] = -1;
  }
  for (int q = min(n_end, R) + lane; q < R; q += 32) {
    run_p1[rbase + q] = -1;
    run_o1[rbase + q] = -1;
  }
  if (lane == 0) n_events[r] = n_ev;
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
    const int64_t blocks = (n_rows + THREAD_ROWS_PER_BLOCK - 1) / THREAD_ROWS_PER_BLOCK;
    thread_rows_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
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
