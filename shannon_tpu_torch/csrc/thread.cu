// Read-threading kernels K4 and K5 of the shannon_tpu_torch port (plain C
// interface; see kernels.cu for the conventions every entry point follows).

#include "common.cuh"
#include "scan.cuh"

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
// K5: across-read compaction of the threading rows, in one pass.
// Replaces shannon_tpu/ops/thread.py:178 compact_thread_outputs (two flat
// position-key sorts).  K4 writes each row's n_events events and its real
// runs at the front of the row (-1 after them), so a row's payload is a
// prefix of it and its flat position is the sum of the earlier rows' counts.
// Bound: memory, and only what the data needs: n_events and the run_p0 rows
// read (to count the runs), the real events (16 bytes) and runs (32 bytes)
// read and written once, n_runs written.  The padding is never read.
// Design.  One launch on the decoupled look-back scan of scan.cuh, with a
// tile of COMPACT_TILE_ROWS rows (a ticket and a status word a tile, as K2's
// 4,096-lane tiles).  A warp takes 32 consecutive rows, lane q row q: lane q
// loads n_events of its row, and for each row the warp loads run_p0's
// first 32 lanes together (all rows' loads in flight at once) and counts
// the real ones with __ballot_sync / __popc, going on to the next 32 lanes
// only while a chunk is all real.  Lane q holds its row's pair as one
// 64-bit scan value, events << 31 | runs (both below 2^31: the wrapper
// refuses N x W or N x R from 2^31 on), so the block's scan in thread order
// is the scan in row order and one look-back gives both offsets.  A warp's
// rows then fill one contiguous stretch of each flat output, and the warp
// copies it 32 entries at a time: lane l takes entry k of the stretch, finds
// its row by a binary search of the rows' exclusive counts across the lanes
// (__shfl_sync), and copies that row's lane k - (its row's start).  The
// stores coalesce, and the loads cost one pass for every 32 events or runs
// of the warp, not one for each row.  Tiles of 256 rows keep the look-back
// short: every tile reaches it at about the same time, so a tile walks back
// through the aggregates of the tiles before it, 32 a step.  The wrapper
// allocates the flat outputs at their capacity (N x W, N x R); the last
// tile writes the two totals, which the wrapper reads once after the launch:
// no host read comes between counting and copying.
// ---------------------------------------------------------------------------
#define COMPACT_TILE_ROWS SCAN_THREADS  // 256 rows, a row a thread
#define COMPACT_RUN_BITS 31
#define COMPACT_RUN_MASK ((1ull << COMPACT_RUN_BITS) - 1)

// The real runs of row r: the leading lanes of its run_p0 row that hold a
// run (>= 0).  first is lane `lane`'s load of the row's first 32 lanes.
static __device__ __forceinline__ int compact_row_runs(const int64_t* __restrict__ run_p0,
                                                       int64_t r, int R, int lane,
                                                       int64_t first) {
  unsigned m = __ballot_sync(THREAD_FULL_MASK, first >= 0);
  int runs = __popc(m);
  for (int j0 = 32; m == THREAD_FULL_MASK && j0 < R; j0 += 32) {
    const int j = j0 + lane;
    m = __ballot_sync(THREAD_FULL_MASK, j < R && run_p0[r * R + j] >= 0);
    runs += __popc(m);
  }
  return runs;
}

// Copy a warp's stretch: the first entries of each of its 32 rows (rows of
// `width` lanes from row0 on, in n_src arrays), row after row, to dst[0,
// total).  Lane q holds row q's exclusive count `ex` (the total for lanes
// past the last row).
static __device__ __forceinline__ void compact_copy(int lane, int ex, int total, int64_t row0,
                                                    int width, int n_src,
                                                    const int64_t* const* src,
                                                    int64_t* const* dst) {
  for (int k0 = 0; k0 < total; k0 += 32) {
    const int k = k0 + lane;
    int q = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(THREAD_FULL_MASK, ex, q + step) <= k) q += step;
    }
    const int start = __shfl_sync(THREAD_FULL_MASK, ex, q);
    if (k < total) {
      const int64_t at = (row0 + q) * width + (k - start);
#pragma unroll
      for (int a = 0; a < n_src; ++a) dst[a][k] = src[a][at];
    }
  }
}

__global__ void __launch_bounds__(SCAN_THREADS) compact_rows_kernel(
    const int64_t* __restrict__ ev_cid, const int64_t* __restrict__ ev_run,
    const int64_t* __restrict__ n_events, const int64_t* __restrict__ run_p0,
    const int64_t* __restrict__ run_p1, const int64_t* __restrict__ run_o0,
    const int64_t* __restrict__ run_o1, int64_t n_rows, int W, int R,
    unsigned long long* scratch, int64_t* __restrict__ c_cid, int64_t* __restrict__ c_run,
    int64_t* __restrict__ c_p0, int64_t* __restrict__ c_p1, int64_t* __restrict__ c_o0,
    int64_t* __restrict__ c_o1, int64_t* __restrict__ n_runs, int64_t* __restrict__ totals) {
  __shared__ ScanShared sh;
  __shared__ unsigned long long s_warp[SCAN_WARPS];
  const long long tile = scan_ticket(scratch, &sh);
  const int lane = threadIdx.x & 31;
  const int64_t row0 = tile * COMPACT_TILE_ROWS + (threadIdx.x & ~31);
  const bool my_row = row0 + lane < n_rows;
  const int my_ev = my_row ? (int)n_events[row0 + lane] : 0;
  int64_t first[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int64_t r = row0 + q;
    first[q] = r < n_rows && lane < R ? run_p0[r * R + lane] : -1;
  }
  int my_runs = 0;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int64_t r = row0 + q;
    if (r >= n_rows) break;  // the whole warp
    const int runs = compact_row_runs(run_p0, r, R, lane, first[q]);
    if (lane == q) my_runs = runs;
  }
  const unsigned long long v = ((unsigned long long)my_ev << COMPACT_RUN_BITS) | my_runs;
  unsigned long long aggregate;
  const unsigned long long before = block_exclusive_scan(v, s_warp, &aggregate);
  unsigned long long* status = scratch + 1;
  scan_publish_aggregate(status, tile, aggregate);
  const unsigned long long prefix = scan_tile_prefix(status, tile, aggregate, &sh);
  if (tile == gridDim.x - 1 && threadIdx.x == 0) {
    totals[0] = (int64_t)((prefix + aggregate) >> COMPACT_RUN_BITS);
    totals[1] = (int64_t)((prefix + aggregate) & COMPACT_RUN_MASK);
  }
  const unsigned long long at = __shfl_sync(THREAD_FULL_MASK, prefix + before, 0);
  if (my_row) n_runs[row0 + lane] = my_runs;
  // the warp's stretches: its rows' exclusive counts, lane by lane
  const unsigned long long in_warp = warp_inclusive_scan(v) - v;
  const int ex_e = (int)(in_warp >> COMPACT_RUN_BITS);
  const int ex_r = (int)(in_warp & COMPACT_RUN_MASK);
  const unsigned long long end = __shfl_sync(THREAD_FULL_MASK, in_warp + v, 31);
  const int64_t* ev_src[2] = {ev_cid, ev_run};
  const int64_t at_e = (int64_t)(at >> COMPACT_RUN_BITS), at_r = (int64_t)(at & COMPACT_RUN_MASK);
  int64_t* ev_dst[2] = {c_cid + at_e, c_run + at_e};
  compact_copy(lane, ex_e, (int)(end >> COMPACT_RUN_BITS), row0, W, 2, ev_src, ev_dst);
  const int64_t* run_src[4] = {run_p0, run_p1, run_o0, run_o1};
  int64_t* run_dst[4] = {c_p0 + at_r, c_p1 + at_r, c_o0 + at_r, c_o1 + at_r};
  compact_copy(lane, ex_r, (int)(end & COMPACT_RUN_MASK), row0, R, 4, run_src, run_dst);
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

// Scratch words (8 bytes each) shannon_compact_rows takes for n_rows rows:
// the scan's ticket and a status word a tile of COMPACT_TILE_ROWS rows.
int64_t shannon_compact_rows_words(int64_t n_rows) {
  return (n_rows + COMPACT_TILE_ROWS - 1) / COMPACT_TILE_ROWS + 1;
}

// ev rows [n_rows, W], run rows [n_rows, R] and n_events [n_rows], K4's
// layout; flat outputs at their capacities n_rows x W (c_cid, c_run) and
// n_rows x R (the four runs); scratch: shannon_compact_rows_words(n_rows)
// words, zeroed here; totals [2]: the events and runs written, int64.
int shannon_compact_rows(const void* ev_cid, const void* ev_run, const void* n_events,
                         const void* run_p0, const void* run_p1, const void* run_o0,
                         const void* run_o1, int64_t n_rows, int W, int R, void* scratch,
                         int64_t scratch_words, void* c_cid, void* c_run, void* c_p0,
                         void* c_p1, void* c_o0, void* c_o1, void* n_runs, void* totals,
                         void* stream) {
  const int64_t tiles = shannon_compact_rows_words(n_rows) - 1;
  if (n_rows < 0 || W < 0 || R < 1 || scratch_words != tiles + 1 ||
      n_rows * (int64_t)W > (int64_t)COMPACT_RUN_MASK ||
      n_rows * (int64_t)R > (int64_t)COMPACT_RUN_MASK) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (tiles == 0) return (int)cudaMemsetAsync(totals, 0, 2 * sizeof(int64_t), s);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (size_t)(tiles + 1), s);
  if (err != cudaSuccess) return (int)err;
  compact_rows_kernel<<<(unsigned int)tiles, SCAN_THREADS, 0, s>>>(
      (const int64_t*)ev_cid, (const int64_t*)ev_run, (const int64_t*)n_events,
      (const int64_t*)run_p0, (const int64_t*)run_p1, (const int64_t*)run_o0,
      (const int64_t*)run_o1, n_rows, W, R, (unsigned long long*)scratch, (int64_t*)c_cid,
      (int64_t*)c_run, (int64_t*)c_p0, (int64_t*)c_p1, (int64_t*)c_o0, (int64_t*)c_o1,
      (int64_t*)n_runs, (int64_t*)totals);
  return (int)cudaGetLastError();
}

}  // extern "C"
