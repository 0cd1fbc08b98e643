// Dead-end rescue, kernel K8 of the shannon_tpu_torch port (plain C interface;
// see kernels.cu for the conventions every entry point follows).
//
// ---------------------------------------------------------------------------
// K8: every dead-end rescue round of one call, enqueued back to back.
// Replaces shannon_tpu/ops/correction.py:143 _rescue_chunk: up to `rounds`
// Jacobi rounds, stopping after the first round that rescues nothing, and
// that last round's changed flag.  A lane the abundance cut dropped (raw > 0,
// counts == 0) is rescued in a round iff an extension on one side is alive
// and every sibling on the other side is dead (lines 161-175).
// Bound: memory, most of it round 1 on the main path: the cut lanes'
// extension rows and the idx of their hits, then the sibling rows of the few
// lanes with an alive extension.  The probe tables are [8, C] (12,582,912
// lanes at 1M reads, 1.8 GB with their idx), so a later round's lanes, each
// at a random place in them, are bound by random DRAM sectors, not bytes.
// Design.
//  - One state byte a lane: RESCUE_CAND for a lane the cut dropped,
//    RESCUE_ALIVE for one alive from the start, RESCUE_NEVER for one that is
//    dead and can never be rescued, and t + 1 once it is rescued in round t.
//    A probe target is alive in round t iff its byte lies in [1, t]
//    (rescue_alive), so a lane rescued in round t still reads as dead to
//    every lane in round t: the rounds update in place and stay Jacobi.  The
//    targets' aliveness is gathered from this byte array (12.6 MB on the main
//    path, inside L2), never from the 50 MB of int32 counts.
//  - One pass first (rescue_init_kernel) writes the state bytes, copies the
//    counts to the output (a lane rescued later writes its raw count there,
//    so no round copies the table) and packs each cut lane's 16 hit flags
//    into one uint16, so a later round reads one sector for them, not 16.
//  - Frontier.  Round 1 takes every lane.  Round t + 1 takes only the cut
//    lanes with an extension target rescued in round t.  A lane's decision
//    reads only its 16 targets, and aliveness only grows, so a lane whose
//    targets did not change decides as before (not rescued); one whose
//    sibling came alive can only lose a rescue, never gain one.  Only a new
//    alive extension can rescue a lane.  The probe relation is symmetric
//    within each family (x extends y iff y extends x, x is a sibling of y iff
//    y is one of x, canonical forms included; the CPU tests check it on their
//    spectra), so a lane rescued in round t marks its own hit extension
//    targets that are still cut in round t + 1's bitmap (atomicOr: a lane
//    marked twice is listed once).  Round t + 1 scans that bitmap (C / 8
//    bytes), a thread a word, clears each word it takes and evaluates its set
//    bits.  Two bitmaps alternate.  The order in which a round meets its
//    lanes changes from run to run; no decision depends on it.
//  - No counter every warp hits: each thread counts its frontier and its
//    rescues in registers, and a warp adds them to ctl once, after its last
//    lane.  (A list appended by a warp-wide atomicAdd on one length, or a
//    count per warp on one address, serializes the dense round's hundreds
//    of thousands of warps on that address: measured slower than a whole
//    one-round pass over the table, PERF.md section 6.)
//  - A lane's loads come in waves, so it waits on few in a row (rescue_decide).
//  - No host sync between rounds.  A round after one that rescued nothing
//    returns at once; the wrapper reads ctl once, after the last round.
// ---------------------------------------------------------------------------

#include "common.cuh"

#define RESCUE_CAND 0
#define RESCUE_ALIVE 1
#define RESCUE_NEVER 255
// Stamps run up to rounds + 1 below RESCUE_NEVER (ops/correction.py
// RESCUE_MAX_ROUNDS; the wrapper splits a longer call into chunks).
#define RESCUE_MAX_ROUNDS 253
// Blocks of round 1 (grid-stride over lanes); a later round takes as many
// as are resident at once (grid-stride over bitmap words), so a small
// frontier does not wait on waves of blocks with nothing to do.
#define RESCUE_GRID 2112
// Resident blocks of a round an SM asks for (40 registers a thread): its
// time is the latency of its lanes' loads, so residency is what it buys.
#define RESCUE_BLOCKS_PER_SM 6
#define RESCUE_FULL_MASK 0xffffffffu

static __device__ __forceinline__ bool rescue_alive(uint8_t s, int t) {
  return (unsigned)(uint8_t)(s - 1) < (unsigned)t;
}

__global__ void rescue_init_kernel(const int32_t* __restrict__ counts,
                                   const int32_t* __restrict__ raw,
                                   const uint8_t* __restrict__ shit,
                                   const uint8_t* __restrict__ ehit, int64_t C,
                                   uint8_t* __restrict__ state, uint16_t* __restrict__ hits,
                                   int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int32_t c = counts[i];
  const uint8_t s = c > 0 ? RESCUE_ALIVE : (c == 0 && raw[i] > 0 ? RESCUE_CAND : RESCUE_NEVER);
  state[i] = s;
  out[i] = c;
  if (s != RESCUE_CAND) return;
  unsigned m = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    m |= (unsigned)ehit[(int64_t)p * C + i] << p;
    m |= (unsigned)shit[(int64_t)p * C + i] << (8 + p);
  }
  hits[i] = (uint16_t)m;
}

// Cut lane i in round t: whether it is rescued, and in *push the rows whose
// extension target was still cut (what a rescue marks for round t + 1), with
// those targets in ey.  hm holds the lane's 16 hit flags (hits[i]:
// extension rows in bits 0-7, sibling rows in bits 8-15).  Eager (a frontier lane,
// which always has a newly alive extension): the idx of every hit, then the
// state byte of every target, so the lane waits on three loads in a row.
// Lazy (round 1, where most cut lanes have no alive extension): extensions
// first, then only the sibling rows opposite an alive extension.
static __device__ __forceinline__ bool rescue_decide(
    const int64_t* __restrict__ sidx, const int64_t* __restrict__ eidx, unsigned hm,
    const uint8_t* state, int64_t C, int64_t i, int t, bool eager, int32_t ey[8],
    unsigned* push) {
  int32_t sy[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int64_t l = (int64_t)p * C + i;
    ey[p] = (hm >> p) & 1 ? (int32_t)eidx[l] : 0;
    if (eager) sy[p] = (hm >> (8 + p)) & 1 ? (int32_t)sidx[l] : 0;
  }
  unsigned ext = 0, cut = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if ((hm >> p) & 1) {
      const uint8_t s = state[ey[p]];
      ext |= (unsigned)rescue_alive(s, t) << p;
      cut |= (unsigned)(s == RESCUE_CAND) << p;
    }
  }
  *push = cut;
  if (ext == 0) return false;
  // even rows are right probes, odd rows left ones: an alive left extension
  // needs every right sibling dead, an alive right extension every left one
  const unsigned need = ((ext & 0xAAu) ? 0x55u : 0u) | ((ext & 0x55u) ? 0xAAu : 0u);
  unsigned sib = 0;
  if (!eager) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      sy[p] = (need >> p) & (hm >> (8 + p)) & 1 ? (int32_t)sidx[(int64_t)p * C + i] : 0;
    }
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if ((need >> p) & (hm >> (8 + p)) & 1) {
      sib |= (unsigned)rescue_alive(state[sy[p]], t) << p;
    }
  }
  return ((ext & 0xAAu) && !(sib & 0x55u)) || ((ext & 0x55u) && !(sib & 0xAAu));
}

// Rescue lane i in round t: stamp it, write its raw count, and unless
// `last` mark its extension targets that were still cut (push) in bits_out.
static __device__ __forceinline__ void rescue_lane(
    const int32_t* __restrict__ raw, int64_t i, int t, int last, const int32_t ey[8],
    unsigned push, uint32_t* __restrict__ bits_out, uint8_t* state, int32_t* __restrict__ out) {
  state[i] = (uint8_t)(t + 1);
  out[i] = raw[i];
  if (last) return;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if ((push >> p) & 1) atomicOr(&bits_out[ey[p] >> 5], 1u << (ey[p] & 31));
  }
}

// Round t: every lane (t == 1) or the lanes set in bits_in, whose words it
// clears.  Adds the round's frontier to ctl[t] and its rescues to
// ctl[rounds + 2 + t].
__global__ void __launch_bounds__(THREADS, RESCUE_BLOCKS_PER_SM) rescue_round_kernel(
    const int32_t* __restrict__ raw, const int64_t* __restrict__ sidx,
    const int64_t* __restrict__ eidx, const uint16_t* __restrict__ hits, int64_t C, int t,
    int rounds, int last,
    uint32_t* __restrict__ bits_in, uint32_t* __restrict__ bits_out, uint8_t* state,
    int32_t* __restrict__ out, int32_t* ctl) {
  int32_t* rescued = ctl + rounds + 2;
  if (t > 1 && rescued[t - 1] == 0) return;  // the loop has stopped
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned n_front = 0, n_resc = 0;
  int32_t ey[8];
  unsigned push;
  if (t == 1) {
    for (int64_t i = first; i < C; i += stride) {
      if (state[i] != RESCUE_CAND) continue;
      ++n_front;
      if (rescue_decide(sidx, eidx, hits[i], state, C, i, t, false, ey, &push)) {
        ++n_resc;
        rescue_lane(raw, i, t, last, ey, push, bits_out, state, out);
      }
    }
  } else {
    const int64_t words = (C + 31) / 32;
    for (int64_t w = first; w < words; w += stride) {
      uint32_t m = bits_in[w];
      if (m == 0) continue;
      bits_in[w] = 0;
      n_front += __popc(m);
      for (; m != 0; m &= m - 1) {
        const int64_t i = 32 * w + (__ffs(m) - 1);
        const uint8_t si = state[i];
        const unsigned hm = hits[i];  // beside state[i], not after it
        if (si == RESCUE_CAND && rescue_decide(sidx, eidx, hm, state, C, i, t, true, ey, &push)) {
          ++n_resc;
          rescue_lane(raw, i, t, last, ey, push, bits_out, state, out);
        }
      }
    }
  }
  n_front = __reduce_add_sync(RESCUE_FULL_MASK, n_front);
  n_resc = __reduce_add_sync(RESCUE_FULL_MASK, n_resc);
  if ((threadIdx.x & 31) == 0) {
    if (n_front) atomicAdd(&ctl[t], (int32_t)n_front);
    if (n_resc) atomicAdd(&rescued[t], (int32_t)n_resc);
  }
}

extern "C" {

// state: C bytes; hits: C uint16; bits: 2 x bit_words uint32 with bit_words
// = ceil(C / 32);
// ctl: 2 x (rounds + 2) int32; out: C int32.  bits and ctl are zeroed here.
// 1 <= rounds <= RESCUE_MAX_ROUNDS, C < 2^31.
int shannon_rescue_rounds(const void* counts, const void* raw, const void* sidx,
                          const void* shit, const void* eidx, const void* ehit, int64_t C,
                          int rounds, void* state, void* hits, void* bits, int64_t bit_words,
                          void* ctl, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rounds < 1 || rounds > RESCUE_MAX_ROUNDS || C < 0 || C >= (1ll << 31) ||
      bit_words != (C + 31) / 32) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemsetAsync(bits, 0, sizeof(uint32_t) * 2 * (size_t)bit_words, s);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(ctl, 0, sizeof(int32_t) * 2 * (size_t)(rounds + 2), s);
  }
  if (err != cudaSuccess || C == 0) return (int)err;
  rescue_init_kernel<<<blocks_for(C), THREADS, 0, s>>>(
      (const int32_t*)counts, (const int32_t*)raw, (const uint8_t*)shit, (const uint8_t*)ehit, C,
      (uint8_t*)state, (uint16_t*)hits, (int32_t*)out);
  err = cudaGetLastError();
  const unsigned int grid = blocks_for(C) < RESCUE_GRID ? blocks_for(C) : RESCUE_GRID;
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rescue_round_kernel, THREADS, 0);
  }
  const unsigned int resident = (unsigned int)(sms * per_sm) < grid ? sms * per_sm : grid;
  uint32_t* bit = (uint32_t*)bits;
  for (int t = 1; t <= rounds && err == cudaSuccess; ++t) {
    rescue_round_kernel<<<t == 1 ? grid : (resident > 0 ? resident : 1), THREADS, 0, s>>>(
        (const int32_t*)raw, (const int64_t*)sidx, (const int64_t*)eidx,
        (const uint16_t*)hits, C, t, rounds, t == rounds,
        bit + (t & 1) * bit_words, bit + ((t + 1) & 1) * bit_words, (uint8_t*)state,
        (int32_t*)out, (int32_t*)ctl);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // extern "C"
