// Error-correction kernels K7-K10 of the shannon_tpu_torch port (plain C
// interface; see kernels.cu for the conventions every entry point follows).
//
// The spectrum is a sorted table of C int64 keys with int32 counts, PAD past
// its real entries.  A probe table is [8, C], entry i of probe row p at
// p * C + i: row 2b is the right probe with base b, row 2b + 1 the left one
// (the row order of probe_keys in shannon_tpu_torch/ops/correction.py).  Its
// idx is meaningful only where hit, so K8 and K9 read idx only there.

#include "common.cuh"

// Reverse complement of the low 2k bits of a key (k <= 31): complement,
// reverse the 64 bits, swap the two bits of each base back, shift down.
static __device__ __forceinline__ uint64_t revcomp_bits(uint64_t key, int k) {
  const uint64_t mask = (1ull << (2 * k)) - 1;
  uint64_t r = __brevll(~key & mask);
  r = ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
  return r >> (64 - 2 * k);
}

// ---------------------------------------------------------------------------
// K7: probe lookup.
// Replaces shannon_tpu/ops/correction.py:78 _probe_resolve (with
// ops/kmers.py:69 canonical_hilo and ops/spectrum.py:137 lookup_hilo).
// Bound: latency of the dependent loads of a binary search (log2(C) steps of
// 8 bytes per probe), not bandwidth.  One thread per (probe row p, entry i),
// i fastest, so the key loads and the idx/hit stores are coalesced.  The
// probe is built in registers with the plain version's exact bit operations
// (pad lanes included, whose probes keep the bits above 2k), so the [8, C]
// probe tensor of the plain version is never stored; the search is K3's
// (lower_bound_hit in common.cuh).
// ---------------------------------------------------------------------------
__global__ void probe_lookup_kernel(const int64_t* __restrict__ table,
                                    int64_t C, int k, int side_ext,
                                    int canonical, int64_t* __restrict__ idx,
                                    uint8_t* __restrict__ hit) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 8 * C) return;
  int p = (int)(t / C);
  int64_t i = t - (int64_t)p * C;
  const uint64_t v = (uint64_t)table[i];
  const uint64_t mask = (1ull << (2 * k)) - 1;
  const uint64_t b = (uint64_t)(p >> 1);
  const int hs = 2 * (k - 1);
  const bool right = (p & 1) == 0;
  uint64_t q;
  if (side_ext) {
    q = right ? (((v << 2) | b) & mask) : ((v >> 2) | (b << hs));
  } else {
    q = right ? ((v & ~3ull) | b) : ((v & (mask >> 2)) | (b << hs));
  }
  int64_t key = (int64_t)q;
  if (canonical) {
    int64_t rc = (int64_t)revcomp_bits(q, k);
    key = rc < key ? rc : key;
  }
  int64_t lane;
  bool found = lower_bound_hit(table, C, key, &lane);
  idx[t] = lane;
  hit[t] = found ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K8: one dead-end rescue round.
// Replaces one round of shannon_tpu/ops/correction.py:143 _rescue_chunk (the
// loop body, lines 161-175).  A Jacobi round: it reads only the previous
// round's counts and writes a second buffer, so every lane decides on the
// same state, as the reference does.
// Bound: memory.  Only a lane that the cut dropped (raw > 0, counts == 0) can
// be rescued, and only such a lane reads its 16 probe rows and gathers the
// counts of the hits; every other lane copies its count through.  `changed`
// is set to 1 by any rescuing thread (the entry point zeroes it first).
// ---------------------------------------------------------------------------
__global__ void rescue_round_kernel(const int32_t* __restrict__ counts,
                                    const int32_t* __restrict__ raw,
                                    const int64_t* __restrict__ sidx,
                                    const uint8_t* __restrict__ shit,
                                    const int64_t* __restrict__ eidx,
                                    const uint8_t* __restrict__ ehit,
                                    int64_t C, int32_t* __restrict__ out,
                                    int32_t* __restrict__ changed) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int32_t c = counts[i];
  const int32_t r = raw[i];
  bool resc = false;
  if (r > 0 && c == 0) {
    bool rsib = false, lsib = false, rext = false, lext = false;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int64_t l = (int64_t)p * C + i;
      const bool s = shit[l] && counts[sidx[l]] > 0;
      const bool e = ehit[l] && counts[eidx[l]] > 0;
      if (p & 1) {
        lsib |= s;
        lext |= e;
      } else {
        rsib |= s;
        rext |= e;
      }
    }
    resc = (lext && !rsib) || (rext && !lsib);
  }
  out[i] = resc ? r : c;
  if (resc) *changed = 1;
}

// The error cap of a sibling maximum F: max(3, (lam + 4 sqrt(lam)) + 1) with
// lam = eps3 * F, in the reference's order.  Every operation is an explicit
// round-to-nearest intrinsic, so nvcc cannot contract a multiply and an add
// into an FMA and the sqrt is the correctly rounded one.
static __device__ __forceinline__ float error_cap(float F, float eps3) {
  const float lam = __fmul_rn(eps3, F);
  const float t = __fadd_rn(__fadd_rn(lam, __fmul_rn(4.0f, __fsqrt_rn(lam))), 1.0f);
  return fmaxf(3.0f, t);
}

// ---------------------------------------------------------------------------
// K9: one sibling-prune round.
// Replaces one round of shannon_tpu/ops/correction.py:184 _prune_chunk (the
// loop body, lines 205-217).  Jacobi, like K8.  A lane with count c > 0 takes
// the largest sibling count where hit on the right rows (0, 2, 4, 6) and on
// the left rows (1, 3, 5, 7) and is pruned when, on either side,
// f32(c) < ratio * f32(max) and, when use_cap, f32(c) <= error_cap(f32(max)).
// ratio and eps3 arrive as the float32 values the plain version uses.
// Bound: memory.  Lanes with count 0 copy through without touching the probe
// rows; the others read 8 hit bytes and gather the counts of their hits.
// ---------------------------------------------------------------------------
__global__ void prune_round_kernel(const int32_t* __restrict__ counts,
                                   const int64_t* __restrict__ sidx,
                                   const uint8_t* __restrict__ shit, int64_t C,
                                   float ratio, float eps3, int use_cap,
                                   int32_t* __restrict__ out,
                                   int32_t* __restrict__ changed) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int32_t c = counts[i];
  bool doomed = false;
  if (c > 0) {
    int32_t rmax = 0, lmax = 0;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int64_t l = (int64_t)p * C + i;
      if (shit[l]) {
        const int32_t v = counts[sidx[l]];
        if (p & 1) {
          lmax = v > lmax ? v : lmax;
        } else {
          rmax = v > rmax ? v : rmax;
        }
      }
    }
    const float cf = __int2float_rn(c);
    const float rf = __int2float_rn(rmax);
    const float lf = __int2float_rn(lmax);
    bool dr = cf < __fmul_rn(ratio, rf);
    bool dl = cf < __fmul_rn(ratio, lf);
    if (use_cap) {
      dr = dr && cf <= error_cap(rf, eps3);
      dl = dl && cf <= error_cap(lf, eps3);
    }
    doomed = dr || dl;
  }
  out[i] = doomed ? 0 : c;
  if (doomed) *changed = 1;
}

// ---------------------------------------------------------------------------
// K10: compaction of the kept entries.
// Replaces shannon_tpu/ops/correction.py:19 _compact (a 3-key sort of the
// whole table that moved the dropped lanes to the back).  scan is the
// inclusive torch.cumsum of the keep flags, taken between the caller's mask
// and this launch.  A kept lane moves to slot scan - 1, so the kept keys stay
// in table order and the table stays sorted without a sort; lanes from
// n = scan[C - 1] on are filled with PAD / 0.  The two writes never meet:
// every kept slot is below n.
// Bound: memory; one streaming pass.
// ---------------------------------------------------------------------------
__global__ void compact_keep_kernel(const int64_t* __restrict__ key,
                                    const int32_t* __restrict__ count,
                                    const uint8_t* __restrict__ keep,
                                    const int32_t* __restrict__ scan, int64_t C,
                                    int64_t* __restrict__ out_key,
                                    int32_t* __restrict__ out_count) {
  int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= C) return;
  if (keep[s]) {
    const int64_t slot = (int64_t)scan[s] - 1;
    out_key[slot] = key[s];
    out_count[slot] = count[s];
  }
  if (s >= (int64_t)scan[C - 1]) {
    out_key[s] = PAD_KEY;
    out_count[s] = 0;
  }
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
extern "C" {

int shannon_probe_lookup(const void* table, int64_t C, int k, int side_ext,
                         int canonical, void* idx, void* hit, void* stream) {
  if (C > 0) {
    probe_lookup_kernel<<<blocks_for(8 * C), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)table, C, k, side_ext, canonical, (int64_t*)idx,
        (uint8_t*)hit);
  }
  return (int)cudaGetLastError();
}

int shannon_rescue_round(const void* counts, const void* raw, const void* sidx,
                         const void* shit, const void* eidx, const void* ehit,
                         int64_t C, void* out, void* changed, void* stream) {
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int32_t), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (C > 0) {
    rescue_round_kernel<<<blocks_for(C), THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)counts, (const int32_t*)raw, (const int64_t*)sidx,
        (const uint8_t*)shit, (const int64_t*)eidx, (const uint8_t*)ehit, C,
        (int32_t*)out, (int32_t*)changed);
  }
  return (int)cudaGetLastError();
}

int shannon_prune_round(const void* counts, const void* sidx, const void* shit,
                        int64_t C, float ratio, float eps3, int use_cap,
                        void* out, void* changed, void* stream) {
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int32_t), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (C > 0) {
    prune_round_kernel<<<blocks_for(C), THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)counts, (const int64_t*)sidx, (const uint8_t*)shit, C,
        ratio, eps3, use_cap, (int32_t*)out, (int32_t*)changed);
  }
  return (int)cudaGetLastError();
}

int shannon_compact_keep(const void* key, const void* count, const void* keep,
                         const void* scan, int64_t C, void* out_key,
                         void* out_count, void* stream) {
  if (C > 0) {
    compact_keep_kernel<<<blocks_for(C), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)key, (const int32_t*)count, (const uint8_t*)keep,
        (const int32_t*)scan, C, (int64_t*)out_key, (int32_t*)out_count);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
