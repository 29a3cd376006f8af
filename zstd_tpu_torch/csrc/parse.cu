// Greedy LZ77 parse of block lanes, one warp per lane: walk positions left
// to right, take a match where the hash candidate shares >= MIN_MATCH
// bytes, extend 8-capped matches, skip ahead faster the longer the literal
// run, and emit (literal length, match length, offset) records.
//
// Replaces: zstd_tpu/ops/match_finder.py::_parse_kernel (:98; wrapper
// parse_blocks, :179), a Pallas kernel with one grid step per lane and
// position chunk, candidates in SMEM and the block in VMEM rows.
//
// Bound on this card: 8 bytes read per position the walk visits (its
// candidate and lcp), 2 per byte a match extension compares, and 12 bytes
// written per record, over 3.35 TB/s. The walk is serial per lane (where it
// goes next depends on what it found), so the kernel is latency-bound far
// above that. The design keeps the chain
// short: the warp loads the candidates and lcps of 32 positions at once
// (one coalesced load each) and shuffles the one the walk needs, so a
// literal stretch costs a shuffle per step, not a trip to memory; a
// match's extension compares 32 bytes per step with __ballot_sync.
//
// Semantics kept from the reference: a match is taken at i when
// lcp >= MIN_MATCH and cand >= 0, with offset i - cand; it is extended past
// the 8-byte cap only when lcp == 8, byte-equal up to n_valid, in whole
// 128-byte steps, stopping at the first step that falls short or leaves
// the length at 1 << 20 or more; otherwise the walk skips
// 1 + ((i - anchor) >> 8). At MAX_SEQS records the rest of the lane is the
// trailing literal run from `anchor`. The lcp input is capped at
// n_valid - i and the extension stops at n_valid, so no byte past n_valid
// is compared.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MIN_MATCH = 5;
constexpr int MAX_SEQS = 32768;
constexpr int EXTEND_STEP = 128;
constexpr int EXTEND_CAP = 1 << 20;
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void parse_kernel(const uint8_t* __restrict__ data, long long L,
                             const int32_t* __restrict__ cand,
                             const int32_t* __restrict__ lcp,
                             const int32_t* __restrict__ n_valid, int B,
                             int32_t* __restrict__ ll, int32_t* __restrict__ ml,
                             int32_t* __restrict__ off,
                             int32_t* __restrict__ nseq,
                             int32_t* __restrict__ anchor_out) {
  const int b = blockIdx.x;  // one warp (the whole block) per lane
  const int lane = threadIdx.x;
  if (b >= B) return;
  const uint8_t* d = data + (long long)b * L;
  const int32_t* cd = cand + (long long)b * L;
  const int32_t* lc = lcp + (long long)b * L;
  int32_t* o_ll = ll + (long long)b * MAX_SEQS;
  int32_t* o_ml = ml + (long long)b * MAX_SEQS;
  int32_t* o_of = off + (long long)b * MAX_SEQS;
  const int nv = (int)min(max((long long)n_valid[b], 0ll), L);

  int i = 0, anchor = 0, ns = 0;
  int wb = -EXTEND_STEP;  // first position of the loaded window
  int w_lcp = 0, w_cand = -1;
  while (i < nv && ns < MAX_SEQS) {
    if (i - wb >= 32) {  // positions only grow: reload at i
      wb = i;
      int p = wb + lane;
      w_lcp = p < nv ? lc[p] : 0;
      w_cand = p < nv ? cd[p] : -1;
    }
    const int l = __shfl_sync(FULL, w_lcp, i - wb);
    const int c = __shfl_sync(FULL, w_cand, i - wb);
    if (l >= MIN_MATCH && c >= 0) {
      const int o = i - c;
      int m = l;
      bool go = m == 8;
      while (go) {
        const int p = i + m;
        const int lim = min(nv - p, EXTEND_STEP);
        int adv = lim;
        for (int j0 = 0; j0 < lim; j0 += 32) {
          const int j = j0 + lane;
          const bool ne = j < lim && d[p + j] != d[p - o + j];
          const unsigned mask = __ballot_sync(FULL, ne);
          if (mask) {
            adv = j0 + __ffs(mask) - 1;
            break;
          }
        }
        m += adv;
        go = adv >= EXTEND_STEP && m < EXTEND_CAP;
      }
      if (lane == 0) {
        o_ll[ns] = i - anchor;
        o_ml[ns] = m;
        o_of[ns] = o;
      }
      ++ns;
      i += m;
      anchor = i;
    } else {
      // literal-run acceleration a la the reference skip_matching
      i += 1 + ((i - anchor) >> 8);
    }
  }
  if (lane == 0) {
    nseq[b] = ns;
    anchor_out[b] = anchor;
  }
}

}  // namespace

extern "C" int zt_parse_lanes(const void* data, long long L, const void* cand,
                              const void* lcp, const void* n_valid, int B,
                              void* ll, void* ml, void* off, void* nseq,
                              void* anchor, void* stream) {
  if (B > 0) {
    parse_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, L, (const int32_t*)cand, (const int32_t*)lcp,
        (const int32_t*)n_valid, B, (int32_t*)ll, (int32_t*)ml,
        (int32_t*)off, (int32_t*)nseq, (int32_t*)anchor);
  }
  return (int)cudaGetLastError();
}
