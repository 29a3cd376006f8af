// Repeat-offset resolution of every frame row: the concrete offsets (B, S)
// i32, the exact output length and the ok flag of each row; with chained
// block groups, each group's incoming history composed along its chain
// first.
//
// Replaces: zstd_tpu/ops/sequence.py::_prefix_compose,
// ::resolve_offsets and ::resolve_offsets_symbolic (XLA, no Pallas
// kernel), and zstd_tpu/models/batch_decoder.py::_resolve and
// ::_resolve_chained around them.
//
// Semantics (zstd_tpu_torch/ops/sequence.py::resolve_frames_plain, parity
// with sequence_execution.rs:59-115): a record's effect on the 3-entry
// history is a transform of the incoming history, each new entry either
// hist[t] - v (t in 0..2) or the constant v (t == 3), and its offset is
// such a symbol too (_rec_symbols). A synthetic record (is_real false)
// leaves the history alone and its offset is its of_value. offsets =
// the record's symbol against the history before it; out_len = the row's
// sum of ll + ml, wrapped to int32; ok is false when a real record
// resolves to an offset <= 0 or carries an of_value <= 0. All arithmetic is
// uint32 reinterpreted, so the kernel and the plain version (int32 that
// wraps) agree bit for bit on any input: a symbol's value is a sum of
// record values, and a sum mod 2^32 does not depend on its order.
//
// Design. Each row is cut into segments of seg_w slots (1024 from the
// wrapper), one warp each, so a long row (a chained group holds ~90,000
// slots) is many warps, not one serial walk. A warp walks its segment 32
// slots a step: each thread builds its record's transform; a 5-step
// __shfl_up_sync scan composes them, so each thread holds the transform of
// the chunk's records up to its own; the transform before its record,
// composed after the history the warp carries from chunk to chunk in
// registers, gives its offset. Tags ride packed in 2-bit fields. Three
// launches on one stream, no host sync between them:
//   1. every segment from the symbolic identity history: its outgoing
//      transform into `segt` (16 bytes a segment);
//   2. with chains only, one thread per chain: the rows' segments applied
//      in order along chain_rows, writing the incoming history of every
//      row that chain_cont marks (the inert padding row never is);
//   3. every segment again, from its row's incoming history composed with
//      the transforms of the row's earlier segments (a shuffle scan, 32
//      segments a step): the concrete offsets, ll + ml added to out_len
//      (atomically, mod 2^32) and ok cleared by a bad record.
//
// Bound on this card: ll, ml, of_value (i32) and is_real (u8) read once
// and the offsets written once, 17 bytes a slot, over 3.35 TB/s. The first
// launch reads ll, of_value and is_real again (9 bytes a slot), so the
// design moves 26 bytes a slot.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;  // warps per block

// new entry s = t_s == 3 ? v_s : hist[t_s] - v_s; t packs t_0, t_1, t_2 in
// bits 0-1, 2-3, 4-5
struct Trans {
  uint32_t t;
  uint32_t v0, v1, v2;
};

__device__ __forceinline__ Trans identity() { return Trans{0u | 1u << 2 | 2u << 4, 0, 0, 0}; }

__device__ __forceinline__ uint32_t sel(uint32_t i, uint32_t a, uint32_t b, uint32_t c) {
  return i == 0 ? a : (i == 1 ? b : c);
}

// symbol (bt, bv) against transform a: (tag, value) of a(hist)[bt] - bv
__device__ __forceinline__ void apply(const Trans& a, uint32_t bt, uint32_t bv,
                                      uint32_t& ct, uint32_t& cv) {
  if (bt == 3) {
    ct = 3;
    cv = bv;
    return;
  }
  uint32_t ts = (a.t >> (2 * bt)) & 3u;
  uint32_t vs = sel(bt, a.v0, a.v1, a.v2);
  ct = ts;
  cv = ts == 3 ? vs - bv : vs + bv;
}

// transform a, then transform b
__device__ __forceinline__ Trans compose(const Trans& a, const Trans& b) {
  Trans r;
  uint32_t t0, t1, t2;
  apply(a, b.t & 3u, b.v0, t0, r.v0);
  apply(a, (b.t >> 2) & 3u, b.v1, t1, r.v1);
  apply(a, (b.t >> 4) & 3u, b.v2, t2, r.v2);
  r.t = t0 | t1 << 2 | t2 << 4;
  return r;
}

__device__ __forceinline__ Trans shfl_up(const Trans& x, int d) {
  return Trans{__shfl_up_sync(kFull, x.t, d), __shfl_up_sync(kFull, x.v0, d),
               __shfl_up_sync(kFull, x.v1, d), __shfl_up_sync(kFull, x.v2, d)};
}

__device__ __forceinline__ Trans shfl(const Trans& x, int src) {
  return Trans{__shfl_sync(kFull, x.t, src), __shfl_sync(kFull, x.v0, src),
               __shfl_sync(kFull, x.v1, src), __shfl_sync(kFull, x.v2, src)};
}

__device__ __forceinline__ Trans load_trans(const uint4* segt, long long i) {
  uint4 q = segt[i];
  return Trans{q.x, q.y, q.z, q.w};
}

// A warp's task: slots [seg * seg_w, (seg + 1) * seg_w) of one row.
// kMode 1: the segment's transform into segt[task] (and, from segment 0,
// out_len 0 and ok 1 for the row). kMode 0: the concrete offsets against
// hist[row] and the segments before this one, the segment's ll + ml added
// to out_len and its bad records clearing ok.
template <int kMode>
__global__ void __launch_bounds__(32 * kWarps) segment_kernel(
    const int32_t* __restrict__ ll, const int32_t* __restrict__ ml,
    const int32_t* __restrict__ of, const uint8_t* __restrict__ is_real,
    long long S, int B, int seg_w, int nseg, uint4* __restrict__ segt,
    const int32_t* __restrict__ hist, int32_t* __restrict__ offsets,
    int32_t* __restrict__ out_len, uint8_t* __restrict__ ok_out) {
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= (long long)B * nseg) return;
  const int row = (int)(task / nseg);
  const int seg = (int)(task % nseg);
  const long long base = (long long)row * S;
  const long long lo = (long long)seg * seg_w;
  const long long hi = min(S, lo + seg_w);

  Trans carry;
  if (kMode == 0) {
    const int32_t* h = hist + 3LL * row;
    carry = Trans{3u | 3u << 2 | 3u << 4, (uint32_t)h[0], (uint32_t)h[1],
                  (uint32_t)h[2]};
    // the segments before this one, 32 at a time
    for (int j0 = 0; j0 < seg; j0 += 32) {
      Trans x = j0 + lane < seg ? load_trans(segt, (long long)row * nseg + j0 + lane)
                                : identity();
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        Trans y = shfl_up(x, d);
        if (lane >= d) x = compose(y, x);
      }
      carry = compose(carry, shfl(x, 31));
    }
  } else {
    carry = identity();
  }
  uint32_t len = 0;
  bool bad = false;

  // software pipeline: the next chunk's loads are in flight during a scan
  int32_t n_l = 0, n_m = 0, n_o = 0;
  uint8_t n_r = 0;
  if (lo + lane < hi) {
    n_l = ll[base + lo + lane];
    if (kMode == 0) n_m = ml[base + lo + lane];
    n_o = of[base + lo + lane];
    n_r = is_real[base + lo + lane];
  }
  for (long long c0 = lo; c0 < hi; c0 += 32) {
    const long long s = c0 + lane;
    const bool live = s < hi;
    const int32_t l = n_l, m = n_m, o = n_o;
    const bool real = live && n_r != 0;
    const long long sn = s + 32;
    if (sn < hi) {
      n_l = ll[base + sn];
      if (kMode == 0) n_m = ml[base + sn];
      n_o = of[base + sn];
      n_r = is_real[base + sn];
    }

    // the record's output symbol and history transform (_rec_symbols)
    const int32_t idx = l == 0 ? (int32_t)((uint32_t)o + 1u) : o;
    const bool lit = o > 3;
    const uint32_t ot = (!real || lit) ? 3u : (idx == 2 ? 1u : (idx == 3 ? 2u : 0u));
    const uint32_t ov = !real ? (uint32_t)o
                              : (lit ? (uint32_t)o - 3u : (idx >= 4 ? 1u : 0u));
    const bool shift = real && (lit || idx >= 2);
    const bool shift2 = real && (lit || idx >= 3);
    Trans x;
    x.t = (shift ? ot : 0u) | (shift ? 0u : 1u) << 2 | (shift2 ? 1u : 2u) << 4;
    x.v0 = shift ? ov : 0u;
    x.v1 = 0;
    x.v2 = 0;

#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      Trans y = shfl_up(x, d);
      if (lane >= d) x = compose(y, x);
    }
    if (kMode == 0) {
      Trans ex = shfl_up(x, 1);
      if (lane == 0) ex = identity();
      Trans before = compose(carry, ex);
      uint32_t tag, val;
      apply(before, ot, ov, tag, val);  // tag is 3: the carry is concrete
      if (live) {
        offsets[base + s] = (int32_t)val;
        len += (uint32_t)l + (uint32_t)m;
        bad |= real && ((int32_t)val <= 0 || o <= 0);
      }
    }
    carry = compose(carry, shfl(x, 31));
  }

  if (kMode == 0) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) len += __shfl_xor_sync(kFull, len, d);
    const bool any_bad = __any_sync(kFull, bad);
    if (lane == 0) {
      atomicAdd(reinterpret_cast<unsigned int*>(out_len) + row, len);
      if (any_bad) ok_out[row] = 0;
    }
  } else if (lane == 0) {
    segt[task] = make_uint4(carry.t, carry.v0, carry.v1, carry.v2);
    if (seg == 0) {
      out_len[row] = 0;
      ok_out[row] = 1;
    }
  }
}

__device__ __forceinline__ int clamp_row(int r, int B) { return min(max(r, 0), B - 1); }

// one thread per chain: h = the chain's first row's initial history, then
// each next row's incoming history = the previous row's segments applied
// to h in order
__global__ void chains_kernel(const int32_t* __restrict__ rows, int C, int K,
                              const uint8_t* __restrict__ cont,
                              const int32_t* __restrict__ init_hist,
                              const uint4* __restrict__ segt, int B, int nseg,
                              int32_t* __restrict__ hist) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int32_t* plan = rows + (long long)c * K;
  int r = clamp_row(plan[0], B);
  uint32_t h[3] = {(uint32_t)init_hist[3LL * r], (uint32_t)init_hist[3LL * r + 1],
                   (uint32_t)init_hist[3LL * r + 2]};
  for (int k = 1; k < K; ++k) {
    for (int g = 0; g < nseg; ++g) {
      const Trans t = load_trans(segt, (long long)r * nseg + g);
      const uint32_t v[3] = {t.v0, t.v1, t.v2};
      uint32_t n[3];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const uint32_t tag = (t.t >> (2 * s)) & 3u;
        n[s] = tag == 3 ? v[s] : sel(tag, h[0], h[1], h[2]) - v[s];
      }
      h[0] = n[0];
      h[1] = n[1];
      h[2] = n[2];
    }
    r = clamp_row(plan[k], B);
    if (cont[r]) {
      hist[3LL * r] = (int32_t)h[0];
      hist[3LL * r + 1] = (int32_t)h[1];
      hist[3LL * r + 2] = (int32_t)h[2];
    }
  }
}

}  // namespace

// rows == nullptr (C == 0): no chains, offsets against init_hist.
// Otherwise `hist` holds a copy of init_hist on entry. `segt` is scratch of
// B * ceil(S / seg_w) uint4, one per warp task of seg_w slots (a multiple
// of 32).
extern "C" int zt_resolve_frames(
    const void* ll, const void* ml, const void* of, const void* is_real,
    long long S, int B, const void* init_hist, const void* rows, int C,
    int K, const void* cont, int seg_w, void* segt, void* hist,
    void* offsets, void* out_len, void* ok, void* stream) {
  if (B > 0 && S > 0 && seg_w > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int nseg = (int)((S + seg_w - 1) / seg_w);
    const long long tasks = (long long)B * nseg;
    const unsigned blocks = (unsigned)((tasks + kWarps - 1) / kWarps);
    const int32_t* h = (const int32_t*)init_hist;
    segment_kernel<1><<<blocks, 32 * kWarps, 0, st>>>(
        (const int32_t*)ll, (const int32_t*)ml, (const int32_t*)of,
        (const uint8_t*)is_real, S, B, seg_w, nseg, (uint4*)segt, nullptr,
        nullptr, (int32_t*)out_len, (uint8_t*)ok);
    if (rows != nullptr && C > 0) {
      chains_kernel<<<(C + 127) / 128, 128, 0, st>>>(
          (const int32_t*)rows, C, K, (const uint8_t*)cont, h,
          (const uint4*)segt, B, nseg, (int32_t*)hist);
      h = (const int32_t*)hist;
    }
    segment_kernel<0><<<blocks, 32 * kWarps, 0, st>>>(
        (const int32_t*)ll, (const int32_t*)ml, (const int32_t*)of,
        (const uint8_t*)is_real, S, B, seg_w, nseg, (uint4*)segt, h,
        (int32_t*)offsets, (int32_t*)out_len, (uint8_t*)ok);
  }
  return (int)cudaGetLastError();
}
