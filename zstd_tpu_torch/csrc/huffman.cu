// Huffman literal-stream decoder: one warp per lane over self-synchronising
// segments, fused with the stage's scatter into the frames' literal buffers.
//
// Replaces: zstd_tpu/ops/pallas_huffman.py::_huff_kernel (wrapper
// decode_huffman_lanes_pallas) together with the packed-word scatter-add of
// zstd_tpu/models/batch_decoder.py::_huff_bucket.
//
// Semantics (zstd_tpu/ops/huffman.py::decode_huffman_lanes, parity with
// literals_section_decoder.rs:88-147): the initial state is the top
// max_bits bits below init_pos; each step emits LUT[state].symbol, then
// state = ((state << nb) & mask) | next nb bits. A lane is ok iff
// init_pos >= 0, every symbol starts from pos > -max_bits, and the position
// ends at exactly -max_bits after nsym symbols; a lane with nsym <= 0 is a
// no-op and ok. Each decoded byte j lands at lit[dst_frame, dst_off + j]
// (bytes past the row width are dropped); a lane that is not ok clears
// frame_ok[dst_frame]. Streams and host prefills are byte-disjoint, so a
// plain store is the reference's scatter-add.
//
// Design. When every entry of the lane's table has 1 <= nb <= mb (mb >= 1;
// the framer's weight-grouped tables always do), the state is a function of
// the bit position alone: state == bits [p, p + mb) (zeros below bit 0), and
// decoding is the linked list p -> p - nb(LUT[bits [p, p + mb)]) from
// p0 = init_pos - mb. Huffman codes self-synchronise: a walk started at any
// position soon lands on the true chain (6.2 symbols on average, 71 at most
// on the main corpus, tests/test_torch_huffman_schedule.py). So a block of
// 32 threads takes one lane:
//   1. load: the lane's LUT (2^mb entries packed to 16 bits) into shared
//      memory, checked by the warp (ballot); the stream's bytes up to
//      init_pos into shared memory with 16-byte loads (a stream larger than
//      the call's staging size reads global memory through the same reader
//      with aligned 8-byte loads);
//   2. walk: (-mb, p0] is cut into up to 32 segments of at least 64 bits;
//      thread 0 starts at p0, thread k at its segment's top, and each walks
//      until it leaves its segment, keeping its exit and symbol count. Then
//      in warp rounds every thread whose start differs from the exit of the
//      segment above re-walks from that exit, until nothing changes (at
//      most 32 rounds; one on real data). A warp scan of the counts places
//      each segment's symbols;
//   3. write: each thread re-walks its settled segment and stores its
//      symbols as packed aligned 4-byte words, the bytes of a word it
//      shares with a neighbouring segment one at a time (a shared buffer
//      flushed with 16-byte stores measured no faster and fits fewer
//      blocks an SM, scripts/huffman_profile.py);
//   4. a lane is ok iff init_pos >= 0, the table check passed, and the
//      settled chain from p0 holds exactly nsym symbols and ends exactly at
//      -mb. Any other live lane (a malformed one, or a table that breaks the
//      property) is walked serially by one thread for exactly nsym symbols
//      with the plain loop, which writes its bytes and its ok.
// The kernel counts warp lanes, serial lanes and re-walk rounds in the
// caller's stats array (zeroed by each call).
//
// Bound on this card: the streams read once and the literals written once
// over 3.35 TB/s (~0.012 ms on the main path). The kernel stays
// latency-bound above it: a segment is a chain of ~190 dependent steps (a
// shared-memory read of the stream, a shared LUT load) taken three times
// (walk, settle, write), so its time is the chain latency of the lanes an
// SM holds at once, which the shared-memory size per block decides.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitreader.cuh"

namespace {

constexpr int kSegMin = 64;   // least bits in a segment
constexpr int kPad = 16;      // zero bytes below bit 0 in the staged stream

// stats: warp lanes, serial lanes, re-walk rounds (sum), rounds (max)
enum { kWarpLanes, kSerialLanes, kRoundsSum, kRoundsMax };

// The staged stream: word w[k] holds bits [32k - 128, 32k - 96).
struct SmemBits {
  const uint32_t* w;
  __device__ __forceinline__ uint32_t peek(int p, uint32_t mask) const {
    int q = p + 8 * kPad;
    return __funnelshift_r(w[q >> 5], w[(q >> 5) + 1], q & 31) & mask;
  }
};

// The stream row in global memory: bytes at or past ls, or below 0, read
// as zeros. Aligned 8-byte loads, only of words that hold a byte of it.
struct GmemBits {
  const uint8_t* row;
  long long ls;

  __device__ __forceinline__ uint64_t load8(uintptr_t a, long long first)
      const {
    // the aligned word at address a, whose byte 0 is row byte `first`
    if (first + 8 <= 0 || first >= ls) return 0;
    return *reinterpret_cast<const uint64_t*>(a);
  }

  // bytes [i, i + 4) of the row as a little-endian word
  __device__ __forceinline__ uint32_t bytes4(long long i) const {
    uintptr_t a = reinterpret_cast<uintptr_t>(row) + i;
    uintptr_t a0 = a & ~uintptr_t(7);
    long long f0 = i - (long long)(a - a0);
    uint64_t lo = load8(a0, f0);
    uint64_t hi = (a - a0) > 4 ? load8(a0 + 8, f0 + 8) : 0;
    int sh = 8 * (int)(a - a0);
    uint64_t v = sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
    uint32_t r = (uint32_t)v;
    // bytes of a neighbouring row that shared the aligned words
    for (int t = 0; t < 4; ++t)
      if (i + t < 0 || i + t >= ls) r &= ~(0xFFu << (8 * t));
    return r;
  }

  __device__ __forceinline__ uint32_t peek(int p, uint32_t mask) const {
    return (bytes4((long long)(p >> 3)) >> (p & 7)) & mask;
  }
};

// Walk from p while p > lo; returns the exit position, count in cnt.
template <class R>
__device__ __forceinline__ int walk(const R& rd, const uint16_t* lut,
                                    uint32_t mask, int p, int lo, int& cnt) {
  int c = 0;
  while (p > lo) {
    uint32_t e = lut[rd.peek(p, mask)];
    p -= (int)(e >> 8);
    ++c;
  }
  cnt = c;
  return p;
}

// Output bytes straight to the literal row: full aligned words as 4-byte
// stores, bytes shared with a neighbouring segment one at a time.
struct WordSink {
  uint8_t* row;     // lit row of the frame
  long long d0;     // row index of the lane's byte 0
  long long lit_w;
  uintptr_t cur = 0;
  uint32_t acc = 0, have = 0;

  __device__ __forceinline__ void flush() {
    if (!have) return;
    if (have == 0xFu) {
      *reinterpret_cast<uint32_t*>(cur) = acc;
    } else {
      for (int t = 0; t < 4; ++t)
        if (have >> t & 1u)
          reinterpret_cast<uint8_t*>(cur)[t] = (uint8_t)(acc >> (8 * t));
    }
    have = 0;
    acc = 0;
  }
  __device__ __forceinline__ void put(int j, uint32_t sym) {
    long long d = d0 + j;
    if (d < 0 || d >= lit_w) return;
    uintptr_t a = reinterpret_cast<uintptr_t>(row + d);
    uintptr_t w = a & ~uintptr_t(3);
    if (w != cur) {
      flush();
      cur = w;
    }
    int t = (int)(a & 3);
    acc |= sym << (8 * t);
    have |= 1u << t;
  }
  __device__ __forceinline__ void done() { flush(); }
};

// Emit the symbols of a settled segment, numbered from its start.
template <class R>
__device__ __forceinline__ void emit(const R& rd, const uint16_t* lut,
                                     uint32_t mask, int p, int lo,
                                     WordSink& sink) {
  int j = 0;
  while (p > lo) {
    uint32_t e = lut[rd.peek(p, mask)];
    sink.put(j++, e & 0xFFu);
    p -= (int)(e >> 8);
  }
  sink.done();
}

// Settle the segments and, if the lane is ok, write it. Returns ok.
template <class R>
__device__ bool warp_lane(const R& rd, const uint16_t* lut, int mb, int p0,
                          int n, uint8_t* row, long long off,
                          long long lit_w, unsigned long long* stats) {
  const int k = threadIdx.x;
  const uint32_t mask = (1u << mb) - 1u;
  const int L = p0 + mb;  // bits in (-mb, p0]
  const int K = max(1, min(32, L / kSegMin));
  const int seg = (L + K - 1) / K;
  int hi = p0 - k * seg;
  int lo = k >= K - 1 ? -mb : p0 - (k + 1) * seg;
  if (k >= K) hi = lo;  // no segment
  int s = hi, c = 0;
  int e = walk(rd, lut, mask, s, lo, c);
  int rounds = 0;
  for (;;) {
    int above = __shfl_up_sync(0xFFFFFFFFu, e, 1);
    bool redo = k > 0 && k < K && above != s;
    if (!__any_sync(0xFFFFFFFFu, redo)) break;
    ++rounds;
    if (redo) {
      s = above;
      e = walk(rd, lut, mask, s, lo, c);
    }
  }
  int incl = c;
  for (int d = 1; d < 32; d <<= 1) {
    int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (k >= d) incl += v;
  }
  int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  int end = __shfl_sync(0xFFFFFFFFu, e, K - 1);
  if (total != n || end != -mb) return false;
  if (k == 0) {
    atomicAdd(&stats[kRoundsSum], (unsigned long long)rounds);
    atomicMax(&stats[kRoundsMax], (unsigned long long)rounds);
  }
  WordSink sink{row, off + incl - c, lit_w};  // from this segment's start
  emit(rd, lut, mask, s, lo, sink);
  return true;
}

// The plain loop: one thread, exactly n symbols; returns ok.
__device__ bool serial_lane(const uint8_t* stream, long long ls,
                            const int32_t* lut, int mb, long long p, int n,
                            uint8_t* out, long long off, long long lit_w) {
  uint32_t mask = (1u << mb) - 1u;
  RevBitReader rd(stream, ls);
  bool ok = p >= 0;
  uint32_t state = rd.read(p, mb);
  p -= mb;
  for (int j = 0; j < n; ++j) {
    int e = lut[state & 2047u];
    ok = ok && (p > -mb);
    int nb = min((e >> 8) & 0xFF, 32);
    uint32_t bits = rd.read(p, nb);
    p -= nb;
    state = (uint32_t)((((uint64_t)state << nb) & mask) | bits);
    long long d = off + j;
    if (d >= 0 && d < lit_w) out[d] = (uint8_t)(e & 0xFF);
  }
  return ok && (p == -mb);
}

__global__ void huff_kernel(const uint8_t* __restrict__ streams,
                            long long ls, int n_lanes,
                            const int32_t* __restrict__ init_pos,
                            const int32_t* __restrict__ tid,
                            const int32_t* __restrict__ nsym,
                            const int32_t* __restrict__ dst_frame,
                            const int32_t* __restrict__ dst_off,
                            const int32_t* __restrict__ tables, int n_tables,
                            const int32_t* __restrict__ maxbits,
                            uint8_t* __restrict__ lit, long long lit_w,
                            int n_frames, uint8_t* __restrict__ frame_ok,
                            int stage_cap,
                            unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* lut_s = reinterpret_cast<uint16_t*>(smem);  // 4 KiB
  uint8_t* stage = smem + 4096;  // kPad + stage_cap + 16 bytes
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int n = nsym[b];
  if (n <= 0) return;
  const int t = min(max(tid[b], 0), n_tables - 1);
  const int mb = min(max(maxbits[t], 0), 11);
  const int32_t* lut = tables + (long long)t * 2048;
  const long long p_in = init_pos[b];
  const int f = min(max(dst_frame[b], 0), n_frames - 1);
  const long long off = dst_off[b];
  uint8_t* row = lit + (long long)f * lit_w;
  const uint8_t* srow = streams + (long long)b * ls;

  // the table: 1 <= nb <= mb on all 2^mb entries, packed to 16 bits
  bool tab_ok = mb >= 1;
  for (int i = k; i < (1 << mb); i += 32) {
    int e = lut[i];
    int nb = (e >> 8) & 0xFF;
    tab_ok = tab_ok && nb >= 1 && nb <= mb;
    lut_s[i] = (uint16_t)((e & 0xFF) | (nb << 8));
  }
  bool warp = __all_sync(0xFFFFFFFFu, tab_ok) && p_in >= 0 &&
              p_in <= 8 * ls && p_in < (1 << 30);
  bool ok = false;
  if (warp) {
    const long long nbytes = min((p_in + 7) >> 3, ls);
    if (nbytes <= stage_cap) {
      // stage bytes [0, nbytes) at stage + kPad; zeros below and above
      uint8_t* dst = stage + kPad;
      if (k < kPad / 4) reinterpret_cast<uint32_t*>(stage)[k] = 0u;
      int full = 0;
      if ((reinterpret_cast<uintptr_t>(srow) & 15) == 0) {
        full = (int)(nbytes >> 4);
        for (int q = k; q < full; q += 32)
          reinterpret_cast<uint4*>(dst)[q] =
              reinterpret_cast<const uint4*>(srow)[q];
      }
      for (int i = 16 * full + k; i < nbytes; i += 32) dst[i] = srow[i];
      int top = (int)((nbytes + 3) & ~3LL);
      if (k < 4) reinterpret_cast<uint32_t*>(dst + top)[k] = 0u;
      for (int i = (int)nbytes + k; i < top; i += 32) dst[i] = 0;
      __syncwarp();
      SmemBits rd{reinterpret_cast<const uint32_t*>(stage)};
      ok = warp_lane(rd, lut_s, mb, (int)p_in - mb, n, row, off, lit_w,
                     stats);
    } else {
      __syncwarp();
      GmemBits rd{srow, ls};
      ok = warp_lane(rd, lut_s, mb, (int)p_in - mb, n, row, off, lit_w,
                     stats);
    }
  }
  if (k != 0) return;
  if (ok) {
    atomicAdd(&stats[kWarpLanes], 1ull);
    return;
  }
  atomicAdd(&stats[kSerialLanes], 1ull);
  if (!serial_lane(srow, ls, lut, mb, p_in, n, row, off, lit_w))
    frame_ok[f] = 0;
}

}  // namespace

// stage_cap: bytes of a stream staged in shared memory (a longer one reads
// global memory); the LUT takes 4 KiB more.
extern "C" int zt_huffman_lanes(const void* streams, long long ls,
                                int n_lanes, const void* init_pos,
                                const void* tid, const void* nsym,
                                const void* dst_frame, const void* dst_off,
                                const void* tables, int n_tables,
                                const void* maxbits, void* lit,
                                long long lit_w, int n_frames,
                                void* frame_ok, int stage_cap, void* stats,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(stats, 0, 4 * sizeof(uint64_t), st);
  if (err != cudaSuccess) return (int)err;
  if (n_lanes <= 0) return 0;
  stage_cap = ((stage_cap > 0 ? stage_cap : 0) + 15) & ~15;
  size_t smem = 4096 + kPad + stage_cap + 16;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(huff_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  huff_kernel<<<n_lanes, 32, smem, st>>>(
      (const uint8_t*)streams, ls, n_lanes, (const int32_t*)init_pos,
      (const int32_t*)tid, (const int32_t*)nsym, (const int32_t*)dst_frame,
      (const int32_t*)dst_off, (const int32_t*)tables, n_tables,
      (const int32_t*)maxbits, (uint8_t*)lit, lit_w, n_frames,
      (uint8_t*)frame_ok, stage_cap, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}
