// Interleaved 3-state tANS sequence decoder, one warp per block lane,
// fused with the stage's slot scatter and trailing-literal fill.
//
// Replaces: zstd_tpu/ops/pallas_sequence.py::_seq_kernel (wrapper
// decode_sequence_lanes_pallas) together with the row scatter and trailing
// fill of zstd_tpu/models/batch_decoder.py::_seq_bucket.
//
// Semantics (zstd_tpu/ops/sequence.py::decode_sequence_lanes, parity with
// sequence_section_decoder.rs:154-221): initial states are read LL, OF, ML;
// per sequence the extra bits are read OF, ML, LL, and the states update
// LL -> ML -> OF, skipped on the last sequence. of_value = (1 << of_code) +
// extra wraps as int32 in the reference when of_code is 31, so it is
// computed in uint32 and reinterpreted. A lane is ok iff init_pos >= 0, the
// position stays >= 0 after every step with of <= 31, ml <= 52, ll <= 35,
// it ends at exactly 0, and the trailing run (block literals minus the sum
// of ll) is >= 0. Sequence k lands at slot (dst_frame, dst_off + k); the
// trailing run's length lands in ll at (dst_frame, trail_slot); slots past
// the row width are dropped; a lane that is not ok clears
// frame_ok[dst_frame]. The framer 128-aligns each lane's slot span and
// leaves its gap slots zero, so writing only the decoded slots equals the
// reference's zero-filling row scatter.
//
// Bound on this card: the streams read once and 12 bytes written per
// sequence over 3.35 TB/s (tens of microseconds on the main path). But a
// lane is a serial chain: each sequence's three table lookups wait on the
// state the sequence before it read, and each bit read on the position
// the read before it left. So the kernel is bound by the latency of one
// lane's chain, and its design shortens that chain and runs every lane at
// once:
//   - one 32-thread block per lane, so the lanes spread over every SM (the
//     main path's 1024 lanes are ~8 blocks an SM) and no two lanes share a
//     warp's lockstep;
//   - the warp copies the lane's three FSE tables into shared memory first,
//     folding each LL and ML state's baseline and extra-bit count into a
//     second word beside its entry: a step makes one shared-memory lookup
//     per state and no dependent code-table load;
//   - the warp stages the lane's stream bytes in a 2 KiB shared-memory
//     window (16-byte loads); the warp moves the window down when the chain
//     nears its bottom, once every ~1,000 sequences;
//   - a sequence's six bit fields (three extra-bit fields, three state
//     updates) are one read of their summed width (four reads only past 63
//     bits): two 8-byte shared-memory loads at the position, issued beside
//     the three table lookups, so a step waits on one shared-memory
//     latency; the chain carries each state as its clamped table index and
//     its position in 32 bits relative to the window;
//   - one thread runs the chain and writes each record into a 64-entry
//     shared-memory ring; the warp flushes the ring to the slot rows as
//     coalesced stores.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRing = 64;         // records per flush
constexpr int kWin = 2048;        // stream window bytes, a multiple of 16
constexpr int kWinAlloc = kWin + 32;  // + alignment slack + the u64 over-read
// the most bits one sequence reads: of 31, ml 16, ll 16 extra bits and three
// state updates of at most 32 bits each
constexpr int kSeqBits = 31 + 16 + 16 + 3 * 32;

__constant__ int32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,   15,   16,    18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
__constant__ int32_t kLLExtra[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,
                                     1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
__constant__ int32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,  16,  17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,  32,  33,  34,  35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
__constant__ int32_t kMLExtra[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                     2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// The reverse bit reader of bitreader.cuh, without its container: bits
// [pr - n, pr) for 0 <= n <= 63, bit pr - n the LSB, where pr is a bit
// position relative to the warp's shared-memory window of the stream (row
// bytes [blo, blo + kWinAlloc - 16) at win[0..], so pr = p - 8 * blo).
// Each read fetches the two 8-byte words around bits [pr - 64, pr); the
// chain keeps pr - 64 - kSeqBits >= 0. The window holds zeros for bytes
// outside the row, so bits below bit 0 and bytes at or past the row read as
// zeros, as in bitreader.cuh.
__device__ __forceinline__ uint64_t read_at(const uint64_t* w64, int pr,
                                            int n) {
  const int off = pr - 64;
  const uint64_t a = w64[off >> 6], b = w64[(off >> 6) + 1];
  const int r = off & 63;
  const uint64_t c = r ? (a >> r) | (b << (64 - r)) : a;  // bits [pr-64, pr)
  return n ? c >> (64 - n) : 0;
}

__device__ __forceinline__ uint32_t low_bits(uint64_t v, int n) {
  return (uint32_t)v & (n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1u));
}

// the least window position at which a whole sequence may be decoded
constexpr int kMinPr = kSeqBits + 64;

// The whole warp: load the window whose top covers the container that a
// read ending at bit p refills, the window's first byte 16-aligned in
// memory. Bytes outside [0, len) of the row are zeros. Returns blo.
__device__ long long load_window(uint8_t* win, const uint8_t* row,
                                 long long len, long long p, int lane) {
  long long top = (p + 7) >> 3;
  long long want = top - (kWinAlloc - 32);
  long long mis = (long long)(((uintptr_t)row + (uintptr_t)want) & 15u);
  long long blo = want - mis;
  for (int j = lane; j < (kWinAlloc - 16) / 16; j += 32) {
    long long r0 = blo + 16LL * j;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 >= 0 && r0 + 16 <= len) {
      v = __ldg(reinterpret_cast<const uint4*>(row + r0));
    } else if (r0 + 16 > 0 && r0 < len) {
      uint8_t b[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        long long r = r0 + i;
        b[i] = (r >= 0 && r < len) ? row[r] : 0;
      }
      v.x = b[0] | b[1] << 8 | b[2] << 16 | (uint32_t)b[3] << 24;
      v.y = b[4] | b[5] << 8 | b[6] << 16 | (uint32_t)b[7] << 24;
      v.z = b[8] | b[9] << 8 | b[10] << 16 | (uint32_t)b[11] << 24;
      v.w = b[12] | b[13] << 8 | b[14] << 16 | (uint32_t)b[15] << 24;
    }
    reinterpret_cast<uint4*>(win)[j] = v;
  }
  return blo;
}

// table index of state baseline + bits, clamped into the table as the
// plain version clamps baseline + bits in int64: bits at or above 2^30 put
// the sum past any table (the wrapper takes tables of at most 2^16 states)
__device__ __forceinline__ int state_index(int32_t e, uint32_t bits,
                                           int width) {
  const int s = (e >> 16) + (int)min(bits, 1u << 30);
  return min(max(s, 0), width - 1);
}

// shared memory of one block: LL and ML tables as (entry, base | extra << 24)
// pairs, the OF table, the record ring, the stream window
struct Smem {
  uint2* ll;
  uint2* ml;
  int32_t* of;
  int32_t* ring;  // ll [kRing], ml [kRing], of [kRing]
  uint8_t* win;
};

__host__ __device__ inline size_t smem_bytes(int ll_w, int of_w, int ml_w) {
  size_t n = 8 * (size_t)(ll_w + ml_w) + 4 * (size_t)of_w + 12 * kRing;
  n = (n + 15) & ~(size_t)15;
  return n + kWinAlloc;
}

__global__ void __launch_bounds__(32) seq_kernel(
    const uint8_t* __restrict__ streams, long long ls,
    const int32_t* __restrict__ init_pos, const int32_t* __restrict__ nseq,
    const int32_t* __restrict__ ll_tid, const int32_t* __restrict__ of_tid,
    const int32_t* __restrict__ ml_tid, const int32_t* __restrict__ ll_tab,
    int ll_w, int n_ll, const int32_t* __restrict__ of_tab, int of_w,
    int n_of, const int32_t* __restrict__ ml_tab, int ml_w, int n_ml,
    const int32_t* __restrict__ ll_logs, const int32_t* __restrict__ of_logs,
    const int32_t* __restrict__ ml_logs,
    const int32_t* __restrict__ dst_frame, const int32_t* __restrict__ dst_off,
    const int32_t* __restrict__ lit_total,
    const int32_t* __restrict__ trail_slot, int32_t* __restrict__ ll_out,
    int32_t* __restrict__ ml_out, int32_t* __restrict__ of_out,
    long long seq_w, int n_frames, uint8_t* __restrict__ frame_ok) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = nseq[b];
  if (n <= 0) return;

  Smem sm;
  sm.ll = reinterpret_cast<uint2*>(smem_raw);
  sm.ml = sm.ll + ll_w;
  sm.of = reinterpret_cast<int32_t*>(sm.ml + ml_w);
  sm.ring = sm.of + of_w;
  size_t head = 8 * (size_t)(ll_w + ml_w) + 4 * (size_t)of_w + 12 * kRing;
  sm.win = smem_raw + ((head + 15) & ~(size_t)15);

  const int lt = min(max(ll_tid[b], 0), n_ll - 1);
  const int ot = min(max(of_tid[b], 0), n_of - 1);
  const int mt = min(max(ml_tid[b], 0), n_ml - 1);
  {
    const int32_t* src = ll_tab + (long long)lt * ll_w;
    for (int i = lane; i < ll_w; i += 32) {
      int32_t e = src[i];
      int c = min(e & 0xFF, 35);
      sm.ll[i] = make_uint2((uint32_t)e,
                            (uint32_t)kLLBase[c] | (uint32_t)kLLExtra[c] << 24);
    }
    src = ml_tab + (long long)mt * ml_w;
    for (int i = lane; i < ml_w; i += 32) {
      int32_t e = src[i];
      int c = min(e & 0xFF, 52);
      sm.ml[i] = make_uint2((uint32_t)e,
                            (uint32_t)kMLBase[c] | (uint32_t)kMLExtra[c] << 24);
    }
    src = of_tab + (long long)ot * of_w;
    for (int i = lane; i < of_w; i += 32) sm.of[i] = src[i];
  }
  const uint8_t* row = streams + (long long)b * ls;
  long long p = init_pos[b];
  long long blo = load_window(sm.win, row, ls, p, lane);
  const uint64_t* w64 = reinterpret_cast<const uint64_t*>(sm.win);
  __syncwarp();

  const int f = min(max(dst_frame[b], 0), n_frames - 1);
  const long long dst = (long long)f * seq_w;
  const long long d0 = dst_off[b];
  int32_t* r_ll = sm.ring;
  int32_t* r_ml = sm.ring + kRing;
  int32_t* r_of = sm.ring + 2 * kRing;

  // the chain's state, live in lane 0: the table indices of the three
  // states. The position only falls, so "p >= 0 after every step" is
  // "p == 0 at the end", checked there.
  bool ok = p >= 0;
  int i_ll = 0, i_of = 0, i_ml = 0;
  long long used = 0;
  int pr = (int)(p - 8 * blo);
  if (lane == 0) {
    int ll_log = min(max(ll_logs[lt], 0), 32);
    int of_log = min(max(of_logs[ot], 0), 32);
    int ml_log = min(max(ml_logs[mt], 0), 32);
    i_ll = state_index(0, (uint32_t)read_at(w64, pr, ll_log), ll_w);
    pr -= ll_log;
    i_of = state_index(0, (uint32_t)read_at(w64, pr, of_log), of_w);
    pr -= of_log;
    i_ml = state_index(0, (uint32_t)read_at(w64, pr, ml_log), ml_w);
    pr -= ml_log;
  }
  pr = __shfl_sync(kFull, pr, 0);

  int k = 0;
  while (true) {
    const int kf = k;
    if (lane == 0) {
      const int k_end = min(n, kf + kRing);
      while (k < k_end && pr >= kMinPr) {
        const uint2 el = sm.ll[i_ll];
        const uint2 em = sm.ml[i_ml];
        const int32_t e_of = sm.of[i_of];
        const int32_t e_ll = (int32_t)el.x, e_ml = (int32_t)em.x;
        int ofc = e_of & 0xFF;
        ok = ok && ofc <= 31 && (e_ml & 0xFF) <= 52 && (e_ll & 0xFF) <= 35;
        ofc = min(ofc, 31);
        const int mlb = (int)(em.y >> 24), llb = (int)(el.y >> 24);
        const int t1 = ofc + mlb + llb;  // extra bits, read OF, ML, LL
        // state update bits, LL, ML, OF; none after the last sequence
        const bool upd = k < n - 1;
        const int nl = upd ? min((e_ll >> 8) & 0xFF, 32) : 0;
        const int nm = upd ? min((e_ml >> 8) & 0xFF, 32) : 0;
        const int no = upd ? min((e_of >> 8) & 0xFF, 32) : 0;
        const int t2 = nl + nm + no;

        uint64_t ext;
        uint32_t bl, bm, bo;
        if (t1 + t2 <= 63) {  // one read: the extra bits above the states'
          const uint64_t x = read_at(w64, pr, t1 + t2);
          ext = x >> t2;
          bl = low_bits(x >> (nm + no), nl);
          bm = low_bits(x >> no, nm);
          bo = low_bits(x, no);
        } else {  // only with long codes or states wider than 21 bits
          ext = read_at(w64, pr, t1);
          bl = (uint32_t)read_at(w64, pr - t1, nl);
          bm = (uint32_t)read_at(w64, pr - t1 - nl, nm);
          bo = (uint32_t)read_at(w64, pr - t1 - nl - nm, no);
        }
        pr -= t1 + t2;
        i_ll = state_index(e_ll, bl, ll_w);
        i_ml = state_index(e_ml, bm, ml_w);
        i_of = state_index(e_of, bo, of_w);
        const int32_t ofv =
            (int32_t)((1u << ofc) + (uint32_t)(ext >> (mlb + llb)));
        const int32_t ml = (int32_t)(em.y & 0xFFFFFF) +
                           (int32_t)low_bits(ext >> llb, mlb);
        const int32_t ll =
            (int32_t)(el.y & 0xFFFFFF) + (int32_t)low_bits(ext, llb);
        r_ll[k - kf] = ll;
        r_ml[k - kf] = ml;
        r_of[k - kf] = ofv;
        used += ll;
        ++k;
      }
    }
    k = __shfl_sync(kFull, k, 0);
    pr = __shfl_sync(kFull, pr, 0);
    __syncwarp();
    for (int t = lane; t < k - kf; t += 32) {
      long long slot = d0 + kf + t;
      if (slot >= 0 && slot < seq_w) {
        ll_out[dst + slot] = r_ll[t];
        ml_out[dst + slot] = r_ml[t];
        of_out[dst + slot] = r_of[t];
      }
    }
    if (k >= n) break;
    __syncwarp();
    if (pr < kMinPr) {  // move the window down to the chain's position
      p = 8 * blo + pr;
      blo = load_window(sm.win, row, ls, p, lane);
      pr = (int)(p - 8 * blo);
      __syncwarp();
    }
  }
  p = 8 * blo + pr;
  if (lane == 0) {
    ok = ok && p == 0;
    long long trailing = (long long)lit_total[b] - used;
    ok = ok && trailing >= 0;
    long long ts = trail_slot[b];
    if (ts >= 0 && ts < seq_w)
      ll_out[dst + ts] = (int32_t)(trailing > 0 ? trailing : 0);
    if (!ok) frame_ok[f] = 0;
  }
}

}  // namespace

extern "C" int zt_sequence_lanes(
    const void* streams, long long ls, int n_lanes, const void* init_pos,
    const void* nseq, const void* ll_tid, const void* of_tid,
    const void* ml_tid, const void* ll_tab, int ll_w, int n_ll,
    const void* of_tab, int of_w, int n_of, const void* ml_tab, int ml_w,
    int n_ml, const void* ll_logs, const void* of_logs, const void* ml_logs,
    const void* dst_frame, const void* dst_off, const void* lit_total,
    const void* trail_slot, void* ll_out, void* ml_out, void* of_out,
    long long seq_w, int n_frames, void* frame_ok, void* stream) {
  if (n_lanes > 0) {
    size_t smem = smem_bytes(ll_w, of_w, ml_w);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    seq_kernel<<<n_lanes, 32, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)streams, ls, (const int32_t*)init_pos,
        (const int32_t*)nseq, (const int32_t*)ll_tid,
        (const int32_t*)of_tid, (const int32_t*)ml_tid,
        (const int32_t*)ll_tab, ll_w, n_ll, (const int32_t*)of_tab, of_w,
        n_of, (const int32_t*)ml_tab, ml_w, n_ml, (const int32_t*)ll_logs,
        (const int32_t*)of_logs, (const int32_t*)ml_logs,
        (const int32_t*)dst_frame, (const int32_t*)dst_off,
        (const int32_t*)lit_total, (const int32_t*)trail_slot,
        (int32_t*)ll_out, (int32_t*)ml_out, (int32_t*)of_out, seq_w,
        n_frames, (uint8_t*)frame_ok);
  }
  return (int)cudaGetLastError();
}
