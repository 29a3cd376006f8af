// LZ77 sequence executor: one warp per frame row, the row's recent output
// in a shared-memory ring, its records executed 32 at a time in rounds.
//
// Replaces: zstd_tpu/ops/pallas_execute.py::_exec_kernel (wrapper
// execute_sequences_pallas; the opt-in _exec_kernel_pre variant computes
// the same function and needs no port of its own).
//
// Semantics: per frame row, walk the records (ll, ml, offset) in slot
// order; copy ll literal bytes, then ml bytes from `offset` back, which is a
// periodic fill when offset < ml. Records with ll == ml == 0 are no-ops (the
// gaps of the framer's 128-aligned slot spans). A row is ok iff every
// record with ml > 0 has 0 < offset <= the bytes written before its match
// (and no record has a negative length), the total equals out_len,
// out_len <= out_width, and the literals it consumes fit the literal row
// (the lane checks of execute_sequences_pallas, pallas_execute.py:798-814,
// without its SMEM record cap). A row that is not ok comes back all zero.
// Bytes past out_len are zero (the wrapper allocates the output zeroed).
//
// Bound on this card: the output (written once) and the literals and
// records (read once) over 3.35 TB/s. But a frame is a dependency chain:
// on the main path (1024 frames of 128 KiB, ~8,600 records each, a 13-byte
// match and 2 literals on average) more than half the matches copy bytes
// that one of the ~9 records before them wrote, and a byte's chain of
// copies back to a literal is up to ~1,900 deep. Every step of that chain
// is a store and a dependent load, so the design keeps the chain in shared
// memory and runs the independent copies beside each other:
//   - one 32-thread block (a warp) per frame row; the row's last R bytes
//     of output live in a shared-memory ring (R a power of two, 8-64 KiB,
//     chosen per call so that the rows fit the SMs in one wave where they
//     can), and the warp flushes the ring to the output row with 16-byte
//     stores; a source older than the ring is read back from the output
//     row, where the warp flushed it;
//   - records come 32 at a time, one a lane, loaded one chunk ahead; warp
//     prefix sums give each record's output start and literal start and
//     check it, so validation and execution are one pass over the records
//     (a row found bad stops and zeroes what it flushed);
//   - a chunk's literals are placed first, read from a 4 KiB shared window
//     of the literal row that the warp refills with 16-byte loads;
//   - a match whose source lies wholly in the destination of one earlier
//     short, not periodic match of its chunk reads that match's source
//     instead (the bytes are equal), found by pointer jumping over the
//     lanes: chains of copies of copies, common in text, collapse (11.3
//     rounds a chunk without this on the main path, 2.4 with it);
//   - then its matches run in rounds: a match copies in the first round in
//     which no pending match of its chunk writes into its source bytes
//     (the earlier chunks are done and the literals are placed, so every
//     other byte it reads is final); the pending match with the lowest
//     destination is always ready, so a round always makes progress; the
//     lanes that overlap a match's source are found once a chunk by
//     binary searches over the lanes, and each ready match is copied by
//     its own lane, 8 loads then 8 stores (a round is one step of a chain
//     of dependent matches, so its instruction count is the kernel's
//     time): straight-line code on two pointers set once a chunk for a
//     plain match of at most 8 bytes (no periodic fill, its source in the
//     ring, neither range wrapping it: most matches on the main path), a
//     loop of such blocks for a longer plain match, one source byte picked
//     at a time for the others;
//   - a record whose literal run or match is longer than kLong bytes splits
//     its chunk: the records before it run as above, then the whole warp
//     copies it in pieces of kPiece bytes, flushing between pieces.
// Counters in device memory (zt_execute_stats) hold the rounds per chunk
// of the last call.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kLong = 64;      // longer runs are copied by the whole warp
constexpr int kPiece = 1024;   // bytes a long run copies between flushes
constexpr int kLitWin = 4096;  // literal window bytes (>= 32 * kLong + 16)
constexpr int kSlack = 16;     // shared bytes past the window that copies
                               // read and do not use
constexpr int kRingMinLog = 13;  // 8 KiB: >= 32 * 2 * kLong + 16, >= kPiece
constexpr int kRingMaxLog = 16;  // 64 KiB

// rounds of the last call: sum over chunks, chunks, max over chunks
__device__ unsigned long long g_stats[3];

__device__ __forceinline__ long long warp_incl_scan(long long v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    long long u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

struct Frame {
  uint8_t* ring;        // shared: output position p at ring[p & mask]
  unsigned mask;
  int R;
  uint8_t* win;         // shared: literal row bytes [w0, w0 + kLitWin)
  long long w0;
  bool win_ok;
  uint8_t* dst;         // the output row (global)
  const uint8_t* lit;   // the literal row (global)
  long long lit_w;
  int fl;               // output bytes flushed to dst
  int lane;
};

// Output bytes [f.fl, hi) from the ring to the output row; the ring holds
// them (hi - R <= f.fl). The whole warp calls it.
__device__ void flush(Frame& f, int hi) {
  int p = f.fl;
  if (p >= hi) return;
  uint8_t* dst = f.dst;
  int head = (int)((16 - ((uintptr_t)(dst + p) & 15)) & 15);
  int a = min(p + head, hi);
  for (int q = p + f.lane; q < a; q += 32) dst[q] = f.ring[q & f.mask];
  int b = a + ((hi - a) & ~15);
  bool ring_al = ((a & 15) == 0);
  for (int q = a + 16 * f.lane; q < b; q += 512) {
    uint4 v;
    if (ring_al) {
      v = *reinterpret_cast<const uint4*>(f.ring + (q & f.mask));
    } else {
      uint8_t t[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) t[i] = f.ring[(q + i) & f.mask];
      v.x = t[0] | t[1] << 8 | t[2] << 16 | (uint32_t)t[3] << 24;
      v.y = t[4] | t[5] << 8 | t[6] << 16 | (uint32_t)t[7] << 24;
      v.z = t[8] | t[9] << 8 | t[10] << 16 | (uint32_t)t[11] << 24;
      v.w = t[12] | t[13] << 8 | t[14] << 16 | (uint32_t)t[15] << 24;
    }
    *reinterpret_cast<uint4*>(dst + q) = v;
  }
  for (int q = b + f.lane; q < hi; q += 32) dst[q] = f.ring[q & f.mask];
  f.fl = hi;
  __syncwarp();
}

// Make the literal window hold literal bytes [a, b) (b - a <= kLitWin -
// 15): reload it from the 16-byte-aligned address at or below a. Bytes
// outside the row read as zeros. The whole warp calls it.
__device__ void need_literals(Frame& f, long long a, long long b) {
  if (f.win_ok && a >= f.w0 && b <= f.w0 + kLitWin) return;
  long long w0 = a - (long long)(((uintptr_t)(f.lit + a)) & 15);
  for (int j = f.lane; j < kLitWin / 16; j += 32) {
    long long r0 = w0 + 16LL * j;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 >= 0 && r0 + 16 <= f.lit_w) {
      v = __ldg(reinterpret_cast<const uint4*>(f.lit + r0));
    } else if (r0 + 16 > 0 && r0 < f.lit_w) {
      uint8_t t[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        long long r = r0 + i;
        t[i] = (r >= 0 && r < f.lit_w) ? f.lit[r] : 0;
      }
      v.x = t[0] | t[1] << 8 | t[2] << 16 | (uint32_t)t[3] << 24;
      v.y = t[4] | t[5] << 8 | t[6] << 16 | (uint32_t)t[7] << 24;
      v.z = t[8] | t[9] << 8 | t[10] << 16 | (uint32_t)t[11] << 24;
      v.w = t[12] | t[13] << 8 | t[14] << 16 | (uint32_t)t[15] << 24;
    }
    reinterpret_cast<uint4*>(f.win)[j] = v;
  }
  f.w0 = w0;
  f.win_ok = true;
  __syncwarp();
}

// The byte at output position q: from the ring when q >= lo (the ring's
// oldest position not overwritten by the current step), else from the
// output row, where it was flushed.
__device__ __forceinline__ uint8_t src_byte(const Frame& f, int q, int lo) {
  return q >= lo ? f.ring[q & f.mask] : f.dst[q];
}

__device__ __forceinline__ int warp_incl_scan32(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// The source index of byte i of a match of m bytes from offset o: i, or
// i mod o for a periodic fill (o < m; the division only there).
__device__ __forceinline__ int period(int i, int o, int m) {
  if (o < m && i >= o) i %= o;
  return i;
}

// The smallest lane k whose key[k] > x, for keys that do not decrease over
// the lanes (32 if none): a binary search by shuffles.
__device__ __forceinline__ int first_above(int key, int x) {
  int k = 0;
#pragma unroll
  for (int step = 16; step; step >>= 1)
    if (__shfl_sync(kFull, key, k + step - 1) <= x) k += step;
  return k;
}

// One ready lane's match of m <= kLong bytes at d from offset o, by the
// lane itself, 8 bytes at a time, the 8 loads before the 8 stores. Its
// sources lie below d and are final, and no other match of the round
// writes into them. A round is one step of a chain of dependent matches,
// so its instruction count is the kernel's time: the common match (not a
// periodic fill, its source in the ring, neither range wrapping it) runs
// straight-line code on two pointers; the others pick each source byte.
__device__ __forceinline__ void copy_match(Frame& f, bool plain, int s,
                                           int d, int o, int m, int lo) {
  if (plain) {
    const uint8_t* src = f.ring + (s & f.mask);
    uint8_t* dst = f.ring + (d & f.mask);
    for (int i0 = 0; i0 < m; i0 += 8) {
      uint8_t v[8];
      // the bytes past the match that this reads are not used (they lie
      // in the ring or in the literal window after it)
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = src[i0 + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (i0 + u < m) dst[i0 + u] = v[u];
      }
    }
    return;
  }
  for (int i0 = 0; i0 < m; i0 += 8) {
    uint8_t v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (i0 + u < m) v[u] = src_byte(f, s + period(i0 + u, o, m), lo);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (i0 + u < m) f.ring[(d + i0 + u) & f.mask] = v[u];
    }
  }
}

// The records [start, stop) of the chunk (lanes; none longer than kLong):
// literals, then matches in rounds. os: the record's output start, ls its
// literal start, d its match start; dep: the lanes whose match writes into
// this lane's source. Returns the rounds.
__device__ int run_segment(Frame& f, int start, int stop, int l, int m,
                           int o, int os, int ls, int d, int s,
                           unsigned dep) {
  const int lane = f.lane;
  const bool in = lane >= start && lane < stop;
  const int seg_os = __shfl_sync(kFull, os, start);
  const int seg_end = __shfl_sync(kFull, d + m, stop - 1);
  const int la = __shfl_sync(kFull, ls, start);
  const int lb = __shfl_sync(kFull, ls + l, stop - 1);
  if (seg_end - f.R > f.fl) flush(f, seg_os);
  if (lb > la) need_literals(f, la, lb);
  if (in && l > 0) {
    const uint8_t* w = f.win + (ls - f.w0);
    if ((int)(os & f.mask) + l <= f.R) {
      uint8_t* dst = f.ring + (os & f.mask);
      for (int i0 = 0; i0 < l; i0 += 8) {
        uint8_t v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = w[i0 + u];  // into the slack
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (i0 + u < l) dst[i0 + u] = v[u];
        }
      }
    } else {
      for (int i = 0; i < l; ++i) f.ring[(os + i) & f.mask] = w[i];
    }
  }
  __syncwarp();
  const int lo = seg_end - f.R;
  const bool plain = o >= m && s >= lo && (int)(s & f.mask) + m <= f.R &&
                     (int)(d & f.mask) + m <= f.R;
  const uint8_t* src = f.ring + (s & f.mask);
  uint8_t* dst = f.ring + (d & f.mask);
  unsigned pending = __ballot_sync(kFull, in && m > 0);
  int rounds = 0;
  while (pending) {
    const bool ready = ((pending >> lane) & 1) && !(pending & dep);
    if (ready && plain && m <= 8) {
      uint8_t v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = src[u];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (u < m) dst[u] = v[u];
      }
    } else if (ready) {
      copy_match(f, plain, s, d, o, m, lo);
    }
    __syncwarp();
    pending &= ~__ballot_sync(kFull, ready);
    ++rounds;
  }
  return rounds;
}

// One record longer than kLong, by the whole warp, in pieces of kPiece
// bytes; each piece's sources are final before it starts. A thread takes 8
// bytes of a piece at a time, 32 apart, their 8 loads before their 8
// stores. A match's source byte for x0 + i is x0 + i - o when o >= n, else
// the periodic fill's byte x0 - o + (i mod o), the residue stepped along
// with i (by 32 mod o) rather than divided for.
__device__ void run_long(Frame& f, int l, int m, int o, int os, int ls) {
  const int lane = f.lane;
  for (int x0 = os; x0 < os + l; x0 += kPiece) {
    const int n = min(kPiece, os + l - x0);
    if (x0 + n - f.R > f.fl) flush(f, x0);
    const uint8_t* w = f.lit + (ls + (x0 - os));
    for (int i0 = lane; i0 < n; i0 += 256) {
      uint8_t v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (i0 + 32 * u < n) v[u] = w[i0 + 32 * u];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (i0 + 32 * u < n) f.ring[(x0 + i0 + 32 * u) & f.mask] = v[u];
      }
    }
    __syncwarp();
  }
  const int d = os + l;
  for (int x0 = d; x0 < d + m; x0 += kPiece) {
    const int n = min(kPiece, d + m - x0);
    if (x0 + n - f.R > f.fl) flush(f, x0);
    const int lo = x0 + n - f.R;
    const bool per = o < n;
    const bool near = x0 - o >= lo;  // every source of the piece in the ring
    const int step = per ? 32 % o : 0;
    int res = per ? lane % o : 0;
    for (int i0 = lane; i0 < n; i0 += 256) {
      int q[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        q[u] = per ? x0 - o + res : x0 + i0 + 32 * u - o;
        res += step;
        if (res >= o) res -= o;
      }
      uint8_t v[8];
      if (near) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (i0 + 32 * u < n) v[u] = f.ring[q[u] & f.mask];
        }
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (i0 + 32 * u < n) v[u] = src_byte(f, q[u], lo);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (i0 + 32 * u < n) f.ring[(x0 + i0 + 32 * u) & f.mask] = v[u];
      }
    }
    __syncwarp();
  }
}

__global__ void exec_kernel(const int32_t* __restrict__ ll,
                            const int32_t* __restrict__ ml,
                            const int32_t* __restrict__ off, long long S,
                            const uint8_t* __restrict__ lit, long long lit_w,
                            const int32_t* __restrict__ out_len,
                            const int32_t* __restrict__ rows, int n_rows,
                            int n_frames, uint8_t* out, long long out_w,
                            uint8_t* __restrict__ ok_out, int ring_log) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  if (r >= n_rows) return;
  const int row = min(max(rows[r], 0), n_frames - 1);
  const int32_t* L = ll + (long long)row * S;
  const int32_t* M = ml + (long long)row * S;
  const int32_t* O = off + (long long)row * S;
  const long long olen = out_len[row];

  Frame f;
  f.R = 1 << ring_log;
  f.mask = (unsigned)f.R - 1;
  f.ring = smem;
  f.win = smem + f.R;
  f.w0 = 0;
  f.win_ok = false;
  f.dst = out + (long long)r * out_w;
  f.lit = lit + (long long)row * lit_w;
  f.lit_w = lit_w;
  f.fl = 0;
  f.lane = lane;

  // ok needs olen == the total >= 0 and olen <= out_w: positions then fit
  // in 32 bits, since execution stops at a chunk that passes olen
  bool bad = olen < 0 || olen > out_w;
  long long op = 0, lp = 0;
  unsigned long long rounds_sum = 0, chunks = 0, rounds_max = 0;
  int32_t l_n = 0, m_n = 0, o_n = 0;
  if (lane < S) {
    l_n = L[lane];
    m_n = M[lane];
    o_n = O[lane];
  }
  for (long long base = 0; base < S && !bad; base += 32) {
    const int32_t l = l_n, m = m_n, o = o_n;
    const long long k = base + 32 + lane;
    l_n = m_n = o_n = 0;
    if (k < S) {
      l_n = L[k];
      m_n = M[k];
      o_n = O[k];
    }
    if (!__any_sync(kFull, (l | m) != 0)) {
      // an empty chunk (the end of the row, or the gap between two
      // blocks' slot spans): find the next chunk that holds a record, four
      // chunks a load round, and go on from there
      long long nb = base + 32;
      for (; nb < S; nb += 128) {
        unsigned nz = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long q = nb + 32 * j + lane;
          if (q < S && (L[q] | M[q]) != 0) nz |= 1u << j;
        }
        nz = __reduce_or_sync(kFull, nz);
        if (nz) {
          nb += 32 * (__ffs(nz) - 1);
          break;
        }
      }
      base = nb - 32;
      const long long q = nb + lane;
      l_n = m_n = o_n = 0;
      if (q < S) {
        l_n = L[q];
        m_n = M[q];
        o_n = O[q];
      }
      continue;
    }
    // validate the chunk: 32-bit sums when every length is below 2^25,
    // else 64-bit (any int32 input)
    const long long run = (long long)l + m;
    long long run_incl, l_incl;
    if (__all_sync(kFull, (unsigned)l < (1u << 25) &&
                              (unsigned)m < (1u << 25))) {
      run_incl = warp_incl_scan32(l + m, lane);
      l_incl = warp_incl_scan32(l, lane);
    } else {
      run_incl = warp_incl_scan(run, lane);
      l_incl = warp_incl_scan(l, lane);
    }
    const long long before_match = op + run_incl - m;
    const bool rec_bad =
        l < 0 || m < 0 || (m != 0 && !(o > 0 && o <= before_match));
    const long long op_end = op + __shfl_sync(kFull, run_incl, 31);
    const long long lp_end = lp + __shfl_sync(kFull, l_incl, 31);
    if (__any_sync(kFull, rec_bad) || op_end > olen || lp_end > lit_w) {
      bad = true;
      break;
    }
    // execute it: every position is below olen < 2^31
    const int d = (int)before_match;
    const int os = d - l;
    const int ls = (int)(lp + l_incl - l);
    // the match's source [s, e): d - o, or where the bytes there were
    // copied from, when they are the output of one short, not periodic
    // match j of this chunk (its destination holds its source's bytes):
    // s_j + (s - d_j), s_j redirected the same way, by pointer jumping
    const int len = m > 0 ? min(m, o) : 0;
    const bool lng = l > kLong || m > kLong;
    int s = m > 0 ? d - o : 0;
    {
      const int j = first_above(d, s) - 1, jc = max(j, 0);
      const int dj = __shfl_sync(kFull, d, jc), mj = __shfl_sync(kFull, m, jc);
      const int oj = __shfl_sync(kFull, o, jc);
      const bool lj = __shfl_sync(kFull, lng, jc);
      const bool redirect = m > 0 && !lng && j >= 0 && j < lane && mj > 0 &&
                            !lj && oj >= mj && s + len <= dj + mj;
      int t = redirect ? j : -1;
      if (redirect) s -= dj;  // relative to s_j until t resolves
#pragma unroll
      for (int it = 0; it < 5; ++it) {
        const int from = t >= 0 ? t : lane;
        const int s_t = __shfl_sync(kFull, s, from);
        const int t_t = __shfl_sync(kFull, t, from);
        if (t >= 0) {
          s += s_t;
          t = t_t;
        }
      }
    }
    const int e = s + len;
    // dep: the lanes before this one whose output overlaps the source;
    // record ends and match starts do not decrease over the lanes, so
    // they are the lanes jl..jh
    const int jl = first_above(d + m, s);
    const int jh = min(first_above(d, e - 1), lane) - 1;
    const unsigned dep =
        m > 0 && jh >= jl ? (2u << jh) - (1u << jl) : 0u;
    const unsigned longs = __ballot_sync(kFull, l > kLong || m > kLong);
    int rounds = 0;
    int start = 0;
    while (start < 32) {
      const unsigned rest = longs & (kFull << start);
      const int stop = rest ? __ffs(rest) - 1 : 32;
      if (stop > start)
        rounds += run_segment(f, start, stop, l, m, o, os, ls, d, s, dep);
      if (stop == 32) break;
      run_long(f, __shfl_sync(kFull, l, stop), __shfl_sync(kFull, m, stop),
               __shfl_sync(kFull, o, stop), __shfl_sync(kFull, os, stop),
               __shfl_sync(kFull, ls, stop));
      ++rounds;
      start = stop + 1;
    }
    rounds_sum += rounds;
    rounds_max = max(rounds_max, (unsigned long long)rounds);
    ++chunks;
    op = op_end;
    lp = lp_end;
  }
  const bool good = !bad && op == olen;
  if (good) {
    flush(f, (int)olen);
  } else {
    // a bad row leaves its output zero: clear what was flushed
    for (int q = lane; q < f.fl; q += 32) f.dst[q] = 0;
  }
  if (lane == 0) {
    ok_out[r] = good ? 1 : 0;
    if (good && chunks) {
      atomicAdd(&g_stats[0], rounds_sum);
      atomicAdd(&g_stats[1], chunks);
      atomicMax(&g_stats[2], rounds_max);
    }
  }
}

}  // namespace

extern "C" int zt_execute_lanes(const void* ll, const void* ml,
                                const void* off, long long S, const void* lit,
                                long long lit_w, const void* out_len,
                                const void* rows, int n_rows, int n_frames,
                                void* out, long long out_w, void* ok_out,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  void* stats = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&stats, g_stats);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(stats, 0, sizeof(unsigned long long) * 3, st);
  if (err != cudaSuccess) return (int)err;
  if (n_rows <= 0) return (int)cudaGetLastError();
  // the ring: the most that lets every row be resident at once (one wave
  // over the SMs' shared memory), but never more than the row needs
  int dev = 0, n_sm = 1, smem_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  const long long per_sm = (n_rows + n_sm - 1) / n_sm;
  int ring_log = kRingMaxLog;
  while (ring_log > kRingMinLog &&
         per_sm * ((1LL << ring_log) + kLitWin + 1024) > smem_sm)
    --ring_log;
  while (ring_log > kRingMinLog && (1LL << (ring_log - 1)) >= out_w)
    --ring_log;
  const int smem = (1 << ring_log) + kLitWin + kSlack;
  err = cudaFuncSetAttribute(exec_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  exec_kernel<<<n_rows, 32, smem, st>>>(
      (const int32_t*)ll, (const int32_t*)ml, (const int32_t*)off, S,
      (const uint8_t*)lit, lit_w, (const int32_t*)out_len,
      (const int32_t*)rows, n_rows, n_frames, (uint8_t*)out, out_w,
      (uint8_t*)ok_out, ring_log);
  return (int)cudaGetLastError();
}

// The last call's rounds: out[0] the sum over its chunks (of ok rows that
// hold a record), out[1] those chunks, out[2] the most in one chunk. Waits
// for the device.
extern "C" int zt_execute_stats(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stats,
                                   sizeof(unsigned long long) * 3);
}
