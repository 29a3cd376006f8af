// Greedy LZ77 parse of block lanes: walk positions left to right, take a
// match where the hash candidate shares >= MIN_MATCH bytes, extend 8-capped
// matches, skip ahead faster the longer the literal run, and emit
// (literal length, match length, offset) records.
//
// Replaces: zstd_tpu/ops/match_finder.py::_parse_kernel (:98; wrapper
// parse_blocks, :179), a Pallas kernel with one grid step per lane and
// position chunk, candidates in SMEM and the block in VMEM rows.
//
// Semantics kept from the reference: a match is taken at i when
// lcp >= MIN_MATCH and cand >= 0, with offset i - cand; it is extended past
// the 8-byte cap only when lcp == 8, byte-equal up to n_valid, in whole
// 128-byte steps, stopping at the first step that falls short or leaves
// the length at 1 << 20 or more; otherwise the walk skips
// 1 + ((i - anchor) >> 8). At MAX_SEQS records the rest of the lane is the
// trailing literal run from `anchor`. The inputs are find_candidates'
// (0 <= cand < i, lcp capped at 8 and at n_valid - i), so no byte past
// n_valid is compared.
//
// Design. The walk's state is (position i, literal-run start anchor), and
// after a match anchor == i: two walks that take a match at the same
// position agree from there on. So a lane is cut into up to SEGMENTS (64)
// segments and taken by a cluster of CTAS (2) CTAs (so 64 lanes fill 128 of
// the 132 SMs), a warp a segment:
//   1. stage: each CTA copies the lane's bytes and the skip set T (t_0 = 0,
//      t_k+1 = t_k + 1 + (t_k >> 8): the offsets from anchor a literal run
//      visits; a bitmap given by the caller) into shared memory, and for
//      its own half of the positions builds a bitmap hit[p] = lcp[p] >= 5
//      && cand[p] >= 0 (by ballot over coalesced loads of lcp and cand)
//      and lcp - 5 at 2 bits a position. A lane too wide for the card's
//      shared memory keeps its bitmaps in the caller's scratch and reads
//      bytes, lcp and T from global memory through the same walk;
//   2. walk: [0, n_valid) is cut into segments of G >= SEG_MIN positions
//      (a multiple of 32, so a bitmap word belongs to one segment); warp k
//      notes the last hit of segment k and, if it has one, walks it from
//      (top, top). The next match from (i, anchor) is the first p >= i
//      with hit[p] and T[p - anchor]: the word of i by every thread alike,
//      else each thread ANDs a word of hit with T shifted to the anchor and
//      a ballot finds it 1,024 positions at a time. cand[p] is loaded as
//      soon as p is known; an lcp of 8 extends by comparing 128 bytes a
//      step, 4 a thread, in shared memory, and the extended length is kept
//      by position in the caller's scratch. Each walk keeps its match
//      starts in a bitmap and its record count;
//   3. settle: in rounds separated by cluster barriers, warp 0 of each CTA
//      scans the segments in order (the other CTA's read across the
//      cluster's shared memory) and gives each its entry: the exit of the
//      segment above, where that segment's walk is from its own entry or
//      stale; but a segment with no hit at or past the state entering it
//      forwards that state in closed form, (anchor + next T >= end -
//      anchor, anchor), so a stretch without matches costs no round. Every
//      segment with hits whose entry changed re-walks from it, clearing
//      the old walk's match starts as it passes them, and stops as soon as
//      it takes a match where the old walk took one (then the rest, its
//      exit and the count of the rest are the old walk's). After ROUND_CAP
//      rounds a lane still unsettled is finished in segment order by warp
//      0 of each CTA in turn: the serial walk;
//   4. write: a warp scan of the counts, and the CTAs' totals across the
//      cluster, place each segment's records. Each warp writes its records
//      from its bitmap of match starts, 32 words at a time: a thread a
//      word (at most 7 starts), their lengths (2-bit lcp, or the kept
//      extension) and candidates loaded at once, a warp scan of counts and
//      ends giving each record its index and literal length. Records past
//      MAX_SEQS are dropped; the record MAX_SEQS - 1, if any, gives the
//      anchor, otherwise the lane's exit does.
// The kernel counts lanes, segments, re-walk rounds (sum and max over the
// lanes settled without the serial walk), serial lanes and lanes with
// more than MAX_SEQS records in the caller's stats array (zeroed by each
// call).
//
// Bound on this card: 8 bytes read per position the walk visits (its
// candidate and lcp), 2 per byte a match extension compares, and 12 bytes
// written per record, over 3.35 TB/s. The kernel stays far above it: a
// segment is a chain of dependent steps (a shared-memory scan, the 2-bit
// lcp, the extension's compares after a load of cand), and with 32 warps
// an SM the scalar steps of the walks also contend for issue slots
// (scripts/parse_profile.py times other segment counts and staging, and
// splits the cycles in an instrumented copy).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MIN_MATCH = 5;
constexpr int MAX_SEQS = 32768;
constexpr int EXTEND_STEP = 128;
constexpr int EXTEND_CAP = 1 << 20;
constexpr int SEGMENTS = 64;  // segments (warps) a lane at most
constexpr int CTAS = 2;       // CTAs a lane, one cluster
constexpr int WARPS = SEGMENTS / CTAS;  // warps a CTA at most
constexpr int SEG_MIN = 512;  // least positions a segment
constexpr int ROUND_CAP = 8;  // re-walk rounds before the serial walk
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(SEGMENTS % CTAS == 0 && WARPS <= 32, "a warp a segment");

// stats: lanes, segments, rounds (sum), rounds (max), serial lanes,
// truncated lanes
enum { kLanes, kSegments, kRoundsSum, kRoundsMax, kSerial, kTruncated,
       kStats };

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// bits [b0, b1) of a word, 0 <= b0 <= 31, b0 <= b1 <= 32
__device__ __forceinline__ uint32_t bit_range(int b0, int b1) {
  if (b1 <= b0) return 0u;
  uint32_t hi = b1 >= 32 ? FULL : (1u << b1) - 1u;
  return hi & (FULL << b0);
}

// One lane's arrays. kStaged: bytes, bitmaps and 2-bit lcp in shared
// memory; otherwise bytes, lcp and T in global memory, bitmaps in scratch.
template <bool kStaged>
struct Lane {
  const uint8_t* d;     // bytes
  const uint32_t* hit;  // hit bitmap
  uint32_t* ms;         // match starts of the current walks
  const uint32_t* tb;   // T bitmap
  const uint32_t* lc2;  // lcp - 5, 2 bits a position (kStaged, !wide_lcp)
  const int32_t* lcp;   // global lcp row
  const int32_t* cand;  // global cand row
  int32_t* ext;         // extended match lengths by position (scratch)
  int nv;
  int ntw;              // words of T
  int cap;              // staged bytes readable (kStaged)
  bool wide_lcp;        // a hit with lcp > 8: read lcp from global memory

  // T bits [t, t + 32), t > -32; bits below 0 read as 0. T holds every
  // t < 256, and its words reach past t + 32 for any t < L.
  __device__ __forceinline__ uint32_t tbits(int t) const {
    if (t < 256 - 31) return t < 0 ? FULL << (-t) : FULL;
    return __funnelshift_r(tb[t >> 5], tb[(t >> 5) + 1], t & 31);
  }

  __device__ __forceinline__ int lcp_at(int p) const {
    if (kStaged && !wide_lcp)
      return (int)((lc2[p >> 4] >> (2 * (p & 15))) & 3u) + MIN_MATCH;
    return lcp[p];
  }

  // bytes [x, x + 4) as a little-endian word (bytes past n_valid masked
  // by the caller)
  __device__ __forceinline__ uint32_t load4(int x) const {
    if (kStaged) {
      x = min(max(x, 0), cap);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(d);
      return __funnelshift_r(w[x >> 2], w[(x >> 2) + 1], 8 * (x & 3));
    }
    uint32_t v = 0;
    for (int t = 0; t < 4; ++t)
      if (x + t >= 0 && x + t < nv) v |= (uint32_t)d[x + t] << (8 * t);
    return v;
  }
};

// The first p in [i, e) with hit[p] and T[p - a], or -1. Warp-uniform.
template <class Ln>
__device__ int next_match(const Ln& L, int i, int a, int e) {
  const int lane = lane_id();
  {  // the word of i, by every thread alike: the next match is mostly there
    const int base = i & ~31;
    uint32_t h = L.hit[i >> 5] & (FULL << (i - base));
    if (h) h &= L.tbits(base - a);
    if (h) {
      const int p = base + __ffs(h) - 1;
      return p < e ? p : -1;  // e in this word: no match before it
    }
  }
  for (int w0 = (i >> 5) + 1; (w0 << 5) < e; w0 += 32) {
    const int base = (w0 + lane) << 5;
    uint32_t h = 0;
    if (base < e) {
      h = L.hit[w0 + lane];
      if (e - base < 32) h &= (1u << (e - base)) - 1u;
      if (h) h &= L.tbits(base - a);
    }
    const unsigned bal = __ballot_sync(FULL, h != 0);
    if (bal) {
      const int src = __ffs(bal) - 1;
      const uint32_t hw = __shfl_sync(FULL, h, src);
      return ((w0 + src) << 5) + __ffs(hw) - 1;
    }
  }
  return -1;
}

// The least t in T with t >= v. Warp-uniform.
template <class Ln>
__device__ int next_t(const Ln& L, int v) {
  const int lane = lane_id();
  for (int w0 = v >> 5;; w0 += 32) {
    const int w = w0 + lane;
    uint32_t m = w < L.ntw ? L.tb[w] : 0u;
    if (w == (v >> 5)) m &= FULL << (v & 31);
    const unsigned bal = __ballot_sync(FULL, m != 0);
    if (bal) {
      const int src = __ffs(bal) - 1;
      return ((w0 + src) << 5) + __ffs(__shfl_sync(FULL, m, src)) - 1;
    }
    if (w0 + 32 >= L.ntw) return 1 << 30;  // unreachable with a full T
  }
}

// The length of the match taken at p, whose candidate is c (loaded by the
// caller as soon as p is known, so that the load is in flight while the
// bitmap is kept); an extended one is also stored at ext[p] for the write.
// Warp-uniform.
template <class Ln>
__device__ int match_len(const Ln& L, int p, int c) {
  int m = L.lcp_at(p);
  if (m != 8) return m;
  const int lane = lane_id();
  const int o = p - c;
  for (;;) {
    const int q = p + m;
    const int lim = min(L.nv - q, EXTEND_STEP);
    int adv = lim;
    const int j = 4 * lane;
    uint32_t x = 0;
    if (j < lim) {
      x = L.load4(q + j) ^ L.load4(q - o + j);
      if (lim - j < 4) x &= (1u << (8 * (lim - j))) - 1u;
    }
    const unsigned bal = __ballot_sync(FULL, x != 0);
    if (bal) {
      const int src = __ffs(bal) - 1;
      adv = 4 * src + ((__ffs(__shfl_sync(FULL, x, src)) - 1) >> 3);
    }
    m += adv;
    if (!(adv >= EXTEND_STEP && m < EXTEND_CAP)) {
      if (lane == 0) L.ext[p] = m;
      return m;
    }
  }
}

// Set bits of ms in [lo, hi). Warp-uniform.
__device__ int count_bits(const uint32_t* ms, int lo, int hi) {
  int c = 0;
  if (lo < hi) {
    for (int w = (lo >> 5) + lane_id(); w <= ((hi - 1) >> 5); w += 32) {
      const int base = w << 5;
      c += __popc(ms[w] &
                  bit_range(max(lo - base, 0), min(hi - base, 32)));
    }
  }
  return __reduce_add_sync(FULL, (unsigned)c);
}

// Per-segment state, in shared memory, indexed by the lane's segment
// number. A CTA keeps its own segments' walks and reads its neighbour's
// through the cluster; the scan's results are its own.
struct Segs {
  int ent_i[SEGMENTS], ent_a[SEGMENTS];  // state the segment was walked from
  int ex_i[SEGMENTS], ex_a[SEGMENTS];    // its exit
  int cnt[SEGMENTS];                      // its records
  int last[SEGMENTS];                     // its last hit, -1 if none
  int tg_i[SEGMENTS], tg_a[SEGMENTS];     // the entry the scan gives it
  int base[SEGMENTS];                     // its first record's index here
  int out_i, out_a;  // state past this CTA's segments (the lane's exit
                     // once settled)
  int any;           // the scan found a segment to re-walk
  int total;         // records of this CTA's segments
};

// (Re-)walk segment k = [s, e) from (i, a), replacing the old walk's match
// starts; stops where it takes a match the old walk took (the rest is the
// old walk's). Updates the segment's entry, exit and count. The word of
// match starts the walk is in stays in a register (the new walk's bits,
// beside the old word as it was) and is stored when the walk leaves it;
// the words it passes over are zeroed.
template <class Ln>
__device__ void seg_walk(const Ln& L, Segs& S, int k, int s, int e, int i,
                         int a) {
  const int i0 = i, a0 = a;
  int n = 0;
  bool met = false;
  int cw = s >> 5;  // the word of match starts the walk is in
  uint32_t cur = 0, old = L.ms[cw];
  while (i < e) {
    const int p = next_match(L, i, a, e);
    if (p < 0) {
      i = a + next_t(L, e - a);
      break;
    }
    const int c = L.cand[p];
    if ((p >> 5) != cw) {  // every thread alike stores the same word
      L.ms[cw] = cur;
      for (int w = cw + 1 + lane_id(); w < (p >> 5); w += 32) L.ms[w] = 0u;
      cw = p >> 5;
      cur = 0;
      old = L.ms[cw];
    }
    const uint32_t bit = 1u << (p & 31);
    cur |= bit;
    if (old & bit) {  // the old walk took p: keep its rest
      met = true;
      L.ms[cw] = cur | (old & ~(bit | (bit - 1u)));
      __syncwarp();
      n += count_bits(L.ms, p, e);
      break;
    }
    ++n;
    const int m = match_len(L, p, c);
    i = p + m;
    a = i;
  }
  if (!met) {  // no old match start is left in [s, e)
    L.ms[cw] = cur;
    for (int w = cw + 1 + lane_id(); w <= ((e - 1) >> 5); w += 32)
      L.ms[w] = 0u;
  }
  __syncwarp();
  if (lane_id() == 0) {
    S.ent_i[k] = i0;
    S.ent_a[k] = a0;
    S.cnt[k] = n;
    if (!met) {
      S.ex_i[k] = i;
      S.ex_a[k] = a;
    }
  }
  __syncwarp();
}

// Warp 0 of each CTA: the entries of the K segments of G positions in
// order, from (0, 0). A segment with no hit at or past the state entering
// it forwards that state in closed form; otherwise the next state is its
// walk's exit (stale if its walk was from another entry, and then it is to
// re-walk). Sets tg of this CTA's segments [k0, k1), any, and out (the
// state past segment k1 - 1; past the lane once settled).
template <class Ln>
__device__ void scan_entries(const Ln& L, Segs& S, cg::cluster_group& cl,
                             int K, int G, int Kc, int k0, int k1) {
  constexpr int R = (SEGMENTS + 31) / 32;
  const int lane = lane_id();
  int ei[R], ea[R], xi[R], xa[R], lh[R];
#pragma unroll
  for (int h = 0; h < R; ++h) {  // every segment's walk, a thread each
    const int j = 32 * h + lane;
    lh[h] = -1;
    ei[h] = ea[h] = xi[h] = xa[h] = 0;
    if (j < K) {
      const Segs* o = cl.map_shared_rank(&S, j / Kc);
      lh[h] = o->last[j];
      ei[h] = o->ent_i[j];
      ea[h] = o->ent_a[j];
      xi[h] = o->ex_i[j];
      xa[h] = o->ex_a[j];
    }
  }
  int si = 0, sa = 0;
  bool any = false;
#pragma unroll
  for (int h = 0; h < R; ++h) {
    for (int src = 0; src < 32 && 32 * h + src < K; ++src) {
      const int j = 32 * h + src;
      const int e = min(j * G + G, L.nv);
      const int last = __shfl_sync(FULL, lh[h], src);
      const int i0 = __shfl_sync(FULL, ei[h], src);
      const int a0 = __shfl_sync(FULL, ea[h], src);
      const int i1 = __shfl_sync(FULL, xi[h], src);
      const int a1 = __shfl_sync(FULL, xa[h], src);
      if (j == k1) {
        S.out_i = si;
        S.out_a = sa;
      }
      if (j >= k0 && j < k1) {
        S.tg_i[j] = si;
        S.tg_a[j] = sa;
      }
      if (last >= 0) {
        any = any || i0 != si || a0 != sa;
        if (si <= last) {
          si = i1;
          sa = a1;
          continue;
        }
      }
      if (si < e) si = sa + next_t(L, e - sa);
    }
  }
  __syncwarp();
  if (lane == 0) {
    if (k1 >= K) {
      S.out_i = si;
      S.out_a = sa;
    }
    S.any = any;
  }
}

// Write the records of settled segment [s, e), entered with anchor a0:
// its match starts in ms, from index first on. 32 words (1,024 positions)
// at a time: each thread takes a word (at most 7 match starts, 5 bytes
// apart at least) and loads their lengths and candidates at once; a warp
// scan of the counts and of the records' last ends gives each record its
// index and the end of the record before it.
template <class Ln>
__device__ void seg_emit(const Ln& L, int s, int e, int a0, int first,
                         int32_t* ll, int32_t* ml, int32_t* of,
                         int32_t* anchor_out) {
  constexpr int kMax = 7;
  const int lane = lane_id();
  int prev = a0, idx = first;  // end of the record before; next index
  for (int w0 = s >> 5; (w0 << 5) < e && idx < MAX_SEQS; w0 += 32) {
    const int base = (w0 + lane) << 5;
    const uint32_t bits = base < e ? L.ms[w0 + lane] : 0u;
    int pp[kMax], mm[kMax], cc[kMax];
    uint32_t x = bits;
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      pp[j] = x ? base + __ffs(x) - 1 : -1;
      x &= x - 1;
    }
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      if (pp[j] >= 0) {
        mm[j] = L.lcp_at(pp[j]);
        cc[j] = L.cand[pp[j]];
        if (mm[j] == 8) mm[j] = L.ext[pp[j]];
      }
    }
    const int n = __popc(bits);
    int last = -1;
#pragma unroll
    for (int j = 0; j < kMax; ++j)
      if (j < n) last = pp[j] + mm[j];
    int incl = n, end = last;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      const int u = __shfl_up_sync(FULL, end, d);
      if (lane >= d) {
        incl += v;
        end = max(end, u);
      }
    }
    const int before = __shfl_up_sync(FULL, end, 1);
    int pe = lane > 0 ? max(prev, before) : prev;
    const int r0 = idx + incl - n;
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      const int r = r0 + j;
      if (j < n && r < MAX_SEQS) {
        ll[r] = pp[j] - pe;
        ml[r] = mm[j];
        of[r] = pp[j] - cc[j];
        if (r == MAX_SEQS - 1) *anchor_out = pp[j] + mm[j];
      }
      if (j < n) pe = pp[j] + mm[j];
    }
    idx += __shfl_sync(FULL, incl, 31);
    prev = max(prev, __shfl_sync(FULL, end, 31));
  }
}

template <bool kStaged>
__device__ void parse_lane(Lane<kStaged>& L, Segs& S, int K, int G, int Kc,
                           int32_t* ll, int32_t* ml, int32_t* of,
                           int32_t* nseq_out, int32_t* anchor_out,
                           unsigned long long* stats) {
  cg::cluster_group cl = cg::this_cluster();
  const int r = (int)cl.block_rank();
  const int lane = lane_id();
  const int w = threadIdx.x >> 5;
  const int nv = L.nv;
  const int k0 = min(K, r * Kc), k1 = min(K, k0 + Kc);  // this CTA's
  const int k = k0 + w;
  const bool mine = k < k1;
  const int s = k * G, e = min(s + G, nv);

  // the last hit of every segment; walk those with one from their top
  if (mine) {
    int lh = -1;
    for (int q = (s >> 5) + lane; q <= ((e - 1) >> 5); q += 32) {
      const uint32_t h = L.hit[q];  // no bit past n_valid is set
      if (h) lh = (q << 5) + 31 - __clz(h);
    }
    lh = __reduce_max_sync(FULL, lh);
    if (lane == 0) {
      S.last[k] = lh;
      S.cnt[k] = 0;
    }
    if (lh >= 0) seg_walk(L, S, k, s, e, s, s);
  }

  // settle: Jacobi rounds, then the serial walk past ROUND_CAP
  int rounds = 0;
  bool serial = false;
  for (;;) {
    cl.sync();  // the walks are done
    if (w == 0) scan_entries(L, S, cl, K, G, Kc, k0, k1);
    cl.sync();  // every scan has read the walks
    if (!S.any) break;
    if (rounds == ROUND_CAP) {
      serial = true;
      break;
    }
    ++rounds;
    if (mine && S.last[k] >= 0 &&
        (S.tg_i[k] != S.ent_i[k] || S.tg_a[k] != S.ent_a[k]))
      seg_walk(L, S, k, s, e, S.tg_i[k], S.tg_a[k]);
  }
  if (serial) {  // each CTA in turn, warp 0 in segment order
    for (int q = 0; q < CTAS; ++q) {
      if (q == r && w == 0) {
        int si = 0, sa = 0;
        if (r > 0) {
          const Segs* up = cl.map_shared_rank(&S, r - 1);
          si = up->out_i;
          sa = up->out_a;
        }
        for (int j = k0; j < k1; ++j) {
          const int ej = min(j * G + G, nv);
          if (S.last[j] >= 0) {
            if (si != S.ent_i[j] || sa != S.ent_a[j])
              seg_walk(L, S, j, j * G, ej, si, sa);
            si = S.ex_i[j];
            sa = S.ex_a[j];
          } else if (si < ej) {
            si = sa + next_t(L, ej - sa);
          }
        }
        if (lane == 0) {
          S.out_i = si;
          S.out_a = sa;
        }
      }
      cl.sync();
    }
  }

  // place the records: a warp scan here, the CTAs before it in the cluster
  if (w == 0) {
    const int j = k0 + lane;
    const int c = j < k1 ? S.cnt[j] : 0;
    int incl = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    if (j < k1) S.base[j] = incl - c;
    if (lane == 31) S.total = incl;
  }
  cl.sync();
  int first = 0, total = 0;
  for (int q = 0; q < CTAS; ++q) {
    const int t = cl.map_shared_rank(&S, q)->total;
    first += q < r ? t : 0;
    total += t;
  }
  if (threadIdx.x == 0 && r == (K - 1) / Kc) {
    *nseq_out = min(total, MAX_SEQS);
    if (total < MAX_SEQS) *anchor_out = S.out_a;
  }
  if (threadIdx.x == 0 && r == 0) {
    atomicAdd(&stats[kLanes], 1ull);
    atomicAdd(&stats[kSegments], (unsigned long long)K);
    if (serial) {
      atomicAdd(&stats[kSerial], 1ull);
    } else {
      atomicAdd(&stats[kRoundsSum], (unsigned long long)rounds);
      atomicMax(&stats[kRoundsMax], (unsigned long long)rounds);
    }
    if (total > MAX_SEQS) atomicAdd(&stats[kTruncated], 1ull);
  }
  if (mine && S.cnt[k] > 0 && first + S.base[k] < MAX_SEQS)
    seg_emit(L, s, e, S.ent_a[k], first + S.base[k], ll, ml, of,
             anchor_out);
  cl.sync();  // no CTA leaves while another may read its shared memory
}

__global__ void __launch_bounds__(32 * WARPS, 1)
parse_kernel(const uint8_t* __restrict__ data, long long Lw,
             const int32_t* __restrict__ cand,
             const int32_t* __restrict__ lcp,
             const int32_t* __restrict__ n_valid, int B,
             int32_t* __restrict__ ll, int32_t* __restrict__ ml,
             int32_t* __restrict__ off, int32_t* __restrict__ nseq,
             int32_t* __restrict__ anchor_out,
             const uint32_t* __restrict__ tbits, int ntw, bool staged,
             int32_t* __restrict__ scratch,
             unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Segs S;
  __shared__ int wide_flag;
  const int b = blockIdx.x / CTAS;  // the lane; its CTAs form one cluster
  const int r = blockIdx.x % CTAS;
  if (b >= B) return;
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int nv = (int)min(max((long long)n_valid[b], 0ll), Lw);
  int32_t* o_ll = ll + (long long)b * MAX_SEQS;
  int32_t* o_ml = ml + (long long)b * MAX_SEQS;
  int32_t* o_of = off + (long long)b * MAX_SEQS;
  if (nv == 0) {  // every CTA of the cluster leaves here
    if (threadIdx.x == 0 && r == 0) {
      nseq[b] = 0;
      anchor_out[b] = 0;
    }
    return;
  }
  const uint8_t* drow = data + (long long)b * Lw;
  const int32_t* crow = cand + (long long)b * Lw;
  const int32_t* lrow = lcp + (long long)b * Lw;
  const int hw = (int)((Lw + 31) >> 5);  // words of a bitmap
  int32_t* ext = scratch + (long long)b * (Lw + 2 * hw);

  // segments: G positions each (a multiple of 32), K of them, Kc a CTA
  int G = (nv + SEGMENTS - 1) / SEGMENTS;
  G = max(SEG_MIN, (G + 31) & ~31);
  const int K = (nv + G - 1) / G;
  const int Kc = (K + CTAS - 1) / CTAS;
  const int lo = min(r * Kc * G, nv), hi = min((r + 1) * Kc * G, nv);

  uint32_t *hit, *ms, *tb, *lc2 = nullptr;
  const int sb = (int)(((Lw + 15) & ~15LL) + 16);  // staged bytes
  if (staged) {
    uint8_t* st = smem;
    hit = reinterpret_cast<uint32_t*>(smem + sb);
    ms = hit + hw;
    lc2 = ms + hw;
    tb = lc2 + (hw * 2);
    if (lo < hi) {  // bytes [0, nv), 16-byte loads where the row is aligned
      int full = 0;
      if ((reinterpret_cast<uintptr_t>(drow) & 15) == 0) {
        full = nv >> 4;
        for (int q = threadIdx.x; q < full; q += blockDim.x)
          reinterpret_cast<uint4*>(st)[q] =
              reinterpret_cast<const uint4*>(drow)[q];
      }
      for (int q = 16 * full + threadIdx.x; q < nv; q += blockDim.x)
        st[q] = drow[q];
      for (int q = nv + threadIdx.x; q < sb; q += blockDim.x) st[q] = 0;
    }
    // T for every CTA: the scan reads it
    for (int w = threadIdx.x; w < ntw; w += blockDim.x) tb[w] = tbits[w];
  } else {
    hit = reinterpret_cast<uint32_t*>(ext) + Lw;
    ms = hit + hw;
    tb = const_cast<uint32_t*>(tbits);
  }
  if (threadIdx.x == 0) wide_flag = 0;
  __syncthreads();

  // this CTA's positions [lo, hi) (word-aligned: Kc * G is a multiple of
  // 32): hit bitmap and 2-bit lcp, a warp per 32 positions, 4 in flight
  bool wide = false;
  const int c_end = (hi + 31) >> 5;
  for (int c0 = (lo >> 5) + 4 * warp; c0 < c_end; c0 += 4 * nwarps) {
    int lv[4], cv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = ((c0 + u) << 5) + lane;
      const bool in = p < hi;
      lv[u] = in ? lrow[p] : 0;
      cv[u] = in ? crow[p] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u;
      if (c >= c_end) break;
      const bool h = lv[u] >= MIN_MATCH && cv[u] >= 0;
      wide = wide || (h && lv[u] > 8);
      const uint32_t word = __ballot_sync(FULL, h);
      if (lane == 0) {
        hit[c] = word;
        ms[c] = 0u;
      }
      if (staged) {
        uint32_t v = h ? (uint32_t)((lv[u] - MIN_MATCH) & 3) << (2 * (lane & 15))
                       : 0u;
        v |= __shfl_xor_sync(FULL, v, 1);
        v |= __shfl_xor_sync(FULL, v, 2);
        v |= __shfl_xor_sync(FULL, v, 4);
        v |= __shfl_xor_sync(FULL, v, 8);
        if ((lane & 15) == 0) lc2[2 * c + (lane >> 4)] = v;
      }
    }
  }
  if (wide) wide_flag = 1;
  __syncthreads();

  if (staged) {
    // the same arrays, addressed from smem so the walk reads shared memory
    uint32_t* h = reinterpret_cast<uint32_t*>(smem + sb);
    Lane<true> Ls{smem, h, h + hw, h + 4 * hw, h + 2 * hw, lrow, crow, ext,
                  nv, ntw, sb - 8, wide_flag != 0};
    parse_lane(Ls, S, K, G, Kc, o_ll, o_ml, o_of, nseq + b, anchor_out + b,
               stats);
  } else {
    Lane<false> Lg{drow, hit, ms, tb, nullptr, lrow, crow, ext, nv, ntw, 0,
                   true};
    parse_lane(Lg, S, K, G, Kc, o_ll, o_ml, o_of, nseq + b, anchor_out + b,
               stats);
  }
}

}  // namespace

// tbits: the skip set T as ntw words (bit t set for t in T, through the
// first t >= L); a lane is staged in shared memory when its bytes, bitmaps
// and T fit the card's shared memory a block, else it keeps its two
// bitmaps in scratch; scratch: B rows of L + 2 * ceil(L / 32) words
// (extended match lengths by position, then the bitmaps); stats: 6
// counters.
extern "C" int zt_parse_lanes(const void* data, long long L, const void* cand,
                              const void* lcp, const void* n_valid, int B,
                              void* ll, void* ml, void* off, void* nseq,
                              void* anchor, const void* tbits, int ntw,
                              void* scratch, void* stats, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(stats, 0, kStats * sizeof(uint64_t), st);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || L <= 0) return 0;
  const long long need = (L + (L >> 8) + 1) / 32 + 2;
  if (ntw < need || scratch == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (err = cudaFuncGetAttributes(&fa, parse_kernel)) != cudaSuccess)
    return (int)err;
  const long long hw = (L + 31) >> 5;
  const long long need_smem = ((L + 15) & ~15LL) + 16 + 4 * (4 * hw + ntw);
  const bool staged = need_smem + (long long)fa.sharedSizeBytes <= optin;
  const size_t smem = staged ? (size_t)need_smem : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(parse_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // warps a CTA: the most segments a lane of this width takes, over CTAS
  const long long kmax = min((long long)SEGMENTS, (L + SEG_MIN - 1) / SEG_MIN);
  const int warps = (int)((kmax + CTAS - 1) / CTAS);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * CTAS);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CTAS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, parse_kernel, (const uint8_t*)data, L, (const int32_t*)cand,
      (const int32_t*)lcp, (const int32_t*)n_valid, B, (int32_t*)ll,
      (int32_t*)ml, (int32_t*)off, (int32_t*)nseq, (int32_t*)anchor,
      (const uint32_t*)tbits, ntw, staged, (int32_t*)scratch,
      (unsigned long long*)stats);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
