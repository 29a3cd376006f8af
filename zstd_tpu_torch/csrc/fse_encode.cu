// FSE (tANS) sequence encoding and bit packing, two warps per lane: warp 0
// computes every sequence's codes and extra bits and packs the bit fields;
// three threads of warp 1 walk the three interleaved state chains (LL/ML/OF).
//
// Replaces: zstd_tpu/ops/fse_encode.py::encode_sequence_lanes (:45, an XLA
// lax.scan, no Pallas kernel) with zstd_tpu/ops/bitpack.py::pack_bits_lanes
// (:18) over its runs. As plain torch the scan is a Python step per
// sequence slot, about ten launches each, so the port gives it a kernel.
//
// Design. The block copies the lane's three tables (12 KB) into shared
// memory and takes the lane's sequences from last to first in chunks of
// 32, one sequence a thread of warp 0, in a three-stage pipeline (chunk
// slots in shared memory, one block barrier a round):
//   1. codes (warp 0): the chunk's ll, ml and of values are loaded
//      coalesced one chunk ahead of use; each thread classifies its
//      sequence (binary search over the code baselines in shared memory),
//      computes its extra-bit fields and looks up its deltaNbBits and
//      deltaFindState;
//   2. states (warp 1, threads 0-2, one per stream), a chunk behind: each
//      walks its state chain over the chunk in order, recording each step's
//      bit count and emitted bits; only the dependent next-state lookup
//      ns[(state >> nb) + deltaFindState] stays on the chain;
//   3. pack (warp 0), two chunks behind: each thread sums its sequence's
//      six field widths; a warp scan added to the lane's running bit total
//      places the fields, which the threads OR into a shared window of
//      32-bit words; full words go out with coalesced stores and the
//      partial word carries to the next chunk. Words at or past out_words
//      are dropped while the total still counts them (a field past the
//      window, which only a corrupt table's bit count makes, is OR-ed into
//      the output directly).
// The final states are flushed by thread 0 at the end. With one warp doing
// all three steps, the state chains took 47.7% of the longest lane's cycles
// (scripts/fse_profile.py), so the pipeline overlaps them with the rest.
//
// Bound on this card: the sequences (12 bytes each), the lane's non-RLE
// tables at their least size (u16 next states, 1 << log of them; 8 bytes
// per code of the alphabet) and the output words over 3.35 TB/s. The kernel
// is latency-bound far above that: its time is the longest lane's chunks,
// each the longer of a 32-step dependent state chain (a shared load a step)
// and warp 0's code search, scan and stores, and a barrier.
//
// Semantics kept from the reference: the initial state of a stream is
// ns[((nb << 16) - deltaNbBits) >> nb + deltaFindState] with
// nb = (deltaNbBits + 2^15) >> 16 and an arithmetic shift of the int32
// value; each step's bit count is (state + deltaNbBits) >> 16 in uint32
// wraparound. RLE streams carry all-zero tables and log 0 (0-bit runs); a
// lane with nseq == 0 writes no bits. Next-state indices are clamped to the
// stream's table, as the reference's gather clamps. Per sequence the fields
// go out as OF, ML, LL state bits, then LL, ML, OF extra bits; the last
// sequence (the first encoded) has only its extra bits, and the final
// states follow as ML, OF, LL. A field of nb > 32 bits is its value's 32
// bits followed by zeros.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NS_W = 512;   // next-state columns per stream
constexpr int SYM_W = 256;  // deltaNbBits / deltaFindState columns
constexpr int N_LL = 36, N_ML = 53;
constexpr int CH = 32;      // sequences a chunk, one a thread
constexpr int BUF_W = 256;  // words of the shared output window
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Shared {
  int ns[3][NS_W];
  uint32_t nbd[3][SYM_W];
  int fs[3][SYM_W];
  int ctab[2 * N_LL + 2 * N_ML];
  // a chunk's slot, one of three in flight: its state steps' table
  // entries (by stream), extra-bit fields (ll, ml, of), and each step's
  // emitted bits and bit count
  struct Slot {
    uint32_t d[3][CH];
    int f[3][CH];
    uint32_t xv[3][CH];
    int xw[3][CH];
    uint32_t sbits[3][CH];
    uint32_t snb[3][CH];
  } slot[3];
  int fin[3];             // the final states
  uint32_t buf[BUF_W];    // output words [base, base + BUF_W)
};

// largest c with base[c] <= v, 0 below the first baseline
__device__ __forceinline__ int code_of(const int* base, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (base[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo > 0 ? lo - 1 : 0;
}

// The lane's output (warp 0): a shared window of words over the output row.
struct Out {
  Shared& sh;
  uint32_t* w;         // the lane's output row
  long long cap;       // out_words
  long long base = 0;  // output word of buf[0]

  __device__ __forceinline__ void put_word(long long wd, uint32_t x) {
    if (!x) return;
    long long j = wd - base;
    if (j < BUF_W) atomicOr(&sh.buf[j], x);
    else if (wd < cap) atomicOr(&w[wd], x);
  }

  // bits [pos, pos + nb): v's low min(nb, 32) bits, zeros above
  __device__ __forceinline__ void put(long long pos, uint32_t v, long long nb) {
    if (nb <= 0) return;
    if (nb < 32) v &= (1u << nb) - 1u;
    int s = (int)(pos & 31);
    put_word(pos >> 5, v << s);
    if (s) put_word((pos >> 5) + 1, v >> (32 - s));
  }

  // after the bits below `end` are in: store the words before its word,
  // carry its word to buf[0]
  __device__ void advance(long long end, int lane) {
    long long full = end >> 5;
    long long n = min(full - base, (long long)BUF_W);
    for (long long j = lane; j < n; j += 32)
      if (base + j < cap) w[base + j] = sh.buf[j];
    __syncwarp();
    uint32_t carry = 0;
    if (lane == 0) {
      if (full - base < BUF_W) carry = sh.buf[full - base];
      else if (full < cap) carry = atomicOr(&w[full], 0u);
    }
    __syncwarp();
    for (long long j = lane; j < n + 1 && j < BUF_W; j += 32) sh.buf[j] = 0;
    __syncwarp();
    if (lane == 0) sh.buf[0] = carry;
    base = full;
    __syncwarp();
  }

  // the last, partial word
  __device__ void finish(long long end, int lane) {
    long long j = end >> 5;
    if ((end & 31) && lane == 0 && j - base < BUF_W && j < cap)
      w[j] = sh.buf[j - base];
  }
};

// Warp 0, step 1: chunk c's codes, extra bits and table entries into its
// slot; the values of the chunk after it are loaded meanwhile.
struct Coder {
  const int32_t *ll, *ml, *of;
  long long row;
  int n;
  int llv = 0, mlv = 0, ofv = 0;  // this thread's sequence of the chunk

  __device__ __forceinline__ void load(int i) {
    if (i >= 0) {
      llv = ll[row + i];
      mlv = ml[row + i];
      ofv = of[row + i];
    }
  }

  __device__ __forceinline__ void code(Shared& sh, Shared::Slot& sl, int c,
                                       int lane) {
    const int* ctab = sh.ctab;
    const int v0 = llv, v1 = mlv, v2 = ofv;
    load(n - 1 - CH * (c + 1) - lane);
    int llc = code_of(ctab, N_LL, v0);
    int mlc = code_of(ctab + 2 * N_LL, N_ML, v1);
    int ofc = 31 - __clz((unsigned)max(v2, 1));
    sl.d[0][lane] = sh.nbd[0][llc];
    sl.f[0][lane] = sh.fs[0][llc];
    sl.d[1][lane] = sh.nbd[1][mlc];
    sl.f[1][lane] = sh.fs[1][mlc];
    sl.d[2][lane] = sh.nbd[2][ofc];
    sl.f[2][lane] = sh.fs[2][ofc];
    sl.xv[0][lane] = (uint32_t)(v0 - ctab[llc]);
    sl.xw[0][lane] = ctab[N_LL + llc];
    sl.xv[1][lane] = (uint32_t)(v1 - ctab[2 * N_LL + mlc]);
    sl.xw[1][lane] = ctab[2 * N_LL + N_ML + mlc];
    sl.xv[2][lane] = (uint32_t)v2 - (1u << ofc);
    sl.xw[2][lane] = ofc;
  }
};

// Warp 1, step 2, threads 0-2: stream s's state chain over chunk c (the
// first step of chunk 0 is the initial state).
__device__ __forceinline__ void walk_states(const Shared& sh,
                                            Shared::Slot& sl, int s, int c,
                                            int n, int& state) {
  const int hi = (s == 2 ? 256 : NS_W) - 1;
  const int* ns = sh.ns[s];
  const int steps = min(CH, n - CH * c);
  int t = 0;
  if (c == 0) {
    uint32_t d = sl.d[s][0];
    int nb0 = (int)((d + (1u << 15)) >> 16);
    int value = (int)(((uint32_t)nb0 << 16) - d);
    state = ns[min(max((value >> min(nb0, 31)) + sl.f[s][0], 0), hi)];
    sl.snb[s][0] = 0;
    sl.sbits[s][0] = 0;
    t = 1;
  }
  for (; t < steps; ++t) {
    uint32_t nb = ((uint32_t)state + sl.d[s][t]) >> 16;
    sl.snb[s][t] = nb;
    sl.sbits[s][t] = (uint32_t)state;
    state = ns[min(max((state >> min((int)nb, 31)) + sl.f[s][t], 0), hi)];
  }
}

// Warp 0, step 3: place and deposit chunk c's fields (OF, ML, LL states;
// LL, ML, OF extras) after T bits; returns the chunk's bits.
__device__ __forceinline__ long long pack(Out& out, const Shared::Slot& sl,
                                          int c, int n, long long T,
                                          int lane) {
  long long w_st[3] = {0, 0, 0};
  uint32_t v_st[3] = {0, 0, 0};
  int xw[3] = {0, 0, 0};
  uint32_t xv[3] = {0, 0, 0};
  if (n - 1 - CH * c - lane >= 0) {
    for (int k = 0; k < 3; ++k) {
      w_st[k] = sl.snb[2 - k][lane];
      v_st[k] = sl.sbits[2 - k][lane];
      xw[k] = sl.xw[k][lane];
      xv[k] = sl.xv[k][lane];
    }
  }
  // a sequence holds < 2^18 bits (a state's count is < 2^16), a chunk < 2^23
  int width = 0;
  for (int k = 0; k < 3; ++k)
    width += (int)w_st[k] + (xw[k] > 0 ? xw[k] : 0);
  int incl = width;
  for (int o = 1; o < 32; o <<= 1) {
    int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  long long pos = T + incl - width;
  for (int k = 0; k < 3; ++k) {
    out.put(pos, v_st[k], w_st[k]);
    pos += w_st[k];
  }
  for (int k = 0; k < 3; ++k) {
    out.put(pos, xv[k], xw[k]);
    pos += xw[k] > 0 ? xw[k] : 0;
  }
  return __shfl_sync(FULL, incl, 31);
}

// Two warps a lane, chunks in a three-stage pipeline: in round r, warp 0
// codes chunk r and packs chunk r - 2 while warp 1 walks the states of
// chunk r - 1; one block barrier a round.
__global__ void __launch_bounds__(64) fse_encode_kernel(
    const int32_t* __restrict__ ll, const int32_t* __restrict__ ml,
    const int32_t* __restrict__ of, int S, const int32_t* __restrict__ nseq,
    int B, const int32_t* __restrict__ ns, const int32_t* __restrict__ nbd,
    const int32_t* __restrict__ fs, const int32_t* __restrict__ logs,
    const int32_t* __restrict__ codes, int32_t* __restrict__ words,
    long long out_words, int32_t* __restrict__ total) {
  __shared__ Shared sh;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < 3 * NS_W; k += 64)
    (&sh.ns[0][0])[k] = ns[(long long)b * 3 * NS_W + k];
  for (int k = threadIdx.x; k < 3 * SYM_W; k += 64) {
    (&sh.nbd[0][0])[k] = (uint32_t)nbd[(long long)b * 3 * SYM_W + k];
    (&sh.fs[0][0])[k] = fs[(long long)b * 3 * SYM_W + k];
  }
  for (int k = threadIdx.x; k < 2 * N_LL + 2 * N_ML; k += 64)
    sh.ctab[k] = codes[k];
  for (int k = threadIdx.x; k < BUF_W; k += 64) sh.buf[k] = 0;

  const long long row = (long long)b * S;
  const int n = min(max(nseq[b], 0), S);
  const int chunks = (n + CH - 1) / CH;
  Out out{sh, reinterpret_cast<uint32_t*>(words) + (long long)b * out_words,
          out_words};
  Coder coder{ll, ml, of, row, n};
  long long T = 0;  // bits so far (warp 0)
  int state = 0;    // warp 1, thread s < 3: the state of stream s
  if (warp == 0) coder.load(n - 1 - lane);
  __syncthreads();

  for (int r = 0; r < chunks + 2; ++r) {
    if (warp == 0) {
      if (r < chunks) coder.code(sh, sh.slot[r % 3], r, lane);
      if (r >= 2) {
        T += pack(out, sh.slot[(r - 2) % 3], r - 2, n, T, lane);
        __syncwarp();
        out.advance(T, lane);
      }
    } else if (lane < 3 && r >= 1 && r <= chunks) {
      walk_states(sh, sh.slot[(r - 1) % 3], lane, r - 1, n, state);
    }
    __syncthreads();
  }
  if (warp == 1 && lane < 3) sh.fin[lane] = state;
  __syncthreads();
  if (warp != 0) return;
  if (n > 0) {
    // the final states, ML, OF, LL, by thread 0
    const int32_t* lg = logs + (long long)b * 3;  // ll, ml, of
    if (lane == 0) {
      const int order[3] = {1, 2, 0};
      for (int k = 0; k < 3; ++k) {
        int w = lg[order[k]];
        out.put(T, (uint32_t)sh.fin[order[k]], w);
        T += w > 0 ? w : 0;
      }
    }
    T = __shfl_sync(FULL, T, 0);
    __syncwarp();
    out.advance(T, lane);
    out.finish(T, lane);
  }
  if (lane == 0) total[b] = (int32_t)T;
}

}  // namespace

extern "C" int zt_fse_encode(const void* ll, const void* ml, const void* of,
                             int S, const void* nseq, int B, const void* ns,
                             const void* nbd, const void* fs, const void* logs,
                             const void* codes, void* words,
                             long long out_words, void* total, void* stream) {
  if (B > 0) {
    fse_encode_kernel<<<B, 64, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ll, (const int32_t*)ml, (const int32_t*)of, S,
        (const int32_t*)nseq, B, (const int32_t*)ns, (const int32_t*)nbd,
        (const int32_t*)fs, (const int32_t*)logs, (const int32_t*)codes,
        (int32_t*)words, out_words, (int32_t*)total);
  }
  return (int)cudaGetLastError();
}
