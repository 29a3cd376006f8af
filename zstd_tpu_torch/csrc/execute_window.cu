// Windowed LZ77 executor for chained frames, byte-parallel: every output
// byte of every chain finds its source by pointer doubling.
//
// Replaces: zstd_tpu/ops/pallas_execute.py:883 execute_window_pallas (kernel
// body `kernel`, :1076, which runs _exec_kernel over a window prefix copied
// into VMEM and a far stream gathered from HBM, one block group per call).
//
// Semantics (ops/execute_window.py holds the plain version): chain c's
// rows plan[c, 0..K) execute in order into acc[c, base:], whose
// hist0[c] bytes before `base` are the dictionary prefill. For a group
// with w bytes of the chain written before it, avail = min(w + hist0,
// cap): the group is ok iff no record has a negative length, every record
// with ml > 0 has 0 < offset <= pos_before_match + avail (pos counted from
// the group's start), the total equals out_len[row], sum(ll) <=
// row_lit_len[row] and base + w + total <= the accumulator width. The
// first group that is not ok stops the chain before it writes anything;
// written[c] counts the bytes of the ok groups, ok[c] says whether every
// group was ok. Positions are 64-bit: a frame may exceed 2 GiB.
//
// On this card the whole history of a chain is in device memory, so the
// TPU kernel's window copy and far-stream gather are gone: a match reads
// acc[c, base + w + pos - offset] wherever that lies, and near and far
// chains differ only in `cap`.
//
// Bound on this card: the records (12 bytes each) and literals read once
// and the output written once, over 3.35 TB/s (bytes).
//
// Why byte-parallel. Record order is serial, but the dependence is not
// worth walking: on an 8 MiB frame of the chained path (349,183 records)
// offsets are short (median 149, p99 75,869), yet cutting the chain into
// 16 or 64 KiB segments, each serial and each match waiting for the
// records that produce its source, leaves a critical path of 346,830 and
// 348,091 records: about 1.0x parallel. Following each match byte's source
// pointer instead, every byte reaches a literal or prefill byte within 15
// rounds of src = src[src]. One warp per chain walked 16 chains on 16 of
// the card's 132 SMs at ~800 cycles a record (157 ms for 16 x 8 MiB); here
// every phase spreads over the records and bytes of the whole batch:
//
//   1. validate: one block per (chain, group). The group's start w is the
//      sum of out_len over the chain's earlier groups (exact for every
//      group that can run: an ok group's total is its out_len). Block-wide
//      prefix sums over the records check each group and give every
//      record its output column and literal start.
//   2. chains: one thread per chain; its live groups are the prefix of ok
//      groups, which gives written[c] and ok[c].
//   3. seed: one warp per 32 record slots of the live groups, the warp
//      sharing each record's bytes. Literal runs are copied into acc (16
//      bytes at a time where source and target align); every output byte
//      gets a pointer: a literal byte itself, a match byte p - o (the
//      closed form start - o + (p - start) % o in a periodic fill). A
//      pointer to a literal or prefill byte is final (its top bit set).
//   4. jump: ptr[p] = ptr[ptr[p]] over every open pointer, `rounds` =
//      bit_length(width) launches (depth < width); a round whose
//      predecessor left nothing open exits at once (flags[r]). Jumping in
//      place is safe: every value a thread reads is an ancestor of the
//      byte, and the final one is unique.
//   5. gather: acc[c, p] = acc[c, ptr[p]] for every match byte: sources
//      are literal or prefill bytes, already in place, so no read races a
//      write.
//
// Pointers are columns of the chain's row, 32-bit below a width of 2^31
// and 64-bit at or above it (`wide`).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kValidateThreads = 512;
constexpr int kPerThread = 4;  // records per validating thread per chunk
constexpr int kChunk = kValidateThreads * kPerThread;
constexpr int kThreads = 256;

__device__ __forceinline__ int clamp_row(int r, int n) {
  return min(max(r, 0), n - 1);
}

struct Sums {
  long long run, lit;
};

// Block-wide exclusive scan of (run, lit); *total gets the block's sums.
__device__ Sums block_excl_scan(Sums v, Sums* total) {
  constexpr int kWarps = kValidateThreads / 32;
  __shared__ long long s_run[kWarps], s_lit[kWarps];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Sums inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    long long r = __shfl_up_sync(kFull, inc.run, d);
    long long l = __shfl_up_sync(kFull, inc.lit, d);
    if (lane >= d) {
      inc.run += r;
      inc.lit += l;
    }
  }
  if (lane == 31) {
    s_run[warp] = inc.run;
    s_lit[warp] = inc.lit;
  }
  __syncthreads();
  if (warp == 0) {
    long long r = lane < kWarps ? s_run[lane] : 0;
    long long l = lane < kWarps ? s_lit[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      long long ur = __shfl_up_sync(kFull, r, d);
      long long ul = __shfl_up_sync(kFull, l, d);
      if (lane >= d) {
        r += ur;
        l += ul;
      }
    }
    if (lane < kWarps) {
      s_run[lane] = r;
      s_lit[lane] = l;
    }
  }
  __syncthreads();
  Sums ex = {inc.run - v.run + (warp ? s_run[warp - 1] : 0),
             inc.lit - v.lit + (warp ? s_lit[warp - 1] : 0)};
  *total = Sums{s_run[kWarps - 1], s_lit[kWarps - 1]};
  __syncthreads();  // the next call reuses s_run, s_lit
  return ex;
}

__global__ void __launch_bounds__(kValidateThreads)
validate_kernel(const int32_t* __restrict__ ll, const int32_t* __restrict__ ml,
                const int32_t* __restrict__ off, long long S,
                const int32_t* __restrict__ out_len,
                const int32_t* __restrict__ row_lit_len, int n_frames,
                const int32_t* __restrict__ plan, int K, long long acc_w,
                long long base, const int32_t* __restrict__ hist0,
                const long long* __restrict__ cap,
                long long* __restrict__ rec_out,
                long long* __restrict__ rec_lit,
                uint8_t* __restrict__ group_ok) {
  long long g = blockIdx.x;  // c * K + k
  int c = (int)(g / K), k = (int)(g % K);
  __shared__ long long s_w;
  if (threadIdx.x == 0) {
    long long w = 0;
    for (int j = 0; j < k; ++j)
      w += out_len[clamp_row(plan[(long long)c * K + j], n_frames)];
    s_w = w;
  }
  __syncthreads();
  long long w = s_w;
  int row = clamp_row(plan[g], n_frames);
  long long h0 = min(max((long long)hist0[c], 0LL), base);
  long long avail = min(w + h0, cap[c]);
  const int32_t* L = ll + (long long)row * S;
  const int32_t* M = ml + (long long)row * S;
  const int32_t* O = off + (long long)row * S;
  long long* RO = rec_out + g * S;
  long long* RL = rec_lit + g * S;
  long long start = base + w;
  long long op = 0, lp = 0;
  bool bad = false;
  for (long long b = 0; b < S; b += kChunk) {
    long long j0 = b + (long long)threadIdx.x * kPerThread;
    int l[kPerThread], m[kPerThread], o[kPerThread];
    Sums mine = {0, 0};
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      long long j = j0 + i;
      bool in = j < S;
      l[i] = in ? L[j] : 0;
      m[i] = in ? M[j] : 0;
      o[i] = in ? O[j] : 0;
      mine.run += (long long)l[i] + m[i];
      mine.lit += l[i];
    }
    Sums total;
    Sums ex = block_excl_scan(mine, &total);
    long long pos = op + ex.run, lpos = lp + ex.lit;
    bool rec_bad = false;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      long long j = j0 + i;
      if (j < S) {
        long long li = l[i], mi = m[i], oi = o[i];
        rec_bad = rec_bad || li < 0 || mi < 0 ||
                  (mi != 0 && !(oi > 0 && oi <= pos + li + avail));
        RO[j] = start + pos;
        RL[j] = lpos;
        pos += li + mi;
        lpos += li;
      }
    }
    op += total.run;
    lp += total.lit;
    bad = __syncthreads_or(bad || rec_bad);
    if (bad) break;  // uniform: the block agrees
  }
  if (threadIdx.x == 0) {
    group_ok[g] = !bad && op == (long long)out_len[row] &&
                  lp <= (long long)row_lit_len[row] && w + op <= acc_w - base;
  }
}

__global__ void chains_kernel(const uint8_t* __restrict__ group_ok,
                              const int32_t* __restrict__ out_len,
                              int n_frames, const int32_t* __restrict__ plan,
                              int K, int n_chains,
                              long long* __restrict__ written,
                              uint8_t* __restrict__ ok,
                              int32_t* __restrict__ n_live) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  long long w = 0;
  int n = 0;
  while (n < K && group_ok[(long long)c * K + n]) {
    w += out_len[clamp_row(plan[(long long)c * K + n], n_frames)];
    ++n;
  }
  written[c] = w;
  ok[c] = n == K ? 1 : 0;
  n_live[c] = n;
}

template <typename P>
struct Ptr {
  static constexpr P kFinal = P(1) << (sizeof(P) * 8 - 1);
  static constexpr P kColumn = kFinal - 1;
};

// The warp copies n literal bytes, 16 at a time where both ends align.
__device__ __forceinline__ void copy_run(uint8_t* dst, const uint8_t* src,
                                         long long n, int lane) {
  uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  if (n >= 64 && ((d ^ reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    long long head = (16 - (long long)(d & 15)) & 15;
    if (lane < head) dst[lane] = src[lane];
    long long nv = (n - head) >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
    uint4* d4 = reinterpret_cast<uint4*>(dst + head);
    for (long long i = lane; i < nv; i += 32) d4[i] = s4[i];
    for (long long i = head + nv * 16 + lane; i < n; i += 32) dst[i] = src[i];
  } else {
    for (long long i = lane; i < n; i += 32) dst[i] = src[i];
  }
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
seed_kernel(const int32_t* __restrict__ ll, const int32_t* __restrict__ ml,
            const int32_t* __restrict__ off, long long S,
            const uint8_t* __restrict__ lit, long long lit_w, int n_frames,
            const int32_t* __restrict__ plan, int K, long long n_groups,
            uint8_t* __restrict__ acc, long long acc_w, long long base,
            const long long* __restrict__ rec_out,
            const long long* __restrict__ rec_lit,
            const int32_t* __restrict__ n_live, P* __restrict__ ptr,
            long long stride, int32_t* __restrict__ flags) {
  constexpr P kFinal = Ptr<P>::kFinal;
  long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  long long chunks = (S + 31) >> 5;
  long long g = warp / chunks;
  if (g >= n_groups) return;  // whole warps: g is per warp
  int c = (int)(g / K), k = (int)(g % K);
  if (k >= n_live[c]) return;
  int row = clamp_row(plan[g], n_frames);
  long long j = (warp % chunks) * 32 + lane;
  int l = 0, m = 0, o = 0;
  long long os = 0, ls = 0;
  if (j < S) {
    l = ll[(long long)row * S + j];
    m = ml[(long long)row * S + j];
    o = off[(long long)row * S + j];
    if (l | m) {
      os = rec_out[g * S + j];
      ls = rec_lit[g * S + j];
    }
  }
  unsigned todo = __ballot_sync(kFull, (l | m) != 0);
  uint8_t* arow = acc + (long long)c * acc_w;
  P* prow = ptr + (long long)c * stride;  // column p at prow[p - base]
  const uint8_t* lrow = lit + (long long)row * lit_w;
  bool open = false;
  while (todo) {
    int t = __ffs(todo) - 1;
    todo &= todo - 1;
    long long rl = __shfl_sync(kFull, l, t);
    long long rm = __shfl_sync(kFull, m, t);
    unsigned ro = (unsigned)__shfl_sync(kFull, o, t);
    long long ros = __shfl_sync(kFull, os, t);
    long long rls = __shfl_sync(kFull, ls, t);
    copy_run(arow + ros, lrow + rls, rl, lane);
    for (long long i = lane; i < rl; i += 32)
      prow[ros - base + i] = (P)(ros + i) | kFinal;
    long long ms = ros + rl;  // the match's first column
    for (long long i = lane; i < rm; i += 32) {
      long long src = i < ro ? ms + i - ro
                             : ms - ro + (long long)((unsigned)i % ro);
      // final: a prefill byte, or a literal of this record's own run
      bool done = src < base || src >= ros;
      open = open || !done;
      prow[ms - base + i] = (P)src | (done ? kFinal : P(0));
    }
  }
  if (__any_sync(kFull, open) && lane == 0) flags[0] = 1;
}

// 4 consecutive pointers at a 16-byte (32-bit) or 32-byte (64-bit) boundary.
__device__ __forceinline__ void load4(const uint32_t* p, uint32_t v[4]) {
  uint4 x = *reinterpret_cast<const uint4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void store4(uint32_t* p, const uint32_t v[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load4(const unsigned long long* p,
                                      unsigned long long v[4]) {
  ulonglong2 a = reinterpret_cast<const ulonglong2*>(p)[0];
  ulonglong2 b = reinterpret_cast<const ulonglong2*>(p)[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void store4(unsigned long long* p,
                                      const unsigned long long v[4]) {
  reinterpret_cast<ulonglong2*>(p)[0] = make_ulonglong2(v[0], v[1]);
  reinterpret_cast<ulonglong2*>(p)[1] = make_ulonglong2(v[2], v[3]);
}

// One round of pointer doubling over every chain's written bytes. No
// __restrict__ on ptr: the round reads what other threads write.
template <typename P>
__global__ void __launch_bounds__(kThreads)
jump_kernel(P* ptr, long long stride, long long base,
            const long long* __restrict__ written, int n_chains,
            int32_t* flags, int round) {
  constexpr P kFinal = Ptr<P>::kFinal;
  if (flags[round] == 0) return;  // the round before left nothing open
  bool open = false;
  long long step = (long long)gridDim.x * kThreads * 4;
  for (int c = blockIdx.y; c < n_chains; c += gridDim.y) {
    long long n = written[c];
    P* row = ptr + (long long)c * stride;
    for (long long q = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
         q < n; q += step) {
      P v[4], t[4];
      load4(row + q, v);
      bool go[4], any = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        go[i] = q + i < n && !(v[i] & kFinal);
        any = any || go[i];
      }
      if (!any) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)  // independent loads, all in flight
        t[i] = go[i] ? row[(long long)v[i] - base] : v[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (go[i]) {
          v[i] = t[i];
          open = open || !(t[i] & kFinal);
        }
      }
      store4(row + q, v);
    }
  }
  if (__syncthreads_or(open) && threadIdx.x == 0) flags[round + 1] = 1;
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const P* __restrict__ ptr, long long stride, long long base,
              const long long* __restrict__ written, int n_chains,
              uint8_t* acc, long long acc_w) {
  constexpr P kColumn = Ptr<P>::kColumn;
  long long step = (long long)gridDim.x * kThreads * 4;
  for (int c = blockIdx.y; c < n_chains; c += gridDim.y) {
    long long n = written[c];
    const P* row = ptr + (long long)c * stride;
    uint8_t* arow = acc + (long long)c * acc_w;
    for (long long q = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
         q < n; q += step) {
      P v[4];
      load4(row + q, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        long long p = base + q + i;
        long long src = (long long)(v[i] & kColumn);
        if (q + i < n && src != p) arow[p] = arow[src];
      }
    }
  }
}

// Blocks for a sweep over every chain's pointers: about 8 per SM in all,
// chains across y, positions across x.
dim3 sweep_grid(int n_chains, long long stride) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int y = n_chains < 65535 ? n_chains : 65535;
  long long need = (stride / 4 + kThreads - 1) / kThreads;
  long long x = (8LL * sms) / y;
  if (x > need) x = need;
  if (x < 1) x = 1;
  return dim3((unsigned)x, (unsigned)y);
}

template <typename P>
void run(const int32_t* ll, const int32_t* ml, const int32_t* off,
         long long S, const uint8_t* lit, long long lit_w,
         const int32_t* out_len, const int32_t* row_lit_len, int n_frames,
         const int32_t* plan, int K, int n_chains, uint8_t* acc,
         long long acc_w, long long base, const int32_t* hist0,
         const long long* cap, long long* written, uint8_t* ok,
         long long* rec_out, long long* rec_lit, uint8_t* group_ok,
         int32_t* n_live, P* ptr, long long stride, int32_t* flags,
         int rounds, cudaStream_t st) {
  long long n_groups = (long long)n_chains * K;
  cudaMemsetAsync(flags, 0, sizeof(int32_t) * (rounds + 1), st);
  validate_kernel<<<(unsigned)n_groups, kValidateThreads, 0, st>>>(
      ll, ml, off, S, out_len, row_lit_len, n_frames, plan, K, acc_w, base,
      hist0, cap, rec_out, rec_lit, group_ok);
  chains_kernel<<<(n_chains + 255) / 256, 256, 0, st>>>(
      group_ok, out_len, n_frames, plan, K, n_chains, written, ok, n_live);
  long long warps = n_groups * ((S + 31) >> 5);
  long long seed_blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (seed_blocks > 0) {
    seed_kernel<P><<<(unsigned)seed_blocks, kThreads, 0, st>>>(
        ll, ml, off, S, lit, lit_w, n_frames, plan, K, n_groups, acc, acc_w,
        base, rec_out, rec_lit, n_live, ptr, stride, flags);
  }
  dim3 grid = sweep_grid(n_chains, stride);
  for (int r = 0; r < rounds; ++r) {
    jump_kernel<P><<<grid, kThreads, 0, st>>>(ptr, stride, base, written,
                                              n_chains, flags, r);
  }
  gather_kernel<P><<<grid, kThreads, 0, st>>>(ptr, stride, base, written,
                                              n_chains, acc, acc_w);
}

}  // namespace

// Queues the five phases on `stream`; allocates nothing and never waits.
// Scratch (from the caller): rec_out, rec_lit (n_chains * K * S) i64,
// group_ok (n_chains * K) u8, n_live (n_chains) i32, ptr (n_chains *
// stride) pointers, i32 or (wide) i64, stride >= acc_w - base and a
// multiple of 4, flags (rounds + 1) i32: flags[r] != 0 iff jump round r
// had open pointers to follow.
extern "C" int zt_execute_window(
    const void* ll, const void* ml, const void* off, long long S,
    const void* lit, long long lit_w, const void* out_len,
    const void* row_lit_len, int n_frames, const void* plan, int K,
    int n_chains, void* acc, long long acc_w, long long base,
    const void* hist0, const void* cap, void* written, void* ok,
    void* rec_out, void* rec_lit, void* group_ok, void* n_live, void* ptr,
    long long stride, int wide, void* flags, int rounds, void* stream) {
  if (n_chains <= 0 || K <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
#define ZT_WINDOW_ARGS(P)                                                    \
  (const int32_t*)ll, (const int32_t*)ml, (const int32_t*)off, S,            \
      (const uint8_t*)lit, lit_w, (const int32_t*)out_len,                   \
      (const int32_t*)row_lit_len, n_frames, (const int32_t*)plan, K,        \
      n_chains, (uint8_t*)acc, acc_w, base, (const int32_t*)hist0,           \
      (const long long*)cap, (long long*)written, (uint8_t*)ok,              \
      (long long*)rec_out, (long long*)rec_lit, (uint8_t*)group_ok,          \
      (int32_t*)n_live, (P*)ptr, stride, (int32_t*)flags, rounds, st
  if (wide) {
    run<unsigned long long>(ZT_WINDOW_ARGS(unsigned long long));
  } else {
    run<uint32_t>(ZT_WINDOW_ARGS(uint32_t));
  }
#undef ZT_WINDOW_ARGS
  return (int)cudaGetLastError();
}
