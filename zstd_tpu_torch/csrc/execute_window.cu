// Windowed LZ77 executor for chained frames, one warp per chain.
//
// Replaces: zstd_tpu/ops/pallas_execute.py::execute_window_pallas (kernel
// body `kernel`, which runs _exec_kernel over a window prefix copied into
// VMEM and a far stream gathered from HBM, one block group per call).
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
// chains differ only in `cap`. One launch covers every group of every
// chain.
//
// Bound on this card: the records (12 bytes each) and literals read once
// and the output written once, over 3.35 TB/s. The copy is serial per
// chain (each match may read the bytes the record before it wrote), so
// one warp walks its chain's records in order, its 32 threads sharing each
// copy with __syncwarp() between dependent copies, as csrc/execute.cu does
// for single-group frames; the kernel is latency-bound on that chain.
// Each group is validated by a first pass (warp prefix sums over 32-record
// chunks) before any of its bytes is stored.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ long long warp_incl_scan(long long v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    long long u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__global__ void window_kernel(const int32_t* __restrict__ ll,
                              const int32_t* __restrict__ ml,
                              const int32_t* __restrict__ off, long long S,
                              const uint8_t* __restrict__ lit, long long lit_w,
                              const int32_t* __restrict__ out_len,
                              const int32_t* __restrict__ row_lit_len,
                              int n_frames, const int32_t* __restrict__ plan,
                              int K, int n_chains, uint8_t* acc,
                              long long acc_w, long long base,
                              const int32_t* __restrict__ hist0,
                              const long long* __restrict__ cap,
                              long long* __restrict__ written_out,
                              uint8_t* __restrict__ ok_out) {
  int c = blockIdx.x;
  int lane = threadIdx.x;
  if (c >= n_chains) return;
  uint8_t* chain = acc + (long long)c * acc_w + base;
  long long h0 = min(max((long long)hist0[c], 0LL), base);
  long long cp = cap[c];
  long long room = acc_w - base;
  long long written = 0;
  bool alive = true;

  for (int k = 0; k < K && alive; ++k) {
    int row = min(max(plan[(long long)c * K + k], 0), n_frames - 1);
    const int32_t* L = ll + (long long)row * S;
    const int32_t* M = ml + (long long)row * S;
    const int32_t* O = off + (long long)row * S;
    long long avail = min(written + h0, cp);

    // pass 1: validate the group (and find its last active chunk)
    long long op = 0, lp = 0, last_chunk = -1;
    bool bad = false;
    for (long long b = 0; b < S; b += 32) {
      long long j = b + lane;
      long long l = 0, m = 0, o = 0;
      if (j < S) {
        l = L[j];
        m = M[j];
        o = O[j];
      }
      long long run_incl = warp_incl_scan(l + m, lane);
      long long l_incl = warp_incl_scan(l, lane);
      long long before_match = op + run_incl - m;
      bool rec_bad = l < 0 || m < 0 ||
                     (m != 0 && !(o > 0 && o <= before_match + avail));
      bad = bad || __any_sync(kFull, rec_bad);
      if (__any_sync(kFull, (l + m) != 0)) last_chunk = b;
      op += __shfl_sync(kFull, run_incl, 31);
      lp += __shfl_sync(kFull, l_incl, 31);
    }
    if (bad || op != (long long)out_len[row] ||
        lp > (long long)row_lit_len[row] || written + op > room) {
      alive = false;
      break;
    }

    // pass 2: execute in record order at the chain's cursor
    uint8_t* dst = chain + written;
    const uint8_t* src = lit + (long long)row * lit_w;
    op = 0;
    lp = 0;
    for (long long b = 0; b <= last_chunk; b += 32) {
      long long j = b + lane;
      int32_t l_r = 0, m_r = 0, o_r = 0;
      if (j < S) {
        l_r = L[j];
        m_r = M[j];
        o_r = O[j];
      }
      for (int t = 0; t < 32; ++t) {
        long long l = __shfl_sync(kFull, l_r, t);
        long long m = __shfl_sync(kFull, m_r, t);
        long long o = __shfl_sync(kFull, o_r, t);
        if (l == 0 && m == 0) continue;
        for (long long i = lane; i < l; i += 32) dst[op + i] = src[lp + i];
        op += l;
        lp += l;
        if (m > 0) {
          __syncwarp();
          const uint8_t* from = dst + op - o;  // may lie in earlier groups
          if (o >= m) {
            for (long long i = lane; i < m; i += 32) dst[op + i] = from[i];
          } else {
            for (long long i = lane; i < m; i += 32) dst[op + i] = from[i % o];
          }
          op += m;
        }
        __syncwarp();
      }
    }
    written += op;
  }
  if (lane == 0) {
    written_out[c] = written;
    ok_out[c] = alive ? 1 : 0;
  }
}

}  // namespace

extern "C" int zt_execute_window(const void* ll, const void* ml,
                                 const void* off, long long S,
                                 const void* lit, long long lit_w,
                                 const void* out_len, const void* row_lit_len,
                                 int n_frames, const void* plan, int K,
                                 int n_chains, void* acc, long long acc_w,
                                 long long base, const void* hist0,
                                 const void* cap, void* written, void* ok,
                                 void* stream) {
  if (n_chains > 0) {
    window_kernel<<<n_chains, 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ll, (const int32_t*)ml, (const int32_t*)off, S,
        (const uint8_t*)lit, lit_w, (const int32_t*)out_len,
        (const int32_t*)row_lit_len, n_frames, (const int32_t*)plan, K,
        n_chains, (uint8_t*)acc, acc_w, base, (const int32_t*)hist0,
        (const long long*)cap, (long long*)written, (uint8_t*)ok);
  }
  return (int)cudaGetLastError();
}
