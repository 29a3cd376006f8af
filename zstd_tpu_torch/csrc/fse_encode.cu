// FSE (tANS) sequence encoding and bit packing, one block lane per warp:
// each lane's three interleaved states (LL/ML/OF) walk its sequences from
// last to first, and the bit runs go straight into the lane's words.
//
// Replaces: zstd_tpu/ops/fse_encode.py::encode_sequence_lanes (:45, an XLA
// lax.scan, no Pallas kernel) with zstd_tpu/ops/bitpack.py::pack_bits_lanes
// (:18) over its runs. As plain torch the scan is a Python step per
// sequence slot, about ten launches each, so the port gives it a kernel.
//
// Bound on this card: the sequences (12 bytes each), the lane's non-RLE
// tables at their least size (u16 next states, 1 << log of them; 8 bytes
// per code of the alphabet) and the output words over 3.35 TB/s. The state walk is a serial chain per
// lane (each next state is a table lookup indexed by the one before), so
// the kernel is latency-bound far above that. The design keeps the chain
// short: the warp first copies the lane's three tables (12 KB) into shared
// memory, then one thread walks the lane with shared-memory lookups and a
// 64-bit bit container, writing each 32-bit word once. Encoding and packing
// are fused, so the (B, 6S+6) run arrays of the reference never exist.
//
// Semantics kept from the reference: the initial state of a stream is
// ns[((nb << 16) - deltaNbBits) >> nb + deltaFindState] with
// nb = (deltaNbBits + 2^15) >> 16 and an arithmetic shift of the int32
// value; each step's bit count is (state + deltaNbBits) >> 16 in uint32
// wraparound. RLE streams carry all-zero tables and log 0 (0-bit runs); a
// lane with nseq == 0 writes no bits. Next-state indices are clamped to the
// stream's table, as the reference's gather clamps.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NS_W = 512;   // next-state columns per stream
constexpr int SYM_W = 256;  // deltaNbBits / deltaFindState columns
constexpr int N_LL = 36, N_ML = 53;

struct BitOut {
  uint32_t* w;
  long long cap;
  long long pos;
  unsigned long long acc;
  int fill;
  long long total;

  __device__ void put(uint32_t v, int nb) {
    if (nb <= 0) return;
    v &= nb >= 32 ? 0xFFFFFFFFu : ((1u << nb) - 1u);
    acc |= (unsigned long long)v << fill;
    fill += nb;
    total += nb;
    while (fill >= 32) {
      if (pos < cap) w[pos] = (uint32_t)acc;
      ++pos;
      acc >>= 32;
      fill -= 32;
    }
  }

  __device__ void flush() {
    if (fill > 0 && pos < cap) w[pos] = (uint32_t)acc;
  }
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

__device__ __forceinline__ int of_code(int v) {
  return 31 - __clz((unsigned)max(v, 1));
}

struct Tables {
  int ns[3][NS_W];
  uint32_t nbd[3][SYM_W];
  int fs[3][SYM_W];
};

__device__ __forceinline__ int clamp_idx(int idx, int s) {
  int hi = (s == 2 ? 256 : NS_W) - 1;
  return min(max(idx, 0), hi);
}

__device__ __forceinline__ int init_state(const Tables& t, int s, int code) {
  uint32_t d = t.nbd[s][code];
  int nb = (int)((d + (1u << 15)) >> 16);
  int value = (int)(((uint32_t)nb << 16) - d);
  return t.ns[s][clamp_idx((value >> min(nb, 31)) + t.fs[s][code], s)];
}

// one encode step of stream s: emits the low bits of the state
__device__ __forceinline__ void enc_step(const Tables& t, int s, int code,
                                         int& state, BitOut& out) {
  uint32_t d = t.nbd[s][code];
  int nb = (int)(((uint32_t)state + d) >> 16);
  out.put((uint32_t)state, nb);
  state = t.ns[s][clamp_idx((state >> min(nb, 31)) + t.fs[s][code], s)];
}

__global__ void fse_encode_kernel(
    const int32_t* __restrict__ ll, const int32_t* __restrict__ ml,
    const int32_t* __restrict__ of, int S, const int32_t* __restrict__ nseq,
    int B, const int32_t* __restrict__ ns, const int32_t* __restrict__ nbd,
    const int32_t* __restrict__ fs, const int32_t* __restrict__ logs,
    const int32_t* __restrict__ codes, int32_t* __restrict__ words,
    long long out_words, int32_t* __restrict__ total) {
  __shared__ Tables t;
  __shared__ int ctab[2 * N_LL + 2 * N_ML];
  int b = blockIdx.x;
  if (b >= B) return;
  for (int k = threadIdx.x; k < 3 * NS_W; k += blockDim.x)
    (&t.ns[0][0])[k] = ns[(long long)b * 3 * NS_W + k];
  for (int k = threadIdx.x; k < 3 * SYM_W; k += blockDim.x) {
    (&t.nbd[0][0])[k] = (uint32_t)nbd[(long long)b * 3 * SYM_W + k];
    (&t.fs[0][0])[k] = fs[(long long)b * 3 * SYM_W + k];
  }
  for (int k = threadIdx.x; k < 2 * N_LL + 2 * N_ML; k += blockDim.x)
    ctab[k] = codes[k];
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int* ll_base = ctab;
  const int* ll_xtra = ctab + N_LL;
  const int* ml_base = ctab + 2 * N_LL;
  const int* ml_xtra = ctab + 2 * N_LL + N_ML;
  const long long row = (long long)b * S;
  BitOut out{reinterpret_cast<uint32_t*>(words) + (long long)b * out_words,
             out_words, 0, 0ull, 0, 0};
  int n = min(max(nseq[b], 0), S);
  if (n > 0) {
    int llv = ll[row + n - 1], mlv = ml[row + n - 1], ofv = of[row + n - 1];
    int llc = code_of(ll_base, N_LL, llv);
    int mlc = code_of(ml_base, N_ML, mlv);
    int ofc = of_code(ofv);
    int s_ll = init_state(t, 0, llc);
    int s_ml = init_state(t, 1, mlc);
    int s_of = init_state(t, 2, ofc);
    out.put((uint32_t)(llv - ll_base[llc]), ll_xtra[llc]);
    out.put((uint32_t)(mlv - ml_base[mlc]), ml_xtra[mlc]);
    out.put((uint32_t)ofv - (1u << ofc), ofc);
    for (int i = n - 2; i >= 0; --i) {
      llv = ll[row + i];
      mlv = ml[row + i];
      ofv = of[row + i];
      llc = code_of(ll_base, N_LL, llv);
      mlc = code_of(ml_base, N_ML, mlv);
      ofc = of_code(ofv);
      enc_step(t, 2, ofc, s_of, out);
      enc_step(t, 1, mlc, s_ml, out);
      enc_step(t, 0, llc, s_ll, out);
      out.put((uint32_t)(llv - ll_base[llc]), ll_xtra[llc]);
      out.put((uint32_t)(mlv - ml_base[mlc]), ml_xtra[mlc]);
      out.put((uint32_t)ofv - (1u << ofc), ofc);
    }
    const int32_t* lg = logs + (long long)b * 3;  // ll, ml, of
    out.put((uint32_t)s_ml, lg[1]);
    out.put((uint32_t)s_of, lg[2]);
    out.put((uint32_t)s_ll, lg[0]);
  }
  out.flush();
  total[b] = (int32_t)out.total;
}

}  // namespace

extern "C" int zt_fse_encode(const void* ll, const void* ml, const void* of,
                             int S, const void* nseq, int B, const void* ns,
                             const void* nbd, const void* fs, const void* logs,
                             const void* codes, void* words,
                             long long out_words, void* total, void* stream) {
  if (B > 0) {
    fse_encode_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ll, (const int32_t*)ml, (const int32_t*)of, S,
        (const int32_t*)nseq, B, (const int32_t*)ns, (const int32_t*)nbd,
        (const int32_t*)fs, (const int32_t*)logs, (const int32_t*)codes,
        (int32_t*)words, out_words, (int32_t*)total);
  }
  return (int)cudaGetLastError();
}
