// XXH64 (seed 0) of data[i, start[i] : start[i] + len[i]] per lane, low 32
// bits out: the zstd frame checksum, verified on the device in serving mode.
//
// Replaces: zstd_tpu/ops/xxhash64.py::xxh64_low32_lanes (XLA in the
// reference, a stripe scan over all lanes at once; no Pallas kernel).
//
// Bound on this card: the hashed bytes read once over 3.35 TB/s. But a
// lane is four serial chains: each 32-byte stripe feeds one 8-byte word to
// each of four accumulators, and each accumulator's step (a 64-bit
// multiply, add, rotate, multiply) waits on its step before. A 128 KiB lane
// is 4,096 steps a chain. So the design keeps the chains fed and runs every
// lane at once:
//   - one warp per lane, kWarps lanes a block, so the main path's 1024
//     lanes spread over every SM;
//   - the warp loads the lane's bytes in 1 KiB tiles (32 stripes), coalesced
//     16 bytes a thread, into shared memory; the next tile's loads are in
//     flight (in registers) while the chains run over the current one;
//   - four threads run the four accumulators over the tile's stripes, each
//     reading its words from shared memory 8 at a time ahead of the steps
//     that take them; one thread merges them and hashes the tail under 32
//     bytes;
//   - a start that is not 16-byte aligned (dictionary frames skip the
//     dictionary content) loads the aligned tile around it, and the chain
//     threads read their words at the offset, as two aligned words
//     shifted together when it is not 8-byte aligned.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;     // lanes (warps) per block
constexpr int kTile = 1024;   // bytes per tile: 32 stripes
constexpr int kChunks = kTile / 16 + 1;  // 16-byte loads per tile (+ offset)

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t P3 = 0x165667B19E3779F9ull;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ull;

__device__ __forceinline__ uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t round1(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}

__device__ __forceinline__ uint64_t merge(uint64_t h, uint64_t acc) {
  return (h ^ round1(0, acc)) * P1 + P4;
}

__device__ __forceinline__ uint64_t load64_bytes(const uint8_t* p) {
  uint64_t v = 0;
#pragma unroll
  for (int k = 7; k >= 0; --k) v = (v << 8) | p[k];
  return v;
}

__device__ __forceinline__ uint32_t load32_bytes(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// The 16 bytes at the 16-byte-aligned address c, zeros outside [lo, hi).
__device__ __forceinline__ uint4 load16(const uint8_t* c, const uint8_t* lo,
                                        const uint8_t* hi) {
  if (c >= lo && c + 16 <= hi) return __ldg(reinterpret_cast<const uint4*>(c));
  uint8_t t[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) t[k] = (c + k >= lo && c + k < hi) ? c[k] : 0;
  uint4 v;
  v.x = t[0] | t[1] << 8 | t[2] << 16 | (uint32_t)t[3] << 24;
  v.y = t[4] | t[5] << 8 | t[6] << 16 | (uint32_t)t[7] << 24;
  v.z = t[8] | t[9] << 8 | t[10] << 16 | (uint32_t)t[11] << 24;
  v.w = t[12] | t[13] << 8 | t[14] << 16 | (uint32_t)t[15] << 24;
  return v;
}

// The 8 bytes at shared-memory byte offset b of the tile (any alignment).
__device__ __forceinline__ uint64_t word_at(const uint8_t* tile, int b) {
  const uint64_t* w = reinterpret_cast<const uint64_t*>(tile);
  const int sh = (b & 7) * 8;
  const uint64_t lo = w[b >> 3];
  return sh ? (lo >> sh) | (w[(b >> 3) + 1] << (64 - sh)) : lo;
}

__global__ void xxh_kernel(const uint8_t* __restrict__ data, long long w,
                           int n, const int32_t* __restrict__ start,
                           const int32_t* __restrict__ length,
                           long long* __restrict__ out) {
  __shared__ __align__(16) uint8_t tiles[kWarps][kTile + 48];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= n) return;  // the whole warp
  const long long s = min(max((long long)start[i], 0ll), w);
  const long long len = min(max((long long)length[i], 0ll), w - s);
  const uint8_t* row = data + (long long)i * w;
  const uint8_t* p = row + s;
  const int mis = (int)((uintptr_t)p & 15);
  const uint8_t* abase = p - mis;  // tile t: 16-byte loads from here
  const long long n_stripes = len >> 5;
  const long long n_tiles = (n_stripes + 31) >> 5;
  uint8_t* tile = tiles[warp];

  uint4 next[3];
  auto fetch = [&](long long t) {
    const uint8_t* c = abase + t * kTile;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int j = lane + 32 * k;
      if (j < kChunks) next[k] = load16(c + 16 * j, row, row + w);
    }
  };
  uint64_t v = lane == 0 ? P1 + P2 : lane == 1 ? P2 : lane == 2 ? 0 : 0 - P1;
  if (n_tiles) fetch(0);
  for (long long t = 0; t < n_tiles; ++t) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int j = lane + 32 * k;
      if (j < kChunks) reinterpret_cast<uint4*>(tile)[j] = next[k];
    }
    __syncwarp();
    if (t + 1 < n_tiles) fetch(t + 1);
    if (lane < 4) {
      const int ns = (int)min(32ll, n_stripes - 32 * t);
      const int b0 = mis + 8 * lane;
      if (ns == 32) {
        // a whole tile: 8 words loaded ahead of their 8 steps
#pragma unroll
        for (int g = 0; g < 32; g += 8) {
          uint64_t wv[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) wv[u] = word_at(tile, b0 + 32 * (g + u));
#pragma unroll
          for (int u = 0; u < 8; ++u) v = round1(v, wv[u]);
        }
      } else {
        for (int st = 0; st < ns; ++st)
          v = round1(v, word_at(tile, b0 + 32 * st));
      }
    }
    __syncwarp();
  }
  const uint64_t v1 = __shfl_sync(kFull, v, 0), v2 = __shfl_sync(kFull, v, 1);
  const uint64_t v3 = __shfl_sync(kFull, v, 2), v4 = __shfl_sync(kFull, v, 3);
  if (lane != 0) return;
  uint64_t h;
  if (len >= 32) {
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(h, v1);
    h = merge(h, v2);
    h = merge(h, v3);
    h = merge(h, v4);
  } else {
    h = P5;
  }
  h += (uint64_t)len;
  const uint8_t* q = p + 32 * n_stripes;
  const uint8_t* end = p + len;
  while (q + 8 <= end) {
    h ^= round1(0, load64_bytes(q));
    h = rotl(h, 27) * P1 + P4;
    q += 8;
  }
  if (q + 4 <= end) {
    h ^= (uint64_t)load32_bytes(q) * P1;
    h = rotl(h, 23) * P2 + P3;
    q += 4;
  }
  while (q < end) {
    h ^= (uint64_t)(*q) * P5;
    h = rotl(h, 11) * P1;
    ++q;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  out[i] = (long long)(h & 0xFFFFFFFFull);
}

}  // namespace

extern "C" int zt_xxh64_low32_lanes(const void* data, long long w, int n,
                                    const void* start, const void* length,
                                    void* out, void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarps - 1) / kWarps;
    xxh_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, w, n, (const int32_t*)start,
        (const int32_t*)length, (long long*)out);
  }
  return (int)cudaGetLastError();
}
