"""XXH64 (seed 0) low 32 bits per lane: the frame checksum on the device.

`run_device(pull_outputs=False)` leaves decoded bytes on the device, so the
frame checksum is verified there: each lane's bytes
data[i, start[i] : start[i] + length[i]] are hashed and the low 32 bits
compared with the frame's checksum field (the reference hashes on every
drain, decode_buffer.rs:241-314). `xxh64_low32_lanes` runs the CUDA kernel
(csrc/xxhash64.cu, one warp per lane: 1 KiB tiles in shared memory, four
threads running the four accumulators) for CUDA tensors and
`xxh64_low32_lanes_plain` for CPU tensors.

The plain version walks 32-byte stripes for all lanes at once, as
zstd_tpu/ops/xxhash64.py does, in int64: multiplication and addition wrap
the same as uint64, and logical right shifts are arithmetic shifts masked
(torch on the CPU has no shifts for unsigned 64-bit tensors).
"""

import torch
import torch.nn.functional as F

from zstd_tpu_torch.ops import _kernels


def _s64(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


P1 = _s64(0x9E3779B185EBCA87)
P2 = _s64(0xC2B2AE3D27D4EB4F)
P3 = _s64(0x165667B19E3779F9)
P4 = _s64(0x85EBCA77C2B2AE63)
P5 = _s64(0x27D4EB2F165667C5)


def _shr(x, r: int):
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x, r: int):
    return (x << r) | _shr(x, 64 - r)


def _round(acc, inp):
    return _rotl(acc + inp * P2, 31) * P1


def _words(b):
    """(..., 8k) int64 bytes -> (..., k) little-endian int64 words."""
    b = b.reshape(*b.shape[:-1], -1, 8)
    w = b[..., 0]
    for k in range(1, 8):
        w = w | (b[..., k] << (8 * k))
    return w


def xxh64_low32_lanes_plain(data, length, start=None):
    """Plain torch version of the kernel (same arguments, same result)."""
    dev = data.device
    N, W = data.shape
    if start is None:
        start = torch.zeros_like(length)
    s = start.long().clamp(0, W)
    n = length.long().clamp(min=0)
    n = torch.minimum(n, W - s)
    # shift each lane to its start; zero-pad to whole stripes + a tail
    Wp = -(-W // 32) * 32 + 32
    cols = s[:, None] + torch.arange(Wp, device=dev)[None, :]
    buf = F.pad(data, (0, Wp)).long().gather(1, cols.clamp(max=W + Wp - 1))
    buf = torch.where(cols < W, buf, 0)
    stripes = _words(buf).reshape(N, -1, 4)

    acc = torch.tensor([_s64((P1 + P2) & (2**64 - 1)), P2, 0, -P1],
                       dtype=torch.int64, device=dev).repeat(N, 1)
    n_stripes = n // 32
    for k in range(int(n_stripes.max()) if N else 0):
        acc = torch.where((k < n_stripes)[:, None],
                          _round(acc, stripes[:, k]), acc)
    h = (_rotl(acc[:, 0], 1) + _rotl(acc[:, 1], 7) + _rotl(acc[:, 2], 12)
         + _rotl(acc[:, 3], 18))
    for i in range(4):
        h = (h ^ _round(torch.zeros_like(h), acc[:, i])) * P1 + P4
    h = torch.where(n >= 32, h, torch.full_like(h, P5)) + n

    # tail: up to 31 bytes after the last whole stripe
    tail_len = n & 31
    tcols = (n - tail_len)[:, None] + torch.arange(32, device=dev)[None, :]
    tail = buf.gather(1, tcols)
    tw = _words(tail)
    for k in range(3):
        upd = _rotl(h ^ _round(torch.zeros_like(h), tw[:, k]), 27) * P1 + P4
        h = torch.where(tail_len >= 8 * (k + 1), upd, h)
    p4 = (tail_len >> 3) * 8
    has4 = (tail_len & 4) > 0
    b4 = tail.gather(1, (p4[:, None] + torch.arange(4, device=dev)) % 32)
    v4 = b4[:, 0] | (b4[:, 1] << 8) | (b4[:, 2] << 16) | (b4[:, 3] << 24)
    h = torch.where(has4, _rotl(h ^ (v4 * P1), 23) * P2 + P3, h)
    p1 = p4 + torch.where(has4, 4, 0)
    for j in range(3):
        bj = tail.gather(1, ((p1 + j) % 32)[:, None])[:, 0]
        h = torch.where((tail_len & 3) > j, _rotl(h ^ (bj * P5), 11) * P1, h)

    h = h ^ _shr(h, 33)
    h = h * P2
    h = h ^ _shr(h, 29)
    h = h * P3
    h = h ^ _shr(h, 32)
    return h & 0xFFFFFFFF


def xxh64_low32_lanes(data, length, start=None):
    """Low 32 bits of XXH64(seed 0) of data[i, start[i]:start[i]+length[i]].

    data (N, W) u8; length, start (N,) i32 (start defaults to 0).
    Returns (N,) int64 in [0, 2**32)."""
    if not _kernels.on_cuda(data):
        return xxh64_low32_lanes_plain(data, length, start)
    dev = data.device
    _kernels.require(data, "data", torch.uint8, 2, dev)
    if start is None:
        start = torch.zeros_like(length)
    for name, t in (("length", length), ("start", start)):
        _kernels.require(t, name, torch.int32, 1, dev)
        if t.shape[0] != data.shape[0]:
            raise ValueError(f"{name}: {t.shape[0]} lanes, "
                             f"expected {data.shape[0]}")
    n = data.shape[0]
    out = torch.empty((n,), dtype=torch.int64, device=dev)
    _kernels.launch("xxhash64", data, data.shape[1], n, start,
                    length, out)
    xxh64_low32_lanes.launches += 1
    return out


xxh64_low32_lanes.launches = 0
