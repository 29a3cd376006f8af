"""xxHash64 (seed 0) for zstd content checksums.

The frame checksum is the low 32 bits of xxh64(decoded_content), stored LE
(RFC 8878 §3.1.1; reference uses twox-hash behind the `hash` feature).

Two implementations:
  - `xxhash64(data)`: vectorized NumPy over the bulk with a scalar tail —
    fast enough for GB-scale host verification.
  - streaming `Xxh64` with update(), for the streaming decoder drain path.

The device checksum (a CUDA kernel per lane of decoded bytes, with a plain
torch twin) lives in zstd_tpu_torch/ops/xxhash64.py.
"""

import numpy as np

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M64 = 0xFFFFFFFFFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def _merge_round(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return ((acc * _P1) + _P4) & _M64


class Xxh64:
    """Streaming xxHash64, seed fixed to 0."""

    __slots__ = ("v1", "v2", "v3", "v4", "total", "tail")

    def __init__(self):
        self.v1 = (_P1 + _P2) & _M64
        self.v2 = _P2
        self.v3 = 0
        self.v4 = (-_P1) & _M64
        self.total = 0
        self.tail = b""

    def update(self, data) -> None:
        data = bytes(data)
        self.total += len(data)
        buf = self.tail + data
        nstripes = len(buf) // 32
        if nstripes:
            body = np.frombuffer(buf[: nstripes * 32], dtype="<u8").reshape(-1, 4)
            v = np.array([self.v1, self.v2, self.v3, self.v4], dtype=np.uint64)
            p1 = np.uint64(_P1)
            p2 = np.uint64(_P2)
            with np.errstate(over="ignore"):
                for row in body:
                    v = v + row * p2
                    v = ((v << np.uint64(31)) | (v >> np.uint64(33))) * p1
            self.v1, self.v2, self.v3, self.v4 = (int(x) for x in v)
        self.tail = buf[nstripes * 32:]

    def digest(self) -> int:
        if self.total >= 32:
            h = (_rotl(self.v1, 1) + _rotl(self.v2, 7) + _rotl(self.v3, 12) + _rotl(self.v4, 18)) & _M64
            h = _merge_round(h, self.v1)
            h = _merge_round(h, self.v2)
            h = _merge_round(h, self.v3)
            h = _merge_round(h, self.v4)
        else:
            h = (self.v3 + _P5) & _M64  # v3 holds the seed (0)
        h = (h + self.total) & _M64
        buf = self.tail
        i = 0
        while i + 8 <= len(buf):
            k1 = _round(0, int.from_bytes(buf[i:i + 8], "little"))
            h ^= k1
            h = (_rotl(h, 27) * _P1 + _P4) & _M64
            i += 8
        if i + 4 <= len(buf):
            h ^= (int.from_bytes(buf[i:i + 4], "little") * _P1) & _M64
            h = (_rotl(h, 23) * _P2 + _P3) & _M64
            i += 4
        while i < len(buf):
            h ^= (buf[i] * _P5) & _M64
            h = (_rotl(h, 11) * _P1) & _M64
            i += 1
        h ^= h >> 33
        h = (h * _P2) & _M64
        h ^= h >> 29
        h = (h * _P3) & _M64
        h ^= h >> 32
        return h


def _select_xxh64():
    """Prefer the native streaming hasher (ZT_NO_NATIVE=1 forces Python)."""
    import os

    if os.environ.get("ZT_NO_NATIVE"):
        return Xxh64
    try:
        from zstd_tpu_torch import runtime

        if runtime.get_lib() is not None:
            return runtime.Xxh64Native
    except Exception:
        pass
    return Xxh64


PyXxh64 = Xxh64
Xxh64 = _select_xxh64()


def xxhash64(data) -> int:
    """One-shot xxh64 with seed 0 (native runtime when available)."""
    try:
        from zstd_tpu_torch.runtime import xxh64 as _native

        r = _native(bytes(data))
        if r is not None:
            return r
    except Exception:
        pass
    h = Xxh64()
    h.update(data)
    return h.digest()


class FastXxh64:
    """Streaming-API hasher that defers to the native one-shot at digest
    time (chunks are buffered; frame payloads are bounded by the window)."""

    __slots__ = ("parts",)

    def __init__(self):
        self.parts = []

    def update(self, data) -> None:
        self.parts.append(bytes(data))

    def digest(self) -> int:
        return xxhash64(b"".join(self.parts))


def content_checksum(data) -> int:
    """The 32-bit zstd content checksum of `data`."""
    return xxhash64(data) & 0xFFFFFFFF
