"""Device-batched match generation (the encode-side hot loop).

Port of zstd_tpu/encoding/device_matcher.py. The reference spends >60% of
encode time in its sequential suffix matcher (Readme.md:121,
match_generator.rs); DeviceMatcher replaces it with the device match finder
(ops/match_finder.py): hashes, candidates and lcp vectorised in torch, the
greedy parse in a CUDA kernel. A batch's blocks are grouped as the
reference groups them: by padded width (pow2 of the block's length, at
least 1024), each group split into device rounds of at most MAX_LANES
blocks, so a small block never pays for a large one's width and no round
outgrows the card (each lane's parse depends only on its own bytes, so the
grouping does not change the records). The results feed the existing block
assembly unchanged through the Matcher protocol.

Streams produced this way are valid but not byte-identical to the host
matcher's (different tie-breaks and no cross-block window); gates are round
trip, libzstd interop and compressed size, and equality with the
reference's device-matched frames.
"""

import time

import numpy as np
import torch

from zstd_tpu_torch.common.config import CompressionLevel
from zstd_tpu_torch.encoding.match_gen import RawSequence
from zstd_tpu_torch.encoding.matcher import Matcher
from zstd_tpu_torch.models.batch_decoder import resolve_device
from zstd_tpu_torch.ops.match_finder import parse_blocks

MAX_LANES = 512  # blocks per device round (the reference's cap)


def lane_width(n: int) -> int:
    """A block of n bytes parses at pow2(n), at least 1024."""
    return max(1 << (n - 1).bit_length(), 1024)


def rounds(blocks: list) -> list:
    """The device rounds of `blocks`: grouped by lane_width, widest last,
    at most MAX_LANES blocks each."""
    by_width = {}
    for b in blocks:
        by_width.setdefault(lane_width(len(b)), []).append(b)
    return [blks[s:s + MAX_LANES] for _, blks in sorted(by_width.items())
            for s in range(0, len(blks), MAX_LANES)]


def block_lanes(blocks: list, device):
    """The parse's inputs for `blocks`: data (B, W) uint8, zero-padded to
    W = pow2(longest block) (at least 1024), and n_valid (B,) int32."""
    B = len(blocks)
    w = lane_width(max(map(len, blocks)))
    data = np.zeros((B, w), np.uint8)
    n_valid = np.zeros(B, np.int32)
    for i, b in enumerate(blocks):
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        n_valid[i] = len(b)
    return (torch.from_numpy(data).to(device),
            torch.from_numpy(n_valid).to(device))


def _to_sequences(block: bytes, ll, ml, of, nseq: int, anchor: int) -> list:
    seqs = []
    pos = 0
    for k in range(nseq):
        l, m, o = int(ll[k]), int(ml[k]), int(of[k])
        seqs.append(RawSequence(block[pos:pos + l], o, m))
        pos += l + m
    if anchor < len(block) or not seqs:
        seqs.append(RawSequence(block[anchor:], 0, 0))
    return seqs


class DeviceMatcher(Matcher):
    """Batched device match finder behind the per-block Matcher protocol.

    `device` None means the GPU (raises without one); "cpu" runs the plain
    versions. Call precompute(blocks) with every block about to be
    compressed (in any order): it parses them all and keeps their results
    until the next precompute. find(block) then serves those results,
    parsing an unseen block on its own.

    last_stats after each precompute (or parse of an unseen block), summed
    over its device rounds (rounds()): blocks, records, device_s (upload,
    candidates, parse and the records' download) and records_s (turning
    the records into RawSequence lists on the host).
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cache = {}
        self.last_stats = {}

    def reset(self, level: CompressionLevel) -> None:
        pass

    def _parse_round(self, blocks: list, out: dict, stats: dict) -> None:
        t0 = time.perf_counter()
        ll, ml, of, nseq, anchor = parse_blocks(
            *block_lanes(blocks, self.device))
        nseq_h = nseq.cpu().numpy()
        anchor_h = anchor.cpu().numpy()
        cut = max(int(nseq_h.max()), 1)
        ll_h, ml_h, of_h = (t[:, :cut].cpu().numpy() for t in (ll, ml, of))
        t1 = time.perf_counter()
        for i, b in enumerate(blocks):
            out[b] = _to_sequences(b, ll_h[i], ml_h[i], of_h[i],
                                   int(nseq_h[i]), int(anchor_h[i]))
        stats["blocks"] += len(blocks)
        stats["records"] += int(nseq_h.sum())
        stats["device_s"] += t1 - t0
        stats["records_s"] += time.perf_counter() - t1

    def _parse(self, blocks: list) -> dict:
        out = {}
        stats = {"blocks": 0, "records": 0, "device_s": 0.0,
                 "records_s": 0.0}
        for group in rounds(blocks):
            self._parse_round(group, out, stats)
        self.last_stats = stats
        return out

    def precompute(self, blocks: list) -> None:
        todo = list(dict.fromkeys(b for b in blocks if len(b) >= 8))
        self._cache = self._parse(todo) if todo else {}

    def find(self, block: bytes) -> list:
        if len(block) < 8:
            return [RawSequence(block, 0, 0)] if block else []
        if block not in self._cache:
            self._cache.update(self._parse([block]))
        return self._cache[block]


__all__ = ["DeviceMatcher"]
