"""Device-batched match generation (the encode-side hot loop).

Port of zstd_tpu/encoding/device_matcher.py. The reference spends >60% of
encode time in its sequential suffix matcher (Readme.md:121,
match_generator.rs); DeviceMatcher replaces it with the device match finder
(ops/match_finder.py): hashes, candidates and lcp vectorised in torch, the
greedy parse in a CUDA kernel. All blocks of a batch go in one device round,
at the widest block's width (each lane's parse depends only on its own
bytes, so the reference's width buckets give the same records), and the
results feed the existing block assembly unchanged through the Matcher
protocol.

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


def block_lanes(blocks: list, device):
    """The parse's inputs for `blocks`: data (B, W) uint8, zero-padded to
    W = pow2(longest block) (at least 1024), and n_valid (B,) int32."""
    B = len(blocks)
    w = max(1 << (max(map(len, blocks)) - 1).bit_length(), 1024)
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

    last_stats after each device round: blocks, records, device_s (upload,
    candidates, parse and the records' download) and records_s (turning
    the records into RawSequence lists on the host).
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cache = {}
        self.last_stats = {}

    def reset(self, level: CompressionLevel) -> None:
        pass

    def _parse(self, blocks: list) -> dict:
        t0 = time.perf_counter()
        ll, ml, of, nseq, anchor = parse_blocks(
            *block_lanes(blocks, self.device))
        nseq_h = nseq.cpu().numpy()
        anchor_h = anchor.cpu().numpy()
        cut = max(int(nseq_h.max()), 1)
        ll_h, ml_h, of_h = (t[:, :cut].cpu().numpy() for t in (ll, ml, of))
        t1 = time.perf_counter()
        out = {b: _to_sequences(b, ll_h[i], ml_h[i], of_h[i], int(nseq_h[i]),
                                int(anchor_h[i]))
               for i, b in enumerate(blocks)}
        self.last_stats = {"blocks": len(blocks),
                           "records": int(nseq_h.sum()), "device_s": t1 - t0,
                           "records_s": time.perf_counter() - t1}
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
