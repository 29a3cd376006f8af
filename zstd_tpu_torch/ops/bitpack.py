"""Batched bit-packing — the encoder's mirror of bitstream.py.

Port of zstd_tpu/ops/bitpack.py. Huffman encoding has no sequential state:
every symbol's (code, nbits) is a table lookup, bit positions are an
exclusive cumsum, and the pack is two scatter-adds into a word array (a code
crossing a word boundary splits). One lane per output stream. This is plain
torch on every device (XLA in the reference too): it is data-parallel and
needs no kernel of its own.

torch has no add or shifts for uint32 tensors on the CPU, so the words are
carried in int64 masked to 32 bits and returned as int32 tensors holding the
uint32 bit patterns (`words.numpy().view(np.uint32)` on the host).
"""

import numpy as np
import torch

M32 = 0xFFFFFFFF


def as_int32_bits(x):
    """int64 values in [0, 2**32) -> the int32 tensor with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_bits_lanes(values, nbits, out_words: int):
    """Pack per-lane bit runs in order.

    values (B, N) integer bit payloads (LSB-first; bits above 32 ignored),
    nbits (B, N) widths in [0, 31] (0 = skip). values[i] occupies bits
    [cum_i, cum_i + nbits_i). Returns (words (B, out_words) int32 holding
    uint32 bit patterns, total_bits (B,) int32); runs past out_words are
    dropped, as the reference's scatter does."""
    nb = nbits.long()
    cum = torch.cumsum(nb, dim=1) - nb          # exclusive prefix sum
    total = (cum[:, -1] + nb[:, -1]).to(torch.int32)

    word = cum >> 5
    shift = cum & 31
    v = values.long() & M32 & ((1 << nb) - 1)
    lo = (v << shift) & M32
    # high part when the run crosses the word boundary (shift + nb > 32)
    hi = torch.where(shift > 0, v >> (32 - shift), 0)

    B = values.shape[0]
    words = torch.zeros((B, out_words + 1), dtype=torch.int64,
                        device=values.device)
    live = nb > 0
    w1 = torch.where(live & (word < out_words), word, out_words)
    words.scatter_add_(1, w1, torch.where(live, lo, 0))
    w2 = torch.where(live & (hi > 0) & (word + 1 < out_words), word + 1,
                     out_words)
    words.scatter_add_(1, w2, torch.where(w2 < out_words, hi, 0))
    return as_int32_bits(words[:, :out_words] & M32), total


def finalize_streams(words, total_bits):
    """Host-side: append the sentinel 1-bit and cut to padded byte length.

    words (B, W) uint32 bit patterns (a tensor of int32, or an array of
    4-byte words); total_bits (B,). Returns a list of bytes per lane."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    words = np.ascontiguousarray(words).view(np.uint32)
    if isinstance(total_bits, torch.Tensor):
        total_bits = total_bits.cpu().numpy()
    out = []
    for i in range(words.shape[0]):
        t = int(total_bits[i])
        raw = words[i].tobytes()[: (t + 7) // 8 + 1]
        buf = bytearray(raw[: (t // 8) + 1])
        # clear above t, set sentinel at bit t
        bit = t & 7
        buf[-1] &= (1 << bit) - 1
        buf[-1] |= 1 << bit
        out.append(bytes(buf))
    return out
