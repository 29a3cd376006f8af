"""Batched FSE (tANS) sequence encoding and bit packing, one lane per block.

Port of zstd_tpu/ops/fse_encode.py (an XLA `lax.scan` in the reference,
packed by ops/bitpack.py): the three interleaved states (LL/ML/OF) walk each
lane's sequences in reverse stream order and emit bit runs — the encoder
side of compressed.rs:160-221.

Wire layout per lane (write order):
  [ll_extra, ml_extra, of_extra] of the LAST sequence            (3 runs)
  for i = n-2 .. 0: [of_state, ml_state, ll_state,
                     ll_extra, ml_extra, of_extra] of sequence i (6 runs)
  [ml_flush, of_flush, ll_flush]                                 (3 runs)

RLE / zero-bit modes carry all-zero tables and log 0, so they emit 0-width
state runs; a lane with no sequences emits nothing.

Lane arrays (`seq_lane_arrays` builds them), one row per lane:
  ll, ml, of (B, S) int32 raw values (literal length, match length, offset
      value), S >= max nseq
  nseq (B,) int32
  ns (B, 3, 512) int32 next-state tables, streams in the order ll, ml, of
      (the of table uses its first 256 columns)
  nbd (B, 3, 256) int32 deltaNbBits (uint32 bit patterns)
  fs (B, 3, 256) int32 deltaFindState
  logs (B, 3) int32 table logs (ll, ml, of), 0 for an RLE stream

`encode_sequences_packed` launches the CUDA kernel (csrc/fse_encode.cu,
encode and pack fused, two warps per lane: one codes and packs 32
sequences at a time, three threads of the other walk the states) for CUDA
tensors and packs
`encode_sequence_lanes_plain`'s runs with ops/bitpack.py for CPU tensors.
A state's next-state index is clamped to its table (the reference's gather
clamps too); valid tables never reach the clamp.
"""

import numpy as np
import torch

from zstd_tpu_torch.common import constants as C
from zstd_tpu_torch.ops import _kernels
from zstd_tpu_torch.ops.bitpack import M32, pack_bits_lanes

STREAMS = 3                      # ll, ml, of
NS_WIDTH = 512                   # next-state columns per stream
SYM_WIDTH = 256                  # deltaNbBits / deltaFindState columns
STATE_COLS = (512, 512, 256)     # table widths of ll, ml, of


def pack_encode_table(table, state_width: int):
    """fse_enc.FSEEncodeTable -> (next_state u16[state_width],
    nb_delta u32[256], find_state i32[256])."""
    ns = np.zeros(state_width, np.uint16)
    ns[:table.table_size] = table.next_state
    return ns, table.delta_nb_bits.astype(np.uint32), \
        table.delta_find_state.astype(np.int32)


def code_tables(device):
    """(36 + 36 + 53 + 53,) int32: LL baselines, LL extra bits, ML
    baselines, ML extra bits — the kernel's code classification tables."""
    return torch.tensor(C.LL_CODE_BASELINE + C.LL_CODE_EXTRA_BITS
                        + C.ML_CODE_BASELINE + C.ML_CODE_EXTRA_BITS,
                        dtype=torch.int32, device=device)


def out_words_for(S: int) -> int:
    """Words per lane for S sequence slots (the reference's bound:
    zstd_tpu/models/batch_encoder.py:333)."""
    return (6 * S + 6) * 32 // 32 + 4


def _s32(x):
    """int64 holding a 32-bit pattern -> its signed int32 value (int64)."""
    return ((x + (1 << 31)) & M32) - (1 << 31)


def encode_sequence_lanes_plain(ll, ml, of, nseq, ns, nbd, fs, logs):
    """Plain torch version: a loop over sequence steps, vectorised over
    lanes. Returns (values (B, 6S+6) int64, nbits (B, 6S+6) int32) bit runs
    in the wire layout above (ops/bitpack.pack_bits_lanes packs them)."""
    dev = ll.device
    B, S = ll.shape
    ll_base, ll_xtra, ml_base, ml_xtra = torch.split(
        code_tables(dev).long(), [36, 36, 53, 53])
    pow2 = torch.tensor([1 << k for k in range(32)], dtype=torch.int64,
                        device=dev)
    llv, mlv, ofv = ll.long(), ml.long(), of.long()
    # code = largest c with baseline[c] <= value (0 below the first)
    llc = (torch.searchsorted(ll_base, llv, right=True) - 1).clamp(min=0)
    mlc = (torch.searchsorted(ml_base, mlv, right=True) - 1).clamp(min=0)
    ofc = torch.searchsorted(pow2, ofv.clamp(min=1), right=True) - 1
    # extras (value, width) per sequence, in the order ll, ml, of
    xv = torch.stack([llv - ll_base[llc], mlv - ml_base[mlc],
                      ofv - pow2[ofc]], dim=1) & M32           # (B, 3, S)
    xn = torch.stack([ll_xtra[llc], ml_xtra[mlc], ofc], dim=1)
    codes = torch.stack([llc, mlc, ofc], dim=1)                 # (B, 3, S)
    d = nbd.long().gather(2, codes) & M32
    f = fs.long().gather(2, codes)
    ns = ns.long()
    hi = torch.tensor(STATE_COLS, device=dev)[None, :] - 1

    n = nseq.long().clamp(0, S)
    has = n > 0
    last = (n - 1).clamp(min=0)[:, None, None].expand(B, STREAMS, 1)
    d0 = d.gather(2, last)[..., 0]
    f0 = f.gather(2, last)[..., 0]
    nb0 = ((d0 + (1 << 15)) & M32) >> 16
    value = _s32((nb0 << 16) - d0)
    idx0 = torch.minimum((value >> nb0) + f0, hi).clamp(min=0)
    state = ns.gather(2, idx0[..., None])[..., 0]               # (B, 3)

    # step k encodes sequence i = n - 2 - k (active while i >= 0)
    K = max(int(n.max()) - 1, 0) if B else 0
    karange = torch.arange(K, device=dev)
    i_k = n[:, None] - 2 - karange[None, :]                     # (B, K)
    active = i_k >= 0
    ik = i_k.clamp(min=0)[:, None, :].expand(B, STREAMS, K)
    dk, fk = d.gather(2, ik), f.gather(2, ik)
    bits = torch.zeros((B, STREAMS, K), dtype=torch.int64, device=dev)
    nbs = torch.zeros((B, STREAMS, K), dtype=torch.int64, device=dev)
    for k in range(K):
        nb = ((state + dk[:, :, k]) & M32) >> 16
        bits[:, :, k] = state & ((1 << nb) - 1)
        nbs[:, :, k] = nb
        j = torch.minimum((state >> nb) + fk[:, :, k], hi).clamp(min=0)
        new = ns.gather(2, j[..., None])[..., 0]
        state = torch.where(active[:, k, None], new, state)

    values = torch.zeros((B, 6 * S + 6), dtype=torch.int64, device=dev)
    nbits = torch.zeros((B, 6 * S + 6), dtype=torch.int64, device=dev)
    lastx = last[:, :, 0:1]
    values[:, 0:3] = xv.gather(2, lastx)[..., 0]
    nbits[:, 0:3] = torch.where(has[:, None], xn.gather(2, lastx)[..., 0], 0)
    if K:
        act = active[:, None, :]
        step_v = torch.cat([bits.flip(1), xv.gather(2, ik)], dim=1)
        step_n = torch.cat([nbs.flip(1), xn.gather(2, ik)], dim=1)
        step_n = torch.where(act, step_n, 0)
        # (B, 6, K) -> columns 3 + 6k + r
        values[:, 3:3 + 6 * K] = step_v.transpose(1, 2).reshape(B, 6 * K)
        nbits[:, 3:3 + 6 * K] = step_n.transpose(1, 2).reshape(B, 6 * K)
    t = 3 + 6 * S
    flush = (1, 2, 0)   # ml, of, ll
    values[:, t:t + 3] = state[:, flush]
    nbits[:, t:t + 3] = torch.where(has[:, None], logs.long()[:, flush], 0)
    return values, nbits.to(torch.int32)


def _check(ll, ml, of, nseq, ns, nbd, fs, logs, dev):
    B, S = ll.shape
    for name, t, nd in (("ll", ll, 2), ("ml", ml, 2), ("of", of, 2),
                        ("nseq", nseq, 1), ("ns", ns, 3), ("nbd", nbd, 3),
                        ("fs", fs, 3), ("logs", logs, 2)):
        _kernels.require(t, name, torch.int32, nd, dev)
        if t.shape[0] != B:
            raise ValueError(f"{name}: {t.shape[0]} lanes, expected {B}")
    for name, t, shape in (("ml", ml, (B, S)), ("of", of, (B, S)),
                           ("ns", ns, (B, STREAMS, NS_WIDTH)),
                           ("nbd", nbd, (B, STREAMS, SYM_WIDTH)),
                           ("fs", fs, (B, STREAMS, SYM_WIDTH)),
                           ("logs", logs, (B, STREAMS))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {shape}")


def encode_sequences_packed(ll, ml, of, nseq, ns, nbd, fs, logs,
                            out_words: int):
    """Encode and pack every lane's sequence bitstream (without its sentinel
    bit). Returns (words (B, out_words) int32 holding uint32 bit patterns,
    total_bits (B,) int32); bits past out_words are dropped."""
    dev = ll.device
    _check(ll, ml, of, nseq, ns, nbd, fs, logs, dev)
    if not _kernels.on_cuda(ll):
        return pack_bits_lanes(
            *encode_sequence_lanes_plain(ll, ml, of, nseq, ns, nbd, fs, logs),
            out_words)
    B, S = ll.shape
    words = torch.zeros((B, out_words), dtype=torch.int32, device=dev)
    total = torch.empty((B,), dtype=torch.int32, device=dev)
    _kernels.launch("fse_encode", ll, ml, of, S, nseq, B, ns, nbd, fs, logs,
                    code_tables(dev), words, out_words, total)
    encode_sequences_packed.launches += 1
    return words, total


encode_sequences_packed.launches = 0


def seq_lane_arrays(lanes, device):
    """Lane arrays (see the module docstring) of encoder sequence lanes:
    objects with `triples` [(ll, ml, of_value)], `tables` (ll, of, ml
    FSEEncodeTable or None for RLE) and `logs` (ll, of, ml). S is the next
    power of two of the longest lane, as in the reference."""
    B = len(lanes)
    S = max(1, 1 << (max(len(l.triples) for l in lanes) - 1).bit_length())
    vals = np.zeros((3, B, S), np.int32)
    nseq = np.zeros(B, np.int32)
    ns = np.zeros((B, STREAMS, NS_WIDTH), np.int32)
    nbd = np.zeros((B, STREAMS, SYM_WIDTH), np.uint32)
    fs = np.zeros((B, STREAMS, SYM_WIDTH), np.int32)
    logs = np.zeros((B, STREAMS), np.int32)
    for i, l in enumerate(lanes):
        n = len(l.triples)
        nseq[i] = n
        if n:
            vals[:, i, :n] = np.asarray(l.triples, np.int64).T
        ll_t, of_t, ml_t = l.tables
        logs[i] = l.logs[0], l.logs[2], l.logs[1]  # store ll, ml, of
        for s, t in enumerate((ll_t, ml_t, of_t)):
            if t is None:
                continue  # RLE: zero-width runs, tables unused
            a, b, c = pack_encode_table(t, STATE_COLS[s])
            ns[i, s, :STATE_COLS[s]] = a
            nbd[i, s], fs[i, s] = b, c
    host = (vals[0], vals[1], vals[2], nseq, ns, nbd.view(np.int32), fs, logs)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in host]
