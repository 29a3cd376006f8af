"""Huffman literal lanes: decode every lane and scatter its bytes in place.

One lane per (block, stream): the format's 4 independent literal streams per
block × many blocks per batch (parity with the per-stream loop of
literals_section_decoder.rs:88-147). `huffman_lanes` runs the CUDA kernel
(csrc/huffman.cu) for CUDA tensors and `huffman_lanes_plain` for CPU
tensors; both compute the same function, fused with the stage's scatter
(zstd_tpu/models/batch_decoder.py::_huff_bucket):

  for each lane b with nsym[b] > 0:
    decode nsym[b] symbols from streams[b] (initial state: the top max_bits
    bits below init_pos[b]; each step emits LUT[state] & 0xFF and shifts in
    LUT[state] >> 8 bits, zeros below bit 0);
    lit[dst_frame[b], dst_off[b] + j] = symbol j (dropped past the row);
    frame_ok[dst_frame[b]] = False unless the lane is ok: init_pos >= 0,
    every symbol starts above -max_bits, and the position ends at exactly
    -max_bits.

Tables are the framer's dense LUTs, `huff_tables` (T, 2048) as int32
(sym | nb << 8), selected per lane by `tid`.

The kernel decodes a lane with a warp over self-synchronising segments and
walks a lane serially only when it is malformed or its table breaks
1 <= nb <= max_bits; `lane_stats()` reads its counters of the last call.
"""

import torch

from zstd_tpu_torch.ops import _kernels
from zstd_tpu_torch.ops.bitstream import (lane_windows, length_groups,
                                          read_bits)

# The kernel stages a lane's stream in shared memory up to STAGE_BYTES (a
# longer one reads global memory); with its 4 KiB table, 17 blocks fit an SM
# (scripts/huffman_profile.py times other sizes).
STAGE_BYTES = 8192


def huffman_lanes_plain(streams, init_pos, tid, nsym, dst_frame, dst_off,
                        tables, maxbits, lit, frame_ok) -> None:
    """Plain torch version of the kernel (same arguments, same result).
    Lanes are independent: each group of similar length (length_groups)
    steps on its own."""
    for live in length_groups(nsym):
        _huffman_group(live, streams, init_pos, tid, nsym, dst_frame,
                       dst_off, tables, maxbits, lit, frame_ok)


def _huffman_group(live, streams, init_pos, tid, nsym, dst_frame, dst_off,
                   tables, maxbits, lit, frame_ok) -> None:
    """huffman_lanes_plain over the lanes `live` (indices, nsym > 0)."""
    n_frames, lit_w = lit.shape
    n = nsym[live].long()
    t = tid[live].long().clamp(0, tables.shape[0] - 1)
    mb = maxbits[t].long().clamp(0, 11)
    mask = (torch.ones_like(mb) << mb) - 1
    win = lane_windows(streams, live, init_pos)
    pos0 = init_pos[live].long()
    ok = pos0 >= 0
    state, pos = read_bits(win, pos0, mb)
    lut = tables.long()
    steps = int(n.max())
    syms = torch.zeros((live.numel(), steps), dtype=torch.uint8,
                       device=lit.device)
    zero = torch.zeros_like(n)
    for j in range(steps):
        act = j < n
        e = lut[t, state & 2047]
        ok = ok & (~act | (pos > -mb))
        nb = torch.where(act, ((e >> 8) & 0xFF).clamp(max=32), zero)
        bits, pos = read_bits(win, pos, nb)
        state = torch.where(act, ((state << nb) & mask) | bits, state)
        syms[:, j] = (e & 0xFF).to(torch.uint8)
    ok = ok & (pos == -mb)

    j = torch.arange(steps, device=lit.device)[None, :]
    dst = dst_off[live].long()[:, None] + j
    keep = (j < n[:, None]) & (dst >= 0) & (dst < lit_w)
    f = dst_frame[live].long().clamp(0, n_frames - 1)
    flat = (f[:, None] * lit_w + dst)[keep]
    lit.view(-1)[flat] = syms[keep]
    frame_ok[f[~ok]] = False


def huffman_lanes(streams, init_pos, tid, nsym, dst_frame, dst_off, tables,
                  maxbits, lit, frame_ok) -> None:
    """Decode all Huffman lanes into `lit` (Bf, W) u8 and clear `frame_ok`
    (Bf,) bool for frames with a bad lane, in place.

    streams (B, L) u8; init_pos, tid, nsym, dst_frame, dst_off (B,) i32;
    tables (T, 2048) i32; maxbits (T,) i32."""
    if not _kernels.on_cuda(streams):
        return huffman_lanes_plain(streams, init_pos, tid, nsym, dst_frame,
                                   dst_off, tables, maxbits, lit, frame_ok)
    dev = streams.device
    B = streams.shape[0]
    _kernels.require(streams, "streams", torch.uint8, 2, dev)
    for name, t in (("init_pos", init_pos), ("tid", tid), ("nsym", nsym),
                    ("dst_frame", dst_frame), ("dst_off", dst_off)):
        _kernels.require(t, name, torch.int32, 1, dev)
        if t.shape[0] != B:
            raise ValueError(f"{name}: {t.shape[0]} lanes, expected {B}")
    _kernels.require(tables, "tables", torch.int32, 2, dev)
    if tables.shape[1] != 2048:
        raise ValueError(f"tables: width {tables.shape[1]}, expected 2048")
    _kernels.require(maxbits, "maxbits", torch.int32, 1, dev)
    if maxbits.shape[0] != tables.shape[0]:
        raise ValueError("maxbits: one entry per table expected")
    _kernels.require(lit, "lit", torch.uint8, 2, dev)
    _kernels.require(frame_ok, "frame_ok", torch.bool, 1, dev)
    if frame_ok.shape[0] != lit.shape[0]:
        raise ValueError("frame_ok: one entry per literal row expected")
    stats = torch.empty((4,), dtype=torch.int64, device=dev)
    _kernels.launch("huffman", streams, streams.shape[1], B, init_pos,
                    tid, nsym, dst_frame, dst_off, tables,
                    tables.shape[0], maxbits, lit, lit.shape[1],
                    lit.shape[0], frame_ok, min(streams.shape[1], STAGE_BYTES),
                    stats)
    huffman_lanes.launches += 1
    huffman_lanes.last_stats = stats


huffman_lanes.launches = 0
huffman_lanes.last_stats = None


def lane_stats() -> dict:
    """The kernel's counters of the last CUDA call (waits for the device):
    lanes decoded by the warp walk, lanes walked serially, and the re-walk
    rounds of the warp lanes (sum and max)."""
    s = huffman_lanes.last_stats
    if s is None:
        return {}
    warp, serial, rounds, most = s.tolist()
    return {"warp_lanes": warp, "serial_lanes": serial,
            "rounds_sum": rounds, "rounds_max": most}
