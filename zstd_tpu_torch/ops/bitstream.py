"""Batched reverse-bitstream reads in plain torch (the kernels' CPU path).

The reverse bitstream convention (see zstd_tpu_torch/utils/bitio.py): bit i
of a stream is (data[i//8] >> (i%8)) & 1; a read of n bits consumes
[pos-n, pos) and returns them LSB-at-(pos-n). A read is one gather of a
40-bit little-endian window at byte (pos-n)>>3 plus shift/mask. Bits below
bit 0 and bytes past the row read as zeros — the same function as the CUDA
kernels' reader (csrc/bitreader.cuh). Values ride in int64: torch on the CPU
has no shifts for unsigned 32-bit tensors.
"""

import torch
import torch.nn.functional as F

_PAD = 5  # zero bytes past the row: reads there see zeros, as in the kernels


def build_windows(streams_u8: torch.Tensor) -> torch.Tensor:
    """(B, L) u8 -> (B, L + 5) int64, w[k] = LE 40-bit load at byte k."""
    L = streams_u8.shape[1]
    b = F.pad(streams_u8.long(), (0, _PAD + 4))
    w = b[:, 0:L + _PAD]
    for k in range(1, 5):
        w = w | (b[:, k:k + L + _PAD] << (8 * k))
    return w


def read_bits(windows: torch.Tensor, pos: torch.Tensor, n: torch.Tensor):
    """Read n (0..32) bits ending at bit `pos` per lane (all int64, (B,)).

    Returns (values, new_pos); bits below bit 0 are phantom zeros."""
    new_pos = pos - n
    start = new_pos.clamp(min=0)
    byte = (start >> 3).clamp(0, windows.shape[1] - 1)
    w = windows.gather(1, byte[:, None])[:, 0]
    mask = (torch.ones_like(n) << n) - 1
    val = (w >> (start & 7)) & mask
    phantom = (start - new_pos).clamp(max=40)
    val = (val << phantom) & mask
    return val, new_pos


def length_groups(n: torch.Tensor) -> list:
    """The lanes with n > 0, as index tensors of lanes whose lengths lie in
    one power-of-4 range ([1, 4), [4, 16), ...). A step loop over a group
    runs to its own longest lane, so a batch of many short lanes and a few
    long ones costs the long ones' steps over few lanes, not over all."""
    live = torch.nonzero(n > 0)[:, 0]
    if live.numel() == 0:
        return []
    # floor(log4(n)) from the bit length of n
    key = (torch.frexp(n[live].double())[1] - 1) // 2
    return [live[key == k] for k in torch.unique(key).tolist()]


def lane_windows(streams_u8: torch.Tensor, live: torch.Tensor,
                 init_pos: torch.Tensor) -> torch.Tensor:
    """build_windows of the rows `live`, cut past the byte of their highest
    initial position: a reverse read never rises above its start, so the
    bytes past it are never read and a group of short streams does not pay
    for the batch's widest."""
    top = int(init_pos[live].max().clamp(min=0)) // 8 + 1
    return build_windows(streams_u8[live][:, :min(top, streams_u8.shape[1])])
