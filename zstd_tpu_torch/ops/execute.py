"""LZ77 sequence execution per frame lane.

`execute_lanes` runs the CUDA kernel (csrc/execute.cu: one warp per frame
row, its recent output in a shared-memory ring, 32 records at a time with
their matches in rounds) for CUDA tensors and `execute_lanes_plain` for CPU
tensors; both compute, for each selected frame row r = rows[i]:

  walk records (ll, ml, offset)[r, :] in slot order: copy ll literal bytes
  from lit[r], then ml bytes from `offset` back (a periodic fill when
  offset < ml); out[i, :out_len[r]] is the result, zero past it.
  ok[i] iff no record has a negative length, every record with ml > 0 has
  0 < offset <= the bytes written before its match, the total equals
  out_len[r], out_len[r] <= out_width, and the literals consumed fit the
  literal row (the lane checks of zstd_tpu/ops/pallas_execute.py:798-814).
  A row that is not ok comes back all zero.

The plain version is the pointer-doubling formulation of
zstd_tpu/ops/execute.py::execute_sequences_lanes: per-position source map,
closed-form periodic fills, then src = src[src] until a fixpoint — every
output byte's origin is a literal position.
"""

import ctypes

import torch

from zstd_tpu_torch.ops import _kernels


def _lane_ok(ll, ml, off, out_len, out_width: int, lit_width: int):
    run = ll + ml
    endpos = torch.cumsum(run, dim=1)
    before_match = endpos - ml
    rec_ok = ((ll >= 0) & (ml >= 0)
              & ((ml == 0) | ((off > 0) & (off <= before_match))))
    return (rec_ok.all(dim=1) & (endpos[:, -1] == out_len)
            & (out_len <= out_width)
            & (torch.cumsum(ll, dim=1)[:, -1] <= lit_width))


def execute_lanes_plain(ll, ml, offset, lit, out_len, rows, out_width: int):
    """Plain torch version of the kernel (same arguments, same result)."""
    dev = ll.device
    rows = rows.long()
    ll = ll[rows].long()
    ml = ml[rows].long()
    off = offset[rows].long()
    lits = lit[rows]
    olen = out_len[rows].long()
    N, S = ll.shape
    L = out_width
    ok = _lane_ok(ll, ml, off, olen, L, lit.shape[1])
    if N == 0:
        return torch.zeros((0, L), dtype=torch.uint8, device=dev), ok
    # bad lanes execute nothing: zero their records so the maps stay sane
    ll = torch.where(ok[:, None], ll, 0)
    ml = torch.where(ok[:, None], ml, 0)
    off = torch.where(ok[:, None], off, 0)

    run = ll + ml
    lit_start = torch.cumsum(run, dim=1) - run
    match_start = lit_start + ll
    has_match = ml > 0

    # literal mask: +1 at each literal run start, -1 at its end, then scan
    delta = torch.zeros((N, L + 1), dtype=torch.int64, device=dev)
    delta.scatter_add_(1, lit_start.clamp(max=L), torch.ones_like(ll))
    delta.scatter_add_(1, match_start.clamp(max=L), -torch.ones_like(ll))
    is_lit = torch.cumsum(delta[:, :L], dim=1) > 0

    # governing match start and its offset at every position
    at = torch.where(has_match, match_start, L).clamp(max=L - 1)
    starts = torch.full((N, L), -1, dtype=torch.int64, device=dev)
    starts.scatter_reduce_(1, at, torch.where(has_match, match_start, -1),
                           reduce="amax")
    governing = torch.cummax(starts, dim=1).values
    offs = torch.zeros((N, L), dtype=torch.int64, device=dev)
    offs.scatter_reduce_(1, at, torch.where(has_match, off, 0),
                         reduce="amax")
    start_at = governing.clamp(min=0)
    off_at = offs.gather(1, start_at)

    pos = torch.arange(L, device=dev)[None, :]
    in_range = pos < olen[:, None]
    naive = pos - off_at
    periodic = start_at - off_at + (pos - start_at) % off_at.clamp(min=1)
    src = torch.where(naive >= start_at, periodic, naive)
    src = torch.where(is_lit | ~in_range, pos, src).clamp(min=0)
    for _ in range(max(1, (L - 1).bit_length())):
        nxt = src.gather(1, src)
        if torch.equal(nxt, src):
            break
        src = nxt

    lit_idx = torch.cumsum(is_lit.long(), dim=1) - 1
    final = lit_idx.gather(1, src).clamp(0, lits.shape[1] - 1)
    out = lits.gather(1, final)
    out = torch.where(in_range & ok[:, None], out, 0).to(torch.uint8)
    return out, ok


def execute_lanes(ll, ml, offset, lit, out_len, rows, out_width: int):
    """Execute the frame rows `rows` (N,) i32.

    ll, ml, offset (Bf, S) i32; lit (Bf, W) u8; out_len (Bf,) i32.
    Returns (out (N, out_width) u8, ok (N,) bool)."""
    if not _kernels.on_cuda(ll):
        return execute_lanes_plain(ll, ml, offset, lit, out_len, rows,
                                   out_width)
    dev = ll.device
    for name, t in (("ll", ll), ("ml", ml), ("offset", offset)):
        _kernels.require(t, name, torch.int32, 2, dev)
        if t.shape != ll.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} differs")
    _kernels.require(lit, "lit", torch.uint8, 2, dev)
    _kernels.require(out_len, "out_len", torch.int32, 1, dev)
    _kernels.require(rows, "rows", torch.int32, 1, dev)
    if lit.shape[0] != ll.shape[0] or out_len.shape[0] != ll.shape[0]:
        raise ValueError("lit, out_len: one row per record row expected")
    n = rows.shape[0]
    out = torch.zeros((n, out_width), dtype=torch.uint8, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    _kernels.launch("execute", ll, ml, offset, ll.shape[1], lit,
                    lit.shape[1], out_len, rows, n, ll.shape[0],
                    out, out_width, ok)
    execute_lanes.launches += 1
    return out, ok


execute_lanes.launches = 0


def rounds_stats() -> dict:
    """The match rounds of the last CUDA call, over its chunks of 32 records
    (of ok rows, chunks that hold a record): mean and max rounds per chunk
    and the chunks (waits for the device: for measurements and tests)."""
    buf = (ctypes.c_ulonglong * 3)()
    err = _kernels.symbol("execute", "zt_execute_stats",
                          [ctypes.c_void_p])(ctypes.addressof(buf))
    if err != 0:
        raise _kernels.KernelError(f"execute stats: CUDA error {err}")
    total, chunks, most = buf
    return {"mean": total / chunks if chunks else 0.0, "max": int(most),
            "chunks": int(chunks)}
