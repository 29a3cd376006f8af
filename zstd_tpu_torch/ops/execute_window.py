"""Windowed LZ77 execution of chained frames.

A chained frame is a chain of block groups (frame rows) that execute in
order, each group's matches reaching into the bytes of the groups before it
and into a dictionary prefill. `execute_window` runs the CUDA kernel
(csrc/execute_window.cu) for CUDA tensors and `execute_window_plain` for
CPU tensors; both compute, for every chain c with rows plan[c, 0..K)
(padded with a row that holds no records):

  the chain's bytes accumulate in acc[c, base:], and
  acc[c, base - hist0[c]:base] holds its dictionary prefill (the caller
  writes it; hist0[c] <= base). For the chain's group k, with w the bytes
  its groups before k wrote and avail = min(w + hist0[c], cap[c]), the
  group is ok iff every record has ll, ml >= 0 and, where ml > 0,
  0 < offset <= pos_before_match + avail (pos_before_match counted from
  the group's first byte); its total equals out_len[row]; its literals fit
  its row (sum(ll) <= row_lit_len[row]); and its bytes fit the accumulator
  (base + w + total <= acc width). An ok group executes: ll literal bytes
  from lit[row], then ml bytes from `offset` back, a periodic fill when
  offset < ml. The first group that is not ok stops its chain: nothing of
  it or of a later group is written.

  Returns (written (C,) i64: the bytes the chain's ok groups wrote,
  ok (C,) bool: every group of the chain was ok). acc is updated in place.

This is zstd_tpu/ops/pallas_execute.py::execute_window_pallas (one block
group of each chain per call, with a copied window prefix and a separately
gathered far stream) run over every group of every chain at once: the
whole history stays in the accumulator, so a near chain and a far chain
differ only in their cap (the pow2 window W, or the real window). The
kernel is byte-parallel: it validates every group, seeds a source pointer
for every output byte and follows the pointers by doubling, at most
bit_length(width) rounds, then gathers (csrc/execute_window.cu says why).
Its scratch comes from here: the pointers (4 bytes per accumulator column
past `base` per chain, 8 at a width of 2^31 or more) and 16 bytes per
record slot of the plan.

The plain version is zstd_tpu/ops/execute.py::execute_window_xla's trick:
per group, the accumulator bytes the group may reach (the `avail` bytes
before its start) ride as one synthetic leading literal run through the
pointer-doubling executor (ops/execute.py::execute_lanes_plain), so
matches that reach across the group boundary need no special case.
"""

import torch

from zstd_tpu_torch.ops import _kernels
from zstd_tpu_torch.ops.execute import execute_lanes_plain


def _execute_groups(ll, ml, off, lits, acc, chains, start, total, H: int):
    """Execute one ok group per row into acc[chains[i], start[i]:]: the H
    accumulator bytes before `start` (zeros before the row's start) ride
    as the synthetic leading literal run. ll, ml, off (n, S) i64; lits
    (n, Lw) u8; start, total (n,) i64; offsets reach at most H back."""
    n = ll.shape[0]
    dev = acc.device
    width = H + int(total.max())
    cols = start[:, None] - H + torch.arange(H, device=dev)[None, :]
    hist = acc[chains].gather(1, cols.clamp(min=0))
    lit2 = torch.zeros((n, width + lits.shape[1]), dtype=torch.uint8,
                       device=dev)
    lit2[:, :H] = torch.where(cols >= 0, hist, 0)
    lit2[:, H:H + lits.shape[1]] = lits
    zero = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    out, _ = execute_lanes_plain(
        torch.cat([torch.full_like(zero, H), ll], dim=1),
        torch.cat([zero, ml], dim=1), torch.cat([zero, off], dim=1), lit2,
        H + total, torch.arange(n, device=dev), width)
    j = torch.arange(width - H, device=dev)[None, :]
    keep = j < total[:, None]
    flat = chains[:, None] * acc.shape[1] + start[:, None] + j
    acc.view(-1)[flat[keep]] = out[:, H:][keep]


def execute_window_plain(ll, ml, offset, lit, out_len, row_lit_len, plan,
                         acc, base: int, hist0, cap):
    """Plain torch version of the kernel (same arguments, same result)."""
    dev = acc.device
    C, K = plan.shape
    width = acc.shape[1]
    written = torch.zeros(C, dtype=torch.int64, device=dev)
    ok = torch.ones(C, dtype=torch.bool, device=dev)
    hist0 = hist0.long().clamp(0, base)
    cap = cap.long()
    for k in range(K):
        live = torch.nonzero(ok)[:, 0]
        if live.numel() == 0:
            break
        rows = plan[live, k].long()
        l, m, o = ll[rows].long(), ml[rows].long(), offset[rows].long()
        w = written[live]
        avail = torch.minimum(w + hist0[live], cap[live])
        endpos = torch.cumsum(l + m, dim=1)
        reach = endpos - m + avail[:, None]
        rec_ok = (l >= 0) & (m >= 0) & ((m == 0) | ((o > 0) & (o <= reach)))
        total = endpos[:, -1]
        good = (rec_ok.all(dim=1) & (total == out_len[rows].long())
                & (l.sum(dim=1) <= row_lit_len[rows].long())
                & (base + w + total <= width))
        run = good & (total > 0)
        if bool(run.any()):
            # the history the groups' matches reach before their start
            # (at most avail, by rec_ok): only those bytes ride along
            before = torch.where(m > 0, o - (endpos - m), 0)
            _execute_groups(l[run], m[run], o[run], lit[rows[run]], acc,
                            live[run], base + w[run], total[run],
                            int(before[run].max().clamp(min=0)))
        written[live] = w + torch.where(good, total, 0)
        ok[live] = good
    return written, ok


def execute_window(ll, ml, offset, lit, out_len, row_lit_len, plan, acc,
                   base: int, hist0, cap, *, wide: bool | None = None):
    """Execute every block group of every chain into `acc`, in place.

    ll, ml, offset (Bf, S) i32 (resolved offsets); lit (Bf, Lw) u8;
    out_len, row_lit_len (Bf,) i32; plan (C, K) i32 frame rows; acc (C, A)
    u8; base an int; hist0 (C,) i32; cap (C,) i64. `wide` picks the
    kernel's 64-bit pointers (None: when A >= 2**31, as it must).
    Returns (written (C,) i64, ok (C,) bool).

    One call queues the kernel's phases without waiting for the device;
    execute_window.launches counts calls, and after each CUDA call
    last_cuda_launches holds its kernel launches, last_scratch_bytes its
    scratch and last_flags the jump rounds' flags (rounds_used())."""
    if not _kernels.on_cuda(acc):
        return execute_window_plain(ll, ml, offset, lit, out_len,
                                    row_lit_len, plan, acc, base, hist0, cap)
    dev = acc.device
    for name, t in (("ll", ll), ("ml", ml), ("offset", offset)):
        _kernels.require(t, name, torch.int32, 2, dev)
        if t.shape != ll.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} differs")
    _kernels.require(lit, "lit", torch.uint8, 2, dev)
    for name, t in (("out_len", out_len), ("row_lit_len", row_lit_len)):
        _kernels.require(t, name, torch.int32, 1, dev)
    if (lit.shape[0] != ll.shape[0] or out_len.shape[0] != ll.shape[0]
            or row_lit_len.shape[0] != ll.shape[0]):
        raise ValueError("lit, out_len, row_lit_len: one row per record row "
                         "expected")
    _kernels.require(plan, "plan", torch.int32, 2, dev)
    _kernels.require(acc, "acc", torch.uint8, 2, dev)
    _kernels.require(hist0, "hist0", torch.int32, 1, dev)
    _kernels.require(cap, "cap", torch.int64, 1, dev)
    C, K = plan.shape
    if acc.shape[0] != C or hist0.shape[0] != C or cap.shape[0] != C:
        raise ValueError("acc, hist0, cap: one entry per chain expected")
    if not 0 <= base <= acc.shape[1]:
        raise ValueError(f"base {base} outside the accumulator")
    written = torch.zeros(C, dtype=torch.int64, device=dev)
    ok = torch.ones(C, dtype=torch.bool, device=dev)
    if C == 0 or K == 0:
        return written, ok
    S, A = ll.shape[1], acc.shape[1]
    if wide is None:
        wide = A >= 1 << 31
    elif not wide and A >= 1 << 31:
        raise ValueError(f"width {A}: 32-bit pointers cannot address it")
    stride = -(-(A - base) // 4) * 4
    rounds = A.bit_length()  # the pointer depth is below the width
    ptr = torch.empty(C * stride, device=dev,
                      dtype=torch.int64 if wide else torch.int32)
    rec = torch.empty((2, C * K, S), dtype=torch.int64, device=dev)
    group_ok = torch.empty(C * K, dtype=torch.uint8, device=dev)
    n_live = torch.empty(C, dtype=torch.int32, device=dev)
    flags = torch.empty(rounds + 1, dtype=torch.int32, device=dev)
    _kernels.launch("execute_window", ll, ml, offset, S, lit, lit.shape[1],
                    out_len, row_lit_len, ll.shape[0], plan, K, C, acc, A,
                    base, hist0, cap, written, ok, rec[0], rec[1], group_ok,
                    n_live, ptr, stride, int(wide), flags, rounds)
    execute_window.launches += 1
    # validate, chains, seed, the jump rounds, gather
    execute_window.last_cuda_launches = rounds + 4
    execute_window.last_scratch_bytes = sum(
        t.numel() * t.element_size()
        for t in (ptr, rec, group_ok, n_live, flags))
    execute_window.last_flags = flags
    return written, ok


execute_window.launches = 0
execute_window.last_cuda_launches = 0
execute_window.last_scratch_bytes = 0
execute_window.last_flags = None


def rounds_used() -> int:
    """The jump rounds that had pointers to follow in the last CUDA call
    (waits for the device: for measurements and tests). Raises if the last
    round left a pointer open, which the depth bound rules out."""
    flags = execute_window.last_flags.tolist()
    if flags[-1]:
        raise _kernels.KernelError("execute_window: pointers left open "
                                   f"after {len(flags) - 1} rounds")
    return sum(flags[:-1])
