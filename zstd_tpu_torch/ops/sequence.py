"""tANS sequence lanes and repeat-offset resolution.

`sequence_lanes` decodes every compressed block's interleaved 3-state tANS
bitstream (parity with sequence_section_decoder.rs:154-221) and scatters the
(ll, ml, of_value) records into the frames' slot arrays, fused with the
trailing-literal fill (zstd_tpu/models/batch_decoder.py::_seq_bucket). It
runs the CUDA kernel (csrc/sequence.cu) for CUDA tensors and
`sequence_lanes_plain` for CPU tensors; both compute:

  for each lane b with nseq[b] > 0:
    initial states LL, OF, ML from the top of the stream; per sequence the
    extra bits OF (of_value = (1 << code) + extra, int32-wrapped), ML, LL;
    state updates LL -> ML -> OF, skipped on the last sequence;
    record k -> slot (dst_frame[b], dst_off[b] + k) (dropped past the row);
    ll[dst_frame[b], trail_slot[b]] = max(lit_total[b] - sum(ll), 0);
    frame_ok[dst_frame[b]] = False unless the lane is ok: init_pos >= 0,
    the position stays >= 0 with valid codes (of <= 31, ml <= 52,
    ll <= 35), ends at exactly 0, and the trailing run is >= 0.

`resolve_frames` is stage 2, the repeat-offset resolution
(sequence_execution.rs:59-115) of every frame row with its exact output
length and ok flag. It runs the CUDA kernel (csrc/resolve.cu) for CUDA
tensors and `resolve_frames_plain` for CPU tensors. The plain version is
`resolve_offsets` (symbolic resolution, `resolve_offsets_symbolic`,
followed by `apply_hist`); with chained block groups each group's incoming
history is composed along its chain in between (`compose_hist`).
"""

import numpy as np
import torch

from zstd_tpu_torch.common import constants as C
from zstd_tpu_torch.ops import _kernels
from zstd_tpu_torch.ops.bitstream import (lane_windows, length_groups,
                                          read_bits)

LL_BASE = np.array(C.LL_CODE_BASELINE, dtype=np.int64)
LL_XTRA = np.array(C.LL_CODE_EXTRA_BITS, dtype=np.int64)
ML_BASE = np.array(C.ML_CODE_BASELINE, dtype=np.int64)
ML_XTRA = np.array(C.ML_CODE_EXTRA_BITS, dtype=np.int64)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 with the same low 32 bits (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def sequence_lanes_plain(streams, init_pos, nseq, ll_tid, of_tid, ml_tid,
                         ll_tables, of_tables, ml_tables, ll_logs, of_logs,
                         ml_logs, dst_frame, dst_off, lit_total, trail_slot,
                         ll_out, ml_out, of_out, frame_ok) -> None:
    """Plain torch version of the kernel (same arguments, same result).
    Lanes are independent: each group of similar length (length_groups)
    steps on its own."""
    for live in length_groups(nseq):
        _sequence_group(live, streams, init_pos, nseq, ll_tid, of_tid,
                        ml_tid, ll_tables, of_tables, ml_tables, ll_logs,
                        of_logs, ml_logs, dst_frame, dst_off, lit_total,
                        trail_slot, ll_out, ml_out, of_out, frame_ok)


def _sequence_group(live, streams, init_pos, nseq, ll_tid, of_tid, ml_tid,
                    ll_tables, of_tables, ml_tables, ll_logs, of_logs,
                    ml_logs, dst_frame, dst_off, lit_total, trail_slot,
                    ll_out, ml_out, of_out, frame_ok) -> None:
    """sequence_lanes_plain over the lanes `live` (indices, nseq > 0)."""
    dev = streams.device
    n_frames, seq_w = ll_out.shape
    n = nseq[live].long()

    def table(tabs, logs, tid):
        t = tid[live].long().clamp(0, tabs.shape[0] - 1)
        return tabs.long(), t, logs[t].long().clamp(0, 32)

    ll_t, llt, ll_log = table(ll_tables, ll_logs, ll_tid)
    of_t, oft, of_log = table(of_tables, of_logs, of_tid)
    ml_t, mlt, ml_log = table(ml_tables, ml_logs, ml_tid)

    def entry(tabs, t, state):
        return tabs[t, state.clamp(0, tabs.shape[1] - 1)]

    win = lane_windows(streams, live, init_pos)
    pos0 = init_pos[live].long()
    s_ll, pos = read_bits(win, pos0, ll_log)
    s_of, pos = read_bits(win, pos, of_log)
    s_ml, pos = read_bits(win, pos, ml_log)
    ok = (pos0 >= 0) & (pos >= 0)

    ll_base = torch.as_tensor(LL_BASE, device=dev)
    ll_xtra = torch.as_tensor(LL_XTRA, device=dev)
    ml_base = torch.as_tensor(ML_BASE, device=dev)
    ml_xtra = torch.as_tensor(ML_XTRA, device=dev)
    steps = int(n.max())
    B = live.numel()
    out_ll = torch.zeros((B, steps), dtype=torch.int64, device=dev)
    out_ml = torch.zeros_like(out_ll)
    out_of = torch.zeros((B, steps), dtype=torch.int32, device=dev)
    zero = torch.zeros_like(n)
    for k in range(steps):
        act = k < n
        upd = act & (k < n - 1)
        e_of = entry(of_t, oft, s_of)
        e_ml = entry(ml_t, mlt, s_ml)
        e_ll = entry(ll_t, llt, s_ll)
        ofc, mlc, llc = e_of & 0xFF, e_ml & 0xFF, e_ll & 0xFF
        code_ok = (ofc <= 31) & (mlc <= 52) & (llc <= 35)
        ofc, mlc, llc = ofc.clamp(max=31), mlc.clamp(max=52), llc.clamp(max=35)

        ofx, pos1 = read_bits(win, pos, torch.where(act, ofc, zero))
        ofv = (torch.ones_like(ofc) << ofc) + ofx
        r_ml, pos2 = read_bits(win, pos1, torch.where(act, ml_xtra[mlc], zero))
        r_ll, pos3 = read_bits(win, pos2, torch.where(act, ll_xtra[llc], zero))

        new = []
        p = pos3
        for e in (e_ll, e_ml, e_of):
            nb = torch.where(upd, ((e >> 8) & 0xFF).clamp(max=32), zero)
            bits, p = read_bits(win, p, nb)
            new.append((e >> 16) + bits)
        s_ll = torch.where(upd, new[0], s_ll)
        s_ml = torch.where(upd, new[1], s_ml)
        s_of = torch.where(upd, new[2], s_of)
        ok = torch.where(act, ok & (p >= 0) & code_ok, ok)
        pos = torch.where(act, p, pos)
        out_ll[:, k] = ll_base[llc] + r_ll
        out_ml[:, k] = ml_base[mlc] + r_ml
        out_of[:, k] = _wrap_i32(ofv)
    ok = ok & (pos == 0)

    kk = torch.arange(steps, device=dev)[None, :]
    act = kk < n[:, None]
    used = torch.where(act, out_ll, 0).sum(1)
    trailing = lit_total[live].long() - used
    ok = ok & (trailing >= 0)

    f = dst_frame[live].long().clamp(0, n_frames - 1)
    slot = dst_off[live].long()[:, None] + kk
    keep = act & (slot >= 0) & (slot < seq_w)
    flat = (f[:, None] * seq_w + slot)[keep]
    ll_out.view(-1)[flat] = out_ll[keep].to(torch.int32)
    ml_out.view(-1)[flat] = out_ml[keep].to(torch.int32)
    of_out.view(-1)[flat] = out_of[keep]
    ts = trail_slot[live].long()
    tkeep = (ts >= 0) & (ts < seq_w)
    ll_out.view(-1)[(f * seq_w + ts)[tkeep]] = (
        trailing.clamp(min=0)[tkeep].to(torch.int32))
    frame_ok[f[~ok]] = False


def sequence_lanes(streams, init_pos, nseq, ll_tid, of_tid, ml_tid,
                   ll_tables, of_tables, ml_tables, ll_logs, of_logs,
                   ml_logs, dst_frame, dst_off, lit_total, trail_slot,
                   ll_out, ml_out, of_out, frame_ok) -> None:
    """Decode all sequence lanes into the frame slot arrays ll_out, ml_out,
    of_out (Bf, S) i32 and clear `frame_ok` (Bf,) bool for frames with a
    bad lane, in place.

    streams (B, L) u8; init_pos, nseq, *_tid, dst_frame, dst_off,
    lit_total, trail_slot (B,) i32; *_tables (T, 512/256/512) i32 packed
    sym | nb << 8 | baseline << 16; *_logs (T,) i32."""
    if not _kernels.on_cuda(streams):
        return sequence_lanes_plain(
            streams, init_pos, nseq, ll_tid, of_tid, ml_tid, ll_tables,
            of_tables, ml_tables, ll_logs, of_logs, ml_logs, dst_frame,
            dst_off, lit_total, trail_slot, ll_out, ml_out, of_out, frame_ok)
    dev = streams.device
    B = streams.shape[0]
    _kernels.require(streams, "streams", torch.uint8, 2, dev)
    for name, t in (("init_pos", init_pos), ("nseq", nseq),
                    ("ll_tid", ll_tid), ("of_tid", of_tid),
                    ("ml_tid", ml_tid), ("dst_frame", dst_frame),
                    ("dst_off", dst_off), ("lit_total", lit_total),
                    ("trail_slot", trail_slot)):
        _kernels.require(t, name, torch.int32, 1, dev)
        if t.shape[0] != B:
            raise ValueError(f"{name}: {t.shape[0]} lanes, expected {B}")
    for name, tabs, logs in (("ll", ll_tables, ll_logs),
                             ("of", of_tables, of_logs),
                             ("ml", ml_tables, ml_logs)):
        _kernels.require(tabs, f"{name}_tables", torch.int32, 2, dev)
        _kernels.require(logs, f"{name}_logs", torch.int32, 1, dev)
        if logs.shape[0] != tabs.shape[0]:
            raise ValueError(f"{name}_logs: one entry per table expected")
        if not 0 < tabs.shape[1] <= 1 << 16:
            raise ValueError(f"{name}_tables: {tabs.shape[1]} states a "
                             f"table, the kernel takes 1 to 65536")
    for name, t in (("ll_out", ll_out), ("ml_out", ml_out),
                    ("of_out", of_out)):
        _kernels.require(t, name, torch.int32, 2, dev)
        if t.shape != ll_out.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} differs")
    _kernels.require(frame_ok, "frame_ok", torch.bool, 1, dev)
    if frame_ok.shape[0] != ll_out.shape[0]:
        raise ValueError("frame_ok: one entry per slot row expected")
    _kernels.launch(
        "sequence", streams, streams.shape[1], B, init_pos, nseq,
        ll_tid, of_tid, ml_tid,
        ll_tables, ll_tables.shape[1], ll_tables.shape[0],
        of_tables, of_tables.shape[1], of_tables.shape[0],
        ml_tables, ml_tables.shape[1], ml_tables.shape[0],
        ll_logs, of_logs, ml_logs, dst_frame, dst_off,
        lit_total, trail_slot, ll_out, ml_out, of_out,
        ll_out.shape[1], ll_out.shape[0], frame_ok)
    sequence_lanes.launches += 1


sequence_lanes.launches = 0


# ---- repeat-offset resolution ----------------------------------------------
#
# Every record's effect on the 3-entry history is a transform of the
# incoming history: new slot s = hist[t_s] - v_s (t_s in 0..2) or the
# constant v_s (t_s == 3), and its offset is such a symbol too. Transforms
# compose associatively, so an inclusive prefix scan over the slot axis
# (Hillis-Steele: log2(S) rounds of whole-array ops) gives each record the
# transform of all records before it, exactly. A transform is six (B, S)
# tensors (t0, t1, t2, v0, v1, v2): tags int8, values int32 as in the
# reference, and slot picks are where-selects, so every op is elementwise.

def _sel(tag, x0, x1, x2):
    """Pick among three same-shape tensors by a per-element tag 0..2."""
    return torch.where(tag == 0, x0, torch.where(tag == 1, x1, x2))


def _apply(tags, vals, bt, bv):
    """Symbol (bt, bv) evaluated against transform (tags, vals)."""
    ts = _sel(bt, *tags)
    vs = _sel(bt, *vals)
    const = bt == 3
    return (torch.where(const, bt, ts),
            torch.where(const, bv, torch.where(ts == 3, vs - bv, vs + bv)))


def _compose(a, b):
    """Transform a, then transform b."""
    out = [_apply(a[:3], a[3:], bt, bv) for bt, bv in zip(b[:3], b[3:])]
    return tuple(t for t, _ in out) + tuple(v for _, v in out)


def _rec_symbols(ll, ofv, is_real):
    """Per-record output symbol (o_t, o_v) and history transform."""
    idx = torch.where(ll == 0, ofv + 1, ofv)
    is_lit = ofv > 3
    i8 = torch.int8
    o_t = torch.where(~is_real | is_lit, 3,
                      torch.where(idx == 2, 1,
                                  torch.where(idx == 3, 2, 0))).to(i8)
    o_v = torch.where(~is_real, ofv,
                      torch.where(is_lit, ofv - 3,
                                  (idx >= 4).to(ofv.dtype)))
    shift = is_real & (is_lit | (idx >= 2))
    shift2 = is_real & (is_lit | (idx >= 3))
    zero_t = torch.zeros_like(o_t)
    zero_v = torch.zeros_like(o_v)
    trans = (torch.where(shift, o_t, zero_t),
             torch.where(shift, zero_t, zero_t + 1),
             torch.where(shift2, zero_t + 1, zero_t + 2),
             torch.where(shift, o_v, zero_v), zero_v, zero_v)
    return o_t, o_v, trans


def resolve_offsets_symbolic(ll, ofv, is_real):
    """Repeat-offset resolution against a symbolic incoming history.

    ll, ofv (B, S) i32; is_real (B, S) bool. Every resolved offset is a
    constant or `hist[tag] - val` of the row's incoming history, so rows
    resolve independently and a chain of block groups composes their
    histories afterwards (apply_hist, compose_hist).

    Returns (tag (B, S) int8: 0..2 a slot of the incoming history, 3 a
    constant; val (B, S) i32: the delta, or the constant; trans_tag (B, 3)
    int8 and trans_val (B, 3) i32: the row's outgoing history as a
    transform of its incoming one). The values equal
    zstd_tpu/ops/sequence.py::resolve_offsets_symbolic's (which keeps its
    tags in int32).
    """
    S = ll.shape[1]
    ll = ll.to(torch.int32)
    ofv = ofv.to(torch.int32)
    o_t, o_v, x = _rec_symbols(ll, ofv, is_real)
    d = 1
    while d < S:
        c = _compose(tuple(a[:, :-d] for a in x), tuple(a[:, d:] for a in x))
        x = tuple(torch.cat([a[:, :d], b], dim=1) for a, b in zip(x, c))
        d *= 2
    # the last inclusive column is the row total
    trans_tag = torch.stack([a[:, -1] for a in x[:3]], dim=1)
    trans_val = torch.stack([a[:, -1] for a in x[3:]], dim=1)
    # exclusive prefix: the transform of all records before each record
    ident = (0, 1, 2, 0, 0, 0)
    x = tuple(torch.cat([torch.full_like(a[:, :1], k), a[:, :-1]], dim=1)
              for a, k in zip(x, ident))
    tag, val = _apply(x[:3], x[3:], o_t, o_v)
    return tag, val, trans_tag, trans_val


def apply_hist(tag, val, hist):
    """Concrete values of symbols (tag, val) (..., n) against the incoming
    history `hist` (..., 3): hist[tag] - val, or val where tag == 3."""
    hist = hist.to(torch.int32)
    picked = _sel(tag, hist[..., 0:1], hist[..., 1:2], hist[..., 2:3])
    return torch.where(tag == 3, val, picked - val)


def compose_hist(trans_tag, trans_val, hist):
    """The outgoing history of a row given its incoming history."""
    return apply_hist(trans_tag, trans_val, hist)


def resolve_offsets(ll, ofv, is_real, init_hist):
    """Repeat-offset resolution across frame lanes.

    ll, ofv (B, S) i32; is_real (B, S) bool; init_hist (B, 3) i32.
    Synthetic records (is_real False — RLE blocks, raw blocks, trailing
    literal runs) carry their offset in `ofv` and leave the history alone.
    Returns (offsets (B, S) i32, ok (B,) bool): ok is False for a lane with
    a real record that resolves to an offset <= 0, or whose of_value is
    <= 0 (the decoder never emits one: (1 << code) + extra >= 1 unless it
    wrapped at code 31).
    """
    tag, val, _, _ = resolve_offsets_symbolic(ll, ofv, is_real)
    offsets = apply_hist(tag, val, init_hist)
    return offsets, offsets_ok(offsets, ofv, is_real)


def offsets_ok(offsets, ofv, is_real):
    """(B,) bool: no real record resolves to an offset <= 0 or carries an
    of_value <= 0."""
    bad = is_real & ((offsets <= 0) | (ofv <= 0))
    return ~bad.any(dim=1)


def row_lengths(ll, ml):
    """(B,) i32: each row's sum of ll + ml, wrapped to int32."""
    return (ll.long() + ml.long()).sum(dim=1).to(torch.int32)


def resolve_frames_plain(ll, ml, ofv, is_real, init_hist, chain_rows=None,
                         chain_cont=None):
    """Plain torch version of the kernel (same arguments, same result).

    With chains, every row resolves symbolically, then a loop over chain
    position (vectorised over chains) carries each group's outgoing history
    into the next group, and the offsets materialise."""
    if chain_rows is None:
        offsets, ok = resolve_offsets(ll, ofv, is_real, init_hist)
        return offsets, row_lengths(ll, ml), ok
    tag, val, tt, tv = resolve_offsets_symbolic(ll, ofv, is_real)
    hist = init_hist.to(torch.int32).clone()
    h = hist[chain_rows[:, 0].long()]
    for k in range(1, chain_rows.shape[1]):
        prev, cur = chain_rows[:, k - 1].long(), chain_rows[:, k].long()
        h = compose_hist(tt[prev], tv[prev], h)
        # padding entries point at the inert row, which is never a
        # continuation: they write its own history back
        hist[cur] = torch.where(chain_cont[cur][:, None], h, hist[cur])
    offsets = apply_hist(tag, val, hist)
    return (offsets, row_lengths(ll, ml),
            offsets_ok(offsets, ofv, is_real))


RESOLVE_SEGMENT = 1024  # slots per warp of the resolve kernel


def resolve_frames(ll, ml, ofv, is_real, init_hist, chain_rows=None,
                   chain_cont=None):
    """Stage 2: (offsets (B, S) i32, out_len (B,) i32, ok (B,) bool) of
    every frame row.

    ll, ml, ofv (B, S) i32; is_real (B, S) bool; init_hist (B, 3) i32.
    With chained block groups, chain_rows (C, K) i32 lists each chain's
    rows in order (padded with a row that chain_cont never marks) and
    chain_cont (B,) bool marks the rows whose incoming history is the
    previous row's outgoing one rather than their own init_hist."""
    if not _kernels.on_cuda(ll):
        return resolve_frames_plain(ll, ml, ofv, is_real, init_hist,
                                    chain_rows, chain_cont)
    dev = ll.device
    B, S = ll.shape
    for name, t, dtype in (("ll", ll, torch.int32), ("ml", ml, torch.int32),
                           ("ofv", ofv, torch.int32),
                           ("is_real", is_real, torch.bool)):
        _kernels.require(t, name, dtype, 2, dev)
        if t.shape != ll.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} differs")
    _kernels.require(init_hist, "init_hist", torch.int32, 2, dev)
    if tuple(init_hist.shape) != (B, 3):
        raise ValueError(f"init_hist: shape {tuple(init_hist.shape)}, "
                         f"expected {(B, 3)}")
    offsets = torch.empty((B, S), dtype=torch.int32, device=dev)
    out_len = torch.empty(B, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    C = K = 0
    hist = None
    if chain_rows is not None:
        _kernels.require(chain_rows, "chain_rows", torch.int32, 2, dev)
        _kernels.require(chain_cont, "chain_cont", torch.bool, 1, dev)
        if chain_cont.shape[0] != B:
            raise ValueError("chain_cont: one entry per frame row expected")
        C, K = chain_rows.shape
        if C and K:
            hist = init_hist.clone()
        else:
            chain_rows = None
    # one 16-byte transform per warp task of RESOLVE_SEGMENT slots
    segt = torch.empty((B * -(-S // RESOLVE_SEGMENT), 4), dtype=torch.int32,
                       device=dev)
    _kernels.launch("resolve", ll, ml, ofv, is_real, S, B, init_hist,
                    chain_rows, C, K, chain_cont, RESOLVE_SEGMENT, segt, hist,
                    offsets, out_len, ok)
    resolve_frames.launches += 1
    resolve_frames.last_cuda_launches = 3 if hist is not None else 2
    return offsets, out_len, ok


resolve_frames.launches = 0
resolve_frames.last_cuda_launches = 0
