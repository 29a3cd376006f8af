"""zstd_tpu_torch's device stages against zstd_tpu's XLA formulations.

One shared DeviceBatch (the mixed batch of test_torch_framer, a corrupted
frame included) goes through each port module on the CPU — the plain torch
versions the CUDA kernels are held to on the card — and through the
reference's XLA twin at batch size. All comparisons are bit-exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_framer import mixed_frames
from zstd_tpu.models import batch_decoder as ref_bd
from zstd_tpu.ops.execute import execute_sequences_lanes
from zstd_tpu.ops.huffman import decode_huffman_lanes
from zstd_tpu.ops.sequence import decode_sequence_lanes
from zstd_tpu.ops.xxhash64 import xxh64_low32_lanes as ref_xxh64
from zstd_tpu_torch.models import batch_decoder as bd
from zstd_tpu_torch.ops import execute, huffman, sequence, xxhash64
from zstd_tpu_torch.utils.xxhash64 import xxhash64 as host_xxh64


@pytest.fixture(scope="module")
def staged():
    frames, payloads, dict_bytes = mixed_frames()
    dec = bd.BatchDecoder(device="cpu")
    dec.add_dict(dict_bytes)
    batch = dec.prepare(frames)
    return batch, dec.stage(batch)


def _huff(d):
    lit = d["lit_base"].clone()
    ok = torch.ones(lit.shape[0], dtype=torch.bool)
    huffman.huffman_lanes(d["huff_streams"], d["huff_pos"], d["huff_tid"],
                          d["huff_nsym"], d["huff_dst_frame"],
                          d["huff_dst_off"], d["huff_tables"],
                          d["huff_maxbits"], lit, ok)
    return lit, ok


def _seq(d):
    arrs = [d[k].clone() for k in ("ll_base", "ml_base", "of_base")]
    ok = torch.ones(arrs[0].shape[0], dtype=torch.bool)
    sequence.sequence_lanes(*[d[k] for k in (
        "seq_streams", "seq_pos", "seq_n", "ll_tid", "of_tid", "ml_tid",
        "ll_tables", "of_tables", "ml_tables", "ll_logs", "of_logs",
        "ml_logs", "seq_dst_frame", "seq_dst_off", "seq_lit_total",
        "seq_trail_slot")], *arrs, ok)
    return arrs, ok


def _live(n):
    return [i for i in range(len(n) - 1) if n[i] > 0]


def _corrupt(batch, kind: str):
    """A copy of the batch with one kind of bad lane (lanes stay
    byte-disjoint, so the reference's scatter-add still equals a store)."""
    b = dataclasses.replace(batch)
    hl, sl = _live(batch.huff_nsym), _live(batch.seq_n)
    if kind == "huff_no_sentinel":
        b.huff_pos = batch.huff_pos.copy()
        b.huff_pos[hl[0]] = -1
    elif kind == "huff_short":
        b.huff_nsym = batch.huff_nsym.copy()
        b.huff_nsym[hl[1]] -= 1
    elif kind == "huff_wrong_table":
        b.huff_tid = batch.huff_tid.copy()
        b.huff_tid[hl[2]] = (batch.huff_tid[hl[2]] + 1) % len(
            batch.huff_maxbits)
    elif kind == "seq_no_sentinel":
        b.seq_pos = batch.seq_pos.copy()
        b.seq_pos[sl[0]] = -1
    elif kind == "seq_short":
        b.seq_n = batch.seq_n.copy()
        b.seq_n[sl[1]] -= 1
    elif kind == "seq_trailing":
        b.seq_lit_total = batch.seq_lit_total.copy()
        b.seq_lit_total[sl[2]] = 0
    return b


@pytest.mark.parametrize("kind", [None, "huff_no_sentinel", "huff_short",
                                  "huff_wrong_table"])
def test_huffman_stage_matches_huff_bucket(staged, kind):
    batch, d = staged
    if kind is not None:
        batch = _corrupt(batch, kind)
        d = bd.BatchDecoder(device="cpu").stage(batch)
    lit, ok = _huff(d)
    live = _live(batch.huff_nsym)
    idx = np.asarray(live, np.int32)
    ref_lit, ref_ok = ref_bd._huff_bucket(
        jnp.asarray(batch.huff_streams), jnp.asarray(batch.huff_pos),
        jnp.asarray(batch.huff_tid), jnp.asarray(batch.huff_tables),
        jnp.asarray(batch.huff_maxbits), jnp.asarray(batch.huff_bnd),
        jnp.asarray(batch.huff_syms), jnp.asarray(batch.huff_nsym),
        jnp.asarray(batch.huff_dst_frame), jnp.asarray(batch.huff_dst_off),
        jnp.asarray(idx), jnp.asarray(batch.lit_base.view("<i4")),
        jnp.ones(batch.lit_base.shape[0], bool),
        width=batch.huff_streams.shape[1],
        max_symbols=-(-int(batch.huff_nsym.max()) // 4) * 4,
        use_pallas=False)
    # the reference packs 4 literal bytes per i32: compare bytes
    assert np.array_equal(np.asarray(ref_lit).view(np.uint8), lit.numpy())
    assert np.array_equal(np.asarray(ref_ok), ok.numpy())
    assert bool(ok.all()) == (kind is None)


def test_huffman_lanes_match_xla_twin(staged):
    batch, d = staged
    live = _live(batch.huff_nsym)
    nmax = int(batch.huff_nsym.max())
    lits, ok = decode_huffman_lanes(
        jnp.asarray(batch.huff_streams[live]),
        jnp.asarray(batch.huff_pos[live]), jnp.asarray(batch.huff_tid[live]),
        jnp.asarray(batch.huff_tables), jnp.asarray(batch.huff_maxbits),
        jnp.asarray(batch.huff_nsym[live]), nmax)
    lits, ok = np.asarray(lits), np.asarray(ok)
    # the port's lanes land in a zeroed buffer at their destinations
    lit = torch.zeros_like(d["lit_base"])
    fok = torch.ones(lit.shape[0], dtype=torch.bool)
    huffman.huffman_lanes(d["huff_streams"], d["huff_pos"], d["huff_tid"],
                          d["huff_nsym"], d["huff_dst_frame"],
                          d["huff_dst_off"], d["huff_tables"],
                          d["huff_maxbits"], lit, fok)
    lit = lit.numpy()
    for k, lane in enumerate(live):
        n, f, off = (int(batch.huff_nsym[lane]),
                     int(batch.huff_dst_frame[lane]),
                     int(batch.huff_dst_off[lane]))
        assert np.array_equal(lit[f, off:off + n], lits[k, :n]), lane
    for f in range(lit.shape[0]):
        lanes = [k for k, lane in enumerate(live)
                 if batch.huff_dst_frame[lane] == f]
        assert bool(fok[f]) == bool(ok[lanes].all()), f


@pytest.mark.parametrize("kind", [None, "seq_no_sentinel", "seq_short",
                                  "seq_trailing"])
def test_sequence_stage_matches_seq_bucket(staged, kind):
    batch, d = staged
    if kind is not None:
        batch = _corrupt(batch, kind)
        d = bd.BatchDecoder(device="cpu").stage(batch)
    (ll, ml, of), ok = _seq(d)
    live = _live(batch.seq_n)
    ref = ref_bd._seq_bucket(
        *[jnp.asarray(getattr(batch, k)) for k in (
            "seq_streams", "seq_pos", "seq_n", "ll_tid", "of_tid", "ml_tid",
            "ll_tables", "of_tables", "ml_tables", "ll_logs", "of_logs",
            "ml_logs", "seq_dst_frame", "seq_dst_off", "seq_lit_total",
            "seq_trail_slot")],
        jnp.asarray(np.asarray(live, np.int32)),
        jnp.asarray(batch.ll_base), jnp.asarray(batch.ml_base),
        jnp.asarray(batch.of_base), jnp.ones(batch.ll_base.shape[0], bool),
        width=batch.seq_streams.shape[1],
        max_seqs=-(-int(batch.seq_n.max()) // 128) * 128, use_pallas=False)
    for a, b in zip((ll, ml, of, ok), ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the mixed batch's corrupted frame already fails one sequence lane
    assert int((~ok).sum()) == (1 if kind is None else 2)


def test_sequence_lanes_match_xla_twin(staged):
    batch, d = staged
    live = _live(batch.seq_n)
    nmax = int(batch.seq_n.max())
    ll_x, ml_x, of_x, ok_x = (np.asarray(a) for a in decode_sequence_lanes(
        jnp.asarray(batch.seq_streams[live]),
        jnp.asarray(batch.seq_pos[live]), jnp.asarray(batch.seq_n[live]),
        *[jnp.asarray(getattr(batch, k)[live])
          for k in ("ll_tid", "of_tid", "ml_tid")],
        *[jnp.asarray(getattr(batch, k)) for k in (
            "ll_tables", "of_tables", "ml_tables", "ll_logs", "of_logs",
            "ml_logs")], nmax))
    (ll, ml, of), fok = _seq(d)
    for k, lane in enumerate(live):
        n, f, off = (int(batch.seq_n[lane]), int(batch.seq_dst_frame[lane]),
                     int(batch.seq_dst_off[lane]))
        for got, exp in ((ll, ll_x), (ml, ml_x), (of, of_x)):
            assert np.array_equal(got[f, off:off + n].numpy(), exp[k, :n])
    frames_bad = {int(batch.seq_dst_frame[lane])
                  for k, lane in enumerate(live) if not ok_x[k]}
    assert frames_bad <= set(np.flatnonzero(~fok.numpy()).tolist())


def test_resolve_matches_reference(staged):
    batch, d = staged
    (ll, ml, of), _ = _seq(d)
    offsets, out_len, ok = bd._resolve(ll, ml, of, d["is_real"],
                                       d["init_hist"])
    r_off, r_len, r_ok, _ = ref_bd._resolve(
        jnp.asarray(ll.numpy()), jnp.asarray(ml.numpy()),
        jnp.asarray(of.numpy()), jnp.asarray(batch.is_real),
        jnp.asarray(batch.frame_hist))
    assert np.array_equal(offsets.numpy(), np.asarray(r_off))
    assert np.array_equal(out_len.numpy(), np.asarray(r_len))
    assert np.array_equal(ok.numpy(), np.asarray(r_ok))


def test_resolve_frames_matches_reference(staged):
    """The stage-2 wrapper's CPU path (its kernel's plain twin) against
    zstd_tpu's _resolve on the mixed batch, with and without the chain
    arguments of a batch whose chains are single rows."""
    batch, d = staged
    (ll, ml, of), _ = _seq(d)
    r_off, r_len, r_ok, _ = ref_bd._resolve(
        jnp.asarray(ll.numpy()), jnp.asarray(ml.numpy()),
        jnp.asarray(of.numpy()), jnp.asarray(batch.is_real),
        jnp.asarray(batch.frame_hist))
    B = ll.shape[0]
    plans = [(), (torch.arange(B, dtype=torch.int32)[:, None],
                  torch.zeros(B, dtype=torch.bool))]
    for plan in plans:
        offsets, out_len, ok = sequence.resolve_frames(
            ll, ml, of, d["is_real"], d["init_hist"], *plan)
        assert offsets.dtype == torch.int32 and out_len.dtype == torch.int32
        assert np.array_equal(offsets.numpy(), np.asarray(r_off))
        assert np.array_equal(out_len.numpy(), np.asarray(r_len))
        assert np.array_equal(ok.numpy(), np.asarray(r_ok))


def test_resolve_flags_zero_of_value():
    """A real record with of_value 0 is flagged, not resolved as repcode 1."""
    ll = torch.tensor([[3, 2, 1]], dtype=torch.int32)
    ofv = torch.tensor([[7, 1, 0]], dtype=torch.int32)
    is_real = torch.tensor([[True, True, True]])
    hist = torch.tensor([[1, 4, 8]], dtype=torch.int32)
    offsets, ok = sequence.resolve_offsets(ll, ofv, is_real, hist)
    assert offsets[0, :2].tolist() == [4, 4] and not bool(ok[0])
    offsets, ok = sequence.resolve_offsets(ll[:, :2], ofv[:, :2],
                                           is_real[:, :2], hist)
    assert bool(ok[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_random_records_match_sequential(seed):
    """Repeat-offset rules record by record (sequence_execution.rs:59-115)
    on random records, ll == 0 shifts and synthetic records included."""
    rng = np.random.default_rng(seed)
    B, S = 6, 300
    ll = rng.integers(0, 3, (B, S)).astype(np.int32)
    ofv = np.where(rng.random((B, S)) < 0.5, rng.integers(1, 4, (B, S)),
                   rng.integers(4, 500, (B, S))).astype(np.int32)
    is_real = rng.random((B, S)) < 0.9
    hist0 = rng.integers(1, 50, (B, 3)).astype(np.int32)
    exp = np.zeros((B, S), np.int64)
    for b in range(B):
        h = list(hist0[b])
        for s in range(S):
            o = int(ofv[b, s])
            if not is_real[b, s]:
                exp[b, s] = o
                continue
            if o > 3:
                off = o - 3
                h = [off, h[0], h[1]]
            else:
                idx = o + 1 if ll[b, s] == 0 else o
                if idx == 1:
                    off = h[0]
                elif idx == 2:
                    off = h[1]
                    h = [h[1], h[0], h[2]]
                elif idx == 3:
                    off = h[2]
                    h = [h[2], h[0], h[1]]
                else:
                    off = h[0] - 1
                    h = [off, h[0], h[1]]
            exp[b, s] = off
    offsets, ok = sequence.resolve_offsets(
        torch.from_numpy(ll), torch.from_numpy(ofv),
        torch.from_numpy(is_real), torch.from_numpy(hist0))
    assert np.array_equal(offsets.numpy(), exp)
    assert np.array_equal(ok.numpy(), ~(is_real & (exp <= 0)).any(axis=1))


def test_execute_matches_xla_twin(staged):
    batch, d = staged
    lit, _ = _huff(d)
    (ll, ml, of), _ = _seq(d)
    offsets, out_len, ok_r = bd._resolve(ll, ml, of, d["is_real"],
                                         d["init_hist"])
    rows = d["exec_rows"]
    out, ok = execute.execute_lanes(ll, ml, offsets, lit, out_len, rows,
                                    batch.out_width)
    r = rows.long()
    ref_out, ref_ok = execute_sequences_lanes(
        jnp.asarray(ll[r].numpy()), jnp.asarray(ml[r].numpy()),
        jnp.asarray(offsets[r].numpy()), jnp.asarray(lit[r].numpy()),
        jnp.asarray(out_len[r].numpy()), batch.out_width)
    ref_out, ref_ok = np.asarray(ref_out), np.asarray(ref_ok)
    good = ok.numpy() & ok_r[r].numpy()
    assert good.sum() >= len(rows) - 1  # only the corrupted frame may fail
    assert np.array_equal(out.numpy()[good], ref_out[good])
    assert ref_ok[good].all()


def test_xxh64_matches_reference_and_host(staged):
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (24, 1024), dtype=np.uint8)
    length = rng.integers(0, 1024, 24).astype(np.int32)
    length[:4] = [0, 31, 32, 1024]
    got = xxhash64.xxh64_low32_lanes(torch.from_numpy(data),
                                     torch.from_numpy(length))
    ref = np.asarray(ref_xxh64(data, length))
    assert np.array_equal(got.numpy(), ref.astype(np.int64))
    start = rng.integers(0, 64, 24).astype(np.int32)
    length = np.minimum(length, 1024 - start).astype(np.int32)
    got = xxhash64.xxh64_low32_lanes(torch.from_numpy(data),
                                     torch.from_numpy(length),
                                     torch.from_numpy(start))
    exp = [host_xxh64(data[i, start[i]:start[i] + length[i]].tobytes())
           & 0xFFFFFFFF for i in range(24)]
    assert got.tolist() == exp


def _random_records(seed: int, B: int = 8, S: int = 48, lit_w: int = 2048):
    """Records aimed at the copy boundaries: offset == ll + ml, offset ==
    all bytes written, overlapping matches, long literal runs; plus the
    expected bytes from a byte-by-byte loop."""
    rng = np.random.default_rng(seed)
    LL = np.zeros((B, S), np.int32)
    ML = np.zeros((B, S), np.int32)
    OF = np.zeros((B, S), np.int32)
    LIT = rng.integers(0, 256, (B, lit_w)).astype(np.uint8)
    expect = []
    for b in range(B):
        out, lp = bytearray(), 0
        for i in range(S):
            big = rng.random() < 0.2 and lp < lit_w - 300
            l = min(int(rng.integers(120, 300) if big
                        else rng.integers(0, 40)), lit_w - lp)
            hi = len(out) + l
            m = int(rng.integers(0, 70)) if hi else 0
            c = rng.random()
            o = (l + m if c < 0.25 else hi if c < 0.45
                 else int(rng.integers(1, hi + 1)) if hi else 0)
            o = min(o, hi)
            if o == 0:
                m = 0
            LL[b, i], ML[b, i], OF[b, i] = l, m, o
            out += LIT[b, lp:lp + l].tobytes()
            lp += l
            for _ in range(m):
                out.append(out[len(out) - o])
        expect.append(bytes(out))
    out_len = np.array([len(e) for e in expect], np.int32)
    return LL, ML, OF, LIT, out_len, expect


@pytest.mark.parametrize("seed", [11, 12])
def test_execute_random_records_match_byte_loop(seed):
    LL, ML, OF, LIT, out_len, expect = _random_records(seed)
    rows = torch.arange(LL.shape[0], dtype=torch.int32)
    out, ok = execute.execute_lanes(
        *(torch.from_numpy(a) for a in (LL, ML, OF, LIT, out_len)), rows,
        int(out_len.max()) + 64)
    assert ok.all()
    for b, e in enumerate(expect):
        assert out[b, :len(e)].numpy().tobytes() == e
        assert not out[b, len(e):].any()
