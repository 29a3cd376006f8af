"""The fused decode step of zstd_tpu_torch against zstd_tpu's, on the CPU.

The same numpy kwargs go through zstd_tpu.models.fused.fused_decode_step
(XLA on the CPU) and, through to_fused_kwargs, through the port's
fused_decode_step (the plain torch version of every stage). Two batches:
zstd_tpu's example_batch(8) (libzstd level-3 frames here), and 16 frames
of the port's FASTEST encoder with one corrupted sequence (or Huffman)
stream. out_len, ok and every metric are equal (tolerance 0: integer
codec); out is equal on every ok row, and a row that is not ok is all zero
in the port (the reference leaves its bytes unspecified: its XLA executor
writes what its broken records point at).
"""

import numpy as np
import pytest
import torch

from zstd_tpu.models import fused as ref_fused
from zstd_tpu.models.batch_decoder import BatchDecoder as RefBatchDecoder
from zstd_tpu_torch.common.config import CompressionLevel
from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
from zstd_tpu_torch.models import fused
from zstd_tpu_torch.models.batch_decoder import BatchDecoder


def _payloads(n: int, seed: int) -> list:
    """Text, CSV and repeated binary frames of 2-8 KiB (Huffman literals
    and sequences in every block)."""
    rng = np.random.RandomState(seed)
    words = [b"entropy", b"stream", b"zstandard", b"huffman", b"table",
             b"frame", b"block", b"decode", b"offset", b"sequence"]
    out = []
    for i in range(n):
        size = int(rng.randint(2 << 10, 8 << 10))
        if i % 3 == 0:
            p = b" ".join(words[j] for j in rng.randint(0, 10, size // 6))
        elif i % 3 == 1:
            p = b"".join(b"%d,%d,item-%d\n" % (j, (j * 37) % 1001, j % 64)
                         for j in range(size // 12))
        else:
            base = rng.bytes(int(rng.randint(64, 512)))
            p = base * (size // len(base) + 1)
        out.append(p[:size])
    return out


def ref_kwargs(batch) -> dict:
    """zstd_tpu's fused kwargs of a framed batch, as its example_batch
    builds them."""
    kw = {k: np.asarray(getattr(batch, k)) for k in fused.KEYS
          if k != "init_hist"}
    kw["init_hist"] = np.tile(np.array([1, 4, 8], np.int32),
                              (batch.lit_base.shape[0], 1))
    return kw


def corrupted_batch(kind: str = "sequence", n: int = 16, seed: int = 4):
    """(kwargs, static, payloads, bad frame) of n FASTEST frames framed by
    zstd_tpu, the last byte of one lane's stream of frame 3 (text) zeroed:
    the stream loses its padding sentinel."""
    payloads = _payloads(n, seed)
    frames = [compress_to_vec(p, CompressionLevel.FASTEST) for p in payloads]
    batch = RefBatchDecoder().prepare(frames)
    kw = ref_kwargs(batch)
    bad = 3
    prefix, count = (("seq", "seq_n") if kind == "sequence"
                     else ("huff", "huff_nsym"))
    live = kw[count] > 0
    lane = int(np.nonzero(live & (kw[f"{prefix}_dst_frame"] == bad))[0][0])
    streams = kw[f"{prefix}_streams"].copy()
    streams[lane, int(getattr(batch, f"{prefix}_len")[lane]) - 1] = 0
    kw[f"{prefix}_streams"] = streams
    out_w = 1 << (max(map(len, payloads)) - 1).bit_length()
    static = dict(max_huff_symbols=batch.max_huff_symbols,
                  max_seqs=batch.max_seqs, out_width=out_w)
    return kw, static, payloads, bad


def run_both(kw, static):
    """(reference results, port results), each (out, out_len, ok, metrics)
    as numpy arrays and ints."""
    ro, rl, rok, rm = ref_fused.fused_decode_step(**kw, **static)
    po, pl, pok, pm = fused.fused_decode_step(
        **fused.to_fused_kwargs(kw, "cpu"), **static)
    ref = (np.asarray(ro), np.asarray(rl), np.asarray(rok),
           {k: int(v) for k, v in rm.items()})
    got = (po.numpy(), pl.numpy(), pok.numpy(),
           {k: int(v) for k, v in pm.items()})
    return ref, got


def assert_same(ref, got):
    ro, rl, rok, rm = ref
    po, pl, pok, pm = got
    assert po.shape == ro.shape and po.dtype == ro.dtype == np.uint8
    assert np.array_equal(pl, rl) and np.array_equal(pok, rok)
    assert pm == rm
    assert np.array_equal(po[rok], ro[rok])
    assert not po[~rok].any()


@pytest.fixture(scope="module")
def example():
    return ref_fused.example_batch(8)


def test_fused_step_matches_reference_on_example_batch(example):
    kw, static, payloads = example
    ref, got = run_both(kw, static)
    assert_same(ref, got)
    out, out_len, ok, metrics = got
    assert np.array_equal(out, ref[0])  # every row ok: all bytes equal
    assert ok.all() and metrics["frames_ok"] == len(payloads) + 1
    assert metrics["bytes_out"] == sum(map(len, payloads))
    for i, p in enumerate(payloads):
        assert out[i, :len(p)].tobytes() == p and out_len[i] == len(p)


@pytest.mark.parametrize("kind", ["sequence", "huffman"])
def test_fused_step_matches_reference_on_corrupted_batch(kind):
    kw, static, payloads, bad = corrupted_batch(kind)
    assert (kw["huff_nsym"] > 0).sum() > 0 and (kw["seq_n"] > 0).sum() > 0
    ref, got = run_both(kw, static)
    assert_same(ref, got)
    ok = got[2]
    assert np.nonzero(~ok)[0].tolist() == [bad]
    assert got[3]["frames_bad"] == 1
    for i, p in enumerate(payloads):
        if i != bad:
            assert got[0][i, :len(p)].tobytes() == p


@pytest.mark.parametrize("cap", ["max_huff_symbols", "max_seqs"])
def test_fused_step_lane_caps_match_reference(cap):
    """Caps below the batch's own: a lane is cut where the reference's scan
    stops, and its frame fails in both."""
    kw, static, _, _ = corrupted_batch("sequence", seed=8)
    lanes = kw["huff_nsym"] if cap == "max_huff_symbols" else kw["seq_n"]
    small = dict(static, **{cap: int(np.unique(lanes[lanes > 0])[-3])})
    ref, got = run_both(kw, small)
    assert_same(ref, got)
    assert got[3]["frames_bad"] >= 2
    assert got[3]["frames_bad"] == int((~ref[2]).sum())


def test_port_example_batch_decodes_its_payloads():
    kw, static, payloads = fused.example_batch(12, seed=3, device="cpu")
    assert all(t.device.type == "cpu" for t in kw.values())
    out, out_len, ok, metrics = fused.fused_decode_step(**kw, **static)
    assert out.shape == (len(payloads) + 1, static["out_width"])
    assert bool(ok.all()) and int(metrics["frames_bad"]) == 0
    assert int(metrics["frames_ok"]) == len(payloads) + 1
    assert int(metrics["bytes_out"]) == sum(map(len, payloads))
    for i, p in enumerate(payloads):
        assert out[i, :len(p)].numpy().tobytes() == p
        assert int(out_len[i]) == len(p)


def test_example_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused.example_batch(2)


def test_to_fused_kwargs_takes_a_batch_or_the_reference_kwargs():
    """The port's DeviceBatch and zstd_tpu's kwargs of the same frames map
    to the same tensors (init_hist: the batch's frame_hist, [1, 4, 8] for
    frames without a dictionary), of the dtypes the kernels take."""
    payloads = _payloads(6, 2)
    frames = [compress_to_vec(p, CompressionLevel.FASTEST) for p in payloads]
    batch = BatchDecoder(device="cpu").prepare(frames)
    a = fused.to_fused_kwargs(batch, "cpu")
    b = fused.to_fused_kwargs(ref_kwargs(RefBatchDecoder().prepare(frames)),
                              "cpu")
    assert list(a) == list(b) == list(fused.KEYS)
    for k in fused.KEYS:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    want = {"huff_streams": torch.uint8, "seq_streams": torch.uint8,
            "lit_base": torch.uint8, "is_real": torch.bool}
    for k, t in a.items():
        assert t.dtype == want.get(k, torch.int32), k
        assert t.is_contiguous()


def test_fused_step_equals_the_decoders_run():
    """The fused step and BatchDecoder.run_device share their stages: the
    same bytes, lengths and ok on a batch of single-group frames."""
    kw, static, payloads, bad = corrupted_batch("sequence", n=9)
    out, out_len, ok, _ = fused.fused_decode_step(
        **fused.to_fused_kwargs(kw, "cpu"), **static)
    frames = [compress_to_vec(p, CompressionLevel.FASTEST) for p in payloads]
    dec = BatchDecoder(device="cpu")
    rows, lens, oks = dec.run_device(dec.prepare(frames))
    for i, p in enumerate(payloads):
        assert oks[i] and lens[i] == len(p)
        assert rows[i][:len(p)].tobytes() == p
        if i != bad:
            assert bool(ok[i]) and out[i, :len(p)].numpy().tobytes() == p
    assert not bool(ok[bad])
