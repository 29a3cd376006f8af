"""zstd_tpu_torch.bench, the port's counterpart of the root bench.py, on
the CPU at small sizes (device="cpu": the plain torch versions).

The corpus is bench.py's; the headline returns bench.py's headline keys
with every correctness key true, on libzstd's frames and the port's; the
rows it reads equal zstd_tpu's BatchDecoder rows bit for bit; a frame the
device rejects turns `correct` false although decode_frames still returns
its bytes (the host oracle decodes it again). The longframe, bigwindow and
encode scenarios run for real at KiB sizes with every key true, and each
of their correctness reads turns false where it should: a chained frame
the device rejects, a window inside the near line, an encoder output that
is not its payload's. main() exits non-zero when a scenario raises or a
correctness key is false, and needs a card unless it is given the CPU.

The chained scenarios run under the tiny caps with the near/far line at a
16 KiB window (tests/test_torch_chained.py's), their frames made by
bench.compress's libzstd branch at KiB windows (8 KiB, or 32 KiB where it
is asked for a window): libzstd makes no block larger than its window, so
a frame of a few blocks chains, and the plain sequence stage, which steps
once a record, has few records a lane. (The port's encoder keeps 128 KiB
blocks at any window, which a decoder refuses past an 8 KiB window, so
these frames are libzstd's; the headline tests cover compress's FASTEST
branch.)
"""

import json
import os
from types import SimpleNamespace

import pytest
import torch

import bench as root_bench
from zstd_tpu.models.batch_decoder import BatchDecoder as RefDecoder
from zstd_tpu_torch import bench
from zstd_tpu_torch.models.batch_decoder import BatchDecoder
from zstd_tpu_torch.models.batch_encoder import BatchEncoder
from zstd_tpu_torch.testdata import load_libzstd_fixture, matches_digest
from zstd_tpu_torch.testdata.anatomy import frame_regions
from zstd_tpu_torch.testdata.payloads import make_corpus
from zstd_tpu_torch.utils.caps import tiny_caps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 16   # of 4 KiB: the plain sequence stage steps once a record
CORRUPT = 3     # the frame whose device copy one test corrupts
LONG_MB = 1 / 8     # longframe: a 128 KiB frame, then 4 of 64 KiB
BIG_MB = 3 / 64     # bigwindow: units of 4 KiB, a 48 KiB body
ENCODE_MB = 1 / 4   # encode: 2 frames of 128 KiB, a 512 KiB one-shot


def _parsed() -> dict:
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        return json.load(f)["parsed"]


def _headline_keys() -> list:
    keys = list(_parsed())
    return keys[:keys.index("checksum_verified") + 1]


def _keys(prefix: str) -> list:
    return [k for k in _parsed() if k.startswith(prefix)]


def _hide_zstandard(from_libzstd: bool, monkeypatch) -> None:
    if not from_libzstd:
        monkeypatch.setattr(bench, "zstandard_module", lambda: None)


def _corrupt_seq_stream(frame: bytes) -> bytes:
    """The frame with its first sequence stream flipped (0x5A a byte)."""
    region = next(r for r in frame_regions(frame) if r.kind == "seq_stream")
    mutant = bytearray(frame)
    for i in range(region.start, region.end):
        mutant[i] ^= 0x5A
    return bytes(mutant)


def _device_copy(monkeypatch, frame: bytes, mutant: bytes) -> None:
    """BatchDecoder.prepare frames `mutant` where it is given `frame`: the
    device gets the mutant, the host oracle (decode_frames' retry) the
    frame."""
    prepare = BatchDecoder.prepare

    def corrupted_prepare(self, batch_frames):
        return prepare(self, [mutant if f == frame else f
                              for f in batch_frames])

    monkeypatch.setattr(BatchDecoder, "prepare", corrupted_prepare)


@pytest.fixture
def chained_caps(monkeypatch):
    """The tiny caps with the near/far line at 16 KiB, and bench.compress
    at 8 KiB windows (32 KiB where a window is asked for)."""
    compress = bench.compress
    monkeypatch.setattr(bench, "compress", lambda data, window_log=None:
                        compress(data, 13 if window_log is None else 15))
    with tiny_caps(stream_window=1 << 14):
        yield


def _small(from_libzstd: bool, monkeypatch):
    """(payloads, frames, frames_from) of N_FRAMES 4 KiB frames, made by
    libzstd or (with `zstandard` hidden) by the port's encoder."""
    _hide_zstandard(from_libzstd, monkeypatch)
    payloads, frames, made_by = bench.main_frames(1, frame_kb=4)
    return payloads[:N_FRAMES], frames[:N_FRAMES], made_by


@pytest.fixture(scope="module")
def small_frames():
    payloads, frames, _ = bench.main_frames(1, frame_kb=4)
    return payloads[:N_FRAMES], frames[:N_FRAMES]


@pytest.mark.parametrize("total_mb,frame_kb", [(1, 128), (2, 16)])
@pytest.mark.parametrize("seed", [0, 3, 5])
def test_corpus_is_bench_py_corpus(total_mb, frame_kb, seed):
    assert (make_corpus(total_mb, frame_kb, seed)
            == root_bench.make_corpus(total_mb, frame_kb, seed))


@pytest.mark.parametrize("from_libzstd", [True, False],
                         ids=["libzstd-3", "fastest"])
def test_headline_has_bench_py_keys_and_is_correct(from_libzstd,
                                                   monkeypatch):
    payloads, frames, made_by = _small(from_libzstd, monkeypatch)
    assert made_by == ("libzstd-3" if from_libzstd else "fastest")
    res = bench.run_headline(frames, payloads, "cpu", runs=2, p_rounds=2)
    assert [k for k in _headline_keys() if k not in res] == []
    assert res["unit"] == "GB/s/gpu" and res["frames"] == N_FRAMES
    assert res["decoded_mb"] == sum(map(len, payloads)) / 1e6
    assert res["pipelined_prepare_s"] > 0
    assert bench.failed_checks(res) == []
    assert res["correct"] is True and res["checksum_verified"] is True


def test_rows_equal_reference_decoder_rows(small_frames):
    payloads, frames = small_frames
    dec = BatchDecoder(device="cpu")
    batch = dec.prepare(frames)
    got = bench.frame_rows(batch, *dec.run_device(batch))
    ref = RefDecoder()
    ref_batch = ref.prepare(frames)
    want = bench.frame_rows(ref_batch, *ref.run_device(ref_batch))
    assert got == want == payloads


def test_device_rejected_frame_turns_correct_false(small_frames,
                                                   monkeypatch):
    """One frame's sequence stream is corrupted in what the device gets
    (anatomy.frame_regions finds it); the frame handed to the host oracle
    stays intact, so decode_frames returns every payload and counts no
    host frame, while the frame's own row is rejected."""
    payloads, frames = small_frames
    _device_copy(monkeypatch, frames[CORRUPT],
                 _corrupt_seq_stream(frames[CORRUPT]))
    dec = BatchDecoder(device="cpu")
    assert dec.decode_frames(frames) == payloads and dec.host_frames == 0
    batch = dec.prepare(frames)
    assert not batch.metas[CORRUPT].fallback
    _, _, ok = dec.run_device(batch)
    assert [bool(ok[m.rows[0]]) for m in batch.metas] == [
        i != CORRUPT for i in range(N_FRAMES)]

    res = bench.run_headline(frames, payloads, "cpu", runs=1, p_rounds=2)
    assert res["correct"] is False and res["checksum_verified"] is False
    assert bench.failed_checks(res) == ["correct", "checksum_verified"]


def test_libzstd_headline_is_the_fixture_tiled(monkeypatch):
    """run_libzstd reads every committed frame the bench names: the main
    frames tiled (through run_headline), the chained frame as
    libzstd_longframe_* and the far frame as libzstd_bigwindow_* (through
    _chained, whose read the chained tests below hold; the fixture's rows
    on the CPU are tests/test_torch_conformance.py's)."""
    payloads, frames = bench.libzstd_main(tile=2)
    main = load_libzstd_fixture(["main"])
    assert len(main) == 16 and frames == [e["frame"] for e in main] * 2
    assert all(matches_digest(p, e["digest"])
               for p, e in zip(payloads, main * 2))
    calls = []

    def headline(frames, payloads, device):
        calls.append(("headline", len(frames), device))
        return {"metric": "m", "unit": "u", "value": 1.0, "correct": True}

    def chained(dec, frames, payloads):
        (entry,) = [e for e in load_libzstd_fixture(["chained", "far"])
                    if e["frame"] == frames[0]]
        calls.append((entry["group"], len(frames), str(dec.device)))
        assert matches_digest(payloads[0], entry["digest"])
        meta = SimpleNamespace(rows=[0, 1, 2], window=1 << 24)
        return 2.0, SimpleNamespace(metas=[meta]), True

    monkeypatch.setattr(bench, "run_headline", headline)
    monkeypatch.setattr(bench, "_chained", chained)
    assert bench.run_libzstd("cpu", tile=1) == {
        "libzstd_value": 1.0, "libzstd_correct": True,
        "libzstd_longframe_gbps": 2.0, "libzstd_longframe_groups": 3,
        "libzstd_longframe_correct": True,
        "libzstd_bigwindow_gbps": 2.0, "libzstd_bigwindow_groups": 3,
        "libzstd_bigwindow_correct": True}
    assert calls == [("headline", 16, "cpu"), ("chained", 1, "cpu"),
                     ("far", 1, "cpu")]


def test_longframe_at_kib_sizes_is_correct(chained_caps):
    res = bench.run_longframe(LONG_MB, "cpu")
    assert list(res) == _keys("longframe")
    assert res["longframe_groups"] > 1
    assert bench.failed_checks(res) == []


def test_device_rejected_chained_frame_turns_longframe_correct_false(
        chained_caps, monkeypatch):
    """The longframe's sequence stream is corrupted in what the device gets
    only: decode_frames still returns its bytes (the host oracle decodes
    it again), its own row is rejected, and longframe_correct is false
    while the 4-frame batch beside it stays correct."""
    data = b"".join(bench.corpus(LONG_MB, seed=3))
    frame = bench.compress(data)
    _device_copy(monkeypatch, frame, _corrupt_seq_stream(frame))
    dec = BatchDecoder(device="cpu")
    assert dec.decode_frames([frame]) == [data] and dec.host_frames == 0
    (meta,) = dec.prepare([frame]).metas
    assert len(meta.rows) > 1 and not meta.fallback

    res = bench.run_longframe(LONG_MB, "cpu")
    assert bench.failed_checks(res) == ["longframe_correct"]


@pytest.mark.parametrize("line_kb,correct", [(16, True), (64, False)],
                         ids=["far", "window-inside-the-line"])
def test_bigwindow_at_kib_sizes(line_kb, correct, chained_caps):
    """bigwindow_correct needs the frame's 32 KiB window past the near/far
    line (STREAM_WINDOW_CAP): true at a 16 KiB line, false at 64 KiB,
    where every row is still ok."""
    with tiny_caps(stream_window=line_kb << 10):
        res = bench.run_bigwindow(BIG_MB, "cpu")
    assert list(res) == _keys("bigwindow") and res["bigwindow_groups"] > 1
    assert res["bigwindow_correct"] is correct


@pytest.mark.parametrize("from_libzstd", [True, False],
                         ids=["libzstd", "no-zstandard"])
def test_encode_at_kib_sizes_is_correct(from_libzstd, monkeypatch):
    _hide_zstandard(from_libzstd, monkeypatch)
    res = bench.run_encode(ENCODE_MB, "cpu")
    assert [k for k in _keys("encode") if k not in res] == []
    assert sorted(k for k in res if k.startswith("encode_devmatch")) == [
        "encode_devmatch_correct", "encode_devmatch_mbps",
        "encode_devmatch_stages"]
    assert bench.failed_checks(res) == []
    ratio = res["encode_ratio_vs_libzstd1"]
    assert (ratio > 0) if from_libzstd else ratio is None


def test_encode_correct_reads_every_output(monkeypatch):
    """BatchEncoder's outputs handed back swapped (each a valid frame of
    the other payload): both device encodes' *_correct turn false, the
    host encodes' stay true."""
    compress_frames = BatchEncoder.compress_frames

    def swapped(self, payloads):
        return compress_frames(self, payloads)[::-1]

    monkeypatch.setattr(BatchEncoder, "compress_frames", swapped)
    res = bench.run_encode(ENCODE_MB, "cpu")
    assert bench.failed_checks(res) == ["encode_device_correct",
                                        "encode_devmatch_correct"]


def _stub_scenarios(monkeypatch, bad=None, raises=None):
    """Every scenario of bench.run_scenarios replaced by a stub that
    returns one correctness key (False for `bad`) or raises (`raises`)."""
    def stub(name, key):
        def run(*args, **kw):
            if name == raises:
                raise RuntimeError(f"{name} failed")
            return {key: name != bad}
        return run

    monkeypatch.setattr(bench, "main_frames",
                        lambda total_mb: ([b"x"], [b"z"], "fastest"))
    for name, fn, key in (("headline", "run_headline", "correct"),
                          ("libzstd", "run_libzstd", "libzstd_correct"),
                          ("longframe", "run_longframe", "longframe_correct"),
                          ("bigwindow", "run_bigwindow", "bigwindow_correct"),
                          ("encode", "run_encode", "encode_correct")):
        monkeypatch.setattr(bench, fn, stub(name, key))


def test_main_prints_one_line_and_exits_zero(monkeypatch, capsys):
    _stub_scenarios(monkeypatch)
    assert bench.main(["1"], device="cpu") == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line == {"correct": True, "frames_from": "fastest",
                    "libzstd_correct": True, "longframe_correct": True,
                    "bigwindow_correct": True, "encode_correct": True,
                    "device": "cpu"}


@pytest.mark.parametrize("bad", bench.SCENARIOS)
def test_main_exits_nonzero_when_a_check_is_false(bad, monkeypatch, capsys):
    _stub_scenarios(monkeypatch, bad=bad)
    assert bench.main(["1", "all"], device="cpu") == 1
    out = capsys.readouterr()
    assert len(bench.failed_checks(json.loads(out.out))) == 1
    assert "not true" in out.err


@pytest.mark.parametrize("raises", bench.SCENARIOS)
def test_main_exits_nonzero_when_a_scenario_raises(raises, monkeypatch,
                                                   capsys):
    _stub_scenarios(monkeypatch, raises=raises)
    with pytest.raises(RuntimeError, match=f"{raises} failed"):
        bench.main(["1", ",".join(bench.SCENARIOS)], device="cpu")
    assert capsys.readouterr().out == ""


def test_main_runs_only_the_named_scenarios(monkeypatch, capsys):
    _stub_scenarios(monkeypatch, bad="encode")
    assert bench.main(["1", "headline,bigwindow"], device="cpu") == 0
    assert set(json.loads(capsys.readouterr().out)) == {
        "correct", "frames_from", "bigwindow_correct", "device"}
    with pytest.raises(ValueError, match="unknown scenarios"):
        bench.main(["1", "headline,serving"], device="cpu")


def test_failed_checks_reads_every_correctness_key():
    assert bench.failed_checks({
        "correct": True, "checksum_verified": False, "value": 0.0,
        "libzstd_checksum_verified": True, "encode_device_correct": None,
        "longframe4_correct": False, "encode_ratio_vs_libzstd1": None}) == [
        "checksum_verified", "encode_device_correct", "longframe4_correct"]


def test_bench_needs_a_card_by_default(small_frames):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    payloads, frames = small_frames
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_headline(frames, payloads)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["1", "headline"])


def test_bigwindow_body_is_bench_py_body():
    """bench.py:117-119 at its mb 12: the quote of MiB 2-3 lies 9+ MiB
    back; at a fraction of 12 MiB the same shape in smaller units."""
    head = b"".join(root_bench.make_corpus(9, seed=7))
    want = (head + head[:1 << 20] + b"".join(root_bench.make_corpus(1, seed=8))
            + head[2 << 20:3 << 20])
    assert bench.bigwindow_body(12) == want
    u = 4 << 10
    assert bench.bigwindow_body(BIG_MB) == (
        want[:9 * u] + want[:u] + want[10 << 20:(10 << 20) + u]
        + want[2 * u:3 * u])


@pytest.mark.parametrize("mb", [1, 2, 1 / 8, 3 / 16])
def test_corpus_is_a_prefix_of_make_corpus(mb):
    blob = b"".join(make_corpus(2, seed=3))
    got = bench.corpus(mb, seed=3)
    assert b"".join(got) == blob[:round(mb * (1 << 20))]
    if mb == int(mb):
        assert got == make_corpus(int(mb), seed=3)
