"""libzstd's frames and malformed input through the port on the CPU.

zstd_tpu_torch/testdata/libzstd holds frames libzstd wrote
(scripts/make_torch_libzstd_fixture.py): bench.py's headline frames
(level 3 with checksums), levels 19, 1 and -5, a 4 MiB frame with a 2 MiB
window, a frame whose matches reach past 8 MiB and edge frames; their
payloads are made again from the recipes in its manifest. Here, with the
kernels' plain versions:

  - every frame decodes through zstd_tpu_torch's BatchDecoder(device="cpu")
    to its manifest digest and to libzstd's output, its own device row ok
    (read from run_device, where decode_frames would retry a rejected
    frame on the host oracle); the main, level and edge frames also equal
    zstd_tpu's BatchDecoder output (the 4 MiB and 10 MiB frames are held
    to their digests alone: the reference's CPU run of them takes minutes);
  - the fixture's features (testdata/anatomy.py::frame_features) cover
    every block and literal section type, every table mode of LL, OF and
    ML, the repeat codes with and without the literal-length-0 shift, a
    window smaller than its frame and matches more than 8 MiB back;
  - mutants (testdata/anatomy.py::targeted_mutants, and the reference's
    own tests/test_mutation_fuzz.py::_mutants) decode through the port as
    through zstd_tpu and as the host oracle's decode_frame says (None where
    it raises): one frame per element, trailing bytes ignored;
  - tests/test_soak_roundtrip.py's streams decode through both packages'
    decode_all_device alike.
"""

import os
import random

import pytest
import zstandard
from test_mutation_fuzz import _mutants
from test_soak_roundtrip import _stream

from zstd_tpu.models.batch_decoder import BatchDecoder as RefDecoder
from zstd_tpu.models.splitter import decode_all_device as ref_decode_all
from zstd_tpu_torch.common.errors import FrameHeaderError, ZstdError
from zstd_tpu_torch.models.batch_decoder import BatchDecoder
from zstd_tpu_torch.models.splitter import decode_all_device
from zstd_tpu_torch.oracle import decode_all, decode_frame
from zstd_tpu_torch.testdata import (HERE, libzstd_payload,
                                     load_libzstd_fixture, load_libzstd_stream,
                                     matches_digest)
from zstd_tpu_torch.testdata import payloads as payloads_mod
from zstd_tpu_torch.testdata.anatomy import (add_features, frame_features,
                                             frame_regions, targeted_mutants)

FAR = 8 << 20  # the chained path's near window (framer.STREAM_WINDOW_CAP)


@pytest.fixture(scope="module")
def fixture():
    cache = {}
    return [{**e, "data": libzstd_payload(e, cache)}
            for e in load_libzstd_fixture()]


@pytest.fixture(scope="module")
def decoded(fixture):
    """The port's run_device rows and decode_frames results for every
    fixture frame, in one CPU batch."""
    frames = [e["frame"] for e in fixture]
    dec = BatchDecoder(device="cpu")
    batch = dec.prepare(frames)
    outputs, out_len, ok = dec.run_device(batch)
    rows = []
    for m in batch.metas:
        assert m.ok and not m.fallback and m.rows, m.error
        r = m.rows[0]
        rows.append((bool(ok[r]), int(out_len[r]) - m.dict_skip,
                     outputs[r][m.dict_skip:int(out_len[r])].tobytes()))
    results = dec._postprocess(frames, batch, outputs, out_len, ok)
    return rows, results, dec.host_frames


def _oracle(frame):
    try:
        return decode_frame(frame)
    except ZstdError:
        return None


def test_fixture_payloads_and_size(fixture):
    """Every payload made again from its recipe has its manifest digest;
    the corpus frames are bench.py's make_corpus frames (a prefix of its
    make_corpus(128)); the directory stays within 1.5 MB."""
    from bench import make_corpus

    head = make_corpus(4)
    for e in fixture:
        assert matches_digest(e["data"], e["digest"]), e["file"]
        spec = e["payload"]
        if spec["recipe"] == "corpus" and spec["seed"] == 0 and spec["mb"] == 4:
            assert e["data"] == head[spec["slice"][0] >> 17], e["file"]
    s = load_libzstd_stream()
    data = b"".join(payloads_mod.payload(p) for p in s["payloads"])
    assert matches_digest(data, s["digest"])
    d = os.path.join(HERE, "libzstd")
    assert sum(os.path.getsize(os.path.join(d, f))
               for f in os.listdir(d)) <= 1_500_000
    assert {e["group"] for e in fixture} == {"main", "levels", "chained",
                                             "far", "edge"}
    assert sum(e["group"] == "main" for e in fixture) == 16


def test_fixture_features_cover_the_format(fixture):
    """Summed over the fixture, every feature the device path must handle
    is there (the manifest's `unreached` lists none), and the edge and
    level frames' features are what the oracle's parse of them finds."""
    total = None
    for e in fixture:
        total = e["features"] if total is None else add_features(
            total, e["features"])
    for e in fixture:
        if e["group"] in ("edge", "levels"):
            assert frame_features(e["frame"]) == e["features"], e["file"]
    assert all(total["blocks"].values()), total["blocks"]
    assert all(total["literals"].values()), total["literals"]
    for kind in ("ll", "of", "ml"):
        assert all(total["modes"][kind].values()), (kind, total["modes"])
    assert all(total["repeat_codes"].values()), total["repeat_codes"]
    assert any(e["features"]["window"] < e["size"] for e in fixture)
    assert total["max_offset"] > FAR
    assert total["max_match"] > 131000
    import json

    with open(os.path.join(HERE, "libzstd", "manifest.json")) as f:
        assert json.load(f)["unreached"] == []


def test_fixture_on_the_port(fixture, decoded):
    """Each frame's own device row ok and exact (no host retry), every
    decode_frames result equal to the payload and to libzstd's output."""
    rows, results, host_frames = decoded
    dctx = zstandard.ZstdDecompressor()
    for e, (ok, n, data), res in zip(fixture, rows, results):
        assert ok and n == e["size"] and data == e["data"], e["file"]
        assert res == e["data"], e["file"]
        assert dctx.decompress(e["frame"], max_output_size=max(
            e["size"], 1)) == res, e["file"]
    assert host_frames == 0


def test_fixture_equals_the_reference_decoder(fixture, decoded):
    """The main, level and edge frames through zstd_tpu's BatchDecoder."""
    picked = [i for i, e in enumerate(fixture)
              if e["group"] in ("main", "levels", "edge")]
    ref = RefDecoder().decode_frames([fixture[i]["frame"] for i in picked])
    assert ref == [decoded[1][i] for i in picked]


def test_fixture_stream_through_decode_all_device():
    s = load_libzstd_stream()
    want = b"".join(payloads_mod.payload(p) for p in s["payloads"])
    assert decode_all_device(s["stream"], device="cpu") == want
    assert ref_decode_all(s["stream"]) == want


def _small_bases(fixture):
    """The checksum-less edge frames: the mutator's frames at a size the
    reference's CPU run takes in seconds."""
    return [e["frame"] for e in fixture
            if e["group"] == "edge" and not e["checksum"]]


def _three_ways(frames):
    port = BatchDecoder(device="cpu").decode_frames(frames)
    ref = RefDecoder().decode_frames(frames)
    oracle = [_oracle(z) for z in frames]
    return port, ref, oracle


@pytest.mark.parametrize("seed", [1, 2])
def test_targeted_mutants_three_ways(fixture, seed):
    """Mutants inside compressed block bodies: the port equals zstd_tpu
    and the host oracle's decode_frame, and most reach the kernels."""
    bases = _small_bases(fixture)
    muts = targeted_mutants(bases, random.Random(seed), 32)
    frames = [z for _, _, _, z in muts]
    port, ref, oracle = _three_ways(frames)
    assert port == oracle
    assert ref == oracle
    kinds = {r.kind for _, _, r, _ in muts}
    assert {"huff_stream", "seq_stream"} <= kinds
    assert sum(o is None for o in oracle) > len(frames) // 2


def test_mutant_regions_lie_in_block_bodies(fixture):
    """frame_regions finds each compressed block's parts in order, inside
    the frame, and a stream ends its block's literal or sequence part."""
    for e in fixture:
        if e["group"] not in ("edge", "levels"):
            continue
        regions = frame_regions(e["frame"])
        assert all(0 < r.start < r.end <= len(e["frame"]) for r in regions)
        assert all(a.end <= b.start for a, b in zip(regions, regions[1:]))


@pytest.mark.parametrize("seed", [5, 6])
def test_mutation_fuzz_mutants_three_ways(seed):
    """tests/test_mutation_fuzz.py's own mutator (truncation, insertion,
    splices, byte flips of libzstd frames at levels 1-19)."""
    frames = _mutants(random.Random(seed), n_mut=24)
    port, ref, oracle = _three_ways(frames)
    assert port == oracle
    assert ref == oracle


def test_trailing_bytes_after_a_frame():
    """_mutants(random.Random(1))[17] is a whole frame and 20 bytes more:
    decode_frames decodes one frame per element and ignores what follows
    it, as decode_frame does, while decode_all reads the rest as a next
    frame and raises (tests/test_mutation_fuzz.py compares the device path
    with decode_all; its seed 99 has no such mutant)."""
    z = _mutants(random.Random(1), n_mut=18)[17]
    want = decode_frame(z)
    assert len(z) == 1609 and len(want) == 1589
    with pytest.raises(FrameHeaderError):
        decode_all(z)
    port, ref, _ = _three_ways([z])
    assert port == ref == [want]


@pytest.mark.parametrize("seed", [41])
def test_soak_stream_through_both_packages(seed):
    """tests/test_soak_roundtrip.py::_stream (mixed payloads, levels 1-19,
    window logs, checksums, skippable frames) through both packages'
    decode_all_device."""
    z, want = _stream(random.Random(seed))
    assert decode_all_device(z, device="cpu") == want
    assert ref_decode_all(z) == want
