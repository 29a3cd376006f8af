"""zstd_tpu_torch's device encoder against zstd_tpu's, on the CPU.

Seeded NumPy payloads (text, random, RLE-ish, b"ab" * 1000, empty and
2-byte, plus a long repeat for the match extension) go through each port
module — the plain torch versions the CUDA kernels are held to on the card
— and through the reference: its XLA formulations, its parse kernel in
Pallas interpret mode, its BatchEncoder with the host matcher and with
DeviceMatcher(interpret=True). Every comparison is exact (tolerance 0: an
integer codec). libzstd (`zstandard`) and the port's BatchDecoder decode
every frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard

from test_batch_encoder import payload_matrix
from zstd_tpu.encoding.device_matcher import DeviceMatcher as RefMatcher
from zstd_tpu.models.batch_encoder import BatchEncoder as RefEncoder
from zstd_tpu.ops import bitpack as ref_bitpack
from zstd_tpu.ops import fse_encode as ref_fse
from zstd_tpu.ops import match_finder as ref_mf
from zstd_tpu_torch.common.config import CodecConfig, CompressionLevel
from zstd_tpu_torch.encoding.device_matcher import DeviceMatcher
from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
from zstd_tpu_torch.models.batch_decoder import BatchDecoder
from zstd_tpu_torch.models.batch_encoder import BatchEncoder
from zstd_tpu_torch.ops import bitpack, fse_encode, match_finder

CPU = "cpu"


def seeded_payloads():
    """Text, random, RLE-ish, b"ab" * 1000, empty, 2-byte, and a 700-byte
    unit repeated (a match that extends in whole 128-byte steps)."""
    rng = np.random.default_rng(11)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon"]
    unit = rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
    return [
        b" ".join(words[i] for i in rng.integers(0, 5, 600)),
        rng.integers(0, 256, 1500, dtype=np.uint8).tobytes(),
        b"\x07" * 2000 + b"\x08" * 300 + b"\x07" * 700,
        b"ab" * 1000,
        b"",
        b"xy",
        unit * 5 + rng.integers(0, 256, 90, dtype=np.uint8).tobytes(),
    ]


def lanes_of(payloads, width: int):
    data = np.zeros((len(payloads), width), np.uint8)
    nv = np.zeros(len(payloads), np.int32)
    for i, p in enumerate(payloads):
        data[i, :len(p)] = np.frombuffer(p, np.uint8)
        nv[i] = len(p)
    return data, nv


@pytest.mark.parametrize("width", [4096, 8192])
def test_find_candidates_matches_reference(width):
    data, nv = lanes_of(seeded_payloads(), width)
    rc, rl = ref_mf.find_candidates(jnp.asarray(data), jnp.asarray(nv))
    c, l = match_finder.find_candidates(torch.from_numpy(data),
                                        torch.from_numpy(nv))
    assert np.array_equal(np.asarray(rc), c.numpy())
    assert np.array_equal(np.asarray(rl), l.numpy())


@pytest.fixture(scope="module")
def parsed():
    data, nv = lanes_of(seeded_payloads(), 4096)
    ref = ref_mf.parse_blocks(jnp.asarray(data), jnp.asarray(nv),
                              interpret=True)
    got = match_finder.parse_blocks_plain(torch.from_numpy(data),
                                          torch.from_numpy(nv))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def test_parse_plain_matches_reference(parsed):
    ref, got = parsed
    assert np.array_equal(ref[3], got[3]) and np.array_equal(ref[4], got[4])
    for b, n in enumerate(ref[3]):
        for k in range(3):
            assert np.array_equal(ref[k][b, :n], got[k][b, :n]), (b, k)
    # the 700-byte repeat: one match extended past the 8-byte cap in whole
    # 128-byte steps up to the valid end
    assert got[1][6, 0] > 8 + 128 and got[3][4] == 0 and got[3][5] == 0


@pytest.mark.parametrize("name", ["spanning", "cap"])
def test_parse_plain_matches_reference_across_segments(name):
    """The parse kernel's schedule-model lanes (tests/
    test_torch_parse_schedule.py): matches and random stretches across many
    segments, and a 256 KiB lane past MAX_SEQS whose first MAX_SEQS records
    and anchor are kept; the plain version equal to the reference's Pallas
    parse (interpret mode) on every record below nseq."""
    from test_torch_parse_schedule import cap_lane, spanning_lanes

    data, nv = {"spanning": spanning_lanes, "cap": cap_lane}[name]()
    ref = [np.asarray(r) for r in ref_mf.parse_blocks(
        jnp.asarray(data), jnp.asarray(nv), interpret=True)]
    got = [g.numpy() for g in match_finder.parse_blocks_plain(
        torch.from_numpy(data), torch.from_numpy(nv))]
    assert np.array_equal(ref[3], got[3]) and np.array_equal(ref[4], got[4])
    for b, n in enumerate(ref[3]):
        for k in range(3):
            assert np.array_equal(ref[k][b, :n], got[k][b, :n]), (b, k)
    if name == "cap":
        assert got[3][0] == match_finder.MAX_SEQS
        assert got[4][0] == 167900 and nv[0] == 262144


def test_parse_records_reconstruct_blocks(parsed):
    _, (ll, ml, of, nseq, anchor) = parsed
    for b, p in enumerate(seeded_payloads()):
        out, pos = bytearray(), 0
        for k in range(int(nseq[b])):
            l, m, o = int(ll[b, k]), int(ml[b, k]), int(of[b, k])
            assert m >= match_finder.MIN_MATCH and 0 < o <= pos + l
            out += p[pos:pos + l]
            pos += l + m
            for _ in range(m):
                out.append(out[len(out) - o])
        out += p[int(anchor[b]):]
        assert bytes(out) == p, f"lane {b}"
        assert not ll[b, int(nseq[b]):].any()  # zero past nseq


def test_parse_wrapper_takes_plain_on_cpu_and_checks_inputs():
    data, nv = lanes_of(seeded_payloads()[:2], 4096)
    d, n = torch.from_numpy(data), torch.from_numpy(nv)
    cand, lcp = match_finder.find_candidates(d, n)
    before = match_finder.parse_lanes.launches
    got = match_finder.parse_lanes(d, cand, lcp, n)
    exp = match_finder.parse_lanes_plain(d, cand, lcp, n)
    assert all(torch.equal(a, b) for a, b in zip(got, exp))
    assert match_finder.parse_lanes.launches == before  # no kernel on CPU
    with pytest.raises(ValueError):
        match_finder.parse_lanes(d, cand[:, :-1].contiguous(), lcp, n)
    with pytest.raises(TypeError):
        match_finder.parse_lanes(d, cand.long(), lcp, n)


def test_pack_bits_lanes_matches_reference():
    rng = np.random.default_rng(3)
    B, N = 6, 300
    nb = rng.integers(0, 32, (B, N)).astype(np.int32)
    nb[1] = 0                                    # an empty lane
    vals = rng.integers(0, 1 << 32, (B, N), dtype=np.uint64).astype(np.uint32)
    for out_words in (N, 40):                    # 40 words drop the tail
        rw, rt = ref_bitpack.pack_bits_lanes(jnp.asarray(vals),
                                             jnp.asarray(nb), out_words)
        w, t = bitpack.pack_bits_lanes(torch.from_numpy(vals.astype(np.int64)),
                                       torch.from_numpy(nb), out_words)
        assert np.array_equal(np.asarray(rw), w.numpy().view(np.uint32))
        assert np.array_equal(np.asarray(rt), t.numpy())
        assert (ref_bitpack.finalize_streams(rw, rt)
                == bitpack.finalize_streams(w, t))


def planned_lanes(payloads):
    """The Huffman and sequence lanes the encoder plans (host matcher)."""
    enc = BatchEncoder(device=CPU)
    huff, seq = [], []
    for p in payloads:
        enc._plan_frame(p, huff, seq)
    return enc, huff, seq


def test_fse_encode_plain_matches_reference():
    _, _, lanes = planned_lanes(payload_matrix() + seeded_payloads())
    assert any(0 in l.logs for l in lanes) and len(lanes) > 4
    ll, ml, of, nseq, ns, nbd, fs, logs = fse_encode.seq_lane_arrays(lanes,
                                                                     CPU)
    nseq[2] = 0                                  # a lane with no sequences
    S = ll.shape[1]
    ow = fse_encode.out_words_for(S)
    words, total = fse_encode.encode_sequences_packed(
        ll, ml, of, nseq, ns, nbd, fs, logs, ow)
    pw, pt = bitpack.pack_bits_lanes(*fse_encode.encode_sequence_lanes_plain(
        ll, ml, of, nseq, ns, nbd, fs, logs), ow)
    assert torch.equal(words, pw) and torch.equal(total, pt)

    j = lambda t: jnp.asarray(t.numpy())          # noqa: E731
    ns_h, nbd_h = ns.numpy().astype(np.uint16), nbd.numpy().view(np.uint32)
    tid = jnp.arange(len(lanes), dtype=jnp.int32)
    vals, nbs = ref_fse.encode_sequence_lanes(
        j(ll), j(ml), j(of), j(nseq),
        jnp.asarray(ns_h[:, 0]), jnp.asarray(ns_h[:, 1]),
        jnp.asarray(ns_h[:, 2, :256]),
        jnp.asarray(nbd_h[:, 0]), jnp.asarray(nbd_h[:, 1]),
        jnp.asarray(nbd_h[:, 2]),
        j(fs[:, 0]), j(fs[:, 1]), j(fs[:, 2]), tid, tid, tid,
        j(logs[:, 0]), j(logs[:, 1]), j(logs[:, 2]), S)
    rw, rt = ref_bitpack.pack_bits_lanes(vals, nbs, ow)
    assert np.array_equal(np.asarray(rw), words.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(rt), total.numpy())
    assert int(total[2]) == 0


def test_entropy_streams_match_reference():
    """Both device stages end to end (lane arrays, encode, pack, sentinel)
    against the reference's on the same planned lanes."""
    enc, huff, seq = planned_lanes(payload_matrix())
    ref = RefEncoder()
    assert enc._encode_huff_lanes(huff) == ref._encode_huff_lanes(huff)
    assert enc._encode_seq_lanes(seq) == ref._encode_seq_lanes(seq)


def test_batch_encoder_equals_host_encoder():
    payloads = payload_matrix()
    enc = BatchEncoder(device=CPU)
    frames = enc.compress_frames(payloads)
    for i, (p, z) in enumerate(zip(payloads, frames)):
        assert z == compress_to_vec(p, CompressionLevel.FASTEST), f"case {i}"
    assert set(enc.last_stats) == {"match_s", "plan_s", "entropy_s",
                                   "assemble_s", "lanes"}
    assert enc.last_stats["lanes"] > 0


def test_batch_encoder_uncompressed_level():
    payloads = seeded_payloads()
    enc = BatchEncoder(CodecConfig(level=CompressionLevel.UNCOMPRESSED),
                       device=CPU)
    assert enc.compress_frames(payloads) == [
        compress_to_vec(p, CompressionLevel.UNCOMPRESSED) for p in payloads]


@pytest.fixture(scope="module")
def device_matched():
    payloads = seeded_payloads() + payload_matrix()
    ref = RefEncoder(matcher=RefMatcher(interpret=True)).compress_frames(
        payloads)
    got = BatchEncoder(matcher=DeviceMatcher(device=CPU),
                       device=CPU).compress_frames(payloads)
    return payloads, ref, got


def test_device_matched_frames_equal_reference(device_matched):
    payloads, ref, got = device_matched
    for i in range(len(payloads)):
        assert got[i] == ref[i], f"case {i}"
    text = payloads[0]
    assert len(got[0]) < len(text) // 2   # compressible text compresses


@pytest.mark.parametrize("matcher", ["host", "device"])
def test_frames_decode_with_libzstd_and_port_decoder(device_matched,
                                                     matcher):
    payloads, _, frames = device_matched
    if matcher == "host":
        frames = BatchEncoder(device=CPU).compress_frames(payloads)
    dctx = zstandard.ZstdDecompressor()
    for p, z in zip(payloads, frames):
        assert dctx.decompress(z, max_output_size=max(1, len(p))) == p
    dec = BatchDecoder(device=CPU)
    assert dec.decode_frames(frames) == payloads
    assert dec.host_frames == 0


def test_device_matcher_keeps_one_batch():
    """precompute keeps the results of its own batch only; find parses an
    unseen block on its own and keeps it beside them."""
    a, b, c = [p for p in seeded_payloads() if len(p) >= 8][:3]
    dm = DeviceMatcher(device=CPU)
    dm.precompute([a, b, a])
    assert set(dm._cache) == {a, b}
    assert dm.last_stats["blocks"] == 2 and dm.last_stats["records"] > 0
    assert {"device_s", "records_s"} <= set(dm.last_stats)
    dm.precompute([c])
    assert set(dm._cache) == {c}
    seqs = dm.find(a)
    assert set(dm._cache) == {a, c}
    assert b"".join(s.literals for s in seqs) != a  # a has matches
    (short,) = dm.find(b"short")  # under 8 bytes: one literal run
    assert short.literals == b"short" and short.match_len == 0
    assert dm.find(b"") == []


def _word_block(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta"]
    return b" ".join(words[i] for i in rng.integers(0, 6, n // 4 + 1))[:n]


MATCHER_BATCHES = {
    # 1 KiB, 3 KiB and 100 KiB blocks: three widths, one round each
    "mixed_widths": [_word_block(n, s) for s, n in enumerate(
        [1024, 700, 3072, 2500, 100 << 10, 1024])],
    # more than 512 blocks of one width, beside a few of the next one
    "over_512_lanes": [_word_block(900 + s % 100, s) for s in range(530)]
    + [_word_block(1500 + s, 1000 + s) for s in range(6)],
}


@pytest.mark.parametrize("name", sorted(MATCHER_BATCHES))
def test_device_matcher_rounds_by_width(name, monkeypatch):
    """Blocks go in rounds of at most 512 lanes, each at the pow2 width of
    its own blocks (at least 1024), and the records equal a one-call parse
    of the whole batch at its widest width."""
    from zstd_tpu_torch.encoding import device_matcher

    blocks = MATCHER_BATCHES[name]
    ll, ml, of, nseq, anchor = match_finder.parse_blocks(
        *device_matcher.block_lanes(blocks, CPU))
    want = {b: device_matcher._to_sequences(
        b, ll[i].numpy(), ml[i].numpy(), of[i].numpy(), int(nseq[i]),
        int(anchor[i])) for i, b in enumerate(blocks)}
    calls = []

    def recorder(data, n_valid):
        calls.append((data.shape, n_valid.tolist()))
        return match_finder.parse_blocks(data, n_valid)

    monkeypatch.setattr(device_matcher, "parse_blocks", recorder)
    dm = DeviceMatcher(device=CPU)
    dm.precompute(blocks)
    assert dm.last_stats["blocks"] == len(blocks)
    assert dm.last_stats["records"] == int(nseq.sum())
    assert all(dm.find(b) == want[b] for b in blocks)
    assert len(calls) == len(device_matcher.rounds(blocks)) > 1
    for (lanes, width), n_valid in calls:
        assert lanes == len(n_valid) <= 512
        assert {max(1 << (n - 1).bit_length(), 1024)
                for n in n_valid} == {width}
    assert sorted(n for _, nv in calls for n in nv) == \
        sorted(map(len, blocks))


def test_encoder_and_matcher_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchEncoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceMatcher()


def test_lazy_export():
    import zstd_tpu_torch

    assert zstd_tpu_torch.BatchEncoder is BatchEncoder
