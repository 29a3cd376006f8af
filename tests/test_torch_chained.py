"""Chained frames in zstd_tpu_torch against zstd_tpu, on the CPU.

A frame is chained when the framer splits it into several block groups, or
when its dictionary content seeds its history. Both packages' caps modules
shrink the group caps and the near/far window line to KiB sizes (CAPS: 32
KiB groups, far past a 16 KiB window), so near-window, far-window and
dictionary chains run here in seconds. The same inputs, made from seeds
with numpy or framed from libzstd frames, go through each package, and
everything is compared exactly:

  - symbolic repeat-offset resolution (resolve_offsets_symbolic,
    apply_hist, compose_hist) and the chained resolution of a real batch
    (_resolve_chained);
  - the windowed executor's plain version (execute_window_plain) against
    the byte loop of random chains, against zstd_tpu's execute_window_xla
    (near and far forms) and against execute_window_pallas in interpret
    mode (near, far and dictionary), each driven group by group; and the
    hand-made chains the GPU tests give the kernel (a ~60,000-byte-deep
    chain, matches at the exact edge of their reach and one byte past it,
    a broken middle group, prefill-only sources) through the plain
    version, a byte loop and execute_window_xla;
  - the whole slice: BatchDecoder(device="cpu") on near, far, dictionary,
    mixed near+far and corrupted chained frames beside single-group ones,
    against zstd_tpu's BatchDecoder, the host oracle and libzstd, with no
    frame sent to the host, one poisoned lane only, and serving-mode
    handles giving the same bytes; stage() taking the reference framer's
    batch; the committed dictionary frames of zstd_tpu_torch/testdata.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard

from test_torch_framer import _text as vocab_text
from test_torch_framer import mixed_frames
from test_torch_kernels_cuda import WINDOW_SETS, random_chains, window_args
from zstd_tpu.models import batch_decoder as ref_bd
from zstd_tpu.models.framer import Framer as RefFramer
from zstd_tpu.ops import sequence as ref_seq
from zstd_tpu.ops.execute import execute_window_xla
from zstd_tpu.ops.pallas_execute import execute_window_pallas
from zstd_tpu.oracle.dictionary import Dictionary as RefDictionary
from zstd_tpu.utils import caps as ref_caps
from zstd_tpu_torch.common import constants as C
from zstd_tpu_torch.models import batch_decoder as bd
from zstd_tpu_torch.models.framer import DeviceBatch
from zstd_tpu_torch.oracle import Dictionary, decode_all
from zstd_tpu_torch.oracle import blocks as blocks_mod
from zstd_tpu_torch.oracle import frame as frame_mod
from zstd_tpu_torch.ops import execute_window as ew
from zstd_tpu_torch.ops import sequence
from zstd_tpu_torch.testdata import load_dict_fixture, matches_digest
from zstd_tpu_torch.utils import caps

GW = 8192  # group output width handed to the reference executors


# the TINY caps with the near/far line at a 16 KiB window: far frames then
# have 32 KiB blocks, and the plain sequence stage few steps per lane
CAPS = dict(caps.TINY, stream_window=1 << 14)


@pytest.fixture(scope="module")
def tiny():
    """Both packages at CAPS; restored after the module."""
    old = caps.set_caps(**CAPS)
    ref_caps.set_caps(**CAPS)
    yield
    ref_caps.restore_caps(old)
    caps.restore_caps(old)


# ---- symbolic and chained resolution ----------------------------------------

def _lanes(seed, B=12, S=200):
    rng = np.random.default_rng(seed)
    ll = rng.integers(0, 4, (B, S)).astype(np.int32)
    ofv = np.where(rng.random((B, S)) < 0.5, rng.integers(1, 4, (B, S)),
                   rng.integers(4, 900, (B, S))).astype(np.int32)
    real = rng.random((B, S)) < 0.85
    ofv = np.where(real, ofv, rng.integers(0, 9, (B, S))).astype(np.int32)
    hist = rng.integers(1, 2000, (B, 3)).astype(np.int32)
    return ll, ofv, real, hist


@pytest.mark.parametrize("seed", [0, 1])
def test_symbolic_resolution_matches_reference(seed):
    ll, ofv, real, hist = _lanes(seed)
    got = sequence.resolve_offsets_symbolic(
        torch.from_numpy(ll), torch.from_numpy(ofv), torch.from_numpy(real))
    ref = ref_seq.resolve_offsets_symbolic(jnp.asarray(ll), jnp.asarray(ofv),
                                           jnp.asarray(real))
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    tag, val, tt, tv = got
    h = torch.from_numpy(hist)
    assert np.array_equal(
        sequence.apply_hist(tag, val, h).numpy(),
        np.asarray(ref_seq.apply_hist(*(jnp.asarray(x.numpy())
                                        for x in (tag, val, h)))))
    assert np.array_equal(
        sequence.compose_hist(tt, tv, h).numpy(),
        np.asarray(ref_seq.compose_hist(*(jnp.asarray(x.numpy())
                                          for x in (tt, tv, h)))))
    # resolution is symbolic resolution followed by apply_hist
    off, ok = sequence.resolve_offsets(*(torch.from_numpy(x) for x in
                                         (ll, ofv, real, hist)))
    assert torch.equal(off, sequence.apply_hist(tag, val, h))


# ---- frames -----------------------------------------------------------------

def _words(n, seed):
    rng = np.random.RandomState(seed)
    words = [b"tok%03d " % i for i in range(257)]
    return b"".join(words[i] for i in rng.randint(0, 257, n * 2))[:n]


def _zstd(data, window_log, dict_data=None, stream=False):
    params = zstandard.ZstdCompressionParameters(
        window_log=window_log, compression_level=3, write_checksum=1,
        write_dict_id=1)
    cctx = zstandard.ZstdCompressor(compression_params=params,
                                    dict_data=dict_data)
    if stream:  # no content size in the header
        cobj = cctx.compressobj()
        return cobj.compress(data) + cobj.flush()
    return cctx.compress(data)


def _break_block(frame: bytes, block: int) -> bytes:
    """The frame with the last byte of block `block` zeroed: its sequence
    bitstream loses its padding sentinel, which the device flags."""
    header = frame_mod.parse_frame_header(frame)
    pos = header.header_size
    for _ in range(block):
        bh = blocks_mod.parse_block_header(frame[pos:pos + 3])
        pos += 3 + (1 if bh.block_type == C.BLOCK_RLE else bh.block_size)
    bh = blocks_mod.parse_block_header(frame[pos:pos + 3])
    assert bh.block_type == C.BLOCK_COMPRESSED
    bad = bytearray(frame)
    bad[pos + 3 + bh.block_size - 1] = 0
    return bytes(bad)


@pytest.fixture(scope="module")
def chained(tiny):
    """(frames, payloads, dict_bytes, kinds) at the tiny caps: each kind
    names what the frame exercises."""
    base_frames, base_payloads, dict_bytes = mixed_frames()
    zd = zstandard.ZstdCompressionDict(dict_bytes)
    rng = np.random.default_rng(5)
    near = _words(60 << 10, 7)
    # re-quotes 20-30 KiB back: past the 16 KiB line, inside the window
    head = _words(40 << 10, 9)
    far = head + head[14 << 10:26 << 10] + _words(3 << 10, 10) \
        + head[30 << 10:38 << 10]
    near16 = _words(40 << 10, 11)
    dict_far = vocab_text(rng, 100 << 10)
    dict_near = vocab_text(rng, 40 << 10)
    kinds = ["single", "near", "far", "near16", "dict_far", "dict_near",
             "corrupt", "single", "single_dict", "dict_prefill", "single"]
    frames = [base_frames[0], _zstd(near, 13), _zstd(far, 15, stream=True),
              _zstd(near16, 14), _zstd(dict_far, 15, zd, stream=True),
              _zstd(dict_near, 13, zd, stream=True),
              _break_block(_zstd(near, 13), 5), base_frames[3],
              base_frames[7], base_frames[8], base_frames[9]]
    payloads = [base_payloads[0], near, far, near16, dict_far, dict_near,
                None, base_payloads[3], base_payloads[7], base_payloads[8],
                base_payloads[9]]
    return frames, payloads, dict_bytes, kinds


@pytest.fixture(scope="module")
def port_batch(chained):
    frames, _, dict_bytes, _ = chained
    dec = bd.BatchDecoder(device="cpu")
    dec.add_dict(dict_bytes)
    return dec, dec.prepare(frames)


def test_tiny_caps_frame_chains_in_both_packages(chained, port_batch):
    frames, _, dict_bytes, kinds = chained
    _, got = port_batch
    d = RefDictionary.decode_dict(dict_bytes)
    fr = RefFramer(dicts={d.dict_id: d})
    for i, f in enumerate(frames):
        fr.add_frame(f, i)
    ref = fr.build()
    for field in dataclasses.fields(DeviceBatch):
        a, b = getattr(got, field.name), getattr(ref, field.name)
        if field.name == "metas":
            assert [dataclasses.asdict(m) for m in a] == \
                [dataclasses.asdict(m) for m in b]
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, b), field.name
        else:
            assert a == b, field.name
    from zstd_tpu_torch.models.framer import STREAM_WINDOW_CAP

    metas = dict(zip(kinds, got.metas))
    for k in ("near", "far", "near16", "dict_far", "dict_near"):
        assert len(metas[k].rows) > 1 and not metas[k].fallback, k
    assert metas["far"].window > STREAM_WINDOW_CAP >= metas["near"].window
    assert metas["dict_far"].window > STREAM_WINDOW_CAP
    assert metas["dict_far"].dict_prefill and metas["dict_near"].dict_prefill
    assert metas["dict_prefill"].dict_prefill
    assert len(metas["dict_prefill"].rows) == 1
    plan = bd.chain_plan(got)
    far = [int(m.window) for m in bd.chained_metas(got)
           if m.window > STREAM_WINDOW_CAP]
    caps_ = [int(c) for g in plan["groups"] for c in g["cap"]]
    assert sorted(c for c in caps_ if c > STREAM_WINDOW_CAP) == sorted(far)
    assert max(int(g["hist0"].max()) for g in plan["groups"]) == \
        max(g["base"] for g in plan["groups"]) > 0


def _stages(d):
    """The port's entropy stages on a staged batch (plain versions)."""
    from zstd_tpu_torch.ops import huffman

    lit = d["lit_base"].clone()
    ll, ml, of = (d[k].clone() for k in ("ll_base", "ml_base", "of_base"))
    ok = torch.ones(lit.shape[0], dtype=torch.bool)
    huffman.huffman_lanes(*[d[k] for k in (
        "huff_streams", "huff_pos", "huff_tid", "huff_nsym", "huff_dst_frame",
        "huff_dst_off", "huff_tables", "huff_maxbits")], lit, ok)
    sequence.sequence_lanes(*[d[k] for k in (
        "seq_streams", "seq_pos", "seq_n", "ll_tid", "of_tid", "ml_tid",
        "ll_tables", "of_tables", "ml_tables", "ll_logs", "of_logs",
        "ml_logs", "seq_dst_frame", "seq_dst_off", "seq_lit_total",
        "seq_trail_slot")], ll, ml, of, ok)
    return lit, ll, ml, of, ok


def test_resolve_chained_matches_reference(port_batch):
    dec, batch = port_batch
    d = dec.stage(batch)
    _, ll, ml, of, _ = _stages(d)
    offsets, out_len, ok = bd._resolve_chained(
        ll, ml, of, d["is_real"], d["init_hist"], d["chain_rows"],
        d["chain_row_cont"])
    cont = np.zeros(batch.lit_base.shape[0], bool)
    for m in batch.metas:
        cont[m.rows[1:]] = True
    assert np.array_equal(cont, d["chain_row_cont"].numpy())
    r_off, r_len, r_ok, _ = ref_bd._resolve_chained(
        *(jnp.asarray(x.numpy()) for x in (ll, ml, of, d["is_real"],
                                           d["init_hist"])),
        jnp.asarray(cont))
    assert np.array_equal(offsets.numpy(), np.asarray(r_off))
    assert np.array_equal(out_len.numpy(), np.asarray(r_len))
    assert np.array_equal(ok.numpy(), np.asarray(r_ok))
    # continuation rows really carry a history: resolving every row from
    # its own initial history gives other offsets
    own, _, _ = bd._resolve(ll, ml, of, d["is_real"], d["init_hist"])
    assert not torch.equal(own, offsets)


SUB_BATCHES = {"chained": ("near", "near16", "single", "corrupt"),
               "far": ("far", "single"),
               "dict": ("dict_far", "dict_near", "dict_prefill",
                        "single_dict")}


@pytest.mark.parametrize("name", sorted(SUB_BATCHES))
def test_resolve_frames_matches_reference_on_sub_batches(chained, name):
    """The stage-2 wrapper's CPU path on the chained, far and dictionary
    frames of the tiny-caps batch (each batch with single-group frames
    beside them) against zstd_tpu's _resolve_chained."""
    frames, _, dict_bytes, kinds = chained
    pick = [f for f, k in zip(frames, kinds) if k in SUB_BATCHES[name]]
    dec = bd.BatchDecoder(device="cpu")
    dec.add_dict(dict_bytes)
    batch = dec.prepare(pick)
    d = dec.stage(batch)
    assert d["chains"] is not None
    _, ll, ml, of, _ = _stages(d)
    got = sequence.resolve_frames(ll, ml, of, d["is_real"], d["init_hist"],
                                  d["chain_rows"], d["chain_row_cont"])
    ref = ref_bd._resolve_chained(
        *(jnp.asarray(x.numpy()) for x in (ll, ml, of, d["is_real"],
                                           d["init_hist"],
                                           d["chain_row_cont"])))
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if name == "far":
        from zstd_tpu_torch.models.framer import STREAM_WINDOW_CAP

        assert max(int(g["cap"].max()) for g in d["chains"]) > \
            STREAM_WINDOW_CAP


def test_single_group_rows_execute_at_their_own_width(chained, port_batch):
    """Small single-group frames beside chained ones execute at the width
    of their own bounds, not the chained frames' (the batch's), with the
    same bytes."""
    frames, payloads, _, kinds = chained
    dec, batch = port_batch
    d = dec.stage(batch)
    rows = d["exec_rows_list"]
    own = max(int(batch.out_len[r]) for r in rows)
    assert d["exec_width"] == 1 << (own - 1).bit_length()
    assert d["exec_width"] < batch.out_width
    outputs, out_len, ok = dec.run_device(batch, d, pull_outputs=False)
    for m, p, k in zip(batch.metas, payloads, kinds):
        r = m.rows[0]
        if r in rows:
            t, i = outputs[r]
            assert t.shape[1] == d["exec_width"]
            assert bool(ok[r])
            assert t[i, m.dict_skip:int(out_len[r])].numpy().tobytes() == p


# ---- the windowed executor --------------------------------------------------

def _drive(inputs, step):
    """Every chain group by group through `step(row, hist, avail, cap)` ->
    (ok, group bytes), stopping a chain at its first bad group; returns
    (acc, written, ok) as execute_window gives them."""
    acc = inputs["acc"].copy()
    base, plan = inputs["base"], inputs["plan"]
    inert = inputs["ll"].shape[0] - 1
    written, oks = [], []
    for c in range(plan.shape[0]):
        w, ok = 0, True
        for row in plan[c]:
            if row == inert:
                break
            avail = min(w + int(inputs["hist0"][c]), int(inputs["cap"][c]))
            ok, group = step(int(row), acc[c, :base + w], avail,
                             int(inputs["cap"][c]))
            if not ok:
                break
            acc[c, base + w:base + w + len(group)] = group
            w += len(group)
        written.append(w)
        oks.append(ok)
    return acc, written, oks


def _records(inputs, row):
    return [jnp.asarray(inputs[k][row:row + 1])
            for k in ("ll", "ml", "offset", "lit", "out_len")]


def _window(hist, W):
    win = np.zeros(W, np.uint8)
    tail = hist[-W:]
    win[W - len(tail):] = tail
    return jnp.asarray(win[None])


def _xla_step(inputs, far: bool):
    def step(row, hist, avail, cap):
        ll, ml, off, lits, olen = _records(inputs, row)
        n = int(inputs["out_len"][row])
        av = jnp.asarray([avail], jnp.int32)
        if far:
            acc = np.zeros(inputs["acc"].shape[1], np.uint8)
            acc[:len(hist)] = hist
            new, ok = execute_window_xla(
                ll, ml, off, lits, olen, av, out_width=GW, window=0,
                acc=jnp.asarray(acc[None]),
                written=jnp.asarray([len(hist)], jnp.int32))
            return bool(ok[0]), np.asarray(new)[0, len(hist):len(hist) + n]
        out, ok = execute_window_xla(ll, ml, off, lits, olen, av,
                                     out_width=GW, window=cap,
                                     win=_window(hist, cap))
        return bool(ok[0]), np.asarray(out)[0, :n]
    return step


def _pallas_step(inputs, prefix: int):
    """execute_window_pallas as zstd_tpu's chained-frame loop calls it:
    a near chain's window is its cap; a far chain (cap > `prefix`) keeps a
    `prefix`-byte window and reads far matches from a stream gathered from
    its accumulator (reference layout: `prefix` lead bytes)."""
    def step(row, hist, avail, cap):
        ll, ml, off, lits, olen = _records(inputs, row)
        n = int(inputs["out_len"][row])
        av = jnp.asarray([avail], jnp.int32)
        if cap <= prefix:
            out, ok = execute_window_pallas(
                ll, ml, off, lits, olen, _window(hist, cap), av,
                out_width=GW, window=cap, interpret=True)
            return bool(ok[0]), np.asarray(out)[0, :n]
        w = len(hist) - inputs["base"]
        acc = np.zeros(prefix + inputs["acc"].shape[1], np.uint8)
        acc[:prefix] = np.asarray(_window(hist[:inputs["base"]], prefix))[0]
        acc[prefix:prefix + w] = hist[inputs["base"]:]
        written = jnp.asarray([prefix + w], jnp.int32)
        mlf, fend, fsb, src0 = ref_bd._far_prep(ll, ml, off, written,
                                                W=prefix)
        fw = max(128, -(-int(np.asarray(mlf).sum()) // 128) * 128)
        far = ref_bd._far_gather(jnp.asarray(acc[None]), mlf, fend, src0,
                                 Fw=fw)
        out, ok = execute_window_pallas(
            ll, ml, off, lits, olen, _window(hist, prefix), av,
            out_width=GW, window=prefix, interpret=True, far_bytes=far,
            fsb=fsb)
        return bool(ok[0]), np.asarray(out)[0, :n]
    return step


def _plain(inputs):
    args = window_args(inputs, "cpu")
    written, ok = ew.execute_window_plain(*args)
    return args[7].numpy(), written.tolist(), ok.tolist()


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_window_plain_matches_byte_loop(seed):
    inputs, exp = random_chains(seed)
    acc, written, ok = _plain(inputs)
    assert np.array_equal(acc, exp["acc"])
    assert written == exp["written"] and ok == exp["ok"]
    assert ok.count(False) == 2
    # the CPU wrapper is the plain version
    args = window_args(inputs, "cpu")
    before = ew.execute_window.launches
    assert [t.tolist() for t in ew.execute_window(*args)] == [written, ok]
    assert ew.execute_window.launches == before


@pytest.mark.parametrize("form", ["near", "far"])
def test_window_plain_matches_xla(form):
    inputs, _ = random_chains(6, S=48)
    if form == "near":
        # near chains only: their cap is the window the near form copies
        keep = np.flatnonzero(inputs["cap"] <= 512)
        inputs = dict(inputs, plan=inputs["plan"][keep],
                      acc=inputs["acc"][keep], hist0=inputs["hist0"][keep],
                      cap=inputs["cap"][keep])
    got = _plain(inputs)
    ref = _drive(inputs, _xla_step(inputs, far=form == "far"))
    assert np.array_equal(got[0], ref[0])
    assert got[1:] == ref[1:]
    assert False in got[2] and True in got[2]


def test_window_plain_matches_pallas_interpret():
    """Near chains (a dictionary prefill on two of them, one with a bad
    offset, one past its cap) and a far chain, KiB-sized."""
    inputs, _ = random_chains(8, n_chains=4, groups=2, S=16)
    assert inputs["cap"][0] > 512 and inputs["hist0"][1:3].min() > 0
    got = _plain(inputs)
    ref = _drive(inputs, _pallas_step(inputs, prefix=512))
    assert np.array_equal(got[0], ref[0])
    assert got[1:] == ref[1:]
    assert got[2] == [True, False, False, True]


EDGE_OK = {"deep": [True], "prefill": [True, True],
           "reach": [True, False, True, False, True, False, False]}


@pytest.mark.parametrize("name", sorted(WINDOW_SETS))
def test_window_plain_matches_byte_loop_on_edge_chains(name):
    inputs, exp = WINDOW_SETS[name]()
    acc, written, ok = _plain(inputs)
    assert np.array_equal(acc, exp["acc"])
    assert written == exp["written"] and ok == exp["ok"] == EDGE_OK[name]
    if name == "reach":
        # chains 1 and 5 stop in their first group, 3 and 6 in their second
        assert [written[i] for i in (1, 3, 5, 6)] == [0, 100, 0, 24]
    if name == "deep":
        assert written == [240004]


@pytest.mark.parametrize("name", sorted(WINDOW_SETS))
def test_window_byte_loop_matches_xla_on_edge_chains(name):
    inputs, exp = WINDOW_SETS[name]()
    acc, written, ok = _drive(inputs, _xla_step(inputs, far=True))
    assert np.array_equal(acc, exp["acc"])
    assert written == exp["written"] and ok == exp["ok"]


# ---- the whole slice --------------------------------------------------------

def _oracle(frame, dict_bytes):
    try:
        return decode_all(frame, dicts=[Dictionary.decode_dict(dict_bytes)])
    except Exception:
        return None


@pytest.fixture(scope="module")
def decoded(chained):
    frames, _, dict_bytes, _ = chained
    dec = bd.BatchDecoder(device="cpu")
    dec.add_dict(dict_bytes)
    return dec, dec.decode_frames(frames)


def test_chained_decode_matches_payloads_oracle_and_libzstd(chained,
                                                            decoded):
    frames, payloads, dict_bytes, kinds = chained
    dec, out = decoded
    zd = zstandard.ZstdCompressionDict(dict_bytes)
    for i, (f, p, got) in enumerate(zip(frames, payloads, out)):
        assert got == p, kinds[i]
        assert got == _oracle(f, dict_bytes), kinds[i]
        if p is not None:
            d = zstandard.ZstdDecompressor(dict_data=zd)
            assert d.decompressobj().decompress(f) == got, kinds[i]
    assert dec.host_frames == 0


def test_chained_decode_matches_reference_decoder(chained, decoded):
    frames, _, dict_bytes, _ = chained
    ref = ref_bd.BatchDecoder()
    ref.add_dict(dict_bytes)
    assert decoded[1] == ref.decode_frames(frames)


def test_corrupted_chain_poisons_only_its_lane(chained, port_batch):
    frames, payloads, _, kinds = chained
    dec, batch = port_batch
    outputs, out_len, ok = dec.run_device(batch)
    bad = kinds.index("corrupt")
    assert len(batch.metas[bad].rows) > 1
    assert [i for i, m in enumerate(batch.metas)
            if not bool(ok[m.rows[0]])] == [bad]
    for m, p in zip(batch.metas, payloads):
        r = m.rows[0]
        if p is not None:
            assert outputs[r][m.dict_skip:int(out_len[r])].tobytes() == p


def test_serving_handles_give_the_same_bytes(chained, port_batch):
    frames, payloads, _, kinds = chained
    dec, batch = port_batch
    staged = dec.stage(batch)
    runs = [dec.run_device(batch, staged, pull_outputs=False)]
    runs += list(dec.decode_frames_pipelined([frames], pull_outputs=False,
                                             prestaged=staged))
    for outputs, out_len, ok in runs:
        for m, p, k in zip(batch.metas, payloads, kinds):
            r = m.rows[0]
            if p is None:
                continue
            assert bool(ok[r]), k
            if len(outputs[r]) == 3:
                acc, lane, base = outputs[r]
                got = acc[lane, base:base + int(out_len[r])]
            else:
                t, i = outputs[r]
                got = t[i, m.dict_skip:int(out_len[r])]
            assert got.numpy().tobytes() == p, k
    assert dec.host_frames == 0


def test_chains_execute_in_width_groups(chained, port_batch, monkeypatch):
    """One long chained frame beside several short ones: each width group
    of chains gets its own window call and accumulator, whose bytes sum to
    less than every chain at the widest width; the batch decodes to the
    payloads and the oracle's bytes, its serving handles give the same
    bytes, and the resolution keeps the whole batch's rows."""
    frames, payloads, dict_bytes, kinds = chained
    dec, batch = port_batch
    plan = bd.chain_plan(batch)
    groups = plan["groups"]
    C = plan["rows"].shape[0]
    assert len(groups) > 1
    assert sum(len(g["first"]) for g in groups) == C
    for g in groups:
        assert g["rows"].shape[0] == g["hist0"].shape[0] == len(g["first"])
        assert g["prefill"].shape == (len(g["first"]), g["base"])
        assert g["base"] == int(g["hist0"].max())
    by_first = {m.rows[0]: m for m in bd.chained_metas(batch)}
    keys = [{1 << (len(by_first[r].dict_prefill) - 1 + sum(
        int(batch.out_len[x]) for x in by_first[r].rows)).bit_length()
        for r in g["first"]} for g in groups]
    assert all(len(k) == 1 for k in keys)
    assert len(set.union(*keys)) == len(groups)
    widths = [g["width"] for g in groups]
    assert widths == sorted(widths) and widths[0] < widths[-1]
    assert sum(len(g["first"]) * g["width"] for g in groups) < \
        C * max(widths)
    first_rows = sorted(r for g in groups for r in g["first"])
    assert first_rows == sorted(int(r) for r in plan["rows"][:, 0])

    calls = []
    real = ew.execute_window

    def recorder(*args, **kw):
        calls.append(args[7].shape)
        return real(*args, **kw)

    monkeypatch.setattr(bd, "execute_window", recorder)
    got = dec.decode_frames(frames)
    staged = dec.stage(batch)
    outputs, out_len, ok = dec.run_device(batch, staged, pull_outputs=False)
    assert calls == [(len(g["first"]), g["width"]) for g in groups] * 2
    assert staged["chain_rows"].shape == plan["rows"].shape
    for i, (f, p) in enumerate(zip(frames, payloads)):
        assert got[i] == p == _oracle(f, dict_bytes), kinds[i]
    for m, p, k in zip(batch.metas, payloads, kinds):
        r = m.rows[0]
        if p is None or len(outputs[r]) != 3:
            continue
        acc, lane, base = outputs[r]
        assert bool(ok[r]), k
        assert acc[lane, base:base + int(out_len[r])].numpy().tobytes() \
            == p, k
    assert dec.host_frames == 0


def test_stage_takes_the_reference_framers_batch_with_chains(chained,
                                                             decoded):
    frames, _, dict_bytes, _ = chained
    d = RefDictionary.decode_dict(dict_bytes)
    fr = RefFramer(dicts={d.dict_id: d})
    for i, f in enumerate(frames):
        fr.add_frame(f, i)
    batch = fr.build()
    dec = bd.BatchDecoder(device="cpu")
    dec.add_dict(dict_bytes)
    outputs, out_len, ok = dec.run_device(batch)
    assert dec._postprocess(frames, batch, outputs, out_len, ok) == \
        decoded[1]


@pytest.fixture
def default_caps():
    """Both packages at their production caps for one test."""
    old = caps.set_caps(**caps.DEFAULTS)
    ref_caps.set_caps(**caps.DEFAULTS)
    yield
    ref_caps.restore_caps(old)
    caps.restore_caps(old)


def test_dictionary_fixture_decodes_everywhere(default_caps):
    """The committed dictionary frames (no content size, the last one two
    block groups) against the host oracle, both packages and libzstd; the
    first group's matches reach into the dictionary."""
    raw, frames, digests = load_dict_fixture()
    dec = bd.BatchDecoder(device="cpu")
    dec.add_dict(raw)
    batch = dec.prepare(frames)
    assert [len(m.rows) for m in batch.metas] == [1, 1, 2]
    assert all(m.dict_prefill and not m.fallback for m in batch.metas)
    out = dec.decode_frames(frames)
    assert all(matches_digest(o, dg) for o, dg in zip(out, digests))
    assert out == [_oracle(f, raw) for f in frames]
    ref = ref_bd.BatchDecoder()
    ref.add_dict(raw)
    assert ref.decode_frames(frames) == out
    zd = zstandard.ZstdCompressionDict(raw)
    assert [zstandard.ZstdDecompressor(dict_data=zd).decompressobj()
            .decompress(f) for f in frames] == out
    assert dec.host_frames == 0
    d = dec.stage(batch)
    _, ll, ml, of, _ = _stages(d)
    offsets, _, _ = bd._resolve_chained(ll, ml, of, d["is_real"],
                                        d["init_hist"], d["chain_rows"],
                                        d["chain_row_cont"])
    r = batch.metas[2].rows[0]
    before = torch.cumsum(ll[r].long() + ml[r].long(), 0) - ml[r].long()
    assert bool(((ml[r] > 0) & (offsets[r].long() > before)).any())


def test_other_entry_points_decode_chains(chained):
    """decode_all_device on a stream of chained frames, and the pipelined
    loop with pulled outputs."""
    from zstd_tpu_torch.models.splitter import decode_all_device

    frames, payloads, dict_bytes, kinds = chained
    near, far = kinds.index("near"), kinds.index("far")
    assert decode_all_device(frames[near] + frames[far], device="cpu") == \
        payloads[near] + payloads[far]
    dec = bd.BatchDecoder(device="cpu")
    dec.add_dict(dict_bytes)
    got = list(dec.decode_frames_pipelined([frames[near:near + 1],
                                            frames[4:6]]))
    assert got == [payloads[near:near + 1], payloads[4:6]]
    assert dec.host_frames == 0
