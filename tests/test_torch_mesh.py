"""Decoding over a local mesh in zstd_tpu_torch against zstd_tpu, on the CPU.

A LocalMesh (parallel/mesh.py) names devices of one process; here they are
["cpu"] * n, and the reference runs on conftest's 8 CPU devices. The same
frames, from seeds with numpy and libzstd, go through both packages, and
everything is compared exactly:

  - BatchDecoder.stage(batch, mesh=) + run_device + _postprocess against
    zstd_tpu's stage(batch, mesh=make_mesh(n)) for n in 1, 2, 3 and 8, on
    tests/test_multichip_pipeline.py's 16 frames and on
    tests/test_torch_chained.py's tiny-caps batch (near, far, dictionary
    and corrupted chains beside single-group frames): ok on every frame
    row, out_len on every row that is ok (a failed chain's length is
    unspecified in the reference), the results against the payloads, only
    the corrupted lane None; out_len, ok and the bytes equal to the port's
    unsharded run on every row; serving handles (pull_outputs=False) and
    decode_frames(frames, mesh=) giving the same bytes;
  - split_batch: a frame's rows and lanes never span two shards, every
    row and live lane lands once, renumbered, with the inert row and lane
    closing each shard; shards balanced by output bytes;
  - sharded_decode over a LocalMesh against zstd_tpu's sharded_decode on
    make_mesh(n) for n in 1, 2 and 4 on the "example" and "corrupted"
    batches: arrays, padding rows and metrics;
  - the mesh rules: make_mesh without a group or a card raises, with
    devices= it is a LocalMesh.
"""

import numpy as np
import pytest
import torch
import zstandard

from test_multichip_pipeline import _payloads as mesh_payloads
from test_torch_chained import chained, tiny  # noqa: F401 (fixtures)
from test_torch_fused import corrupted_batch
from zstd_tpu.models import batch_decoder as ref_bd
from zstd_tpu.models import fused as ref_fused
from zstd_tpu.parallel import mesh as ref_mesh
from zstd_tpu_torch.models import batch_decoder as bd
from zstd_tpu_torch.parallel import LocalMesh, make_mesh, sharded_decode

SIZES = [1, 2, 3, 8]


@pytest.fixture(scope="module")
def simple():
    """tests/test_multichip_pipeline.py's 16 frames (libzstd level 3)."""
    payloads = mesh_payloads()
    comp = zstandard.ZstdCompressor(level=3)
    return [comp.compress(p) for p in payloads], payloads, None


def _decoders(dict_bytes):
    dec, ref = bd.BatchDecoder(device="cpu"), ref_bd.BatchDecoder()
    if dict_bytes is not None:
        dec.add_dict(dict_bytes)
        ref.add_dict(dict_bytes)
    return dec, ref


def _cases(request, name):
    if name == "simple":
        return request.getfixturevalue("simple")
    frames, payloads, dict_bytes, _ = request.getfixturevalue("chained")
    return frames, payloads, dict_bytes


@pytest.fixture(scope="module")
def unsharded():
    """run(name, dec, batch): the port's unsharded (outputs, out_len, ok)
    of batch `name`, run once."""
    runs = {}

    def run(name, dec, batch):
        if name not in runs:
            runs[name] = dec.run_device(batch)
        return runs[name]

    return run


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", ["simple", "chained"])
def test_mesh_stage_matches_reference(request, unsharded, name, n):
    frames, payloads, dict_bytes = _cases(request, name)
    dec, ref = _decoders(dict_bytes)
    batch = dec.prepare(frames)
    staged = dec.stage(batch, mesh=make_mesh(devices=["cpu"] * n))
    outputs, out_len, ok = dec.run_device(batch, staged)
    got = dec._postprocess(frames, batch, outputs, out_len, ok)

    ref_batch = ref.prepare(frames)
    r_staged = ref.stage(ref_batch, mesh=ref_mesh.make_mesh(n))
    r_out, r_len, r_ok = ref.run_device(ref_batch, r_staged)
    rows = batch.lit_base.shape[0] - 1
    assert len(out_len) == len(ok) == rows
    assert np.array_equal(ok, np.asarray(r_ok)[:rows])
    # a failed chain's first row has an unspecified length in the
    # reference; the port's equals its unsharded run's
    assert np.array_equal(out_len[ok], np.asarray(r_len)[:rows][ok])
    assert got == payloads
    assert got == ref._postprocess(frames, ref_batch, r_out, r_len, r_ok)
    assert dec.host_frames == 0
    # the corrupted chain poisons its own lane and no other
    bad = [i for i, m in enumerate(batch.metas) if not ok[m.rows[0]]]
    assert bad == [i for i, p in enumerate(payloads) if p is None]

    one_out, one_len, one_ok = unsharded(name, dec, batch)
    assert np.array_equal(out_len, one_len)
    assert np.array_equal(ok, one_ok)
    for r in (m.rows[0] for m in batch.metas if ok[m.rows[0]]):
        assert np.array_equal(outputs[r][:out_len[r]],
                              one_out[r][:one_len[r]])


def test_mesh_serving_handles_give_the_same_bytes(chained):  # noqa: F811
    frames, payloads, dict_bytes, kinds = chained
    dec, _ = _decoders(dict_bytes)
    batch = dec.prepare(frames)
    staged = dec.stage(batch, mesh=make_mesh(devices=["cpu"] * 3))
    runs = [dec.run_device(batch, staged, pull_outputs=False)]
    runs += list(dec.decode_frames_pipelined([frames], pull_outputs=False,
                                             prestaged=staged))
    for outputs, out_len, ok in runs:
        for m, p, k in zip(batch.metas, payloads, kinds):
            r = m.rows[0]
            if p is None:
                assert not ok[r], k
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


def test_decode_frames_over_a_mesh(simple):
    frames, payloads, _ = simple
    dec = bd.BatchDecoder(device="cpu")
    mesh = make_mesh(devices=["cpu"] * 3)
    assert dec.decode_frames(frames, mesh=mesh) == payloads
    truncated = frames[0][:len(frames[0]) // 2]
    assert dec.decode_frames([truncated] + frames, mesh=mesh) == \
        [None] + payloads
    assert dec.host_frames == 0


@pytest.mark.parametrize("n", [2, 3, 5, 8, 40])
def test_frames_never_span_shards(chained, n):  # noqa: F811
    """Each frame's rows and lanes go to one shard, renumbered to it; every
    row and live lane lands once; blocks are contiguous in frame order,
    balanced by output bytes, and a shard with no frame is None."""
    frames, _, dict_bytes, _ = chained
    dec, _ = _decoders(dict_bytes)
    batch = dec.prepare(frames)
    parts = bd.split_batch(batch, n)
    assert len(parts) == n
    if n > len(frames):
        assert None in parts
    owner = {}
    seen = {"huff": [], "seq": []}
    for k, part in enumerate(parts):
        if part is None:
            continue
        sub, rows = part
        assert list(rows) == sorted(rows)
        assert sub.lit_base.shape[0] == len(rows) + 1
        assert np.array_equal(sub.lit_base[:-1], batch.lit_base[rows])
        assert not sub.lit_base[-1].any() and sub.row_meta[-1] == -1
        for m in sub.metas:
            global_rows = [int(rows[r]) for r in m.rows]
            owner.setdefault(m.index, set()).add(k)
            assert global_rows == batch.metas[m.index].rows
            assert (sub.row_meta[m.rows] == sub.metas.index(m)).all()
        for kind, count in (("huff", "huff_nsym"), ("seq", "seq_n")):
            dst = getattr(sub, f"{kind}_dst_frame")
            live = getattr(sub, count)[:-1] > 0
            assert getattr(sub, count)[-1] == 0
            assert ((dst[:-1] >= 0) & (dst[:-1] < len(rows))).all()
            streams = getattr(sub, f"{kind}_streams")[:-1]
            seen[kind] += [(int(rows[f]), s.tobytes())
                           for f, s in zip(dst[:-1][live], streams[live])]
    with_rows = [m.index for m in batch.metas if m.rows]
    assert sorted(owner) == with_rows
    assert all(len(s) == 1 for s in owner.values())
    order = [min(owner[i]) for i in with_rows]
    assert order == sorted(order)
    for kind, count in (("huff", "huff_nsym"), ("seq", "seq_n")):
        dst = getattr(batch, f"{kind}_dst_frame")[:-1]
        live = getattr(batch, count)[:-1] > 0
        streams = getattr(batch, f"{kind}_streams")[:-1]
        assert sorted(seen[kind]) == sorted(
            (int(f), s.tobytes()) for f, s in zip(dst[live], streams[live]))


def test_split_balances_output_bytes():
    """A frame as long as all the others together gets a shard to itself
    at n = 2, and equal frames split evenly."""
    comp = zstandard.ZstdCompressor(level=1)
    small = [bytes([65 + i]) * 4096 for i in range(16)]
    frames = [comp.compress(b"x" * (16 * 4096 + 1))]
    frames += [comp.compress(p) for p in small]
    dec = bd.BatchDecoder(device="cpu")
    batch = dec.prepare(frames)
    parts = bd.split_batch(batch, 2)
    assert [len(p[1]) for p in parts] == [1, 16]
    parts = bd.split_batch(dec.prepare(frames[1:]), 4)
    assert [len(p[1]) for p in parts] == [4, 4, 4, 4]


@pytest.fixture(scope="module")
def batches():
    kw, static, _ = ref_fused.example_batch(8)
    ckw, cstatic, _, _ = corrupted_batch("sequence", n=11)
    return {"example": (kw, static), "corrupted": (ckw, cstatic)}


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("name", ["example", "corrupted"])
def test_local_sharded_decode_matches_reference(batches, name, n):
    kw, static = batches[name]
    ro, rl, rok, rm = ref_mesh.sharded_decode(kw, static,
                                              ref_mesh.make_mesh(n))
    po, pl, pok, pm = sharded_decode(kw, static,
                                     make_mesh(devices=["cpu"] * n))
    assert po.shape == np.asarray(ro).shape and po.dtype == ro.dtype
    assert np.array_equal(pl, np.asarray(rl))
    assert np.array_equal(pok, np.asarray(rok))
    assert {k: int(v) for k, v in pm.items()} == \
        {k: int(v) for k, v in rm.items()}
    good = np.asarray(rok)
    assert np.array_equal(po[good], np.asarray(ro)[good])
    assert not po[~good].any()
    if name == "corrupted":
        assert int(pm["frames_bad"]) == 1


def test_mesh_rules():
    """devices= gives a LocalMesh over exactly those devices; without them
    and without a group, the cards or an error, never the CPU."""
    m = make_mesh(devices=["cpu"] * 3)
    assert isinstance(m, LocalMesh)
    assert m.devices == (torch.device("cpu"),) * 3
    assert m.shape == {"dp": 3} == dict(ref_mesh.make_mesh(3).shape)
    assert make_mesh(2, axis="x", devices=["cpu", "cpu"]).shape == {"x": 2}
    with pytest.raises(ValueError, match="2 devices given"):
        make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="0 devices given"):
        make_mesh(devices=[])
    if torch.cuda.is_available():
        cards = torch.cuda.device_count()
        assert len(make_mesh().devices) == cards
        with pytest.raises(RuntimeError, match="CUDA cards"):
            make_mesh(cards + 1)
    else:
        with pytest.raises(RuntimeError, match="0 CUDA cards"):
            make_mesh()
        with pytest.raises(RuntimeError, match="0 CUDA cards"):
            make_mesh(1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(devices=["cuda:0", "cuda:0"])


def test_stage_refuses_what_is_not_a_local_mesh(simple):
    frames, _, _ = simple
    dec = bd.BatchDecoder(device="cpu")
    batch = dec.prepare(frames)
    with pytest.raises(TypeError, match="decode_frames_multihost"):
        dec.stage(batch, mesh=ref_mesh.make_mesh(2))
