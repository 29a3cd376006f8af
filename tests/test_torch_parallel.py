"""zstd_tpu_torch.parallel against zstd_tpu.parallel, on the CPU.

Real gloo groups: each world is a set of fresh processes
(tests/torch_ranks.py, which imports neither jax nor zstd_tpu) joined over
a file:// store in tmp_path (no TCP port, so xdist workers never collide).
The reference runs only in this process, on conftest's 8 CPU devices.

  - sharded_decode at world 1, 2 and 4 equals zstd_tpu's sharded_decode on
    make_mesh(n), array for array (padding rows and metrics included;
    a row that is not ok is all zero in the port, unspecified in the
    reference), on zstd_tpu's example_batch(8) and on a batch with a
    corrupted sequence stream;
  - decode_frames_multihost at world 2 and 3 returns on every rank the
    whole list in frame order: simple frames, a chained frame (under
    tiny_caps), the committed dictionary frames, a window_log-24 frame,
    and a truncated frame that comes back None; and with more ranks than
    frames;
  - shard_indices, process_info outside a group, scaling_report's keys
    and make_mesh's size check (and, outside a group and without a card,
    its error); shard_arrays puts every lane on the rank of its frame;
    BatchDecoder.stage refuses a rank mesh;
  - initialize_distributed with no arguments joins two ranks from
    MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE, as torchrun sets them,
    and decode_frames_multihost runs there; in this process, without
    WORLD_SIZE it does nothing, and without MASTER_ADDR torch says so.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import zstandard

from test_torch_fused import corrupted_batch
from zstd_tpu.models import fused as ref_fused
from zstd_tpu.parallel import mesh as ref_mesh
from zstd_tpu.parallel import multihost as ref_multihost
from zstd_tpu_torch.models.batch_decoder import BatchDecoder
from zstd_tpu_torch.parallel import mesh, multihost
from zstd_tpu_torch.testdata import load_dict_fixture
from zstd_tpu_torch.utils import caps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_ranks.py")


def _words(n: int, seed: int) -> bytes:
    rng = np.random.RandomState(seed)
    words = [b"tok%03d " % i for i in range(257)]
    return b"".join(words[i] for i in rng.randint(0, 257, n))[:n]


def _zstd(data: bytes, window_log: int, block: int = 0) -> bytes:
    """libzstd level 3 with checksums; with `block`, streamed (no content
    size: the window descriptor is the window) with a block ended every
    `block` bytes."""
    params = zstandard.ZstdCompressionParameters(
        window_log=window_log, compression_level=3, write_checksum=1)
    cctx = zstandard.ZstdCompressor(compression_params=params)
    if not block:
        return cctx.compress(data)
    cobj = cctx.compressobj()
    out = b"".join(cobj.compress(data[i:i + block])
                   + cobj.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                   for i in range(0, len(data), block))
    return out + cobj.flush()


def lane_frames():
    """(frames, expected, dictionary, kinds): every lane kind the decoder
    has, at the tiny caps."""
    raw, dict_frames, digests = load_dict_fixture()
    simple = [(b"multihost frame %d " % i) * (20 + 9 * i) for i in range(5)]
    near = _words(60 << 10, 7)          # two block groups at the tiny caps
    head = _words(48 << 10, 9)          # re-quotes past the far line
    far = head + head[4 << 10:40 << 10] + _words(8 << 10, 10)
    frames = [_zstd(p, 17) for p in simple[:3]]
    frames += [_zstd(near, 13), _zstd(far, 24, block=24 << 10)]
    frames += list(dict_frames)
    frames += [_zstd(simple[3], 17)[:20], _zstd(simple[4], 17)]
    expected = simple[:3] + [near, far]
    expected += [zstandard.ZstdDecompressor(
        dict_data=zstandard.ZstdCompressionDict(raw)).decompressobj()
        .decompress(f) for f in dict_frames]
    expected += [None, simple[4]]
    kinds = (["simple"] * 3 + ["chained", "window_log24"]
             + ["dict"] * len(dict_frames) + ["truncated", "simple"])
    return frames, expected, raw, kinds


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(tmp_path, world: int, jobs: list,
              launcher: bool = False) -> list:
    """Run `jobs` on `world` fresh rank processes; every rank's results.
    With `launcher`, each rank gets MASTER_ADDR, MASTER_PORT (a free local
    port), RANK and WORLD_SIZE in its environment and joins with
    initialize_distributed()."""
    job = tmp_path / f"world{world}.pkl"
    with open(job, "wb") as f:
        pickle.dump({"world": world, "store": str(tmp_path / f"store{world}"),
                     "jobs": jobs, "launcher": launcher}, f)
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = ROOT
    envs = [dict(env) for _ in range(world)]
    if launcher:
        port = str(_free_port())
        for r, e in enumerate(envs):
            e.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(r),
                     WORLD_SIZE=str(world))
    procs = [subprocess.Popen([sys.executable, WORKER, str(job), str(r)],
                              cwd=ROOT, env=envs[r], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {world}:\n{logs[r]}"
    out = []
    for r in range(world):
        with open(f"{job}.{r}.out", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def batches():
    kw, static, _ = ref_fused.example_batch(8)
    ckw, cstatic, _, _ = corrupted_batch("sequence", n=11)
    return {"example": (kw, static), "corrupted": (ckw, cstatic)}


@pytest.fixture(scope="module")
def lanes():
    return lane_frames()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, batches, lanes):
    """{world: every rank's results}, one group each: sharded decodes at 1,
    2 and 4; the lane frames over 2 and 3 ranks; two frames over 3."""
    tmp = tmp_path_factory.mktemp("ranks")
    frames, _, raw, _ = lanes
    sharded = [("sharded", *batches[k]) for k in ("example", "corrupted")]
    decode = ("multihost", frames, raw, True)
    two = [zstandard.ZstdCompressor(level=1).compress(p)
           for p in (b"alpha" * 40, b"beta" * 77)]
    jobs = {1: sharded,
            2: sharded + [decode, ("report", frames[:3]), ("mesh_size", 3),
                          ("stage_mesh", frames[:3])],
            3: [decode, ("multihost", two, None, False)],
            4: sharded}
    return {w: run_world(tmp, w, j) for w, j in jobs.items()}


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", ["example", "corrupted"])
def test_sharded_decode_matches_reference(worlds, batches, world, name):
    kw, static = batches[name]
    ro, rl, rok, rm = ref_mesh.sharded_decode(kw, static,
                                              ref_mesh.make_mesh(world))
    job = 0 if name == "example" else 1
    for rank in worlds[world]:
        po, pl, pok, pm = rank["jobs"][job]
        assert po.shape == ro.shape and po.dtype == ro.dtype
        assert np.array_equal(pl, np.asarray(rl))
        assert np.array_equal(pok, np.asarray(rok))
        assert {k: int(v) for k, v in pm.items()} == \
            {k: int(v) for k, v in rm.items()}
        good = np.asarray(rok)
        assert np.array_equal(po[good], np.asarray(ro)[good])
        assert not po[~good].any()
    if name == "corrupted":
        assert int(pm["frames_bad"]) == 1


@pytest.mark.parametrize("world", [2, 3])
def test_multihost_returns_every_frame_in_order(worlds, lanes, world):
    frames, expected, _, kinds = lanes
    job = {2: 2, 3: 0}[world]
    for rank in worlds[world]:
        got = rank["jobs"][job]
        assert len(got) == len(frames)
        for g, e, k in zip(got, expected, kinds):
            assert g == e, k
    assert expected[kinds.index("truncated")] is None


def test_lane_frames_take_every_path(lanes):
    """The chained frame has several block groups, the window_log-24 one
    is past the far line, and the dictionary frames seed their history,
    none sent to the host."""
    from zstd_tpu_torch.models import framer

    frames, expected, raw, kinds = lanes
    with caps.tiny_caps():
        dec = BatchDecoder(device="cpu")
        dec.add_dict(raw)
        batch = dec.prepare(frames)
        far_line = framer.STREAM_WINDOW_CAP
    metas = batch.metas
    assert len(metas[kinds.index("chained")].rows) > 1
    far = metas[kinds.index("window_log24")]
    assert far.window > far_line and len(far.rows) > 1
    assert all(m.dict_prefill for m, k in zip(metas, kinds) if k == "dict")
    assert not any(m.fallback for m in metas)


def test_multihost_more_ranks_than_frames(worlds):
    for rank in worlds[3]:
        assert rank["jobs"][1] == [b"alpha" * 40, b"beta" * 77]


def test_process_info_inside_and_outside_a_group(worlds):
    assert multihost.process_info() == ref_multihost.process_info() == (0, 1)
    for world, ranks in worlds.items():
        for r, rank in enumerate(ranks):
            assert rank["outside"] == (0, 1)
            assert rank["inside"] == (r, world)


def test_shard_indices_match_reference():
    for n, nproc in ((0, 3), (1, 3), (2, 3), (11, 3), (101, 4), (7, 1)):
        got = [multihost.shard_indices(n, p, nproc) for p in range(nproc)]
        assert got == [ref_multihost.shard_indices(n, p, nproc)
                       for p in range(nproc)]
        assert sorted(sum(got, [])) == list(range(n))


def test_scaling_report_keys(worlds, lanes):
    frames = lanes[0][:3]
    ref = ref_multihost.scaling_report(frames)
    single = multihost.scaling_report(frames,
                                      decoder=BatchDecoder(device="cpu"))
    assert set(single) == set(ref)
    assert single["bytes"] == ref["bytes"] and single["processes"] == 1
    for r, rank in enumerate(worlds[2]):
        rep = rank["jobs"][3]
        assert set(rep) == set(ref)
        assert (rep["process"], rep["processes"]) == (r, 2)
        assert rep["bytes"] == ref["bytes"] and rep["frames"] == 3


def test_make_mesh_checks_the_world(worlds):
    for rank in worlds[2]:
        assert "the group has 2 ranks" in rank["jobs"][4]
    if not torch.cuda.is_available():
        # outside a group and without a card: an error, never a CPU mesh
        with pytest.raises(RuntimeError, match="0 CUDA cards and no process "
                                               "group"):
            mesh.make_mesh()


def test_stage_refuses_a_rank_mesh(worlds):
    for rank in worlds[2]:
        assert "decode_frames_multihost" in rank["jobs"][5]


def test_initialize_distributed_from_the_environment(tmp_path):
    """Two ranks started as torchrun starts them: initialize_distributed()
    with no arguments joins them, and decode_frames_multihost returns every
    frame on both."""
    payloads = [(b"launched rank frame %d " % i) * (30 + 11 * i)
                for i in range(5)]
    frames = [zstandard.ZstdCompressor(level=3).compress(p)
              for p in payloads]
    ranks = run_world(tmp_path, 2, [("multihost", frames, None, False)],
                      launcher=True)
    for r, rank in enumerate(ranks):
        assert rank["outside"] == (0, 1)
        assert rank["inside"] == (r, 2)
        assert rank["jobs"][0] == payloads


def test_initialize_distributed_reads_the_environment(monkeypatch):
    """Without WORLD_SIZE one process joins nothing; with no coordinator
    torch reads MASTER_ADDR (here unset, so it names it) instead of the
    port failing on None."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_distributed() is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize_distributed() is None
    assert multihost.process_info() == (0, 1)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        multihost.initialize_distributed(None, 2, 0)
    assert multihost.process_info() == (0, 1)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_shard_arrays_put_each_lane_on_its_frames_rank(batches, n):
    """Every live lane lands once, on the rank whose block holds its frame,
    renumbered to a local row; the frame rows split in blocks."""
    kw, _ = batches["corrupted"]
    per = -(-kw["lit_base"].shape[0] // n)
    parts = [mesh.shard_arrays(kw, n, rank) for rank in range(n)]
    assert np.array_equal(
        np.concatenate([p["lit_base"] for p in parts])[:len(kw["lit_base"])],
        kw["lit_base"])
    for key, count in (("huff", "huff_nsym"), ("seq", "seq_n")):
        def lanes(frame, streams, live):
            return sorted((int(f), s.tobytes())
                          for f, s in zip(frame[live], streams[live]))

        got = []
        for rank, part in enumerate(parts):
            local = part[f"{key}_dst_frame"]
            assert ((local >= 0) & (local < per)).all()
            got += lanes(local + rank * per, part[f"{key}_streams"],
                         part[count] > 0)
        assert sorted(got) == lanes(kw[f"{key}_dst_frame"],
                                    kw[f"{key}_streams"], kw[count] > 0)
