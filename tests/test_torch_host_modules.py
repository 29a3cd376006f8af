"""The host modules of zstd_tpu_torch against zstd_tpu's, on the CPU.

  - encoding.parallel.compress_frames_parallel in its in-process branch (a
    tiny batch) and its pool branch (>= 1 MiB, two spawned workers): the
    frames of compress_to_vec and of zstd_tpu's compress_frames_parallel
    (in process), decodable by libzstd;
  - decoding: every name is the oracle's (or common.errors) object, as
    zstd_tpu.decoding's names are zstd_tpu.oracle's;
  - the package's dictionary-trainer exports give what zstd_tpu's give;
  - common.trace.profile_to writes a Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import zstandard

import zstd_tpu
import zstd_tpu.decoding as ref_decoding
import zstd_tpu_torch
from zstd_tpu.encoding import parallel as ref_parallel
from zstd_tpu_torch.common.config import CodecConfig, CompressionLevel
from zstd_tpu_torch.encoding import parallel
from zstd_tpu_torch.encoding.frame_enc import compress_to_vec


def _payloads(n: int, size: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    words = [b"pool", b"worker", b"frame", b"entropy", b"block", b"match"]
    return [b" ".join(words[j] for j in rng.randint(0, 6, size // 5))[:size]
            for _ in range(n)]


@pytest.fixture(scope="module")
def pool_workers():
    yield 2
    parallel.shutdown_pool()


@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("branch", ["in_process", "pool"])
def test_compress_frames_parallel_matches(pool_workers, branch, checksum):
    if branch == "pool":
        payloads = _payloads(6, 200 << 10, 1)   # 1.2 MiB, 6 frames
        assert sum(map(len, payloads)) >= 1 << 20
    else:
        payloads = _payloads(3, 4 << 10, 2)
    before = parallel._POOL
    got = parallel.compress_frames_parallel(
        payloads, write_checksum=checksum, workers=pool_workers)
    if branch == "pool":
        assert parallel._POOL is not None
    else:
        assert parallel._POOL is before
    cfg = CodecConfig(level=CompressionLevel.FASTEST, write_checksum=checksum)
    assert got == [compress_to_vec(p, CompressionLevel.FASTEST, cfg)
                   for p in payloads]
    # the reference in process (its pool forks, unsafe beside jax's
    # threads): its frames are the same in either branch
    assert got == ref_parallel.compress_frames_parallel(
        payloads, write_checksum=checksum, workers=1)
    dctx = zstandard.ZstdDecompressor()
    assert [dctx.decompress(f, max_output_size=1 << 20) for f in got] == \
        payloads


def test_pool_uses_spawned_workers(pool_workers):
    parallel.compress_frames_parallel(_payloads(4, 300 << 10, 3),
                                      workers=pool_workers)
    assert parallel._POOL._mp_context.get_start_method() == "spawn"


def test_decoding_names_are_the_oracles():
    from zstd_tpu_torch import decoding, oracle
    from zstd_tpu_torch.common import errors

    assert decoding.__all__ == ref_decoding.__all__
    for name in decoding.__all__:
        want = errors if name == "errors" else getattr(oracle, name)
        assert getattr(decoding, name) is want, name
    frame = zstandard.ZstdCompressor(level=3).compress(b"decoding " * 50)
    assert decoding.decode_all(frame) == ref_decoding.decode_all(frame)


def test_dictionary_trainer_exports():
    for name in ("create_raw_dict_from_source", "create_raw_dict_from_dir"):
        assert name in zstd_tpu_torch.__all__
        assert callable(getattr(zstd_tpu_torch, name))
    from zstd_tpu.models.dict_trainer import DictParams as RefParams
    from zstd_tpu_torch.models.dict_trainer import DictParams

    docs = [b'{"user": %d, "event": "click", "page": "/item/%d"}' % (i, i % 37)
            for i in range(400)]
    got = zstd_tpu_torch.create_raw_dict_from_source(
        docs, DictParams(dict_size=4096))
    assert got and got == zstd_tpu.create_raw_dict_from_source(
        docs, RefParams(dict_size=4096))


def test_dictionary_trainer_from_dir(tmp_path):
    from zstd_tpu.models.dict_trainer import DictParams as RefParams
    from zstd_tpu_torch.models.dict_trainer import DictParams

    for i in range(60):
        (tmp_path / f"doc{i}.json").write_bytes(
            b'{"id": %d, "kind": "sample", "tags": ["a", "b%d"]}' % (i, i % 5))
    got = zstd_tpu_torch.create_raw_dict_from_dir(
        str(tmp_path), DictParams(dict_size=2048))
    assert got and got == zstd_tpu.create_raw_dict_from_dir(
        str(tmp_path), RefParams(dict_size=2048))


def test_profile_to_writes_a_trace(tmp_path):
    import torch

    from zstd_tpu_torch.common.trace import profile_to, scope

    out = tmp_path / "trace"
    with profile_to(str(out)):
        with scope("work"):
            torch.arange(1000).sum()
    path = out / "trace.json"
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "work" for e in events)


def test_pool_workers_import_no_torch():
    """What a worker imports to run _compress_one loads neither torch nor
    a device runtime."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "from zstd_tpu_torch.encoding.parallel import _compress_one\n"
            "_compress_one((b'abc' * 100, 1, True))\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env={**os.environ, "PYTHONPATH": root},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
