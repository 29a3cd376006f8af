"""zstd_tpu_torch's CLI and dictionary trainer on the CPU.

compress / decompress round trips on a 1 MiB file, on the host path and on
the --gpu path run with --device cpu (the same code on the plain
versions), each cross-checked with libzstd (`zstandard`); --gpu without a
card fails with the device resolver's error; train-dict writes what
zstd_tpu's trainer makes from the same seeded sources.
"""

import numpy as np
import pytest
import torch
import zstandard

from zstd_tpu.models import dict_trainer as ref_trainer
from zstd_tpu_torch.cli import ProgressReader, main
from zstd_tpu_torch.models import dict_trainer


def _data(n=1 << 20, seed=2):
    rng = np.random.RandomState(seed)
    parts = []
    size = 0
    while size < n:
        p = (b"stream cli %d " % rng.randint(999)) * rng.randint(5, 40)
        parts.append(p)
        size += len(p)
    return b"".join(parts)[:n]


@pytest.mark.parametrize("gpu", [[], ["--gpu", "--device", "cpu"]],
                         ids=["host", "gpu-path-on-cpu"])
def test_cli_roundtrip_cross_checked_with_libzstd(tmp_path, gpu):
    data = _data()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    z = tmp_path / "in.bin.zst"
    out = tmp_path / "out.bin"
    assert main(["compress", str(src), str(z), "-l", "1", *gpu]) == 0
    blob = z.read_bytes()
    assert zstandard.ZstdDecompressor().decompress(
        blob, max_output_size=len(data) + 64) == data
    assert main(["decompress", str(z), str(out), *gpu]) == 0
    assert out.read_bytes() == data
    # the other decoder reads the same file: libzstd's frame through ours
    lib = tmp_path / "lib.zst"
    lib.write_bytes(zstandard.ZstdCompressor(level=3).compress(data))
    assert main(["decompress", str(lib), str(out), *gpu]) == 0
    assert out.read_bytes() == data


def test_cli_gpu_frame_is_the_device_encoders(tmp_path):
    """compress --gpu writes BatchEncoder(matcher=DeviceMatcher())'s frame."""
    from zstd_tpu_torch.encoding.device_matcher import DeviceMatcher
    from zstd_tpu_torch.models.batch_encoder import BatchEncoder

    data = _data(300_000, seed=4)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    assert main(["compress", str(src), "--gpu", "--device", "cpu"]) == 0
    (frame,) = BatchEncoder(matcher=DeviceMatcher(device="cpu"),
                            device="cpu").compress_frames([data])
    assert (tmp_path / "in.bin.zst").read_bytes() == frame


@pytest.mark.parametrize("cmd", ["compress", "decompress"])
def test_cli_gpu_without_a_card_fails(tmp_path, cmd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = tmp_path / "in.bin"
    src.write_bytes(zstandard.ZstdCompressor().compress(b"x" * 1000))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([cmd, str(src), str(tmp_path / "out"), "--gpu"])


def test_cli_compress_content_size(tmp_path):
    data = _data(300_000, seed=5)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    z = tmp_path / "in.bin.zst"
    assert main(["compress", str(src), str(z), "-l", "1", "-C"]) == 0
    blob = z.read_bytes()
    assert zstandard.get_frame_parameters(blob).content_size == len(data)
    assert zstandard.ZstdDecompressor().decompress(blob) == data


def test_progress_reader_counts_and_reports():
    import io

    buf = io.BytesIO(b"x" * 100000)
    sink = io.StringIO()
    sink.isatty = lambda: True
    pr = ProgressReader(buf, 100000, "t", stream=sink)
    pr._last = -10  # force a report on first read
    while pr.read(8192):
        pass
    pr.finish()
    assert pr.done == 100000
    assert "MB/s" in sink.getvalue()


def _sources(tmp_path):
    rng = np.random.default_rng(17)
    d = tmp_path / "samples"
    (d / "sub").mkdir(parents=True)
    for i in range(120):
        doc = (b"[Unit]\nDescription=Service %d\nAfter=network.target\n"
               b"[Service]\nExecStart=/usr/bin/daemon --id %d --mode %s\n"
               % (i, int(rng.integers(0, 9999)),
                  [b"fast", b"safe", b"debug"][i % 3]))
        (d / ("sub" if i % 4 == 0 else ".") / f"s{i:03d}.conf").write_bytes(
            doc * int(rng.integers(1, 6)))
    return d


def test_train_dict_equals_reference(tmp_path):
    d = _sources(tmp_path)
    out = tmp_path / "dict.bin"
    assert main(["train-dict", str(d), "-o", str(out), "--size",
                 "4096"]) == 0
    got = out.read_bytes()
    want = ref_trainer.create_raw_dict_from_dir(
        str(d), ref_trainer.DictParams(dict_size=4096))
    assert got == want and 0 < len(got) <= 4096


@pytest.mark.parametrize("size", [2048, 16384])
def test_trainer_from_source_equals_reference(tmp_path, size):
    docs = [p.read_bytes() for p in sorted(_sources(tmp_path).rglob("*.conf"))]
    params = dict(dict_size=size, segment_size=512, chunk_size=1024)
    assert (dict_trainer.create_raw_dict_from_source(
        docs, dict_trainer.DictParams(**params))
        == ref_trainer.create_raw_dict_from_source(
            docs, ref_trainer.DictParams(**params)))
    assert dict_trainer.create_raw_dict_from_source([], None) == b""
