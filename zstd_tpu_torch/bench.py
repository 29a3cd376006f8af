"""bench.py's scenarios through zstd_tpu_torch on one GPU.

    python3 -m zstd_tpu_torch.bench [total_mb] [scenarios]

total_mb (default 128) sizes the headline batch in 128 KiB frames;
scenarios is "all" (the default) or a comma-separated list of SCENARIOS.
Prints ONE JSON line with the root bench.py's keys, names and formulas:

  headline   total_mb of make_corpus in 128 KiB frames through
             BatchDecoder: prepare, stage (upload), one checked pulled
             run_device, `runs` timed serving runs (checksums verified on
             the device) and decode_frames_pipelined over the staged batch
             (bench.py:209-304); `frames_from` says how the frames were made
  libzstd    the committed libzstd frames (testdata/libzstd): the
             headline on bench.py's make_corpus(128) frames 0-15 at level 3
             with checksums, tiled to 1024 x 128 KiB, keys prefixed
             libzstd_; the 4 MiB chained frame as libzstd_longframe_* and
             the far frame as libzstd_bigwindow_*
  longframe  one 16 MiB frame, then 4 x 8 MiB frames in one batch
             (bench.py:50-104)
  bigwindow  a 12 MiB body at window_log 24 with matches 9+ MiB back
             (bench.py:107-143)
  encode     process-parallel host encode of 8 MiB, one-shot 16 MiB,
             BatchEncoder with the host matcher and with DeviceMatcher()
             (bench.py:146-206)

Each decode is measured as bench.py measures it (serve()): prepare, a
synchronised upload, one pulled run checked row by row, a warm-up and
timed serving runs on the same staged arrays.

and `device`, the card's name and power limit as nvidia-smi gives them.
Numbers are not rounded.

It differs from bench.py on purpose:
- `correct` and every *_correct read each frame's own run_device row (ok,
  out_len and, pulled, its bytes) in every run, and host_frames == 0:
  decode_frames decodes a frame the device rejected again on the host
  oracle, so its bytes would hide a kernel that rejects frames;
- a scenario that raises stops the run (no *_error fields, no fallback
  line), and the process exits non-zero when any correctness key is false;
- frames come from libzstd (`zstandard`, level 3, checksums) only where it
  is installed, else from the port's encoder at FASTEST; the committed
  libzstd frames stand in for that branch where it is not (the GPU
  machine). encode_ratio_vs_libzstd1 is null without `zstandard`.

The bench runs on the card unless the caller passes device="cpu" (the
tests, at KiB sizes: every scenario's mb may be a fraction).
"""

import json
import math
import subprocess
import sys
import time
from typing import NamedTuple

import torch

from zstd_tpu_torch.common.config import CodecConfig, CompressionLevel
from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
from zstd_tpu_torch.models import framer
from zstd_tpu_torch.models.batch_decoder import BatchDecoder, resolve_device
from zstd_tpu_torch.oracle import decode_frame
from zstd_tpu_torch.testdata.payloads import make_corpus

RUZSTD_BASELINE_GBPS = 0.106  # enwik9 ~ 9.4 s single core (BASELINE.md)
SCENARIOS = ("headline", "libzstd", "longframe", "bigwindow", "encode")
LIBZSTD_TILE = 64  # the 16 committed main frames 64 times: 1024 x 128 KiB
LONG_RUNS = 2  # bench.py's timed runs of a chained batch


def zstandard_module():
    """libzstd's Python binding where it is installed, else None."""
    try:
        import zstandard
    except ImportError:
        return None
    return zstandard


def compress(data: bytes, window_log: int | None = None) -> bytes:
    """bench.py's frame: libzstd level 3 with a checksum where `zstandard`
    imports, else the port's encoder at FASTEST (checksummed too);
    window_log as the encoder's window where given."""
    zstd = zstandard_module()
    if zstd is None:
        cfg = CodecConfig() if window_log is None else CodecConfig(
            window_log=window_log)
        return bytes(compress_to_vec(data, CompressionLevel.FASTEST, cfg))
    if window_log is None:
        return zstd.ZstdCompressor(level=3, write_checksum=True).compress(data)
    params = zstd.ZstdCompressionParameters(
        window_log=window_log, compression_level=3, write_checksum=1)
    cobj = zstd.ZstdCompressor(compression_params=params).compressobj()
    return cobj.compress(data) + cobj.flush()


def main_frames(total_mb: int, frame_kb: int = 128):
    """(payloads, frames, frames_from): make_corpus(total_mb, frame_kb),
    each payload compressed by compress(); frames_from names the encoder,
    "libzstd-3" or "fastest"."""
    payloads = make_corpus(total_mb, frame_kb)
    made_by = "fastest" if zstandard_module() is None else "libzstd-3"
    return payloads, [compress(p) for p in payloads], made_by


def corpus(mb: float, seed: int, frame_kb: int = 128) -> list:
    """make_corpus's frames over its first mb MiB of `seed`: at a whole mb
    make_corpus(mb, frame_kb, seed); mb may be a fraction (its blob at any
    size is a prefix of a larger one)."""
    blob = b"".join(make_corpus(math.ceil(mb), seed=seed))
    blob = blob[:round(mb * (1 << 20))]
    fk = frame_kb << 10
    return [blob[i:i + fk] for i in range(0, len(blob), fk)]


def bigwindow_body(mb: float = 12) -> bytes:
    """bench.py's bigwindow body in units of mb / 12 MiB (1 MiB at its 12):
    9 units of corpus, its first unit again, 1 unit more, then its unit 2
    again: matches 9+ units back."""
    u = round(mb * (1 << 20) / 12)
    head = b"".join(corpus(9 * u / (1 << 20), seed=7))
    return (head + head[:u] + b"".join(corpus(u / (1 << 20), seed=8))
            + head[2 * u:3 * u])


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _row(meta):
    """A frame's device row, None where the framer gave it none or planned
    it for the host (fallback)."""
    if not meta.ok or meta.fallback or not meta.rows:
        return None
    return meta.rows[0]


def frame_rows(batch, outputs, out_len, ok) -> list:
    """Each frame's bytes read from its own pulled run_device row, None
    where the row is not ok or the frame has no device row. Works on any
    batch with the framer's metas (this package's or zstd_tpu's)."""
    out = []
    for m in batch.metas:
        r = _row(m)
        good = r is not None and bool(ok[r]) and int(out_len[r]) >= m.dict_skip
        out.append(outputs[r][m.dict_skip:int(out_len[r])].tobytes()
                   if good else None)
    return out


def rows_ok(batch, payloads, out_len, ok) -> bool:
    """Every frame's own row ok with its payload's length (a serving run,
    whose outputs stay on the device)."""
    for m, p in zip(batch.metas, payloads, strict=True):
        r = _row(m)
        if (r is None or not bool(ok[r])
                or int(out_len[r]) != m.dict_skip + len(p)):
            return False
    return True


class Served(NamedTuple):
    batch: object
    staged: dict
    prepare_s: float
    upload_s: float
    device_s: float   # mean of the timed serving runs
    exact: bool       # every frame's pulled row is its payload
    timed_ok: bool    # every frame's row ok with its length in every run


def serve(dec, frames, payloads, runs: int) -> Served:
    """bench.py's measurement of one batch on dec.device: prepare (timed);
    stage, synchronised (the upload, not its enqueue); one pulled
    run_device, each frame's own row held to its payload; a warm-up and
    `runs` timed serving runs (outputs left on the device) on the same
    staged arrays, each frame's row read in each."""
    dev = dec.device
    t0 = time.perf_counter()
    batch = dec.prepare(frames)
    prepare_s = time.perf_counter() - t0

    _sync(dev)
    t0 = time.perf_counter()
    staged = dec.stage(batch)
    _sync(dev)
    upload_s = time.perf_counter() - t0

    outputs, out_len, ok = dec.run_device(batch, staged)
    exact = frame_rows(batch, outputs, out_len, ok) == list(payloads)
    del outputs

    dec.run_device(batch, staged, pull_outputs=False)  # warm serving path
    timed = []
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(runs):
        _, length, good = dec.run_device(batch, staged, pull_outputs=False)
        timed.append((length, good))
    device_s = (time.perf_counter() - t0) / runs
    return Served(batch, staged, prepare_s, upload_s, device_s, exact,
                  all(rows_ok(batch, payloads, *r) for r in timed))


def run_headline(frames, payloads, device=None, runs: int = 5,
                 p_rounds: int = 4) -> dict:
    """bench.py's headline (bench.py:230-304) through BatchDecoder on
    `device`: serve() with `runs` timed runs, then decode_frames_pipelined
    over `p_rounds` copies of the batch on the staged upload, timed from
    its first yield. pipelined_prepare_s is one more prepare of the same
    frames, warm: the host half of each pipelined round, beside device_s.

    correct: every frame's own row exact in the pulled run, ok with its
    length in every timed run and every pipelined yield, no frame planned
    for the host, host_frames 0 at the end. checksum_verified: every frame
    carries a checksum the device checked in every timed run, and every
    timed run's rows are ok."""
    dec = BatchDecoder(device=resolve_device(device))
    n_bytes = sum(len(p) for p in payloads)
    s = serve(dec, frames, payloads, runs)
    # single-group frames with a checksum field, each checked on the device
    ck_ok = s.timed_ok and all(m.checksum is not None and len(m.rows) == 1
                               for m in s.batch.metas)

    t0 = time.perf_counter()
    dec.prepare(frames)
    t_reprepare = time.perf_counter() - t0
    gen = dec.decode_frames_pipelined([frames] * p_rounds,
                                      pull_outputs=False, prestaged=s.staged)
    piped = [next(gen)[1:]]
    t0 = time.perf_counter()
    piped += [fin[1:] for fin in gen]
    t_pipe = (time.perf_counter() - t0) / (p_rounds - 1)

    correct = (s.exact and s.timed_ok and len(piped) == p_rounds
               and all(rows_ok(s.batch, payloads, *r) for r in piped)
               and dec.host_frames == 0)
    gbps = n_bytes / s.device_s / 1e9
    return {
        "metric": "batched_decode_throughput",
        "value": gbps,
        "unit": "GB/s/gpu",
        "vs_baseline": gbps / RUZSTD_BASELINE_GBPS,
        "correct": correct,
        "frames": len(frames),
        "decoded_mb": n_bytes / 1e6,
        "device_s": s.device_s,
        "host_prepare_s": s.prepare_s,
        "h2d_upload_s": s.upload_s,
        "end_to_end_gbps": n_bytes / (s.device_s + s.prepare_s) / 1e9,
        "pipelined_gbps": n_bytes / t_pipe / 1e9,
        "pipelined_prepare_s": t_reprepare,
        "checksum_verified": ck_ok,
    }


def libzstd_main(tile: int = LIBZSTD_TILE):
    """(payloads, frames) of the committed libzstd main frames, `tile`
    times over; each payload made again from its recipe."""
    from zstd_tpu_torch.testdata import libzstd_payload, load_libzstd_fixture

    cache = {}
    fx = load_libzstd_fixture(["main"])
    return ([libzstd_payload(e, cache) for e in fx] * tile,
            [e["frame"] for e in fx] * tile)


def _chained(dec, frames, payloads):
    """bench.py's long-frame measurement: serve() with LONG_RUNS timed runs
    (the pulled run holds the content of every frame on the staged arrays
    the timed runs then use: serving mode does not hash chained frames on
    the device). Returns (GB/s, the batch, correct): correct when every
    frame is chained (more than one block group), its own row exact pulled
    and ok with its length in every timed run, and host_frames is 0."""
    s = serve(dec, frames, payloads, LONG_RUNS)
    correct = (s.exact and s.timed_ok and dec.host_frames == 0
               and all(len(m.rows) > 1 for m in s.batch.metas))
    return sum(len(p) for p in payloads) / s.device_s / 1e9, s.batch, correct


def _far(key: str, dec, data, frame) -> dict:
    """{key}_gbps, _groups and _correct of one far-window frame: _chained's
    correct, and its window past framer.STREAM_WINDOW_CAP (the far path)."""
    gbps, batch, correct = _chained(dec, [frame], [data])
    m = batch.metas[0]
    return {f"{key}_gbps": gbps, f"{key}_groups": len(m.rows),
            f"{key}_correct": correct and m.window > framer.STREAM_WINDOW_CAP}


def _libzstd_entry(group: str):
    """(payload, frame) of the committed libzstd frame of `group`."""
    from zstd_tpu_torch.testdata import libzstd_payload, load_libzstd_fixture

    e = load_libzstd_fixture([group])[0]
    return libzstd_payload(e), e["frame"]


def run_libzstd(device=None, tile: int = LIBZSTD_TILE) -> dict:
    """Every committed libzstd frame the bench reads: run_headline on the
    main frames `tile` times over (keys prefixed libzstd_, metric and unit
    left out: the headline's), the 4 MiB chained frame (window 2 MiB) as
    libzstd_longframe_* and the far frame (window past 8 MiB) as
    libzstd_bigwindow_*."""
    payloads, frames = libzstd_main(tile)
    res = {f"libzstd_{k}": v
           for k, v in run_headline(frames, payloads, device).items()
           if k not in ("metric", "unit")}
    dec = BatchDecoder(device=resolve_device(device))
    data, frame = _libzstd_entry("chained")
    gbps, batch, correct = _chained(dec, [frame], [data])
    res.update(libzstd_longframe_gbps=gbps,
               libzstd_longframe_groups=len(batch.metas[0].rows),
               libzstd_longframe_correct=correct)
    res.update(_far("libzstd_bigwindow", dec, *_libzstd_entry("far")))
    return res


def run_longframe(mb: float = 16, device=None) -> dict:
    """bench.py:50-104: one mb MiB frame (corpus seed 3), then 4 frames of
    mb / 2 MiB (seeds 30-33) in one batch, each made by compress()."""
    dec = BatchDecoder(device=resolve_device(device))
    data = b"".join(corpus(mb, seed=3))
    gbps, batch, correct = _chained(dec, [compress(data)], [data])
    res = {"longframe_gbps": gbps,
           "longframe_groups": len(batch.metas[0].rows),
           "longframe_correct": correct}
    datas = [b"".join(corpus(mb / 2, seed=30 + i)) for i in range(4)]
    gbps, _, correct = _chained(dec, [compress(d) for d in datas], datas)
    res.update(longframe4_gbps=gbps, longframe4_correct=correct)
    return res


def run_bigwindow(mb: float = 12, device=None) -> dict:
    """bench.py:107-143: bigwindow_body(mb) at window_log 24 through
    compress(), its window past framer.STREAM_WINDOW_CAP."""
    body = bigwindow_body(mb)
    return _far("bigwindow", BatchDecoder(device=resolve_device(device)),
                body, compress(body, 24))


def _decodes(frames, payloads) -> bool:
    """Every frame decoded by the port's host oracle to its payload and,
    where `zstandard` imports, by libzstd too."""
    zstd = zstandard_module()
    dctx = None if zstd is None else zstd.ZstdDecompressor()
    for f, p in zip(frames, payloads, strict=True):
        if decode_frame(bytes(f)) != p:
            return False
        if dctx is not None and dctx.decompress(
                bytes(f), max_output_size=len(p) + 64) != p:
            return False
    return True


def _timed_encode(enc, payloads):
    """(outputs, seconds) of the second compress_frames call of `enc` (the
    first warms it up, kernels built and caches made)."""
    enc.compress_frames(payloads)
    t0 = time.perf_counter()
    outs = enc.compress_frames(payloads)
    return outs, time.perf_counter() - t0


def run_encode(mb: float = 8, device=None) -> dict:
    """bench.py:146-206: corpus(mb, seed=5) through
    compress_frames_parallel (checksum-less, its default workers), the
    one-shot compress_to_vec of corpus(2 * mb, seed=3) (bench.py's 16 MiB),
    then BatchEncoder on `device` with the host matcher (encode_device_*)
    and with DeviceMatcher() (encode_devmatch_*, the parse and FSE-encode
    kernels). Every output decoded back (_decodes); each timed call is the
    second of two."""
    from zstd_tpu_torch.encoding.device_matcher import DeviceMatcher
    from zstd_tpu_torch.encoding.parallel import (compress_frames_parallel,
                                                  shutdown_pool)
    from zstd_tpu_torch.models.batch_encoder import BatchEncoder

    dev = resolve_device(device)
    payloads = corpus(mb, seed=5)
    n = sum(len(p) for p in payloads)
    try:
        compress_frames_parallel(payloads, write_checksum=False)
        t0 = time.perf_counter()
        outs = compress_frames_parallel(payloads, write_checksum=False)
        dt = time.perf_counter() - t0
    finally:
        shutdown_pool()
    res = {"encode_mbps": n / dt / 1e6,
           "encode_ratio": sum(map(len, outs)) / n,
           "encode_correct": _decodes(outs, payloads)}

    big = b"".join(corpus(2 * mb, seed=3))
    compress_to_vec(big)
    t0 = time.perf_counter()
    z = compress_to_vec(big)
    dt = time.perf_counter() - t0
    zstd = zstandard_module()
    lz1 = None if zstd is None else zstd.ZstdCompressor(level=1).compress(big)
    res.update({
        "encode_1shot_mbps": len(big) / dt / 1e6,
        "encode_big_ratio": len(z) / len(big),
        "encode_ratio_vs_libzstd1": None if lz1 is None else len(z) / len(lz1),
        "encode_big_correct": _decodes([z], [big]),
    })

    enc = BatchEncoder(device=dev)
    outs, dt = _timed_encode(enc, payloads)
    res.update(encode_device_correct=_decodes(outs, payloads),
               encode_device_mbps=n / dt / 1e6,
               encode_device_stages=enc.last_stats)
    enc = BatchEncoder(matcher=DeviceMatcher(device=dev), device=dev)
    outs, dt = _timed_encode(enc, payloads)
    res.update(encode_devmatch_correct=_decodes(outs, payloads),
               encode_devmatch_mbps=n / dt / 1e6,
               encode_devmatch_stages=enc.last_stats)
    return res


def run_scenarios(names=SCENARIOS, total_mb: int = 128, device=None,
                  headline_frames=None) -> dict:
    """The scenarios `names` (of SCENARIOS) in order, their keys in one
    dict. headline_frames: the headline's (payloads, frames, frames_from)
    where the caller made them already, else main_frames(total_mb)."""
    unknown = sorted(set(names) - set(SCENARIOS))
    if unknown:
        raise ValueError(f"unknown scenarios {unknown}; known: {SCENARIOS}")
    dev = resolve_device(device)
    res = {}
    if "headline" in names:
        payloads, frames, made_by = (headline_frames
                                     or main_frames(total_mb))
        res.update(run_headline(frames, payloads, dev), frames_from=made_by)
    if "libzstd" in names:
        res.update(run_libzstd(dev))
    if "longframe" in names:
        res.update(run_longframe(device=dev))
    if "bigwindow" in names:
        res.update(run_bigwindow(device=dev))
    if "encode" in names:
        res.update(run_encode(device=dev))
    return res


def failed_checks(result: dict) -> list:
    """The correctness keys of a result that are not True: correct,
    checksum_verified and every *_correct / *_checksum_verified."""
    return [k for k, v in result.items()
            if (k.endswith("correct") or k.endswith("checksum_verified"))
            and v is not True]


def card(device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them; "cpu"
    for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip()


def main(argv=None, device=None) -> int:
    """Run the scenarios of argv ([total_mb] [scenarios]) and print the
    line; 1 when a correctness key is false (a scenario that raises
    propagates)."""
    argv = sys.argv[1:] if argv is None else argv
    total_mb = int(argv[0]) if argv else 128
    names = (SCENARIOS if len(argv) < 2 or argv[1] == "all"
             else tuple(argv[1].split(",")))
    dev = resolve_device(device)
    result = run_scenarios(names, total_mb, dev)
    result["device"] = card(dev)
    print(json.dumps(result), flush=True)
    bad = failed_checks(result)
    if bad:
        print(f"zstd_tpu_torch.bench: correctness keys not true: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
