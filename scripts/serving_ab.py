#!/usr/bin/env python3
"""Decode serving throughput of two checkouts, in alternating pairs.

    python scripts/serving_ab.py DIR_A DIR_B [PAIRS]

Each measurement is a fresh process in one checkout that builds the three
batches of chip_smoke.py's serving phases, at the fastest level: main (1024
frames of 128 KiB, make_corpus(128)), chained (16 frames of 8 MiB,
make_corpus(128, frame_kb=8192)) and far (bench.py's bigwindow body, 12
MiB at window_log 24). For each it prepares and stages the batch once on
the card, makes a warm-up run and times RUNS serving runs
(`run_device(pull_outputs=False)`, host clock, a CUDA synchronize before
each), and prints their mean as GB/s of decoded bytes. The pairs alternate
the order (A B, B A, ...) so that a drift of the card or host falls on
both; the last line gives each checkout's median and quartiles a path.
Needs a CUDA card; PAIRS defaults to 10.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

RUNS = 5


PATHS = ("main", "chained", "far")


def payloads_of(path: str):
    """(payloads, CodecConfig or None) of chip_smoke.py's batch `path`."""
    from chip_smoke import make_corpus
    from zstd_tpu_torch.common.config import CodecConfig

    if path == "main":
        return make_corpus(128), None
    if path == "chained":
        return make_corpus(128, frame_kb=8192), None
    head = b"".join(make_corpus(9, seed=7))
    body = (head + head[:1 << 20] + b"".join(make_corpus(1, seed=8))
            + head[2 << 20:3 << 20])
    return [body], CodecConfig(window_log=24)


def child(root: str) -> int:
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    from zstd_tpu_torch.common.config import CompressionLevel
    from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder
    from zstd_tpu_torch.ops import _kernels

    _kernels.build_all()
    gbps = {}
    for path in PATHS:
        payloads, cfg = payloads_of(path)
        frames = [bytes(compress_to_vec(p, CompressionLevel.FASTEST,
                                        *([cfg] if cfg else [])))
                  for p in payloads]
        n_bytes = sum(map(len, payloads))
        dec = BatchDecoder()
        batch = dec.prepare(frames)
        staged = dec.stage(batch)
        dec.run_device(batch, staged, pull_outputs=False)  # warm-up
        times = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, ok = dec.run_device(batch, staged, pull_outputs=False)
            times.append(time.perf_counter() - t0)
            if not bool(np.all(ok)):
                print(f"serving_ab: {path}: a frame failed", file=sys.stderr)
                return 1
        gbps[path] = n_bytes / (sum(times) / RUNS) / 1e9
        del dec, batch, staged
        torch.cuda.empty_cache()
    print(json.dumps(gbps))
    return 0


def measure(root: str) -> dict:
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--child", root], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"serving_ab: {root} failed:\n"
                         f"{res.stdout}{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        return child(os.path.abspath(sys.argv[2]))
    a, b = (os.path.abspath(p) for p in sys.argv[1:3])
    pairs = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    got = {a: [], b: []}
    for n in range(pairs):
        for root in ((a, b) if n % 2 == 0 else (b, a)):
            got[root].append(measure(root))
            print(f"serving_ab: pair {n}: {root}: " + ", ".join(
                f"{p} {got[root][-1][p]:.4f}" for p in PATHS) + " GB/s",
                flush=True)
    print(json.dumps({os.path.basename(r): {p: {
        "median": float(np.median([x[p] for x in v])),
        "q1": float(np.percentile([x[p] for x in v], 25)),
        "q3": float(np.percentile([x[p] for x in v], 75)),
        "runs": [round(x[p], 4) for x in v]} for p in PATHS}
        for r, v in got.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
