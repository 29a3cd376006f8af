#!/usr/bin/env python3
"""Write zstd_tpu_torch/testdata/: a dictionary and three frames that use it.

    python3 scripts/make_torch_dict_fixture.py     (needs `zstandard`)

The machine with the GPU has no `zstandard`, and the port's encoder writes
no dictionary frames, so the dictionary-prefill path is checked there on
these committed frames. The dictionary is 4 KiB, trained on log lines; the
three frames carry no content size (so each one's dictionary content seeds
its history, the chained path): two of one block group, one of several at
the default group caps. manifest.json holds each payload's size and
SHA-256.
"""

import hashlib
import json
import os

import numpy as np
import zstandard

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "zstd_tpu_torch", "testdata")

HOSTS = [b"edge-%02d" % i for i in range(24)]
LEVELS = [b"INFO", b"WARN", b"DEBUG", b"ERROR"]
PARTS = [b"request served", b"cache miss for key", b"upstream timeout",
         b"retrying connection", b"checksum verified", b"frame decoded",
         b"window advanced", b"dictionary loaded", b"session closed"]


def log_lines(rng, n: int, t0: int) -> bytes:
    """n log lines: a timestamp that counts up, then one of 64 line bodies."""
    bodies = [b" %s %s decoder: %s; %s; %s id=%d\n" % (
        HOSTS[rng.randint(len(HOSTS))], LEVELS[rng.randint(len(LEVELS))],
        PARTS[rng.randint(len(PARTS))], PARTS[rng.randint(len(PARTS))],
        PARTS[rng.randint(len(PARTS))], int(rng.randint(0, 1000)))
        for _ in range(64)]
    pick = rng.randint(0, len(bodies), n)
    return b"".join(b"%d" % (t0 + 3 * i) + bodies[j]
                    for i, j in enumerate(pick))


def main() -> None:
    rng = np.random.RandomState(2026)
    samples = [log_lines(rng, 12, 1_700_000_000 + 97 * i) for i in range(400)]
    dict_data = zstandard.train_dictionary(4096, samples)
    raw = dict_data.as_bytes()
    payloads = [log_lines(rng, 30, 1_700_100_000),
                log_lines(rng, 700, 1_700_200_000),
                log_lines(rng, 24000, 1_700_300_000)]
    cctx = zstandard.ZstdCompressor(level=3, dict_data=dict_data,
                                    write_checksum=True,
                                    write_content_size=False)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "dict.bin"), "wb") as f:
        f.write(raw)
    manifest = {"dict": "dict.bin", "frames": []}
    for i, p in enumerate(payloads):
        z = cctx.compress(p)
        name = f"frame{i}.zst"
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(z)
        manifest["frames"].append({"file": name, "size": len(p),
                                   "sha256": hashlib.sha256(p).hexdigest()})
        print(name, len(p), len(z))
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    print("dict.bin", len(raw))


if __name__ == "__main__":
    main()
