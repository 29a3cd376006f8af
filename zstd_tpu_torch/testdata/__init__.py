"""Committed frames for checking the decode paths anywhere, the machine
with the GPU included (it has no `zstandard`).

libzstd/ holds frames libzstd wrote at bench.py's shapes and beside them
(scripts/make_torch_libzstd_fixture.py): load_libzstd_fixture() returns
them with their manifest entries, libzstd_payload() makes a payload again
from its recipe (payloads.py), and anatomy.py finds the parts of a frame
and mutates them.

dict.bin is a 4 KiB zstd dictionary; frame0.zst .. frame2.zst reference it
and carry no content size, so each one's dictionary content seeds its
history (the chained path): frames 0 and 1 are one block group, frame 2 is
two at the default group caps. manifest.json holds each payload's size and
SHA-256. scripts/make_torch_dict_fixture.py wrote them with libzstd.
"""

import hashlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_dict_fixture():
    """(dictionary bytes, [frame bytes], [(payload size, sha256 hex)])."""
    with open(os.path.join(HERE, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(HERE, manifest["dict"]), "rb") as f:
        raw = f.read()
    frames, digests = [], []
    for entry in manifest["frames"]:
        with open(os.path.join(HERE, entry["file"]), "rb") as f:
            frames.append(f.read())
        digests.append((entry["size"], entry["sha256"]))
    return raw, frames, digests


def _libzstd_manifest() -> dict:
    with open(os.path.join(HERE, "libzstd", "manifest.json")) as f:
        return json.load(f)


def load_libzstd_fixture(groups=None) -> list:
    """The libzstd frames of `groups` (all when None: main, levels,
    chained, far, edge), in manifest order: each its manifest entry (file,
    group, payload recipe, size, sha256, level, window_log, checksum,
    content_size, features) with the frame's bytes under "frame" and
    (size, sha256) under "digest"."""
    out = []
    for entry in _libzstd_manifest()["frames"]:
        if groups is not None and entry["group"] not in groups:
            continue
        with open(os.path.join(HERE, "libzstd", entry["file"]), "rb") as f:
            out.append({**entry, "frame": f.read(),
                        "digest": (entry["size"], entry["sha256"])})
    return out


def load_libzstd_stream() -> dict:
    """The fixture's stream (a frame, a skippable frame and another frame,
    for decode_all_device): its manifest entry with its bytes under
    "stream", its frames' payload recipes under "payloads" and (size,
    sha256) of their concatenation under "digest"."""
    s = _libzstd_manifest()["stream"]
    with open(os.path.join(HERE, "libzstd", s["file"]), "rb") as f:
        return {**s, "stream": f.read(), "digest": (s["size"], s["sha256"])}


def libzstd_payload(entry: dict, cache: dict | None = None) -> bytes:
    """The payload of a fixture entry, made again from its recipe."""
    from zstd_tpu_torch.testdata.payloads import payload

    return payload(entry["payload"], cache)


def matches_digest(data, digest) -> bool:
    """True when `data` has the payload size and SHA-256 of `digest`."""
    return (data is not None and len(data) == digest[0]
            and hashlib.sha256(data).hexdigest() == digest[1])
