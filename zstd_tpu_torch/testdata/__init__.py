"""Dictionary frames for checking the dictionary-prefill path anywhere.

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


def matches_digest(data, digest) -> bool:
    """True when `data` has the payload size and SHA-256 of `digest`."""
    return (data is not None and len(data) == digest[0]
            and hashlib.sha256(data).hexdigest() == digest[1])
