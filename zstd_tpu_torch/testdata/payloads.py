"""The payloads of the libzstd fixture (testdata/libzstd), made again from
their manifest entries: the frames are committed, the payloads are not.

make_corpus is a copy of the root bench.py's corpus (text, CSV and repeated
binary runs); the other recipes build the far-window body and the edge
payloads. Every recipe takes a seed; payload(spec) returns
recipe(spec)[slice]. numpy only: no bench.py, no zstandard.
"""

import numpy as np

WORDS = [b"the", b"of", b"and", b"compression", b"entropy", b"zstandard",
         b"frame", b"block", b"sequence", b"literal", b"window", b"match",
         b"offset", b"huffman", b"table", b"state", b"stream", b"decode"]


def make_corpus(total_mb: int = 64, frame_kb: int = 128, seed: int = 0):
    """Synthetic enwik-like mix: text-ish, structured, and binary runs.
    The blob is a prefix of the same blob at any larger total_mb."""
    rng = np.random.RandomState(seed)
    words = WORDS
    chunks = []
    size = 0
    target = total_mb << 20
    while size < target:
        kind = rng.randint(3)
        if kind == 0:
            n = rng.randint(2000, 8000)
            idx = rng.randint(0, len(words), size=n)
            part = b" ".join(words[i] for i in idx)
        elif kind == 1:
            n = rng.randint(1000, 4000)
            part = b"".join(b"%d,%d,item-%d\n" % (j, (j * 37) % 1001, j % 64)
                            for j in range(n))
        else:
            base = rng.randint(0, 256, size=rng.randint(256, 2048),
                               dtype=np.uint8).tobytes()
            part = base * rng.randint(4, 32)
        chunks.append(part)
        size += len(part)
    blob = b"".join(chunks)[:target]
    fk = frame_kb << 10
    return [blob[i:i + fk] for i in range(0, len(blob), fk)]


def runs(seed: int, n: int) -> bytes:
    """n bytes of highly compressible runs: short random patterns, each
    repeated over 4-64 KiB."""
    rng = np.random.RandomState(seed)
    parts, size = [], 0
    while size < n:
        pat = rng.randint(0, 256, rng.randint(1, 17), dtype=np.uint8).tobytes()
        part = pat * (rng.randint(4 << 10, 64 << 10) // len(pat))
        parts.append(part)
        size += len(part)
    return b"".join(parts)[:n]


def far_body(seed: int) -> bytes:
    """bench.py's bigwindow shape at a fraction of its compressed size:
    768 KiB of corpus, 8.5 MiB of runs, then the corpus's first 512 KiB
    again, so the quote's matches reach more than 8 MiB back."""
    head = make_corpus(1, seed=seed)
    head = b"".join(head)[:768 << 10]
    return head + runs(seed + 1, 17 << 19) + head[:512 << 10]


def text(seed: int, n: int) -> bytes:
    """n bytes of space-separated corpus words."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, len(WORDS), size=n // 3 + 1)
    return b" ".join(WORDS[i] for i in idx)[:n]


def noise(seed: int, n: int) -> bytes:
    """n random bytes (incompressible: a raw block)."""
    return np.random.RandomState(seed).randint(
        0, 256, n, dtype=np.uint8).tobytes()


def fill(seed: int, n: int) -> bytes:
    """n copies of one byte (RLE blocks after the first)."""
    return bytes([seed % 256]) * n


def records(seed: int, n: int) -> bytes:
    """Records of one random byte and a fixed 30-byte body, no two
    neighbours alike: every sequence after the first has literal length 1,
    the same match length and the same repeat offset, so one table code
    each (RLE table modes)."""
    rng = np.random.RandomState(seed)
    body = rng.randint(0, 256, 30, dtype=np.uint8).tobytes()
    out, prev = [], -1
    while len(out) * 31 < n:
        b = int(rng.randint(0, 255))
        b += b >= prev
        out.append(bytes([b]) + body)
        prev = b
    return b"".join(out)[:n]


def tokens(seed: int, n: int) -> bytes:
    """A 128 KiB block that defines 256 random 40-byte tokens (each followed
    by 0x02, then a run of 0x01), then each token once more in random order
    after a 0x00: every literal of the second block is 0x00 (an RLE literal
    section), its sequences one literal and one 40-byte match each."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(1, 256, (256, 40), dtype=np.uint8)
    head = b"".join(t.tobytes() + b"\x02" for t in toks)
    head += b"\x01" * ((128 << 10) - len(head))
    tail = b"".join(b"\x00" + toks[i].tobytes() for i in rng.permutation(256))
    return (head + tail)[:n]


def skewed(seed: int, n: int) -> bytes:
    """n bytes drawn from all 256 values with probabilities falling by a
    factor e every 48: no 5-byte repeats worth a match, literals
    Huffman-coded at ~7 bits, so each of a 48 KiB block's four literal
    streams passes 8 KiB."""
    rng = np.random.RandomState(seed)
    p = np.exp(-np.arange(256) / 48)
    symbols = rng.permutation(256).astype(np.uint8)
    return symbols[rng.choice(256, n, p=p / p.sum())].tobytes()


RECIPES = {"corpus": None, "far": far_body, "runs": runs, "text": text,
           "noise": noise, "fill": fill, "records": records,
           "tokens": tokens, "skewed": skewed}


def payload(spec: dict, cache: dict | None = None) -> bytes:
    """The payload a manifest entry names: {"recipe", "seed", "slice": [a,
    b], and for "corpus" "mb" (make_corpus(mb, 1024 KiB frames, seed)
    joined), else "n" where the recipe takes a size}. `cache` keeps the
    recipes' blobs between calls."""
    key = (spec["recipe"], spec["seed"], spec.get("mb"), spec.get("n"))
    cache = {} if cache is None else cache
    if key not in cache:
        if spec["recipe"] == "corpus":
            blob = b"".join(make_corpus(spec["mb"], 1024, spec["seed"]))
        elif spec["recipe"] == "far":
            blob = far_body(spec["seed"])
        else:
            blob = RECIPES[spec["recipe"]](spec["seed"], spec["n"])
        cache[key] = blob
    a, b = spec["slice"]
    return cache[key][a:b]
