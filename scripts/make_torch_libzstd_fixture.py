#!/usr/bin/env python3
"""Write zstd_tpu_torch/testdata/libzstd/: frames that libzstd wrote.

    python3 scripts/make_torch_libzstd_fixture.py     (needs `zstandard`)

The machine with the GPU has no `zstandard`, and the port's own encoder
writes only FASTEST frames (no Repeat table modes, no window smaller than
its frame), so the frames users hold are committed here. Their payloads are
not: zstd_tpu_torch/testdata/payloads.py makes each one again from the
recipe, seed and slice in manifest.json, which also holds each payload's
size and SHA-256, the compression settings, and the frame's `features`
(testdata/anatomy.py::frame_features: block, literal and table modes,
repeat codes, match reach).

Groups:
  main     make_corpus(128) frames 0-15, 128 KiB each, level 3 with
           checksums: bench.py's headline frames
  levels   frames 16-31 of the same corpus: 8 at level 19, 4 at level 1,
           4 at level -5; every other one with a checksum
  chained  make_corpus(4, frame_kb=4096, seed=3)[0]: one 4 MiB frame at
           level 3 with a checksum (window 2 MiB, smaller than the frame)
  far      payloads.far_body: a 9.75 MiB body at window_log 24 whose last
           512 KiB quote its first bytes from more than 8 MiB back
  edge     an empty frame; a frame of RLE blocks; a raw-block frame; small
           frames with 1-stream literals; a frame at window_log 10 (1 KiB
           blocks: treeless literals and Repeat table modes); a frame of
           records with one literal, one match length and one repeat offset
           each (RLE table modes for LL, OF and ML); a frame whose second
           block's literals are all one byte (an RLE literal section); a
           frame whose literal streams pass 8 KiB each; a frame without its
           content size
  stream   a frame, a skippable frame and a second frame, for
           decode_all_device (not a single frame: kept out of batches)

Settings and payloads chosen for features libzstd 0.25.0's defaults do not
give at bench.py's shapes: window_log 10 (treeless literals, Repeat table
modes, 1-stream treeless sections), the records payload (RLE table modes),
the tokens payload (an RLE literal section) and the skewed payload (literal
streams past the Huffman kernel's 8 KiB staging). `unreached` in the
manifest lists any feature no frame has (none, with libzstd 1.5.7).
"""

import hashlib
import json
import os
import sys

import zstandard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from zstd_tpu_torch.testdata import anatomy, payloads  # noqa: E402

OUT = os.path.join(ROOT, "zstd_tpu_torch", "testdata", "libzstd")
FRAME = 128 << 10


def corpus(frame: int, mb: int = 4, seed: int = 0, kb: int = 128) -> dict:
    return {"recipe": "corpus", "mb": mb, "seed": seed,
            "slice": [frame * (kb << 10), (frame + 1) * (kb << 10)]}


def sized(recipe: str, seed: int, n: int) -> dict:
    return {"recipe": recipe, "seed": seed, "n": n, "slice": [0, n]}


def params(level: int, checksum: bool, window_log: int = 0,
           content_size: bool = True):
    kw = {"window_log": window_log} if window_log else {}
    return zstandard.ZstdCompressionParameters.from_level(
        level, write_checksum=int(checksum),
        write_content_size=int(content_size), **kw)


def entries():
    """(group, name, payload spec, level, checksum, window_log,
    content_size) of every single frame of the fixture."""
    out = [("main", f"main{i:02d}", corpus(i), 3, True, 0, True)
           for i in range(16)]
    levels = [19] * 8 + [1] * 4 + [-5] * 4
    out += [("levels", f"level{lv}_{i:02d}", corpus(i), lv, i % 2 == 0, 0,
             True) for i, lv in zip(range(16, 32), levels)]
    out.append(("chained", "chained", corpus(0, 4, 3, 4096), 3, True, 0,
                True))
    far = {"recipe": "far", "seed": 7, "slice": [0, (768 + 8704 + 512) << 10]}
    out.append(("far", "far", far, 3, True, 24, True))
    out += [
        ("edge", "empty", sized("fill", 0, 0), 3, True, 0, True),
        ("edge", "fill", sized("fill", 97, 300 << 10), 3, False, 0, True),
        ("edge", "noise", sized("noise", 5, 40 << 10), 3, True, 0, True),
        ("edge", "small_a", sized("text", 11, 300), 3, False, 0, True),
        ("edge", "small_b", sized("text", 12, 700), 19, True, 0, True),
        ("edge", "small_c", sized("text", 13, 1500), 1, False, 0, True),
        ("edge", "window10", sized("text", 14, 96 << 10), 3, False, 10,
         True),
        ("edge", "records", sized("records", 15, 62 << 10), 3, False, 0,
         True),
        ("edge", "rle_literals", sized("tokens", 16, (128 << 10) + 256 * 41),
         3, False, 0, True),
        ("edge", "wide_literals", sized("skewed", 17, 48 << 10), 3, False,
         0, True),
        ("edge", "no_size", corpus(40, 8), 3, True, 0, False),
    ]
    return out


def stream_entry(cache):
    """A frame, a skippable frame (16 bytes of content) and another frame."""
    specs = [sized("text", 21, 5000), sized("records", 22, 3000)]
    a, b = (payloads.payload(s, cache) for s in specs)
    za = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(a)
    zb = zstandard.ZstdCompressor(level=1).compress(b)
    skip = ((0x184D2A53).to_bytes(4, "little") + (16).to_bytes(4, "little")
            + bytes(range(16)))
    return za + skip + zb, specs


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    cache = {}
    head = payloads.make_corpus(128)[:48]
    frames, manifest = [], {"zstandard": zstandard.__version__,
                            "libzstd": zstandard.ZSTD_VERSION, "frames": []}
    total = anatomy._zero_features()
    for group, name, spec, level, checksum, wlog, fcs in entries():
        p = payloads.payload(spec, cache)
        if spec["recipe"] == "corpus" and spec["seed"] == 0:
            k = spec["slice"][0] // FRAME
            assert p == head[k], f"{name}: not make_corpus(128)[{k}]"
        cctx = zstandard.ZstdCompressor(
            compression_params=params(level, checksum, wlog, fcs))
        z = cctx.compress(p)
        assert zstandard.ZstdDecompressor().decompress(
            z, max_output_size=max(len(p), 1)) == p
        feats = anatomy.frame_features(z)
        assert feats["content"] == len(p), name
        total = anatomy.add_features(total, feats)
        file = f"{name}.zst"
        with open(os.path.join(OUT, file), "wb") as f:
            f.write(z)
        manifest["frames"].append({
            "file": file, "group": group, "payload": spec, "size": len(p),
            "sha256": hashlib.sha256(p).hexdigest(), "level": level,
            "window_log": wlog, "checksum": checksum,
            "content_size": fcs, "features": feats})
        frames.append(z)
        print(f"{name:12s} {len(p):9d} -> {len(z):7d}  win {feats['window']}"
              f"  blocks {feats['blocks']}  lits {feats['literals']}")
    z, specs = stream_entry(cache)
    with open(os.path.join(OUT, "stream.zst"), "wb") as f:
        f.write(z)
    p = b"".join(payloads.payload(s, cache) for s in specs)
    manifest["stream"] = {"file": "stream.zst", "payloads": specs,
                          "size": len(p),
                          "sha256": hashlib.sha256(p).hexdigest()}
    manifest["unreached"] = unreached(total)
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(json.dumps(total))
    print(f"unreached: {manifest['unreached']}; {size} bytes in {OUT}")


def unreached(total: dict) -> list:
    """Every feature count of `total` that is 0, as "section.key" names."""
    out = []
    for sec in ("blocks", "literals", "repeat_codes"):
        out += [f"{sec}.{k}" for k, v in total[sec].items() if not v]
    for kind, modes in total["modes"].items():
        out += [f"modes.{kind}.{m}" for m, v in modes.items() if not v]
    return out


if __name__ == "__main__":
    main()
