"""Where the parts of a zstd frame lie, what an encoder used in it, and
mutants that corrupt only the parts the device kernels read.

frame_regions(frame) walks a frame's blocks with the package's own header
and section parsers (oracle/blocks.py, oracle/huff0.py, the FSE table
parser) and returns, for every compressed block, the byte ranges of its
Huffman tree description, its literal streams, its sequence-count field,
its FSE table descriptions and its sequence bitstream.

frame_features(frame) decodes the entropy sections with the oracle and
counts what the encoder used: block types, literal section types and
stream counts, each of LL/OF/ML's table modes, repeat-offset codes 1-3
(apart when the literal length is 0, which shifts the code), the largest
match length and offset, the window and the decoded size.

targeted_mutants(frames, rng, n) makes n mutants from `frames` with a
random.Random: byte flips inside one region, bit flips near a stream's end
(its padding sentinel), and a stream overwritten by the tail of a stream of
the same kind from another frame. Headers, block sizes and frame lengths
stay as they were, so the framer reaches the kernels with most of them.
"""

import dataclasses

from zstd_tpu_torch.common import constants as C
from zstd_tpu_torch.oracle import blocks, huff0
from zstd_tpu_torch.oracle import frame as frame_mod
from zstd_tpu_torch.oracle import literals as literals_mod
from zstd_tpu_torch.oracle import sequences as sequences_mod
from zstd_tpu_torch.oracle.decoder import DecoderScratch

# the kernel each region kind feeds first
REGION_KERNEL = {"huff_tree": "huffman", "huff_stream": "huffman",
                 "seq_count": "sequence", "fse_table": "sequence",
                 "seq_stream": "sequence"}
STREAM_KINDS = ("huff_stream", "seq_stream")
_BLOCK = {C.BLOCK_RAW: "raw", C.BLOCK_RLE: "rle",
          C.BLOCK_COMPRESSED: "compressed"}
_MODE = {C.MODE_PREDEFINED: "predefined", C.MODE_RLE: "rle",
         C.MODE_FSE: "fse", C.MODE_REPEAT: "repeat"}
_FSE = (("ll", C.LL_DEFAULT_DIST, C.LL_DEFAULT_ACC_LOG, C.LL_MAX_LOG),
        ("of", C.OF_DEFAULT_DIST, C.OF_DEFAULT_ACC_LOG, C.OF_MAX_LOG),
        ("ml", C.ML_DEFAULT_DIST, C.ML_DEFAULT_ACC_LOG, C.ML_MAX_LOG))


@dataclasses.dataclass
class Region:
    kind: str    # a key of REGION_KERNEL
    start: int   # byte offsets in the frame, end exclusive
    end: int
    lanes: int   # device lanes that read it (a tree: its block's streams)


def _blocks(frame: bytes):
    """(header, start of its content) of each block of the frame."""
    pos = frame_mod.parse_frame_header(frame).header_size
    while True:
        bh = blocks.parse_block_header(frame[pos:pos + 3])
        yield bh, pos + 3
        pos += 3 + (1 if bh.block_type == C.BLOCK_RLE else bh.block_size)
        if bh.last_block:
            return


def _literal_regions(content, at: int):
    """The literal section's regions and the offset past it."""
    sec = blocks.parse_literals_section(content)
    p = sec.header_size
    if sec.lit_type == C.LIT_RAW:
        return [], p + sec.regenerated_size
    if sec.lit_type == C.LIT_RLE:
        return [], p + 1
    out = []
    end = p + sec.compressed_size
    if sec.lit_type == C.LIT_COMPRESSED:
        _, used = huff0.parse_huffman_table(bytes(content[p:end]))
        out.append(Region("huff_tree", at + p, at + p + used,
                          sec.num_streams))
        p += used
    if sec.num_streams == 1:
        sizes = [end - p]
    else:
        jump = [int.from_bytes(content[p + 2 * k:p + 2 * k + 2], "little")
                for k in range(3)]
        p += 6
        sizes = jump + [end - p - sum(jump)]
    for s in sizes:
        out.append(Region("huff_stream", at + p, at + p + s, 1))
        p += s
    return out, end


def frame_regions(frame: bytes) -> list:
    """The Region of every entropy part of every compressed block."""
    out = []
    for bh, at in _blocks(frame):
        if bh.block_type != C.BLOCK_COMPRESSED:
            continue
        content = frame[at:at + bh.block_size]
        lits, p = _literal_regions(content, at)
        out += lits
        sh = blocks.parse_sequences_header(content[p:])
        if sh.num_sequences == 0:
            continue
        out.append(Region("seq_count", at + p, at + p + sh.header_size - 1,
                          1))
        p += sh.header_size
        for (what, dist, acc, max_log), mode in zip(
                _FSE, (sh.ll_mode, sh.of_mode, sh.ml_mode)):
            _, used = sequences_mod.update_fse_table(
                mode, content[p:], True, dist, acc, max_log, what)
            if mode == C.MODE_FSE:
                out.append(Region("fse_table", at + p, at + p + used, 1))
            p += used
        out.append(Region("seq_stream", at + p, at + bh.block_size, 1))
    return out


def _zero_features() -> dict:
    return {"blocks": dict.fromkeys(_BLOCK.values(), 0),
            "literals": dict.fromkeys(
                ("raw", "rle", "compressed_1", "compressed_4", "treeless_1",
                 "treeless_4"), 0),
            "modes": {k: dict.fromkeys(_MODE.values(), 0)
                      for k in ("ll", "of", "ml")},
            "repeat_codes": dict.fromkeys(
                ("1", "2", "3", "1_ll0", "2_ll0", "3_ll0"), 0),
            "sequences": 0, "max_match": 0, "max_offset": 0}


def frame_features(frame: bytes) -> dict:
    """What the frame's encoder used, from the oracle's own decode of its
    entropy sections (module docstring); plus `window` and `content`, the
    window size and the decoded size."""
    header = frame_mod.parse_frame_header(frame)
    f = _zero_features()
    scratch = DecoderScratch(header.window_size or 0)
    hist = list(C.INITIAL_REPEAT_OFFSETS)
    content_size = 0
    for bh, at in _blocks(frame):
        f["blocks"][_BLOCK[bh.block_type]] += 1
        if bh.block_type != C.BLOCK_COMPRESSED:
            content_size += bh.block_size
            continue
        content = frame[at:at + bh.block_size]
        sec = blocks.parse_literals_section(content)
        lt = {C.LIT_RAW: "raw", C.LIT_RLE: "rle", C.LIT_COMPRESSED:
              "compressed", C.LIT_TREELESS: "treeless"}[sec.lit_type]
        if sec.lit_type in (C.LIT_COMPRESSED, C.LIT_TREELESS):
            lt += f"_{sec.num_streams}"
        f["literals"][lt] += 1
        p = sec.header_size
        lits, used = literals_mod.decode_literals(sec, content[p:], scratch)
        p += used
        sh = blocks.parse_sequences_header(content[p:])
        p += sh.header_size
        block_out = len(lits)
        if sh.num_sequences:
            for kind, mode in zip(("ll", "of", "ml"),
                                  (sh.ll_mode, sh.of_mode, sh.ml_mode)):
                f["modes"][kind][_MODE[mode]] += 1
            for s in sequences_mod.decode_sequences(sh, content[p:],
                                                    scratch):
                if s.of <= 3:
                    f["repeat_codes"][f"{s.of}_ll0" if s.ll == 0
                                      else str(s.of)] += 1
                off = sequences_mod.resolve_offset(s.of, s.ll, hist)
                if s.ml:
                    f["max_offset"] = max(f["max_offset"], off)
                f["max_match"] = max(f["max_match"], s.ml)
                block_out += s.ml
            f["sequences"] += sh.num_sequences
        content_size += block_out
    f["window"] = header.window_size or content_size
    f["content"] = content_size
    return f


def add_features(total: dict, f: dict) -> dict:
    """Sum of two feature records (counts added, maxima kept)."""
    out = {}
    for k, v in total.items():
        if isinstance(v, dict):
            out[k] = add_features(v, f[k])
        elif k.startswith("max_"):
            out[k] = max(v, f[k])
        else:
            out[k] = v + f[k]
    return out


def _put(frame: bytearray, at: int, data: bytes) -> None:
    frame[at:at + len(data)] = data


def targeted_mutants(frames: list, rng, n: int) -> list:
    """n mutants of `frames` (bytes), each (frame index, mutation, Region,
    mutant bytes). A mutation is "byte" (1-3 bytes of one region xor'ed
    with a random nonzero byte), "tail" (one bit of a stream's last two
    bytes flipped: its padding sentinel or the bits below it) or "swap"
    (a stream overwritten by the last bytes of a stream of the same kind
    in another frame). The Huffman and the sequence kernel's parts are
    picked about evenly, and of a kernel's parts its streams 7 times in 10
    (the descriptions and counts mostly stop the framer short of it)."""
    regions = [frame_regions(f) for f in frames]
    pools = {}
    for fi, rs in enumerate(regions):
        for r in rs:
            key = (REGION_KERNEL[r.kind], r.kind in STREAM_KINDS)
            pools.setdefault(key, []).append((fi, r))
    streams = {k: [(fi, r) for fi, rs in enumerate(regions) for r in rs
                   if r.kind == k] for k in STREAM_KINDS}
    kernels = sorted({k for k, _ in pools})
    out = []
    while len(out) < n:
        kernel = rng.choice(kernels)
        stream = rng.random() < 0.7
        pool = pools.get((kernel, stream)) or pools[(kernel, not stream)]
        fi, r = rng.choice(pool)
        z = bytearray(frames[fi])
        how = rng.random()
        if r.kind in STREAM_KINDS and how < 0.3:
            mutation = "tail"
            at = r.end - 1 - (rng.random() < 0.3 and r.end - r.start > 1)
            z[at] ^= 1 << rng.randrange(8)
        elif r.kind in STREAM_KINDS and how < 0.5:
            mutation = "swap"
            width = r.end - r.start
            donors = [(fj, s) for fj, s in streams[r.kind]
                      if fj != fi and s.end - s.start >= width]
            if not donors:
                continue
            fj, s = rng.choice(donors)
            _put(z, r.start, frames[fj][s.end - width:s.end])
        else:
            mutation = "byte"
            for _ in range(rng.randint(1, 3)):
                z[rng.randrange(r.start, r.end)] ^= rng.randrange(1, 256)
        if bytes(z) != frames[fi]:
            out.append((fi, mutation, r, bytes(z)))
    return out
