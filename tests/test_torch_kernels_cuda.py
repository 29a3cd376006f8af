"""CUDA kernels of zstd_tpu_torch against their plain torch versions.

These need an NVIDIA GPU with nvcc and skip elsewhere. Every comparison is
bit-exact, `ok` flags included: the codec is integer-only (tolerance 0).
The inputs are real batches framed from the package's own encoder, a
corrupted lane, hand-made execution regimes and random chained frames for
the windowed executor (near and far caps, dictionary prefills, matches
across group boundaries, bad offsets); the decoder runs chained frames and
the committed dictionary frames of zstd_tpu_torch/testdata. The encoder's
kernels (greedy parse, FSE encode) run on seeded random blocks and on the
sequence lanes of real payloads; the parse also on the lanes of the numpy
model of its segmented walk (tests/test_torch_parse_schedule.py: matches
and random stretches across segments, a lane past MAX_SEQS too wide for
shared memory, the same lanes read from global memory), with its
counters equal to the model's, and on candidates with lcp past 8 and 306
lanes; RLE-table and empty lanes included, and
the encoder on the card is held to the host encoder's frames. The
redesigned sequence kernel also runs 1-sequence lanes, RLE tables and a
batch of more than 1024 lanes; the resolve kernel runs random records
(repeat codes, of_value 0 and values near 2^31), the staged batch and
chained rows with inert padding and a 30-group chain. The window
kernel also runs hand-made chains (a ~60,000-byte-deep chain, matches at
the exact edge of their reach and one byte past it, a broken middle group,
prefill-only sources) and its 64-bit pointers on small inputs. The
single-group executor runs a ~1 MiB frame whose sources lie past its
shared-memory ring beside 16 KiB frames, 2048 rows at the smallest ring,
and random records whose rounds per chunk must equal those of the numpy
model of its schedule (tests/test_torch_execute_schedule.py); the
checksum kernel runs lengths 0-33 up to 128 KiB from unaligned starts.
The fused decode step (models/fused.py) on the card equals its CPU run.
A batch staged over a local mesh of two shards on one card (and over two
cards where there are two) equals the single-device decode bit for bit,
main-style and mixed (chained, dictionary and truncated frames), each
shard's kernels launched on its own device.
The committed libzstd frames (zstd_tpu_torch/testdata/libzstd: bench.py's
level-3 frames, levels 19, 1 and -5, a 4 MiB frame with a 2 MiB window, a
frame reaching past 8 MiB, edge frames) decode exact with each frame's own
device row ok (no host retry); the four decode kernels equal their plain
versions on them and on 128 targeted mutants (testdata/anatomy.py), whose
results equal the host oracle's decode_frame beside valid frames that stay
ok; the window kernel equals its plain version on the chained and far
frames.
The Huffman kernel runs the lanes of the numpy model of its segmented walk
(tests/test_torch_huffman_schedule.py: malformed lanes, tables that break
its property, short and one-symbol lanes), with its serial lanes and
re-walk rounds equal to the model's, streams past its shared staging size
and unaligned rows; the FSE-encode kernel
lanes of 1, 31-33, 63-65, 97 and S sequences and output caps below the
streams. This file imports neither jax nor zstandard, so on the GPU machine it runs
with:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_cuda.py
"""

import random

import numpy as np
import pytest
import torch

from zstd_tpu_torch.common.config import CodecConfig, CompressionLevel
from zstd_tpu_torch.common.errors import ZstdError
from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
from zstd_tpu_torch.encoding.device_matcher import DeviceMatcher
from zstd_tpu_torch.models.batch_decoder import BatchDecoder, chain_plan
from zstd_tpu_torch.models.batch_encoder import BatchEncoder
from zstd_tpu_torch.ops import _kernels
from zstd_tpu_torch.ops.bitpack import pack_bits_lanes
from zstd_tpu_torch.ops.execute import execute_lanes, execute_lanes_plain
from zstd_tpu_torch.ops.execute_window import (execute_window,
                                               execute_window_plain,
                                               rounds_used)
from zstd_tpu_torch.ops.fse_encode import (encode_sequence_lanes_plain,
                                           encode_sequences_packed,
                                           out_words_for, seq_lane_arrays)
from zstd_tpu_torch.ops.huffman import (huffman_lanes, huffman_lanes_plain,
                                        lane_stats)
from zstd_tpu_torch.ops.match_finder import (MIN_MATCH, find_candidates,
                                             parse_lanes, parse_lanes_plain,
                                             parse_stats)
from zstd_tpu_torch.ops.sequence import (resolve_frames, resolve_frames_plain,
                                         sequence_lanes, sequence_lanes_plain)
from zstd_tpu_torch.ops.xxhash64 import (xxh64_low32_lanes,
                                         xxh64_low32_lanes_plain)
from zstd_tpu_torch.parallel.mesh import make_mesh
from zstd_tpu_torch.oracle import decode_frame
from zstd_tpu_torch.testdata import (libzstd_payload, load_dict_fixture,
                                     load_libzstd_fixture, matches_digest)
from zstd_tpu_torch.testdata.anatomy import targeted_mutants

pytestmark = pytest.mark.cuda


def _payloads(n: int, size: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    words = [b"entropy", b"stream", b"zstandard", b"huffman", b"table",
             b"frame", b"block", b"decode", b"offset", b"sequence"]
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            idx = rng.integers(0, len(words), size=size // 6)
            p = b" ".join(words[j] for j in idx)
        elif kind == 1:
            p = b"".join(b"%d,%d,item-%d\n" % (j, (j * 37) % 1001, j % 64)
                         for j in range(size // 12))
        else:
            base = rng.integers(0, 256, size=int(rng.integers(64, 512)),
                                dtype=np.uint8).tobytes()
            p = base * (size // len(base) + 1)
        out.append(p[:size])
    return out


def random_chains(seed: int, n_chains: int = 8, groups: int = 3,
                  S: int = 64, lit_w: int = 1024):
    """Random chained frames for the windowed executor, and what it must
    give: the inputs of execute_window as numpy arrays, the expected
    accumulator, written bytes and ok per chain (a byte-by-byte loop).

    Chains differ in their dictionary prefill (hist0, 0 for some) and cap
    (a small near window, or a large far one). Matches reach across group
    boundaries into earlier groups and the prefill, and overlap their own
    output. Chain 1 has an offset past its reach in its second group, and
    chain 2 (small cap) one that lies inside its history but past its
    cap: both stop after their first group. The last chain is one group
    short, its plan padded with the inert row."""
    rng = np.random.default_rng(seed)
    C, K = n_chains, groups
    Bf = C * K + 1
    inert = Bf - 1
    rec = np.zeros((3, Bf, S), np.int32)
    lit = rng.integers(0, 256, (Bf, lit_w)).astype(np.uint8)
    lit[inert] = 0
    out_len = np.zeros(Bf, np.int32)
    row_lit_len = np.zeros(Bf, np.int32)
    plan = np.arange(C * K, dtype=np.int32).reshape(C, K)
    plan[C - 1, K - 1] = inert
    hist0 = np.where(np.arange(C) % 3 == 0, 0,
                     rng.integers(1, 400, C)).astype(np.int32)
    cap = np.where(np.arange(C) % 2 == 0, 1 << 20, 512).astype(np.int64)
    cap[2] = 256
    base = int(hist0.max())
    prefills = [rng.integers(0, 256, int(h)).astype(np.uint8).tobytes()
                for h in hist0]
    outs, oks = [], []
    for c in range(C):
        hist = bytearray(prefills[c])  # prefill, then the chain's output
        done, alive = 0, True
        for k in range(K - 1 if c == C - 1 else K):
            row = c * K + k
            w = len(hist) - len(prefills[c])
            avail = min(w + int(hist0[c]), int(cap[c]))
            pos = lp = 0
            bad = (c in (1, 2)) and k == 1
            for i in range(int(rng.integers(S // 2, S))):
                l = min(int(rng.integers(0, 40)), lit_w - lp)
                reach = pos + l + avail
                m = int(rng.integers(1, 60)) if reach else 0
                u = rng.random()
                if not m:
                    o = 0
                elif u < 0.3 and reach > pos + l:
                    o = int(rng.integers(pos + l + 1, reach + 1))  # boundary
                elif u < 0.5:
                    o = int(rng.integers(1, min(m, reach) + 1))  # overlap
                else:
                    o = int(rng.integers(1, reach + 1))
                if bad and i == 3:
                    m = max(m, 1)
                    o = (reach + 1 if c == 1
                         else min(pos + l + w + int(hist0[c]), reach + 9))
                rec[:, row, i] = (l, m, o)
                hist += lit[row, lp:lp + l].tobytes()
                for _ in range(m if o <= len(hist) else 0):
                    hist.append(hist[-o])
                pos += l + m
                lp += l
            out_len[row] = pos
            row_lit_len[row] = lp
            if alive and not bad:
                done = len(hist) - len(prefills[c])
            alive = alive and not bad
        outs.append(bytes(hist[len(prefills[c]):len(prefills[c]) + done]))
        oks.append(alive)
    width = base + int(out_len.max()) * K + 16
    acc = np.zeros((C, width), np.uint8)
    expect = acc.copy()
    for c in range(C):
        acc[c, base - len(prefills[c]):base] = np.frombuffer(prefills[c],
                                                              np.uint8)
        expect[c] = acc[c]
        expect[c, base:base + len(outs[c])] = np.frombuffer(outs[c], np.uint8)
    inputs = dict(ll=rec[0], ml=rec[1], offset=rec[2], lit=lit,
                  out_len=out_len, row_lit_len=row_lit_len, plan=plan,
                  acc=acc, base=base, hist0=hist0, cap=cap)
    return inputs, dict(acc=expect, written=[len(o) for o in outs], ok=oks)


def window_args(inputs, device):
    """execute_window's arguments on `device` (a fresh accumulator)."""
    return [inputs["base"] if k == "base"
            else torch.from_numpy(np.ascontiguousarray(inputs[k])).to(device)
            for k in ("ll", "ml", "offset", "lit", "out_len", "row_lit_len",
                      "plan", "acc", "base", "hist0", "cap")]


def window_byte_loop(inputs):
    """execute_window's contract as a byte loop: (acc, written, ok)."""
    ll, ml, off = (inputs[k].astype(np.int64)
                   for k in ("ll", "ml", "offset"))
    acc = inputs["acc"].copy()
    base, plan = inputs["base"], inputs["plan"]
    written, oks = [], []
    for c in range(plan.shape[0]):
        h0 = min(max(int(inputs["hist0"][c]), 0), base)
        w, ok = 0, True
        for r in plan[c]:
            row = min(max(int(r), 0), ll.shape[0] - 1)
            recs = list(zip(ll[row], ml[row], off[row]))
            avail = min(w + h0, int(inputs["cap"][c]))
            pos = lp = 0
            for l, m, o in recs:
                if l < 0 or m < 0 or (m and not 0 < o <= pos + l + avail):
                    ok = False
                pos += l + m
                lp += l
            ok = ok and (pos == inputs["out_len"][row]
                         and lp <= inputs["row_lit_len"][row]
                         and base + w + pos <= acc.shape[1])
            if not ok:
                break
            p, lp = base + w, 0
            for l, m, o in recs:
                acc[c, p:p + l] = inputs["lit"][row, lp:lp + l]
                p += l
                lp += l
                for _ in range(m):
                    acc[c, p] = acc[c, p - o]
                    p += 1
            w += pos
        written.append(w)
        oks.append(ok)
    return dict(acc=acc, written=written, ok=oks)


def chain_inputs(chains, hist0, cap, seed: int = 0, lit_w: int = 256):
    """execute_window's inputs for hand-made chains: chains[c] is a list of
    groups, each a list of (ll, ml, offset) records; each group's out_len
    and row_lit_len are its sums, its literals and each chain's prefill
    random. Plans are padded with a last, inert row; the expected result
    is window_byte_loop's."""
    rng = np.random.default_rng(seed)
    groups = [g for ch in chains for g in ch]
    Bf, S = len(groups) + 1, max(len(g) for g in groups)
    K = max(len(ch) for ch in chains)
    rec = np.zeros((3, Bf, S), np.int32)
    for row, g in enumerate(groups):
        rec[:, row, :len(g)] = np.asarray(g, np.int32).T
    lit = rng.integers(0, 256, (Bf, lit_w)).astype(np.uint8)
    plan = np.full((len(chains), K), Bf - 1, np.int32)
    row = 0
    for c, ch in enumerate(chains):
        plan[c, :len(ch)] = np.arange(row, row + len(ch))
        row += len(ch)
    hist0 = np.asarray(hist0, np.int32)
    base = int(hist0.max())
    out_len = (rec[0] + rec[1]).sum(axis=1).astype(np.int32)
    width = base + max(sum(int(out_len[r]) for r in p) for p in plan) + 8
    acc = np.zeros((len(chains), width), np.uint8)
    for c, h in enumerate(hist0):
        acc[c, base - h:base] = rng.integers(0, 256, int(h))
    inputs = dict(ll=rec[0], ml=rec[1], offset=rec[2], lit=lit,
                  out_len=out_len, row_lit_len=rec[0].sum(axis=1,
                                                          dtype=np.int32),
                  plan=plan, acc=acc, base=base, hist0=hist0,
                  cap=np.asarray(cap, np.int64))
    return inputs, window_byte_loop(inputs)


def deep_chain(groups: int = 30, per_group: int = 2000):
    """One chain of 4 literals, then groups * per_group - 1 records (0, 4,
    4) across `groups` groups: every match byte copies the byte 4 back, so
    the last one's source chain is ~60,000 bytes deep (about 16 doubling
    rounds). A 16-byte prefill no record reaches."""
    body = [(0, 4, 4)] * per_group
    chain = [[(4, 4, 4)] + body[1:]] + [body] * (groups - 1)
    return chain_inputs([chain], [16], [1 << 20], seed=1)


def reach_chains():
    """Matches at the edge of their reach, and a broken middle group.
    0: reaches exactly the first prefill byte (pos + hist0); 1: one byte
    past it; 2: reaches exactly `cap` back in its second group (cap below
    the history); 3: one byte past the cap there; 4: no prefill, reaches
    the chain's first byte exactly; 5: one past it; 6: a good group, a
    group with a zero offset, a good group: only the first is written."""
    g = [(5, 7, 3), (0, 9, 1)]
    return chain_inputs(
        [[[(8, 10, 72), (3, 5, 2)], g],
         [[(8, 10, 73), (3, 5, 2)], g],
         [[(60, 40, 30)], [(2, 5, 50), (1, 3, 4)], g],
         [[(60, 40, 30)], [(2, 5, 51), (1, 3, 4)], g],
         [[(6, 6, 6), (1, 4, 13)], g],
         [[(6, 6, 7)]],
         [[(9, 9, 3), (2, 4, 11)], [(1, 6, 5), (0, 3, 0)], g]],
        hist0=[64, 64, 0, 0, 0, 0, 0],
        cap=[1 << 20, 1 << 20, 48, 48, 1 << 20, 1 << 20, 1 << 20], seed=2)


def prefill_chains():
    """Every match reads only dictionary prefill bytes and no record has
    literals: every pointer is final when seeded (no jump round runs)."""
    return chain_inputs(
        [[[(0, 20, 300), (0, 30, 290), (0, 50, 250)],
          [(0, 40, 350), (0, 60, 400), (0, 7, 390)]],
         [[(0, 64, 64), (0, 1, 65)]]],
        hist0=[300, 64], cap=[1 << 20, 512], seed=3)


WINDOW_SETS = {"deep": deep_chain, "reach": reach_chains,
               "prefill": prefill_chains}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    _kernels.build_all()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def case(cuda):
    payloads = _payloads(12, 16 << 10)
    frames = [bytes(compress_to_vec(p, CompressionLevel.FASTEST))
              for p in payloads]
    # one frame without its checksum, an RLE block, raw blocks
    frames[1] = bytes(compress_to_vec(
        payloads[1], CompressionLevel.FASTEST,
        CodecConfig(write_checksum=False)))
    payloads += [b"a" * (1 << 17) + b"xyz" * 100, b"raw bytes " * 300]
    frames += [bytes(compress_to_vec(payloads[-2], CompressionLevel.FASTEST)),
               bytes(compress_to_vec(payloads[-1],
                                     CompressionLevel.UNCOMPRESSED))]
    dec = BatchDecoder(device=cuda)
    batch = dec.prepare(frames)
    return dec, batch, dec.stage(batch), payloads, frames


def _huff_args(d):
    return [d[k] for k in ("huff_streams", "huff_pos", "huff_tid",
                           "huff_nsym", "huff_dst_frame", "huff_dst_off",
                           "huff_tables", "huff_maxbits")]


def _seq_args(d):
    return [d[k] for k in ("seq_streams", "seq_pos", "seq_n", "ll_tid",
                           "of_tid", "ml_tid", "ll_tables", "of_tables",
                           "ml_tables", "ll_logs", "of_logs", "ml_logs",
                           "seq_dst_frame", "seq_dst_off", "seq_lit_total",
                           "seq_trail_slot")]


@pytest.mark.parametrize("corrupt", [False, True])
def test_huffman_kernel_matches_plain(case, corrupt):
    _, _, d, _, _ = case
    args = _huff_args(d)
    assert int((d["huff_nsym"] > 0).sum()) > 0
    if corrupt:
        # a flipped byte and a lane whose stream has no padding sentinel
        lanes = torch.nonzero(d["huff_nsym"] > 0)[:, 0]
        streams = args[0].clone()
        streams[int(lanes[0]), 0] ^= 0x5A
        pos = args[1].clone()
        pos[int(lanes[-1])] = -1
        args[0], args[1] = streams, pos
    outs = []
    for fn in (huffman_lanes, huffman_lanes_plain):
        lit = d["lit_base"].clone()
        ok = torch.ones(lit.shape[0], dtype=torch.bool, device=lit.device)
        fn(*args, lit, ok)
        outs.append((lit, ok))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert bool(outs[0][1].all()) != corrupt


def huffman_staged(stage, streams, init_pos, tid, nsym, dst_frame, dst_off,
                   tables, maxbits, lit, frame_ok):
    """huffman_lanes with the stream bytes the kernel stages in shared
    memory given (a longer stream reads global memory); its counters."""
    stats = torch.empty((4,), dtype=torch.int64, device=lit.device)
    _kernels.launch("huffman", streams, streams.shape[1], streams.shape[0],
                    init_pos, tid, nsym, dst_frame, dst_off, tables,
                    tables.shape[0], maxbits, lit, lit.shape[1],
                    lit.shape[0], frame_ok, stage, stats)
    warp, serial, rounds, most = stats.tolist()
    return {"warp_lanes": warp, "serial_lanes": serial,
            "rounds_sum": rounds, "rounds_max": most}


def _huff_both(device, a, lit, stage=None):
    """The kernel (with the given staging size, or its own) and the plain
    version on numpy lane arrays `a` (the schedule model's inputs)
    and literal rows `lit`: ((lit, ok) of each, the kernel's counters)."""
    from test_torch_huffman_schedule import LANE_KEYS

    t = [torch.from_numpy(np.ascontiguousarray(a[k]).astype(
        np.int32 if k == "huff_tables" else a[k].dtype)).to(device)
        for k in LANE_KEYS]
    outs = []
    for fn in (huffman_lanes, huffman_lanes_plain):
        out = torch.from_numpy(lit.copy()).to(device)
        ok = torch.ones(lit.shape[0], dtype=torch.bool, device=device)
        if fn is huffman_lanes and stage is not None:
            stats = huffman_staged(stage, *t, out, ok)
        else:
            fn(*t, out, ok)
            if fn is huffman_lanes:
                stats = lane_stats()
        outs.append((out, ok))
    torch.cuda.synchronize()
    return outs, stats


@pytest.fixture(scope="module")
def huff_main(cuda):
    from test_torch_huffman_schedule import main_lanes

    return main_lanes(8)


@pytest.mark.parametrize("kind", ["main", "flipped_byte", "init_neg",
                                  "nsym_plus", "nsym_minus", "nb_zero",
                                  "nb_over", "short_lanes"])
def test_huffman_kernel_on_model_lanes(cuda, huff_main, kind):
    """Main-corpus lanes with one bad lane of each kind (or short lanes and
    a one-symbol lane): bit-equal to the plain version; the serial lanes
    and the re-walk rounds equal the numpy model's."""
    from test_torch_huffman_schedule import run_model, variant

    a, lit, _ = variant(*huff_main, kind)
    ((lk, ok_k), (lp, ok_p)), stats = _huff_both(cuda, a, lit)
    assert torch.equal(lk, lp) and torch.equal(ok_k, ok_p)
    _, ok, rounds, serial = run_model(a, lit)
    assert ok.tolist() == ok_k.tolist()
    assert stats["serial_lanes"] == len(serial)
    assert stats["warp_lanes"] == len(rounds)
    assert stats["rounds_sum"] == sum(rounds.values())
    assert stats["rounds_max"] == max(rounds.values())


@pytest.mark.parametrize("stage,pad", [(None, 0), (256, 0), (256, 5),
                                       (None, 3), (4096, 1)])
def test_huffman_kernel_staging_sizes(cuda, huff_main, stage, pad):
    """The main lanes at their own destinations, staged in shared memory or
    read from global memory (streams past the staging size), from stream
    rows and into literal rows that are not aligned (`pad` bytes wider);
    0 serial lanes."""
    arrs, lit = huff_main
    a = dict(arrs)
    if pad:
        B, L = a["huff_streams"].shape
        a["huff_streams"] = np.concatenate(
            [a["huff_streams"], np.zeros((B, pad), np.uint8)], axis=1)
        lit = np.concatenate(
            [lit, np.full((lit.shape[0], pad), 7, np.uint8)], axis=1)
        a["huff_dst_off"] = a["huff_dst_off"] + pad
    ((lk, ok_k), (lp, ok_p)), stats = _huff_both(cuda, a, lit, stage)
    assert torch.equal(lk, lp) and torch.equal(ok_k, ok_p)
    assert bool(ok_k.all())
    assert stats["serial_lanes"] == 0
    assert stats["warp_lanes"] == int((a["huff_nsym"] > 0).sum())


def test_huffman_kernel_long_streams(cuda):
    """Frames of one 128 KiB block of letters: literal-only blocks whose
    four streams pass the 8 KiB staging size, decoded through global
    reads; bit-equal, 0 serial lanes, and the frames decode exactly."""
    rng = np.random.default_rng(5)
    payloads = [bytes(rng.choice(np.frombuffer(b"etaoinshrdlu", np.uint8),
                                 1 << 17)) for _ in range(3)]
    frames = [bytes(compress_to_vec(p, CompressionLevel.FASTEST))
              for p in payloads]
    dec = BatchDecoder(device=cuda)
    batch = dec.prepare(frames)
    live = batch.huff_nsym > 0
    assert int(batch.huff_len[live].max()) > 8192
    d = dec.stage(batch)
    outs = []
    for fn in (huffman_lanes, huffman_lanes_plain):
        lit = d["lit_base"].clone()
        ok = torch.ones(lit.shape[0], dtype=torch.bool, device=cuda)
        fn(*_huff_args(d), lit, ok)
        outs.append((lit, ok))
        if fn is huffman_lanes:
            stats = lane_stats()
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1]) and bool(outs[0][1].all())
    assert stats["serial_lanes"] == 0 and stats["warp_lanes"] == int(
        live.sum())
    assert dec.decode_frames(frames) == payloads


@pytest.mark.parametrize("corrupt", [False, True])
def test_sequence_kernel_matches_plain(case, corrupt):
    _, _, d, _, _ = case
    args = _seq_args(d)
    assert int((d["seq_n"] > 0).sum()) > 0
    if corrupt:
        streams = args[0].clone()
        streams[0, 3] ^= 0xA5
        args[0] = streams
    outs = []
    for fn in (sequence_lanes, sequence_lanes_plain):
        arrs = [d[k].clone() for k in ("ll_base", "ml_base", "of_base")]
        ok = torch.ones(arrs[0].shape[0], dtype=torch.bool,
                        device=arrs[0].device)
        fn(*args, *arrs, ok)
        outs.append(arrs + [ok])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert bool(outs[0][3].all()) != corrupt


def _regimes(device):
    rng = np.random.default_rng(7)
    cases = [
        [(5, 50, 1)],                      # offset 1: run-length fill
        [(10, 30, 7), (3, 40, 13)],        # small offsets, overlapping
        [(140, 200, 130)],                 # offset >= 128
        [(300, 400, 260), (5, 0, 0)],      # mid offset + trailing run
        [(64, 0, 0)],                      # literals only
        [(0, 0, 0), (8, 0, 0), (0, 0, 0), (2, 6, 3)],  # gap no-ops
        [(4, 10, 9)],                      # bad: offset past written bytes
        [(4, 4, 0)],                       # bad: offset 0
    ]
    B, S, lit_w = len(cases), 8, 1024
    LL = np.zeros((B, S), np.int32)
    ML = np.zeros((B, S), np.int32)
    OF = np.zeros((B, S), np.int32)
    lit = rng.integers(0, 256, (B, lit_w)).astype(np.uint8)
    out_len = np.zeros(B, np.int32)
    for b, seqs in enumerate(cases):
        for i, (l, m, o) in enumerate(seqs):
            LL[b, i], ML[b, i], OF[b, i] = l, m, o
        out_len[b] = int(LL[b].sum() + ML[b].sum())
    t = [torch.from_numpy(a).to(device) for a in (LL, ML, OF, lit, out_len)]
    rows = torch.arange(B, dtype=torch.int32, device=device)
    return t, rows


def test_execute_kernel_regimes(cuda):
    (ll, ml, of, lit, out_len), rows = _regimes(cuda)
    out_k, ok_k = execute_lanes(ll, ml, of, lit, out_len, rows, 2048)
    out_p, ok_p = execute_lanes_plain(ll, ml, of, lit, out_len, rows, 2048)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    assert ok_k.tolist() == [True] * 6 + [False, False]


def test_execute_kernel_on_batch(case):
    dec, batch, d, payloads, _ = case
    lit = d["lit_base"].clone()
    ll, ml, of = (d[k].clone() for k in ("ll_base", "ml_base", "of_base"))
    ok = torch.ones(lit.shape[0], dtype=torch.bool, device=lit.device)
    huffman_lanes(*_huff_args(d), lit, ok)
    sequence_lanes(*_seq_args(d), ll, ml, of, ok)
    from zstd_tpu_torch.models.batch_decoder import _resolve

    offsets, out_len, _ = _resolve(ll, ml, of, d["is_real"], d["init_hist"])
    rows = d["exec_rows"]
    out_k, ok_k = execute_lanes(ll, ml, offsets, lit, out_len, rows,
                                batch.out_width)
    out_p, ok_p = execute_lanes_plain(ll, ml, offsets, lit, out_len, rows,
                                      batch.out_width)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p) and torch.equal(ok_k, ok_p)
    assert bool(ok_k.all())
    for m, p in zip(batch.metas, payloads):
        r = d["exec_rows_list"].index(m.rows[0])
        assert out_k[r, :len(p)].cpu().numpy().tobytes() == p


def test_xxh64_kernel_matches_plain(cuda):
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.integers(0, 256, (64, 4096),
                                         dtype=np.uint8)).to(cuda)
    length = torch.from_numpy(
        rng.integers(0, 4000, 64).astype(np.int32)).to(cuda)
    start = torch.from_numpy(rng.integers(0, 64, 64).astype(np.int32)).to(cuda)
    for s in (None, start):
        got = xxh64_low32_lanes(data, length, s)
        exp = xxh64_low32_lanes_plain(data, length, s)
        torch.cuda.synchronize()
        assert torch.equal(got, exp)


@pytest.mark.parametrize("odd_width", [False, True])
def test_xxh64_kernel_lengths_and_starts(cuda, odd_width):
    """Lengths 0-33, around a tile and a whole 128 KiB lane, from start 0
    and from unaligned starts, on rows that are 16-byte aligned or not;
    against the plain version and the host hash."""
    from zstd_tpu_torch.utils.xxhash64 import xxhash64

    rng = np.random.default_rng(6)
    lengths = list(range(34)) + [63, 64, 1023, 1024, 1025, 4103, 1 << 17]
    W = (1 << 17) + (101 if odd_width else 64)
    n = 2 * len(lengths)
    data = rng.integers(0, 256, (n, W), dtype=np.uint8)
    length = np.asarray(lengths * 2, np.int32)
    start = np.concatenate([np.zeros(len(lengths), np.int32),
                            rng.integers(1, 64, len(lengths)).astype(
                                np.int32)])
    args = [torch.from_numpy(a).to(cuda) for a in (data, length, start)]
    got = xxh64_low32_lanes(*args)
    exp = xxh64_low32_lanes_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)
    host = [xxhash64(data[i, start[i]:start[i] + length[i]].tobytes())
            & 0xFFFFFFFF for i in range(n)]
    assert got.tolist() == host


def _exec_inputs(d):
    """The single-group executor's inputs on staged batch d: the entropy
    stages' and the resolution's outputs."""
    from zstd_tpu_torch.models.batch_decoder import _resolve

    lit = d["lit_base"].clone()
    ll, ml, of = (d[k].clone() for k in ("ll_base", "ml_base", "of_base"))
    ok = torch.ones(lit.shape[0], dtype=torch.bool, device=lit.device)
    huffman_lanes(*_huff_args(d), lit, ok)
    sequence_lanes(*_seq_args(d), ll, ml, of, ok)
    offsets, out_len, _ = _resolve(ll, ml, of, d["is_real"], d["init_hist"])
    return ll, ml, offsets, lit, out_len


@pytest.fixture(scope="module")
def big_case(cuda):
    """A single-group frame of ~1 MiB beside 16 KiB frames, all from the
    package's own encoder."""
    payloads = [b"".join(_payloads(3, 350 << 10, seed=4))]
    payloads += _payloads(6, 16 << 10, seed=5)
    frames = [bytes(compress_to_vec(p, CompressionLevel.FASTEST))
              for p in payloads]
    dec = BatchDecoder(device=cuda)
    batch = dec.prepare(frames)
    assert all(len(m.rows) == 1 for m in batch.metas)
    return dec, batch, dec.stage(batch), payloads, frames


def test_execute_kernel_rows_past_the_ring(big_case):
    """The ~1 MiB row reads most of its sources back from its output row
    (the ring is at most 64 KiB), the 16 KiB rows fit the ring; then the
    16 KiB rows given 2048 times over, which shrinks the ring to 8 KiB."""
    dec, batch, d, payloads, frames = big_case
    ll, ml, offsets, lit, out_len = _exec_inputs(d)
    rows, width = d["exec_rows"], d["exec_width"]
    assert width >= 1 << 20
    out_k, ok_k = execute_lanes(ll, ml, offsets, lit, out_len, rows, width)
    out_p, ok_p = execute_lanes_plain(ll, ml, offsets, lit, out_len, rows,
                                      width)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p) and bool(ok_k.all())
    for m, p in zip(batch.metas, payloads):
        r = d["exec_rows_list"].index(m.rows[0])
        assert out_k[r, :len(p)].cpu().numpy().tobytes() == p
    small = rows[1:].repeat(2048 // (rows.shape[0] - 1) + 1)[:2048]
    out_k, ok_k = execute_lanes(ll, ml, offsets, lit, out_len, small, 16384)
    out_p, ok_p = execute_lanes_plain(ll, ml, offsets, lit, out_len, small,
                                      16384)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p) and torch.equal(ok_k, ok_p)
    assert bool(ok_k.all())
    assert dec.decode_frames(frames) == payloads and dec.host_frames == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_execute_kernel_follows_the_schedule(cuda, seed):
    """Random records (long runs and fills, bad rows) against the plain
    version, and the kernel's rounds per chunk against the numpy model of
    its schedule (tests/test_torch_execute_schedule.py)."""
    from chip_smoke import random_records
    from test_torch_execute_schedule import model_lanes
    from zstd_tpu_torch.ops.execute import rounds_stats

    rec, lit, out_len, out_w, short = random_records(seed)
    (b, n), = short.items()
    for lit_w in (lit.shape[1], n):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
             for a in (rec[0], rec[1], rec[2], lit[:, :lit_w], out_len)]
        rows = torch.arange(rec.shape[1], dtype=torch.int32, device=cuda)
        out_k, ok_k = execute_lanes(*t, rows, out_w)
        stats = rounds_stats()
        out_p, ok_p = execute_lanes_plain(*t, rows, out_w)
        torch.cuda.synchronize()
        assert torch.equal(out_k, out_p) and torch.equal(ok_k, ok_p)
        _, ok, rounds = model_lanes(rec[0], rec[1], rec[2], lit[:, :lit_w],
                                    out_len, np.arange(rec.shape[1]), out_w,
                                    1 << 16)
        assert ok.tolist() == ok_k.tolist()
        assert stats["chunks"] == len(rounds) and stats["max"] == max(rounds)
        assert stats["mean"] == pytest.approx(np.mean(rounds))
    assert not bool(ok_k[b])


def test_decoder_on_cuda(case):
    dec, batch, d, payloads, frames = case
    launches = [f.launches for f in (huffman_lanes, sequence_lanes,
                                     execute_lanes, xxh64_low32_lanes)]
    assert dec.decode_frames(frames) == payloads
    _, _, ok = dec.run_device(batch, d, pull_outputs=False)
    assert ok.all()
    after = [f.launches for f in (huffman_lanes, sequence_lanes,
                                  execute_lanes, xxh64_low32_lanes)]
    assert all(a > b for a, b in zip(after, launches))
    assert dec.host_frames == 0


def test_pipelined_on_cuda(case):
    dec, _, _, payloads, frames = case
    got = list(dec.decode_frames_pipelined([frames[:5], frames[5:]]))
    assert got[0] + got[1] == payloads
    served = list(dec.decode_frames_pipelined([frames, frames],
                                              pull_outputs=False))
    assert all(bool(ok.all()) for _, _, ok in served)


def fused_case(device, corrupt: bool):
    """(kwargs on `device`, static, payloads, bad frame or None): the fused
    step's example_batch(32), or 12 frames of 16 KiB with the last byte
    of frame 3's sequence stream zeroed (its padding sentinel lost)."""
    from zstd_tpu_torch.models.framer import Framer
    from zstd_tpu_torch.models.fused import (example_batch, fused_static,
                                             to_fused_kwargs)

    if not corrupt:
        return (*example_batch(32, device=device), None)
    payloads = _payloads(12, 16 << 10, seed=5)
    framer = Framer()
    for i, p in enumerate(payloads):
        framer.add_frame(compress_to_vec(p, CompressionLevel.FASTEST), i)
    batch = framer.build()
    bad = 3
    lane = int(np.nonzero((batch.seq_n > 0)
                          & (batch.seq_dst_frame == bad))[0][0])
    batch.seq_streams = batch.seq_streams.copy()
    batch.seq_streams[lane, batch.seq_len[lane] - 1] = 0
    return (to_fused_kwargs(batch, device), fused_static(batch, 16 << 10),
            payloads, bad)


@pytest.mark.parametrize("corrupt", [False, True])
def test_fused_step_on_cuda_equals_its_cpu_run(cuda, corrupt):
    """models/fused.py's step on the card (one launch each of the Huffman,
    sequence, resolve and execute kernels) against the same step on the
    CPU (their plain versions): on example_batch(32), and on a batch with
    one broken sequence stream (its frame alone fails, all zero)."""
    from zstd_tpu_torch.models.fused import fused_decode_step

    kw, static, payloads, bad = fused_case(cuda, corrupt)
    fns = (huffman_lanes, sequence_lanes, resolve_frames, execute_lanes)
    before = [f.launches for f in fns]
    got = fused_decode_step(**kw, **static)
    assert [f.launches for f in fns] == [b + 1 for b in before]
    ref = fused_decode_step(**{k: v.cpu() for k, v in kw.items()}, **static)
    for a, b in zip(got[:3], ref[:3]):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert {k: int(v) for k, v in got[3].items()} == \
        {k: int(v) for k, v in ref[3].items()}
    out, out_len, ok = (t.cpu() for t in got[:3])
    assert int(got[3]["frames_bad"]) == (1 if corrupt else 0)
    for i, p in enumerate(payloads):
        if i != bad:
            assert bool(ok[i]) and int(out_len[i]) == len(p)
            assert out[i, :len(p)].numpy().tobytes() == p
    if corrupt:
        assert not bool(ok[bad]) and not out[bad].any()


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_execute_kernel_random_records(cuda, seed):
    """Copy boundaries (offset == ll + ml, offset == all bytes written,
    overlaps, long literal runs) against a byte-by-byte loop."""
    rng = np.random.default_rng(seed)
    B, S, lit_w = 64, 48, 2048
    rec = np.zeros((3, B, S), np.int32)
    lit = rng.integers(0, 256, (B, lit_w)).astype(np.uint8)
    expect = []
    for b in range(B):
        out, lp = bytearray(), 0
        for i in range(S):
            big = rng.random() < 0.2 and lp < lit_w - 300
            l = min(int(rng.integers(120, 300) if big
                        else rng.integers(0, 40)), lit_w - lp)
            hi = len(out) + l
            m = int(rng.integers(0, 70)) if hi else 0
            c = rng.random()
            o = (l + m if c < 0.25 else hi if c < 0.45
                 else int(rng.integers(1, hi + 1)) if hi else 0)
            o = min(o, hi)
            if o == 0:
                m = 0
            rec[:, b, i] = (l, m, o)
            out += lit[b, lp:lp + l].tobytes()
            lp += l
            for _ in range(m):
                out.append(out[len(out) - o])
        expect.append(bytes(out))
    out_len = np.array([len(e) for e in expect], np.int32)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
         for a in (rec[0], rec[1], rec[2], lit, out_len)]
    rows = torch.arange(B, dtype=torch.int32, device=cuda)
    width = int(out_len.max()) + 64
    out_k, ok_k = execute_lanes(*t, rows, width)
    out_p, ok_p = execute_lanes_plain(*t, rows, width)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p) and bool(ok_k.all())
    for b, e in enumerate(expect):
        assert out_k[b, :len(e)].cpu().numpy().tobytes() == e


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_window_kernel_random_chains(cuda, seed):
    inputs, exp = random_chains(seed)
    got = []
    for fn in (execute_window, execute_window_plain):
        args = window_args(inputs, cuda)
        written, ok = fn(*args)
        got.append((args[7], written, ok))
    torch.cuda.synchronize()
    (acc_k, w_k, ok_k), (acc_p, w_p, ok_p) = got
    assert torch.equal(acc_k, acc_p) and torch.equal(w_k, w_p)
    assert torch.equal(ok_k, ok_p)
    assert np.array_equal(acc_k.cpu().numpy(), exp["acc"])
    assert w_k.tolist() == exp["written"] and ok_k.tolist() == exp["ok"]


def _window_on(fn, device, inputs, **kw):
    """(acc, written, ok) of fn on a fresh copy of `inputs` on `device`."""
    args = window_args(inputs, device)
    written, ok = fn(*args, **kw)
    return args[7], written, ok


@pytest.mark.parametrize("name", sorted(WINDOW_SETS))
def test_window_kernel_edge_chains(cuda, name):
    inputs, exp = WINDOW_SETS[name]()
    before = execute_window.launches
    acc_k, w_k, ok_k = _window_on(execute_window, cuda, inputs,
                                   wide=False)
    assert execute_window.launches == before + 1
    rounds = rounds_used()
    acc_p, w_p, ok_p = _window_on(execute_window_plain, cuda, inputs)
    torch.cuda.synchronize()
    assert torch.equal(acc_k, acc_p) and torch.equal(w_k, w_p)
    assert torch.equal(ok_k, ok_p)
    assert np.array_equal(acc_k.cpu().numpy(), exp["acc"])
    assert w_k.tolist() == exp["written"] and ok_k.tolist() == exp["ok"]
    bound = execute_window.last_cuda_launches - 4  # the jump launches
    assert bound == inputs["acc"].shape[1].bit_length()
    if name == "deep":
        assert 1 < rounds <= bound
    if name == "prefill":
        assert rounds == 0  # every pointer final when seeded


@pytest.mark.parametrize("seed", [24, None])
def test_window_kernel_wide_pointers(cuda, seed):
    """The 64-bit pointer instantiation, forced on small inputs (random
    chains, and the deep chain when seed is None)."""
    inputs, exp = random_chains(seed) if seed else WINDOW_SETS["deep"]()
    acc_k, w_k, ok_k = _window_on(execute_window, cuda, inputs,
                                   wide=True)
    torch.cuda.synchronize()
    C, width = inputs["acc"].shape
    assert execute_window.last_scratch_bytes >= 8 * C * (width -
                                                         inputs["base"])
    assert np.array_equal(acc_k.cpu().numpy(), exp["acc"])
    assert w_k.tolist() == exp["written"] and ok_k.tolist() == exp["ok"]
    assert rounds_used() > 0


def test_decoder_on_cuda_chained(cuda):
    """Chained frames (2.5 MiB, two block groups each) and the dictionary
    frames decode through the window kernel, one launch per chain width
    group, none on the host."""
    raw, dict_frames, digests = load_dict_fixture()
    payloads = _payloads(3, 5 << 19, seed=4)
    frames = [bytes(compress_to_vec(p, CompressionLevel.FASTEST))
              for p in payloads] + dict_frames
    dec = BatchDecoder(device=cuda)
    dec.add_dict(raw)
    batch = dec.prepare(frames)
    assert all(len(m.rows) > 1 for m in batch.metas[:3])
    before = execute_window.launches
    out = dec.decode_frames(frames)
    assert out[:3] == payloads
    assert all(matches_digest(o, dg) for o, dg in zip(out[3:], digests))
    groups = chain_plan(batch)["groups"]
    assert len(groups) > 1 and dec.host_frames == 0
    assert execute_window.launches == before + len(groups)
    outputs, out_len, ok = dec.run_device(batch, pull_outputs=False)
    for m, p in zip(batch.metas, payloads):
        acc, lane, base = outputs[m.rows[0]]
        n = int(out_len[m.rows[0]])
        assert bool(ok[m.rows[0]]) and n == len(p)
        assert acc[lane, base:base + n].cpu().numpy().tobytes() == p


def random_blocks(seed: int, B: int = 18, L: int = 8192):
    """Seeded blocks for the parse: text, random bytes, long repeats (the
    extension past 8 bytes, up to the valid end), RLE-ish, a short lane,
    an empty lane and a lane one byte long."""
    rng = np.random.default_rng(seed)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon"]
    blocks = []
    for i in range(B):
        kind = i % 6
        if kind == 0:
            b = b" ".join(words[j] for j in rng.integers(0, 5, L // 5))
        elif kind == 1:
            b = rng.integers(0, 256, L, dtype=np.uint8).tobytes()
        elif kind == 2:
            unit = rng.integers(0, 256, int(rng.integers(16, 700)),
                                dtype=np.uint8).tobytes()
            b = unit * (L // len(unit) + 1)
        elif kind == 3:
            b = bytes([int(rng.integers(0, 4))]) * int(rng.integers(100, L))
        elif kind == 4:
            b = b"ab" * int(rng.integers(1, 200)) + rng.integers(
                0, 256, 50, dtype=np.uint8).tobytes()
        else:
            b = [b"", b"q", b"xyzxyzxyz"][i // 6]
        blocks.append(b[:L])
    data = np.zeros((B, L), np.uint8)
    nv = np.zeros(B, np.int32)
    for i, b in enumerate(blocks):
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        nv[i] = len(b)
    return data, nv


@pytest.mark.parametrize("seed", [31, 32])
def test_parse_kernel_matches_plain(cuda, seed):
    data, nv = random_blocks(seed)
    d = torch.from_numpy(data).to(cuda)
    n = torch.from_numpy(nv).to(cuda)
    cand, lcp = find_candidates(d, n)
    before = parse_lanes.launches
    got = parse_lanes(d, cand, lcp, n)
    exp = parse_lanes_plain(d, cand, lcp, n)
    torch.cuda.synchronize()
    assert parse_lanes.launches == before + 1
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    assert int(got[1].max()) > 136  # an extension of whole 128-byte steps


def _parse_both(device, args):
    """The parse kernel and the plain version on numpy lanes `args`
    (data, cand, lcp, n_valid): (kernel outputs, plain outputs, the
    kernel's counters)."""
    args = [torch.from_numpy(a).to(device) for a in args]
    got = parse_lanes(*args)
    stats = parse_stats()
    exp = parse_lanes_plain(*args)
    torch.cuda.synchronize()
    return got, exp, stats


@pytest.mark.parametrize("name", ["random31", "random32", "spanning",
                                  "cap", "serial"])
def test_parse_kernel_on_model_lanes(cuda, name):
    """The schedule model's lanes (empty, one-byte, RLE, random and
    long-repeat lanes; matches and literal runs across segments; a 256 KiB
    lane past MAX_SEQS, too wide for shared memory; lanes whose segments
    never resynchronise, walked serially): bit-equal to the plain version,
    with the counters the numpy model gives."""
    from test_torch_parse_schedule import lane_set, model_lanes

    got, exp, stats = _parse_both(cuda, lane_set(name))
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    assert stats == model_lanes(*lane_set(name))[5]
    if name == "cap":
        assert stats["truncated_lanes"] == 1
    if name == "serial":
        assert stats["serial_lanes"] == 3


def test_parse_kernel_global_memory(cuda):
    """The spanning lanes in a batch 256 KiB wide, too wide for shared
    memory, so the kernel reads bytes, lcp and the skip set from global
    memory: bit-equal, with the model's counters."""
    from test_torch_parse_schedule import lane_set, model_lanes

    data, cand, lcp, nv = lane_set("spanning")
    pad = (1 << 18) - data.shape[1]
    args = (np.pad(data, ((0, 0), (0, pad))),
            np.pad(cand, ((0, 0), (0, pad)), constant_values=-1),
            np.pad(lcp, ((0, 0), (0, pad))), nv)
    got, exp, stats = _parse_both(cuda, args)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    assert stats == model_lanes(*args)[5]


def test_parse_kernel_lcp_past_8(cuda):
    """Candidates with lcp 9-12 (not find_candidates' own, which caps at
    8): such a match is taken at its lcp without extension, and the
    kernel reads those lanes' lcp from global memory: bit-equal."""
    from test_torch_parse_schedule import lane_set

    data, cand, lcp, nv = (a.copy() for a in lane_set("random31"))
    pos = np.arange(data.shape[1])[None, :]
    bump = (lcp >= MIN_MATCH) & (pos % 7 == 0) & (pos + 12 <= nv[:, None])
    lcp[bump] = 9 + (pos % 4).repeat(len(nv), 0)[bump]
    args = [torch.from_numpy(a).to(cuda) for a in (data, cand, lcp, nv)]
    got = parse_lanes(*args)
    exp = parse_lanes_plain(*args)
    torch.cuda.synchronize()
    assert int(bump.sum()) > 100
    for a, b in zip(got, exp):
        assert torch.equal(a, b)


def test_parse_kernel_many_lanes(cuda):
    """306 lanes (612 CTAs, several waves of clusters): bit-equal."""
    sets = [random_blocks(seed, L=4096) for seed in range(40, 57)]
    data = np.concatenate([d for d, _ in sets])
    nv = np.concatenate([n for _, n in sets])
    d = torch.from_numpy(data).to(cuda)
    n = torch.from_numpy(nv).to(cuda)
    cand, lcp = find_candidates(d, n)
    got = parse_lanes(d, cand, lcp, n)
    exp = parse_lanes_plain(d, cand, lcp, n)
    torch.cuda.synchronize()
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    assert parse_stats()["lanes"] == int((nv > 0).sum())


def _seq_lanes(device, payloads):
    """The sequence lanes the encoder plans for `payloads` (host matcher)."""
    enc = BatchEncoder(device=device)
    seq = []
    for p in payloads:
        enc._plan_frame(p, [], seq)
    return seq


def test_fse_encode_kernel_matches_plain(cuda):
    payloads = _payloads(6, 40 << 10, seed=8) + [
        b"ab" * 1000,                                  # one sequence: RLE
        b"".join(b"key%04d=" % (i % 97) + b"v" * 9 for i in range(3000))]
    lanes = _seq_lanes(cuda, payloads)
    assert any(0 in l.logs for l in lanes)             # an RLE-table stream
    arrays = seq_lane_arrays(lanes, cuda)
    arrays[3][1] = 0                                   # an nseq == 0 lane
    ow = out_words_for(arrays[0].shape[1])
    before = encode_sequences_packed.launches
    words, total = encode_sequences_packed(*arrays, ow)
    pw, pt = pack_bits_lanes(*encode_sequence_lanes_plain(*arrays), ow)
    torch.cuda.synchronize()
    assert encode_sequences_packed.launches == before + 1
    assert torch.equal(words, pw) and torch.equal(total, pt)
    assert int(total[1]) == 0 and not bool(words[1].any())


@pytest.fixture(scope="module")
def fse_lanes(cuda):
    payloads = _payloads(6, 40 << 10, seed=8) + [
        b"".join(b"key%04d=" % (i % 97) + b"v" * 9 for i in range(3000))]
    return seq_lane_arrays(_seq_lanes(cuda, payloads), cuda)


@pytest.mark.parametrize("counts", [(1, 31, 32, 33, None),
                                    (2, 63, 64, 65, 97)])
def test_fse_encode_kernel_chunk_edges(cuda, fse_lanes, counts):
    """Lanes cut to 1, 31, 32, 33, ... sequences (one chunk of 32 and its
    edges) and one of all S slots (None; its zero padding encodes as
    sequences too): bit-equal to the plain version."""
    arrays = [a.clone() for a in fse_lanes]
    S = arrays[0].shape[1]
    nseq = arrays[3]
    for lane, c in enumerate(counts):
        nseq[lane] = S if c is None else min(c, S)
    ow = out_words_for(S)
    words, total = encode_sequences_packed(*arrays, ow)
    pw, pt = pack_bits_lanes(*encode_sequence_lanes_plain(*arrays), ow)
    torch.cuda.synchronize()
    assert torch.equal(words, pw) and torch.equal(total, pt)


@pytest.mark.parametrize("out_words", [1, 40, 301])
def test_fse_encode_kernel_past_out_words(cuda, fse_lanes, out_words):
    """An output cap below the lanes' streams: words past it are dropped
    and the totals still count every bit, as in the plain version."""
    words, total = encode_sequences_packed(*fse_lanes, out_words)
    pw, pt = pack_bits_lanes(*encode_sequence_lanes_plain(*fse_lanes),
                             out_words)
    torch.cuda.synchronize()
    assert int(total.max()) > 32 * out_words
    assert torch.equal(words, pw) and torch.equal(total, pt)


def test_batch_encoder_on_cuda_equals_host_encoder(cuda):
    payloads = _payloads(6, 100 << 10, seed=9) + [b"", b"ab",
                                                   b"z" * 50000]
    before = encode_sequences_packed.launches
    frames = BatchEncoder().compress_frames(payloads)
    assert encode_sequences_packed.launches == before + 1
    for p, z in zip(payloads, frames):
        assert z == compress_to_vec(p, CompressionLevel.FASTEST)


def test_device_matched_frames_on_cuda(cuda):
    """The device-matched frames on the card equal the same encoder's
    frames on the CPU (plain versions), and decode on the card."""
    payloads = _payloads(6, 100 << 10, seed=10) + [b"", b"xy"]
    launches = (parse_lanes.launches, encode_sequences_packed.launches)
    frames = BatchEncoder(matcher=DeviceMatcher()).compress_frames(payloads)
    assert parse_lanes.launches == launches[0] + 1
    assert encode_sequences_packed.launches == launches[1] + 1
    ref = BatchEncoder(matcher=DeviceMatcher(device="cpu"),
                       device="cpu").compress_frames(payloads)
    assert frames == ref
    dec = BatchDecoder(device=cuda)
    assert dec.decode_frames(frames) == payloads and dec.host_frames == 0


# ---- the redesigned sequence kernel and the resolve kernel ------------------

def _seq_on(d, args=None):
    """(ll, ml, of, frame_ok) of the sequence kernel and of its plain
    version on staged batch d, and the kernel's launch count delta."""
    outs = []
    before = sequence_lanes.launches
    for fn in (sequence_lanes, sequence_lanes_plain):
        arrs = [d[k].clone() for k in ("ll_base", "ml_base", "of_base")]
        ok = torch.ones(arrs[0].shape[0], dtype=torch.bool,
                        device=arrs[0].device)
        fn(*(args or _seq_args(d)), *arrs, ok)
        outs.append(arrs + [ok])
    torch.cuda.synchronize()
    return outs, sequence_lanes.launches - before


def _small_lane_frames(seed: int = 3) -> list:
    """Frames whose blocks hold one sequence each, frames whose code
    streams are RLE tables (log 0), and a 300 KiB frame of three blocks:
    one row fed by several lanes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        r = rng.integers(0, 256, 200, dtype=np.uint8).tobytes()
        out.append(r + r[:60] + rng.integers(0, 256, 50,
                                             dtype=np.uint8).tobytes())
    return out + [b"ab" * 1000, b"xyz" * 3000, b"q" * 5000 + b"r" * 10,
                  _payloads(1, 300 << 10, seed)[0]]


@pytest.mark.parametrize("kind", ["small_lanes", "wide_batch"])
def test_sequence_kernel_lane_shapes(cuda, kind):
    """1-sequence lanes, RLE tables and a row of several lanes, or more
    than 1024 lanes (several lanes per SM): bit-equal to the plain
    version."""
    if kind == "small_lanes":
        payloads = _small_lane_frames()
    else:
        rng = np.random.default_rng(6)
        payloads = [rng.integers(0, 4, 1500, dtype=np.uint8).tobytes() * 2
                    for _ in range(1100)]
    frames = [bytes(compress_to_vec(p, CompressionLevel.FASTEST))
              for p in payloads]
    dec = BatchDecoder(device=cuda)
    batch = dec.prepare(frames)
    d = dec.stage(batch)
    n = batch.seq_n[:-1]
    if kind == "small_lanes":
        assert (n == 1).sum() >= 6
        live = n > 0
        logs = [batch.ll_logs[batch.ll_tid[:-1][live]],
                batch.of_logs[batch.of_tid[:-1][live]],
                batch.ml_logs[batch.ml_tid[:-1][live]]]
        assert all((lg == 0).any() for lg in logs)
        rows = batch.seq_dst_frame[:-1][live]
        assert np.bincount(rows).max() >= 3
    else:
        assert (n > 0).sum() > 1024
    (got, exp), launched = _seq_on(d)
    assert launched == 1
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    assert bool(got[3].all())
    assert dec.decode_frames(frames) == payloads and dec.host_frames == 0


@pytest.mark.parametrize("where", ["init_neg", "init_far", "stream_top",
                                   "stream_tail", "wide_states"])
def test_sequence_kernel_corrupted_lanes(case, where):
    """A lane whose start (negative, or far past its bytes), top bytes or
    last bytes are broken, or tables whose state updates read 32 and 31
    bits (a sequence's fields then pass 63 bits): every slot and flag as
    the plain version has them."""
    _, _, d, _, _ = case
    args = _seq_args(d)
    lanes = torch.nonzero(d["seq_n"] > 0)[:, 0]
    b = int(lanes[len(lanes) // 2])
    if where == "wide_states":
        for i, nb in ((6, 32), (7, 31)):  # the LL and OF tables
            args[i] = (args[i] & ~0xFF00) | (nb << 8)
    elif where.startswith("init"):
        pos = args[1].clone()
        pos[b] = -1 if where == "init_neg" else pos[b] + 40000
        args[1] = pos
    else:
        streams = args[0].clone()
        top = int(d["seq_pos"][b]) // 8
        lo = 0 if where == "stream_tail" else max(top - 3, 0)
        streams[b, lo:lo + 4] ^= 0x5A
        args[0] = streams
    (got, exp), _ = _seq_on(d, args)
    for a, e in zip(got, exp):
        assert torch.equal(a, e)
    if where == "init_neg":
        assert not bool(got[3][int(d["seq_dst_frame"][b])])


def random_resolve(seed: int, B: int = 40, S: int = 300):
    """Random records: literal and repeat codes, ll == 0 shifts,
    synthetic records, of_value 0 and negative, values near 2^31 and
    lengths whose row sums wrap."""
    rng = np.random.default_rng(seed)
    ll = rng.integers(0, 3, (B, S)).astype(np.int64)
    ml = rng.integers(0, 60, (B, S)).astype(np.int64)
    ofv = np.where(rng.random((B, S)) < 0.5, rng.integers(1, 4, (B, S)),
                   rng.integers(4, 5000, (B, S))).astype(np.int64)
    big = rng.random((B, S)) < 0.03
    ofv = np.where(big, (1 << 31) - rng.integers(1, 8, (B, S)), ofv)
    ofv[:10] = np.where(rng.random((10, S)) < 0.01, 0, ofv[:10])
    ofv[3, 7] = -(1 << 31)
    ll[5] = (1 << 31) - 1  # row 5's length wraps
    is_real = rng.random((B, S)) < 0.85
    is_real[3, 7] = True
    hist = rng.integers(1, 1 << 20, (B, 3)).astype(np.int64)
    hist[2] = [(1 << 31) - 1, 1, 2]
    return [torch.from_numpy(x.astype(np.int32)) for x in (ll, ml, ofv)] + [
        torch.from_numpy(is_real), torch.from_numpy(hist.astype(np.int32))]


def random_chain_plan(B: int, seed: int):
    """Chains over rows 0..B-2 (one of 30 groups, others of 1-4), padded
    with the inert row B - 1; cont marks every chain's rows after its
    first."""
    rng = np.random.default_rng(seed)
    rows, cont = [], np.zeros(B, bool)
    order = rng.permutation(B - 1)
    sizes = [30] + list(rng.integers(1, 5, B))
    at = 0
    for n in sizes:
        if at >= B - 1:
            break
        chain = order[at:at + n]
        rows.append(chain)
        cont[chain[1:]] = True
        at += n
    K = max(len(r) for r in rows)
    plan = np.full((len(rows), K), B - 1, np.int32)
    for c, r in enumerate(rows):
        plan[c, :len(r)] = r
    return torch.from_numpy(plan), torch.from_numpy(cont)


def _resolve_both(device, args, chain=None):
    args = [a.to(device) for a in args]
    chain = [] if chain is None else [c.to(device) for c in chain]
    before = resolve_frames.launches
    got = resolve_frames(*args, *chain)
    exp = resolve_frames_plain(*args, *chain)
    torch.cuda.synchronize()
    assert resolve_frames.launches == before + 1
    return got, exp


@pytest.mark.parametrize("seed,chained,S", [(41, False, 300),
                                            (42, False, 2500),
                                            (43, True, 300), (44, True, 2500)])
def test_resolve_kernel_random_records(cuda, seed, chained, S):
    """Random records; rows of one warp task (300 slots) and of three
    (2500: the later tasks start from the earlier ones' transforms)."""
    args = random_resolve(seed, B=80 if chained else 40, S=S)
    chain = random_chain_plan(args[0].shape[0], seed) if chained else None
    if chained:
        assert (chain[0] != args[0].shape[0] - 1).sum(1).max() == 30
    got, exp = _resolve_both(cuda, args, chain)
    assert resolve_frames.last_cuda_launches == (3 if chained else 2)
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ok = got[2].tolist()
    assert not ok[3] and True in ok and False in ok


def test_resolve_kernel_staged_batches(case):
    """The staged batch's records after the entropy stages, and the same
    records with a chain plan laid over their rows."""
    _, _, d, _, _ = case
    lit = d["lit_base"].clone()
    ll, ml, of = (d[k].clone() for k in ("ll_base", "ml_base", "of_base"))
    ok = torch.ones(lit.shape[0], dtype=torch.bool, device=lit.device)
    sequence_lanes(*_seq_args(d), ll, ml, of, ok)
    args = [ll, ml, of, d["is_real"], d["init_hist"]]
    for chain in (None, random_chain_plan(ll.shape[0], 5)):
        got, exp = _resolve_both(ll.device, args, chain)
        for a, b in zip(got, exp):
            assert torch.equal(a, b)
        if chain is None:
            assert bool(got[2][:-1].all())


def _mesh_frames(kind: str):
    """(frames, expected, dictionary, digests): main-style 16 KiB frames,
    or a mixed batch (a 2.5 MiB chained frame, the committed dictionary
    frames, whose digests are {frame index: digest}, and a truncated frame,
    expected None, beside small ones)."""
    payloads = _payloads(12, 16 << 10, seed=7)
    frames = [bytes(compress_to_vec(p, CompressionLevel.FASTEST))
              for p in payloads]
    if kind == "main":
        return frames, payloads, None, {}
    raw, dict_frames, digests = load_dict_fixture()
    big = _payloads(1, 5 << 19, seed=8)[0]
    frames = frames[:4] + [bytes(compress_to_vec(big,
                                                 CompressionLevel.FASTEST))]
    at = len(frames)
    frames += dict_frames + [frames[0][:len(frames[0]) // 2]]
    expected = payloads[:4] + [big] + [b""] * len(dict_frames) + [None]
    return frames, expected, raw, {at + i: d for i, d in enumerate(digests)}


@pytest.mark.parametrize("kind", ["main", "mixed"])
@pytest.mark.parametrize("cards", ["one", "two"])
def test_local_mesh_equals_single_device(cuda, kind, cards):
    if cards == "two" and torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    devices = ["cuda:0", "cuda:0"] if cards == "one" else ["cuda:0", "cuda:1"]
    mesh = make_mesh(devices=devices)
    frames, expected, raw, digests = _mesh_frames(kind)
    dec = BatchDecoder(device="cuda:0")
    if raw is not None:
        dec.add_dict(raw)
    batch = dec.prepare(frames)
    single = dec.run_device(batch)
    staged = dec.stage(batch, mesh=mesh)
    _kernels.device_launches.clear()
    sharded = dec.run_device(batch, staged)
    launched = dict(_kernels.device_launches)
    assert np.array_equal(single[1], sharded[1])
    assert np.array_equal(single[2], sharded[2])
    got = dec._postprocess(frames, batch, *sharded)
    assert got == dec._postprocess(frames, batch, *single)
    for i, (g, e) in enumerate(zip(got, expected)):
        assert matches_digest(g, digests[i]) if i in digests else g == e
    assert dec.host_frames == 0
    # each shard's stages launched on its own device, and nowhere else
    parts = [p for p in staged["shards"] if p is not None]
    assert len(parts) == 2
    want = {}
    for dev, (_, _, d) in zip(mesh.devices, parts):
        idx = dev.index or 0
        for name in ("huffman", "sequence", "resolve"):
            want[name, idx] = want.get((name, idx), 0) + 1
        if d["exec_rows_list"]:
            want["execute", idx] = want.get(("execute", idx), 0) + 1
        for _ in d["chains"] or ():
            want["execute_window", idx] = \
                want.get(("execute_window", idx), 0) + 1
    assert launched == want
    # serving handles give the same bytes
    outputs, out_len, ok = dec.run_device(batch, staged, pull_outputs=False)
    for i, (m, e) in enumerate(zip(batch.metas, expected)):
        if e is None:
            continue
        r = m.rows[0]
        h = outputs[r]
        row = (h[0][h[1], h[2]:h[2] + int(out_len[r])] if len(h) == 3
               else h[0][h[1], m.dict_skip:int(out_len[r])])
        assert bool(ok[r]) and row.cpu().numpy().tobytes() == got[i]


# --- libzstd's frames (zstd_tpu_torch/testdata/libzstd) ----------------------

@pytest.fixture(scope="module")
def libzstd(cuda):
    """The committed libzstd frames by group, each with its payload."""
    cache, out = {}, {}
    for e in load_libzstd_fixture():
        out.setdefault(e["group"], []).append(
            {**e, "data": libzstd_payload(e, cache)})
    return out


def _rows_exact(dec, batch, staged, payloads, pull: bool):
    """Each frame's own row of run_device ok, its out_len and (pulled) its
    bytes its payload's: read from the rows, so a frame the device rejected
    fails here where decode_frames would retry it on the host."""
    outputs, out_len, ok = dec.run_device(batch, staged, pull_outputs=pull)
    for i, (m, p) in enumerate(zip(batch.metas, payloads)):
        assert m.ok and not m.fallback and m.rows, (i, m.error)
        r = m.rows[0]
        assert bool(ok[r]) and int(out_len[r]) == m.dict_skip + len(p), i
        if pull:
            assert outputs[r][m.dict_skip:m.dict_skip + len(p)].tobytes() \
                == p, i


@pytest.mark.parametrize("group", ["main", "levels", "chained", "far",
                                   "edge"])
def test_libzstd_frames_on_cuda(libzstd, group):
    es = libzstd[group]
    frames, payloads = [e["frame"] for e in es], [e["data"] for e in es]
    dec = BatchDecoder()
    batch = dec.prepare(frames)
    staged = dec.stage(batch)
    _rows_exact(dec, batch, staged, payloads, pull=True)
    _rows_exact(dec, batch, staged, payloads, pull=False)
    assert dec.decode_frames(frames) == payloads
    assert dec.host_frames == 0
    assert all(matches_digest(p, e["digest"]) for p, e in zip(payloads, es))


def _libzstd_mutant_batch(libzstd):
    """128 targeted mutants of the checksum-less fixture frames, each
    beside a valid fixture frame: (frames, mutants, valid entries)."""
    bases = [e["frame"] for g in ("levels", "edge") for e in libzstd[g]
             if not e["checksum"]]
    valid = libzstd["main"] + libzstd["levels"] + libzstd["edge"]
    mutants = targeted_mutants(bases, random.Random(13), 128)
    beside = [valid[j % len(valid)] for j in range(len(mutants))]
    frames = [x for m, v in zip(mutants, beside) for x in (m[3], v["frame"])]
    return frames, mutants, beside


def _decode_kernels_vs_plain(d):
    """The four decode kernels on staged batch d against their plain
    versions, each kernel given the kernels' outputs before it: the plain
    Huffman and sequence stages on a CPU copy of their inputs (a step
    loop costs a few launches a step on the card), resolve and execute on
    the card. Bit-equal, ok flags included. Returns how many frame rows
    each kernel flagged."""
    dev = d["lit_base"].device
    Bf = d["lit_base"].shape[0]
    cpu = [t.cpu() for t in _huff_args(d)]
    lit, lit_p = d["lit_base"].clone(), d["lit_base"].cpu().clone()
    ok_h, ok_hp = torch.ones(Bf, dtype=torch.bool, device=dev), \
        torch.ones(Bf, dtype=torch.bool)
    huffman_lanes(*_huff_args(d), lit, ok_h)
    huffman_lanes_plain(*cpu, lit_p, ok_hp)
    assert torch.equal(lit.cpu(), lit_p) and torch.equal(ok_h.cpu(), ok_hp)
    recs = [d[k].clone() for k in ("ll_base", "ml_base", "of_base")]
    recs_p = [t.cpu() for t in recs]
    ok_s, ok_sp = torch.ones_like(ok_h), torch.ones_like(ok_hp)
    sequence_lanes(*_seq_args(d), *recs, ok_s)
    sequence_lanes_plain(*[t.cpu() for t in _seq_args(d)], *recs_p, ok_sp)
    for a, b in zip(recs + [ok_s], recs_p + [ok_sp]):
        assert torch.equal(a.cpu(), b)
    ll, ml, of = recs
    chain = ([] if d["chains"] is None
             else [d["chain_rows"], d["chain_row_cont"]])
    args = [ll, ml, of, d["is_real"], d["init_hist"], *chain]
    got, exp = resolve_frames(*args), resolve_frames_plain(*args)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    offsets, out_len, ok_r = got
    flagged = {"huffman": int((~ok_h).sum()), "sequence": int((~ok_s).sum()),
               "resolve": int((~ok_r).sum())}
    if d["exec_rows_list"]:
        ex = [ll, ml, offsets, lit, out_len, d["exec_rows"], d["exec_width"]]
        got, exp = execute_lanes(*ex), execute_lanes_plain(*ex)
        assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])
        flagged["execute"] = int((~got[1]).sum())
    return flagged


@pytest.mark.parametrize("batch_of", ["fixture", "mutants"])
def test_libzstd_decode_kernels_match_plain(libzstd, batch_of):
    if batch_of == "fixture":
        frames = [e["frame"] for g in ("main", "levels", "edge")
                  for e in libzstd[g]]
    else:
        frames = _libzstd_mutant_batch(libzstd)[0]
    dec = BatchDecoder()
    flagged = _decode_kernels_vs_plain(dec.stage(dec.prepare(frames)))
    if batch_of == "fixture":
        assert not any(flagged.values()), flagged
    else:
        assert flagged["huffman"] and flagged["sequence"], flagged


@pytest.mark.parametrize("group", ["chained", "far"])
def test_libzstd_window_kernel_matches_plain(libzstd, group):
    dec = BatchDecoder()
    d = dec.stage(dec.prepare([libzstd[group][0]["frame"]]))
    lit, ll, ml, of = (d[k].clone() for k in ("lit_base", "ll_base",
                                              "ml_base", "of_base"))
    ok = torch.ones(lit.shape[0], dtype=torch.bool, device=lit.device)
    huffman_lanes(*_huff_args(d), lit, ok)
    sequence_lanes(*_seq_args(d), ll, ml, of, ok)
    offsets, out_len, _ = resolve_frames(ll, ml, of, d["is_real"],
                                         d["init_hist"], d["chain_rows"],
                                         d["chain_row_cont"])
    (g,) = d["chains"]
    outs = []
    for fn in (execute_window, execute_window_plain):
        acc = torch.zeros((len(g["first"]), g["width"]), dtype=torch.uint8,
                          device=lit.device)
        written, w_ok = fn(ll, ml, offsets, lit, out_len, d["row_lit_len"],
                           g["rows"], acc, g["base"], g["hist0"], g["cap"])
        outs.append((acc, written, w_ok))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    acc, written, w_ok = outs[0]
    e = libzstd[group][0]
    assert bool(w_ok.all()) and int(written[0]) == e["size"]
    assert acc[0, g["base"]:g["base"] + e["size"]].cpu().numpy().tobytes() \
        == e["data"]


def test_libzstd_mutants_on_cuda(libzstd):
    """128 targeted mutants beside valid frames: no CUDA error, each result
    the host oracle's decode_frame's (None where it raises), each valid
    frame's own device row ok and exact, the context alive afterwards."""
    frames, mutants, beside = _libzstd_mutant_batch(libzstd)
    dec = BatchDecoder()
    batch = dec.prepare(frames)
    outputs, out_len, ok = dec.run_device(batch)
    got = dec._postprocess(frames, batch, outputs, out_len, ok)
    torch.cuda.synchronize()
    for j, (m, v) in enumerate(zip(mutants, beside)):
        try:
            want = decode_frame(m[3])
        except ZstdError:
            want = None
        assert got[2 * j] == want, (j, m[1], m[2].kind)
        meta = batch.metas[2 * j + 1]
        r = meta.rows[0]
        assert bool(ok[r]) and got[2 * j + 1] == v["data"], v["file"]
    main = libzstd["main"]
    assert dec.decode_frames([e["frame"] for e in main]) == \
        [e["data"] for e in main]
