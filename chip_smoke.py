#!/usr/bin/env python3
"""Smoke run of zstd_tpu_torch on one NVIDIA GPU: build, check, measure.

    python3 chip_smoke.py        (from the repository root)

Needs one CUDA card and nvcc. Imports torch and zstd_tpu_torch only. Every
phase raises on failure, so any failure exits non-zero:

  1. card: `nvidia-smi` name and power limit, torch's device name
  2. build: every kernel source of zstd_tpu_torch/csrc/, one nvcc each,
     all started together
  3. kernels against their plain torch versions on a small real batch
     (32 frames of 16 KiB from the package's own encoder, one of them
     corrupted) and hand-made LZ77 regimes; the decoded batch against the
     payloads and the host oracle; the executor on random records (bad
     rows included), a 1 MiB single-group frame beside 16 KiB ones and
     2048 rows at its smallest ring; the checksum on lengths 0-33 to
     128 KiB from aligned and unaligned starts
  4. main path: 1024 frames of 128 KiB (make_corpus(128)), FASTEST with
     checksums, through BatchDecoder().decode_frames (every byte checked,
     no frame on the host; Huffman, sequence, resolve and execute
     launched) and one serving run (run_device(pull_outputs=False),
     checksums verified on the device), whose launch counts alone the
     kernels line reports
  5. serving: a warm-up and 5 timed serving runs, then per-stage device
     times from a torch.profiler capture of run_device's trace scopes
  6. each kernel at the main path's shapes on the main path's inputs:
     bit-equal to its plain version, both timed, beside its bound (the
     executor at the staged width of its own rows); the executor's match
     rounds per chunk of 32 records; the Huffman kernel's lanes by the
     warp walk and serially (none may be serial) and its re-walk rounds
  7. small chained batch: three 2.5 MiB frames (two block groups each),
     the committed dictionary frames (zstd_tpu_torch/testdata) and a
     2.5 MiB frame broken in its second group; the window kernel bit-equal
     to its plain version there, every byte checked, the broken frame
     equal to the host oracle's answer and alone in failing
  8. chained path: 16 frames of 8 MiB (make_corpus(128, frame_kb=8192),
     8 MiB window, about 5 block groups each) through decode_frames (every
     byte checked, no frame on the host) and one serving run, whose window
     kernel launches the kernels line reports; a warm-up, 5 timed serving
     runs and per-stage device times, as in 5; the chain width groups and
     their accumulators' size
  9. far window: one 12 MiB frame at window_log 24 (bench.py's bigwindow
     body) decoded and timed; how many resolved matches reach past 8 MiB
 10. the window kernel at the chained path's shapes on its inputs, and on
     the far frame's (one chain, cap the real window): bit-equal to its
     plain version, both timed, beside its bound; its jump rounds, CUDA
     launches per call and scratch bytes; the resolve kernel with the chain
     plans of both batches, bit-equal to its plain version and timed; the
     Huffman kernel on both batches, bit-equal, no lane serial
 11. entropy path: bench.py's encode scenario (make_corpus(8, seed=5), 64
     frames of 128 KiB) through BatchEncoder() with the host matcher;
     every frame equal to compress_to_vec's, fse_encode launched
 12. device encoder, the main path of the encode slice: the same corpus
     through BatchEncoder(matcher=DeviceMatcher()); every frame decoded
     exact by the oracle and by BatchDecoder() on the card (host_frames
     0), parse and fse_encode launched in the counted run; ratio beside
     the host matcher's; 3 timed runs, MB/s, the host/device split
     (last_stats) and the device ms of its trace scopes (torch.profiler)
 13. CLI: `python -m zstd_tpu_torch.cli compress --gpu`, then `decompress
     --gpu`, as subprocesses on one 8 MiB frame (chained on decode); exact
 14. the parse and fse_encode kernels at phase 12's shapes on its inputs:
     bit-equal to their plain versions, both timed, beside their bounds;
     the parse kernel's counters (segments, re-walk rounds, lanes walked
     serially, of which there may be none, and lanes past MAX_SEQS)
 15. the fused step (models/fused.py) on phase 4's batch at out_width
     131072, run right after phase 6: every frame's bytes and out_len,
     frames_bad 0, bytes_out; one counted call launches the Huffman,
     sequence, resolve and execute kernels; 5 timed runs (GB/s beside
     phase 5's serving) and its stages' device ms
 16. decoding across two ranks on the one card: two child processes
     (`chip_smoke.py --rank R DIR`, loading the kernels phase 2 built) in
     a gloo group over a file:// store under build/, each running
     decode_frames_multihost on the main corpus plus a truncated frame
     (None) and sharded_decode on make_mesh(2) over 256 of its frames,
     every result checked in frame order on each rank; fails unless both
     exit 0; scaling_report at world 1 (here) and 2 (one card: not a
     scaling measurement)
 17. process-parallel encode: compress_frames_parallel on phase 11's
     corpus (the pool branch, spawned workers), every frame equal to
     compress_to_vec's; MB/s of the host's cores
 18. the local mesh in one process, run after phase 10 (late in the
     script, torch.profiler captures were seen to lose device events):
     make_mesh(devices=["cuda:0"] * 2), two shards on the one card.
     Phase 4's batch through stage(batch, mesh=) and run_device, every
     byte, out_len and ok as the single-device run, the four decode
     kernels once per shard, its serving GB/s and device busy ms beside
     the single device's (the partition and the reassembly, not
     scaling); a mixed batch (chained, dictionary, window_log-24 and
     truncated frames) lane for lane, the window kernel on each shard
     holding chains; sharded_decode over the mesh on phase 15's batch
     equal to the unsharded fused step
 19. libzstd's frames (zstd_tpu_torch/testdata/libzstd, committed; their
     payloads made again from seeds), run after phase 18: bench.py's 16
     level-3 frames 64 times (1024 x 128 KiB), the level and edge frames,
     a stream with a skippable frame (decode_all_device), one level-19
     frame through the CLI's decompress --gpu, the 4 MiB chained frame
     (window 2 MiB) and the far frame (matches past 8 MiB): each frame's
     own device row ok and exact, pulled and in serving mode (no frame
     retried on the host), host_frames 0, the path's kernels launched,
     the decode kernels and the window kernel bit-equal to their plain
     versions, main serving GB/s beside phase 5's; then 512 targeted
     mutants (testdata/anatomy.py) beside valid frames: no CUDA error,
     every result the host oracle's decode_frame's, every valid frame ok,
     the corrupted lanes reaching the Huffman and sequence kernels counted
     (at least 128 each); the main batch exact again afterwards
 20. bench.py on the card, run after phase 17: zstd_tpu_torch.bench's
     scenarios in this process (run_scenarios), the headline on phase 4's
     frames and payloads, then libzstd's main frames tiled to 1024 with
     its chained and far frames, the longframe, bigwindow and encode
     scenarios, each scenario's kernels launched in its own run
     (BENCH_KERNELS); the bench's JSON line on a line of its own
     (`[chip_smoke] bench: {...}`), every key of BENCH_r05.json's
     `parsed` in it, every correctness key true (each read from the
     frames' own device rows); a pipelined round beside a warm host
     prepare of its frames and a serving run, and the phase's seconds

The line before the last is the `kernels` JSON object; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

from zstd_tpu_torch.testdata.payloads import make_corpus

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA's H100 SXM data sheet
# no integer-ALU row in the data sheet: the float32 non-tensor peak stands in
H100_OPS_PER_S = 67e12


def say(*args):
    print("[chip_smoke]", *args, flush=True)


class Check(AssertionError):
    pass


def need(cond, what: str):
    if not cond:
        raise Check(what)


# --- kernels: how to call each one on a staged batch -------------------------

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


def stage_outputs(d):
    """Literal rows and records after the entropy stages on staged batch d:
    (lit, ll, ml, of)."""
    import torch

    from zstd_tpu_torch.ops import huffman, sequence

    dev = d["lit_base"].device
    lit = d["lit_base"].clone()
    ll, ml, of = (d[k].clone() for k in ("ll_base", "ml_base", "of_base"))
    ok = torch.ones(lit.shape[0], dtype=torch.bool, device=dev)
    huffman.huffman_lanes(*_huff_args(d), lit, ok)
    sequence.sequence_lanes(*_seq_args(d), ll, ml, of, ok)
    return lit, ll, ml, of


def resolve_case(d, ll, ml, of):
    """(setup, call, kernel, plain) of the resolve kernel on the staged
    batch `d` and the records the sequence stage gave it, with the batch's
    chain plan when it has one."""
    from zstd_tpu_torch.ops import sequence

    chain = ([] if d["chains"] is None
             else [d["chain_rows"], d["chain_row_cont"]])

    def call(fn, _):
        return list(fn(ll, ml, of, d["is_real"], d["init_hist"], *chain))

    return (list, call, sequence.resolve_frames,
            sequence.resolve_frames_plain)


def huffman_case(d):
    """(setup, call, kernel, plain) of the Huffman kernel on staged batch d."""
    import torch

    from zstd_tpu_torch.ops import huffman

    def setup():
        lit = d["lit_base"].clone()
        return [lit, torch.ones(lit.shape[0], dtype=torch.bool,
                                device=lit.device)]

    def call(fn, bufs):
        fn(*_huff_args(d), *bufs)
        return bufs

    return setup, call, huffman.huffman_lanes, huffman.huffman_lanes_plain


def sequence_case(d):
    """(setup, call, kernel, plain) of the sequence kernel on staged batch
    d."""
    import torch

    from zstd_tpu_torch.ops import sequence

    def setup():
        arrs = [d[k].clone() for k in ("ll_base", "ml_base", "of_base")]
        return arrs + [torch.ones(arrs[0].shape[0], dtype=torch.bool,
                                  device=arrs[0].device)]

    def call(fn, bufs):
        fn(*_seq_args(d), *bufs)
        return bufs

    return setup, call, sequence.sequence_lanes, sequence.sequence_lanes_plain


def kernel_cases(d, stage=None):
    """{name: (setup() -> buffers, call(fn, buffers) -> outputs, kernel fn,
    plain fn)} on the staged batch `d`, plus the stage outputs. The
    resolve, execute and checksum inputs are what the stages before them
    produce (`stage`, the entropy stages' (lit, ll, ml, of), when given);
    the executor runs at the staged width of its own rows."""
    from zstd_tpu_torch.models.batch_decoder import _resolve
    from zstd_tpu_torch.ops import execute, xxhash64

    lit, ll, ml, of = stage_outputs(d) if stage is None else stage
    offsets, out_len, _ = _resolve(ll, ml, of, d["is_real"], d["init_hist"])
    rows = d["exec_rows"]
    out_width = d["exec_width"]
    out, _ = execute.execute_lanes(ll, ml, offsets, lit, out_len, rows,
                                   out_width)
    skip = d["ck_skip"]
    length = out_len[rows.long()] - skip

    def call_exec(fn, _):
        return list(fn(ll, ml, offsets, lit, out_len, rows, out_width))

    def call_xxh(fn, _):
        return [fn(out, length, skip)]

    cases = {
        "huffman": huffman_case(d),
        "sequence": sequence_case(d),
        "resolve": resolve_case(d, ll, ml, of),
        "execute": (list, call_exec, execute.execute_lanes,
                    execute.execute_lanes_plain),
        "xxhash64": (list, call_xxh, xxhash64.xxh64_low32_lanes,
                     xxhash64.xxh64_low32_lanes_plain),
    }
    return cases, dict(ll=ll, ml=ml, out_len=out_len, length=length,
                       lit=lit, offsets=offsets)


def window_case(d):
    """(setup, call, kernel, plain) of the window kernel on the staged
    batch `d` (which holds chained frames): one call per width group of
    its chain plan, each into its own accumulator, the inputs what the
    stages before it produce; plus those inputs."""
    import torch

    from zstd_tpu_torch.models.batch_decoder import _resolve_chained
    from zstd_tpu_torch.ops import execute_window as ew

    lit, ll, ml, of = stage_outputs(d)
    offsets, out_len, _ = _resolve_chained(
        ll, ml, of, d["is_real"], d["init_hist"], d["chain_rows"],
        d["chain_row_cont"])
    groups = d["chains"]

    def setup():
        accs = []
        for g in groups:
            acc = torch.zeros((len(g["first"]), g["width"]),
                              dtype=torch.uint8, device=lit.device)
            if g["base"]:
                acc[:, :g["base"]] = g["prefill"]
            accs.append(acc)
        return accs

    def call(fn, bufs):
        outs = []
        for g, acc in zip(groups, bufs):
            written, ok = fn(ll, ml, offsets, lit, out_len, d["row_lit_len"],
                             g["rows"], acc, g["base"], g["hist0"], g["cap"])
            outs += [acc, written, ok]
        return outs

    return ((setup, call, ew.execute_window, ew.execute_window_plain),
            dict(ll=ll, ml=ml, offsets=offsets, out_len=out_len))


def max_abs_err(a_list, b_list) -> int:
    err = 0
    for a, b in zip(a_list, b_list):
        need(a.shape == b.shape and a.dtype == b.dtype,
             f"output shape/dtype {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def compare(name, setup, call, kern, plain) -> int:
    """Kernel and plain version on the same inputs; 0 or raise."""
    import torch

    got = call(kern, setup())
    exp = call(plain, setup())
    torch.cuda.synchronize()
    err = max_abs_err(got, exp)
    need(err == 0, f"{name}: kernel differs from its plain version "
                   f"(max abs err {err})")
    return err


def cuda_ms(setup, call, fn, reps: int) -> float:
    """Mean device time of call(fn, setup()) over reps calls, CUDA events
    around the call only (fresh output buffers made before each)."""
    import torch

    total = 0.0
    for _ in range(reps):
        bufs = setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        call(fn, bufs)
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


# --- phases ------------------------------------------------------------------

def phase_card():
    import torch

    from zstd_tpu_torch.bench import card as query_card

    card = query_card("cuda:0")
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    say(f"card: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    return card, name


def phase_build():
    from zstd_tpu_torch.ops import _kernels

    secs = _kernels.build_all(force=True)
    for n in _kernels.NAMES:
        _kernels.entry(n)
    say(f"build: {len(_kernels.NAMES)} kernels in {secs:.1f} s")


def _regimes(device):
    import torch

    rng = np.random.default_rng(7)
    cases = [[(5, 50, 1)], [(10, 30, 7), (3, 40, 13)], [(140, 200, 130)],
             [(300, 400, 260), (5, 0, 0)], [(64, 0, 0)],
             [(0, 0, 0), (8, 0, 0), (0, 0, 0), (2, 6, 3)],
             [(4, 10, 9)], [(4, 4, 0)]]
    B, S = len(cases), 8
    arr = np.zeros((3, B, S), np.int32)
    for b, seqs in enumerate(cases):
        for i, rec in enumerate(seqs):
            arr[:, b, i] = rec
    lit = rng.integers(0, 256, (B, 1024)).astype(np.uint8)
    out_len = (arr[0] + arr[1]).sum(axis=1).astype(np.int32)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for a in (arr[0], arr[1], arr[2], lit, out_len)]
    rows = torch.arange(B, dtype=torch.int32, device=device)
    return t, rows, [True] * 6 + [False, False]


def random_records(seed: int, B: int = 24, S: int = 160, lit_w: int = 6000):
    """execute_lanes' inputs as numpy arrays (records (3, B, S) i32, lit,
    out_len, out_w, and {row: a literal width that starves it}): rows of
    random records: short and long literal runs, offsets 1, 2, small and
    reaching the row start, self-overlapping fills, matches over the
    kernel's 64-byte long-run threshold and over its 1 KiB piece,
    zero-length records; the last rows broken in one way each (a bad
    offset, offset 0, a negative length, out_len off by one, too few
    literals, out_len past the width)."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((3, B, S), np.int32)
    lit = rng.integers(0, 256, (B, lit_w)).astype(np.uint8)
    for b in range(B):
        written = lp = 0
        for i in range(S):
            c = rng.random()
            if c < 0.1:
                continue  # a zero-length gap
            l = int(rng.integers(0, 4) if rng.random() < 0.8
                    else rng.integers(60, 300))
            l = min(l, lit_w - lp)
            hi = written + l
            m = 0
            if hi:
                m = int(rng.choice([rng.integers(3, 20), rng.integers(60, 70),
                                    rng.integers(1000, 2500)],
                                   p=[0.85, 0.1, 0.05]))
            k = rng.random()
            o = (1 if k < 0.1 else 2 if k < 0.15 else hi if k < 0.25
                 else int(rng.integers(1, min(hi, 40) + 1)) if k < 0.7
                 else int(rng.integers(1, hi + 1))) if hi else 0
            o = min(o, hi)
            if o == 0:
                m = 0
            rec[:, b, i] = (l, m, o)
            written, lp = hi + m, lp + l
    n = B - 1
    rec[1, n, 5] = max(rec[1, n, 5], 5)                           # offset
    rec[2, n, 5] = int(rec[:2, n, :5].sum() + rec[0, n, 5]) + 1   # too far
    rec[1, n - 1, 3], rec[2, n - 1, 3] = 5, 0                     # offset 0
    rec[0, n - 2, 7] = -1                                         # negative
    out_len = (rec[0].astype(np.int64) + rec[1]).sum(axis=1).astype(np.int32)
    out_len[n - 3] += 1                                           # total off
    lit_short = int(rec[0, n - 4].sum()) - 1                      # literals
    out_w = int(out_len.max()) + 32
    out_len[n - 5] = out_w + 1                                    # too wide
    return rec, lit, out_len, out_w, {n - 4: lit_short}


def phase_small():
    import torch

    from zstd_tpu_torch.common.config import CompressionLevel
    from zstd_tpu_torch.common.errors import ZstdError
    from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder
    from zstd_tpu_torch.oracle import decode_all
    from zstd_tpu_torch.ops.execute import execute_lanes, execute_lanes_plain

    payloads = make_corpus(1, frame_kb=16, seed=1)[:32]
    frames = [bytes(compress_to_vec(p, CompressionLevel.FASTEST))
              for p in payloads]
    # corrupt frame 5 inside its last block's sequence bitstream
    bad = bytearray(frames[5])
    bad[-7] ^= 0x24
    frames[5] = bytes(bad)
    dec = BatchDecoder()
    batch = dec.prepare(frames)
    d = dec.stage(batch)
    cases, _ = kernel_cases(d)
    for name, case in cases.items():
        compare(name, *case)
    (ll, ml, of, lit, out_len), rows, want = _regimes(d["lit_base"].device)
    out_k, ok_k = execute_lanes(ll, ml, of, lit, out_len, rows, 2048)
    out_p, ok_p = execute_lanes_plain(ll, ml, of, lit, out_len, rows, 2048)
    torch.cuda.synchronize()
    need(torch.equal(out_k, out_p) and torch.equal(ok_k, ok_p),
         "execute regimes: kernel differs from its plain version")
    need(ok_k.tolist() == want, f"execute regimes: ok {ok_k.tolist()}")

    res = dec.decode_frames(frames)
    for i, (r, p, f) in enumerate(zip(res, payloads, frames)):
        if i == 5:
            try:
                ref = decode_all(f)
            except ZstdError:
                ref = None
            need(r == ref, "corrupted frame: device path and oracle differ")
        else:
            need(r == p, f"small batch: frame {i} decoded wrong")
            need(decode_all(f) == p, f"small batch: oracle frame {i}")
    say(f"kernels vs plain versions: bit-equal on {len(frames)} x 16 KiB "
        f"frames (one corrupted: {'None' if res[5] is None else 'decoded'})"
        f" and {len(want)} execute regimes")
    phase_exec_checks(payloads[:8])


def phase_exec_checks(small_payloads):
    """The execute and checksum kernels beyond the main path's shapes:
    random records (long runs, fills, six kinds of bad row); a single-group
    frame of 1 MiB beside 16 KiB frames (the large row reads most sources
    back from its output row) and the 16 KiB rows given 2048 times over
    (an 8 KiB ring); checksums of lengths 0-33 up to 128 KiB from aligned
    and unaligned starts. Each bit-equal to its plain version."""
    import torch

    from zstd_tpu_torch.common.config import CompressionLevel
    from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder
    from zstd_tpu_torch.ops import execute, xxhash64

    dev = torch.device("cuda")
    rows_ok = []
    for seed in (1, 2, 3):
        rec, lit, out_len, out_w, short = random_records(seed)
        (_, n), = short.items()
        for lit_w in (lit.shape[1], n):
            t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (rec[0], rec[1], rec[2], lit[:, :lit_w], out_len)]
            rows = torch.arange(rec.shape[1], dtype=torch.int32, device=dev)
            compare("execute (random records)", list,
                    lambda fn, _: list(fn(*t, rows, out_w)),
                    execute.execute_lanes, execute.execute_lanes_plain)
            rows_ok.append(int(execute.execute_lanes(*t, rows, out_w)[1]
                               .sum()))
    need(max(rows_ok) <= 19, "execute random records: a broken row passed")

    big = b"".join(make_corpus(1, frame_kb=1024, seed=2))
    payloads = [big] + list(small_payloads)
    frames = [bytes(compress_to_vec(p, CompressionLevel.FASTEST))
              for p in payloads]
    dec = BatchDecoder()
    batch = dec.prepare(frames)
    need(all(len(m.rows) == 1 for m in batch.metas),
         "1 MiB frame: not single-group")
    d = dec.stage(batch)
    cases, inputs = kernel_cases(d)
    for name in ("execute", "xxhash64"):
        compare(f"{name} (1 MiB frame)", *cases[name])
    small = d["exec_rows"][1:].repeat(2048 // (len(payloads) - 1) + 1)[:2048]
    width = 1 << (max(len(p) for p in small_payloads) - 1).bit_length()
    args = [inputs[k] for k in ("ll", "ml", "offsets", "lit", "out_len")]
    compare("execute (16 KiB rows x 2048)", list,
            lambda fn, _: list(fn(*args, small, width)),
            execute.execute_lanes, execute.execute_lanes_plain)
    need(dec.decode_frames(frames) == payloads and dec.host_frames == 0,
         "1 MiB frame batch: decoded bytes differ")

    rng = np.random.default_rng(6)
    lengths = list(range(34)) + [63, 64, 1023, 1024, 1025, 4103, 1 << 17]
    for extra in (64, 101):
        W = (1 << 17) + extra
        data = torch.from_numpy(rng.integers(
            0, 256, (2 * len(lengths), W), dtype=np.uint8)).to(dev)
        length = torch.tensor(lengths * 2, dtype=torch.int32, device=dev)
        start = torch.from_numpy(np.concatenate([
            np.zeros(len(lengths), np.int32),
            rng.integers(1, 64, len(lengths)).astype(np.int32)])).to(dev)
        compare("xxhash64 (lengths, starts)", list,
                lambda fn, _: [fn(data, length, start)],
                xxhash64.xxh64_low32_lanes, xxhash64.xxh64_low32_lanes_plain)
    say(f"execute: bit-equal on random records (3 seeds, 2 literal widths, "
        f"ok rows {rows_ok}), a {len(big)}-byte single-group frame beside "
        f"{len(small_payloads)} x 16 KiB (exec width {d['exec_width']}) and "
        f"2048 rows of 16 KiB; xxhash64: bit-equal on {len(lengths)} lengths"
        f" (0-33 to 131072) from aligned and unaligned starts, aligned and "
        f"unaligned rows")


def _counters():
    from zstd_tpu_torch.ops import (execute, execute_window, huffman,
                                    sequence, xxhash64)

    return {"huffman": huffman.huffman_lanes,
            "sequence": sequence.sequence_lanes,
            "resolve": sequence.resolve_frames,
            "execute": execute.execute_lanes,
            "xxhash64": xxhash64.xxh64_low32_lanes,
            "execute_window": execute_window.execute_window}


def phase_main():
    import torch

    from zstd_tpu_torch.common.config import CompressionLevel
    from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder

    t0 = time.perf_counter()
    payloads = make_corpus(128)
    frames = [bytes(compress_to_vec(p, CompressionLevel.FASTEST))
              for p in payloads]
    n_bytes = sum(len(p) for p in payloads)
    say(f"main path input: {len(frames)} frames, {n_bytes} bytes, "
        f"ratio {sum(map(len, frames)) / n_bytes:.4f}, made in "
        f"{time.perf_counter() - t0:.1f} s")

    dec = BatchDecoder()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = dec.decode_frames(frames)
    t_decode = time.perf_counter() - t0
    decode_launches = {k: fn.launches for k, fn in counters.items()}
    t0 = time.perf_counter()
    batch = dec.prepare(frames)
    t_prepare = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged = dec.stage(batch)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    # the counts printed in the kernels line: this one serving run alone
    for fn in counters.values():
        fn.launches = 0
    _, _, ok = dec.run_device(batch, staged, pull_outputs=False)
    launches = {k: fn.launches for k, fn in counters.items()}

    need(all(r == p for r, p in zip(res, payloads)) and len(res) == len(
        payloads), "main path: decoded bytes differ from the payloads")
    need(bool(np.all(ok)), "main path: a frame failed in serving mode")
    need(dec.host_frames == 0, f"main path: {dec.host_frames} host frames")
    n_huff = int((batch.huff_nsym > 0).sum())
    n_seq = int((batch.seq_n > 0).sum())
    need(n_huff > 0 and n_seq > 0, "main path: no Huffman or sequence lanes")
    # decode_frames verifies checksums on the host, so no xxhash64 there
    for k in ("huffman", "sequence", "resolve", "execute"):
        need(decode_launches[k] > 0,
             f"main path: decode_frames never launched kernel {k}")
    for k in SINGLE_GROUP:
        need(launches[k] > 0,
             f"main path: serving run never launched kernel {k}")
    say(f"host prepare (framing) {t_prepare * 1e3:.3f} ms, stage "
        f"(upload) {t_stage * 1e3:.3f} ms")
    say(f"main path: decode_frames {t_decode:.2f} s, all {len(frames)} "
        f"frames byte-exact, host_frames 0, {n_huff} Huffman lanes, "
        f"{n_seq} sequence lanes, {int(batch.seq_n.sum())} sequences "
        f"(longest lane {int(batch.seq_n.max())}), "
        f"launches {decode_launches}")
    say(f"main path: one serving run, checksums verified on the device, "
        f"launches {launches}")
    return dec, batch, staged, n_bytes, launches, payloads, frames


SINGLE_GROUP = ("huffman", "sequence", "resolve", "execute", "xxhash64")
STAGES = ("huffman_decode", "sequence_decode", "offset_resolution",
          "lz77_execute", "device_checksum", "lz77_window_execute")


def profiled_scopes(fn, names, runs: int):
    """Device ms per run of each trace scope in `names`, from a
    torch.profiler capture of `runs` calls of fn(), and the device's busy
    ms per run (the sum of every kernel's and copy's device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    # a scope's range on the device (the profiler's GPU annotation), else
    # the device time of the kernels it links to the scope on the host
    span = dict.fromkeys(names, 0.0)
    host = dict.fromkeys(names, 0.0)
    busy = 0.0  # kernels and copies; a scope's device range is not one
    for ev in prof.events():
        if ev.name in host and ev.device_type == DeviceType.CPU:
            host[ev.name] += ev.device_time_total
        elif ev.name in span:
            span[ev.name] += ev.time_range.elapsed_us()
        elif ev.device_type != DeviceType.CPU:
            busy += ev.time_range.elapsed_us()
    stage_ms = {k: (span[k] or host[k]) / runs / 1e3 for k in names}
    return stage_ms, busy / runs / 1e3


def profiled_stages(dec, batch, staged, runs: int):
    """Per-stage device ms per serving run (run_device's trace scopes) and
    the device's busy ms per run."""
    return profiled_scopes(
        lambda: dec.run_device(batch, staged, pull_outputs=False), STAGES,
        runs)


def phase_serving(dec, batch, staged, n_bytes, label: str = "serving",
                  runs: int = 5):
    """A warm-up and `runs` timed serving runs, then per-stage device times
    (torch.profiler, 3 runs). Single-group frames' checksums are verified
    on the device; chained frames' are not (as in the reference)."""
    import torch

    dec.run_device(batch, staged, pull_outputs=False)  # warm-up
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, ok = dec.run_device(batch, staged, pull_outputs=False)
        times.append(time.perf_counter() - t0)
        need(bool(np.all(ok)), f"{label}: checksum or lane failure")
    t = sum(times) / runs
    say(f"{label}: {runs} runs, mean {t * 1e3:.3f} ms, "
        f"{n_bytes / t / 1e9:.4f} GB/s")
    stage_ms, busy_ms = profiled_stages(dec, batch, staged, runs=3)
    if busy_ms == 0:
        say(f"{label} stages: the profiler saw no device time; not measured")
        return t, {}
    say(f"{label} stages (device ms per run, torch.profiler, 3 runs): "
        + json.dumps({k: v for k, v in stage_ms.items() if v}))
    say(f"{label}: device busy {busy_ms:.3f} ms per run (torch.profiler) "
        f"of {t * 1e3:.3f} ms unprofiled wall; idle share "
        f"{1 - busy_ms / (t * 1e3):.4f}")
    return t, stage_ms


def resolve_work(d):
    """(bytes, operations) the resolve kernel needs on staged batch d:
    ll, ml, of_value (i32) and is_real (u8) read and the offset written,
    17 bytes a slot, and each row's history read and out_len and ok
    written; with chains, the first pass's 9 bytes a slot (ll, of_value,
    is_real), each row's transform written and read twice (24 bytes) and
    the plan. Operations: ~24 integer ops a slot (its symbol and transform
    ~10, one composition ~10, one application ~4), 24 a slot more with
    chains."""
    Bf, S = d["ll_base"].shape
    slots = Bf * S
    nbytes, ops = 17 * slots + 17 * Bf, 24 * slots
    if d["chains"] is not None:
        nbytes += 9 * slots + 48 * Bf + 4 * d["chain_rows"].numel() + Bf
        ops += 24 * slots
    return nbytes, ops


def _bound(nbytes, ops):
    """(least ms, "bytes" or "operations") of nbytes moved and ops done."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = ops / H100_OPS_PER_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def _bounds(batch, d, inputs):
    """Least bytes each kernel must move and ops it must do on this run's
    inputs: each input read once, each output written once."""
    hl = batch.huff_nsym > 0
    htids = np.unique(batch.huff_tid[hl])
    huff_tab = int(sum(4 << int(batch.huff_maxbits[t]) for t in htids))
    n_sym = int(batch.huff_nsym[hl].sum())
    huff_bytes = (int(batch.huff_len[hl].sum()) + 24 * int(hl.sum())
                  + huff_tab + n_sym + batch.lit_base.shape[0])
    sl = batch.seq_n > 0
    seq_tab = 0
    for tids, logs in ((batch.ll_tid, batch.ll_logs),
                       (batch.of_tid, batch.of_logs),
                       (batch.ml_tid, batch.ml_logs)):
        seq_tab += int(sum(4 << int(logs[t]) for t in np.unique(tids[sl])))
    n_seq = int(batch.seq_n[sl].sum())
    seq_bytes = (int(batch.seq_len[sl].sum()) + 40 * int(sl.sum()) + seq_tab
                 + 12 * n_seq + batch.lit_base.shape[0])
    rows = d["exec_rows_list"]
    run = (inputs["ll"] + inputs["ml"])[d["exec_rows"].long()] > 0
    idx = np.arange(run.shape[1])[None, :]
    last = np.where(run.cpu().numpy(), idx + 1, 0).max(axis=1)
    n_out = len(rows) * d["exec_width"]
    exec_bytes = (12 * int(last.sum()) + int(batch.row_lit_len[rows].sum())
                  + 8 * len(rows) + n_out + len(rows))
    hashed = int(inputs["length"].clamp(min=0).sum())
    xxh_bytes = hashed + 16 * len(rows)
    res_bytes, res_ops = resolve_work(d)
    # operation counts per unit of work (integer ALU ops, rounded down):
    # a Huffman symbol ~8, a sequence ~40, an output byte ~1, a hashed byte ~1
    ops = {"huffman": 8 * n_sym, "sequence": 40 * n_seq, "resolve": res_ops,
           "execute": n_out, "xxhash64": hashed}
    nbytes = {"huffman": huff_bytes, "sequence": seq_bytes,
              "resolve": res_bytes, "execute": exec_bytes,
              "xxhash64": xxh_bytes}
    return {k: _bound(nbytes[k], ops[k]) for k in nbytes}


def phase_kernels(batch, staged, launches):
    import torch

    from zstd_tpu_torch.ops import execute
    from zstd_tpu_torch.ops.sequence import resolve_frames

    cases, inputs = kernel_cases(staged)
    bounds = _bounds(batch, staged, inputs)
    replaces = {
        "huffman": "zstd_tpu/ops/pallas_huffman.py:71",
        "sequence": "zstd_tpu/ops/pallas_sequence.py:205",
        "resolve": "zstd_tpu/ops/sequence.py:251",
        "execute": "zstd_tpu/ops/pallas_execute.py:617",
        "xxhash64": "zstd_tpu/ops/xxhash64.py:146",
    }
    rows = []
    for name, (setup, call, kern, plain) in cases.items():
        err = compare(name, setup, call, kern, plain)
        ms = cuda_ms(setup, call, kern, reps=5)
        plain_ms = cuda_ms(setup, call, plain, reps=1)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"zstd_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err, "ms": round(ms, 6),
            "plain_ms": round(plain_ms, 6),
            "bound_ms": round(bounds[name][0], 6),
            "bound_by": bounds[name][1], "library_ms": None})
        say(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.2f} ms, "
            f"bound {bounds[name][0]:.4f} ms by {bounds[name][1]}), "
            f"max abs err {err} (tolerance 0: integer codec)"
            + (f", {resolve_frames.last_cuda_launches} CUDA launches per call"
               if name == "resolve" else ""))
        torch.cuda.empty_cache()
    setup, call, kern, _ = cases["execute"]
    call(kern, setup())
    st = execute.rounds_stats()
    say(f"kernel execute: match rounds per chunk of 32 records on the main "
        f"batch: mean {st['mean']:.4f}, max {st['max']}, {st['chunks']} "
        f"chunks")
    huffman_lane_counts("main path", cases["huffman"])
    return rows


def huffman_lane_counts(label, case):
    """One Huffman kernel call: its lanes decoded by the warp walk and
    walked serially, and its re-walk rounds; no lane of valid frames may
    take the serial path."""
    from zstd_tpu_torch.ops import huffman

    setup, call, kern, _ = case
    call(kern, setup())
    st = huffman.lane_stats()
    lanes = st["warp_lanes"] + st["serial_lanes"]
    say(f"kernel huffman, {label}: {st['warp_lanes']} lanes by the warp "
        f"walk, {st['serial_lanes']} serial; re-walk rounds a lane mean "
        f"{st['rounds_sum'] / max(st['warp_lanes'], 1):.4f}, max "
        f"{st['rounds_max']}")
    need(lanes > 0 and st["serial_lanes"] == 0,
         f"huffman, {label}: {st['serial_lanes']} lanes took the serial path")


def phase_huffman_chained(staged, far_staged):
    """The Huffman kernel on the chained path's and the far frame's
    batches: bit-equal to its plain version, 0 serial lanes; the larger
    error."""
    err = 0
    for label, d in (("chained path", staged), ("far frame", far_staged)):
        case = huffman_case(d)
        err = max(err, compare(f"huffman ({label})", *case))
        huffman_lane_counts(label, case)
    return err


# --- chained frames ----------------------------------------------------------

def _break_last_block(frame: bytes) -> bytes:
    """The frame with the last byte of its last compressed block zeroed:
    that block's sequence bitstream loses its padding sentinel."""
    from zstd_tpu_torch.common import constants as C
    from zstd_tpu_torch.oracle import blocks, frame as frame_mod

    pos = frame_mod.parse_frame_header(frame).header_size
    last = None
    while True:
        bh = blocks.parse_block_header(frame[pos:pos + 3])
        pos += 3 + (1 if bh.block_type == C.BLOCK_RLE else bh.block_size)
        if bh.block_type == C.BLOCK_COMPRESSED:
            last = pos - 1
        if bh.last_block:
            break
    bad = bytearray(frame)
    bad[last] = 0
    return bytes(bad)


def _oracle(frame, dicts=()):
    from zstd_tpu_torch.common.errors import ZstdError
    from zstd_tpu_torch.oracle import decode_all

    try:
        return decode_all(frame, dicts=list(dicts))
    except ZstdError:
        return None


def phase_chained_small():
    from zstd_tpu_torch.common.config import CompressionLevel
    from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder
    from zstd_tpu_torch.oracle import Dictionary
    from zstd_tpu_torch.testdata import load_dict_fixture, matches_digest

    payloads = make_corpus(10, frame_kb=2560, seed=3)[:4]
    frames = [bytes(compress_to_vec(p, CompressionLevel.FASTEST))
              for p in payloads]
    frames[3] = _break_last_block(frames[3])  # in its last block group
    raw, dict_frames, digests = load_dict_fixture()
    frames += dict_frames
    dec = BatchDecoder()
    dec.add_dict(raw)
    batch = dec.prepare(frames)
    need(all(len(m.rows) > 1 for m in batch.metas[:4]),
         "chained small: a 2.5 MiB frame is not chained")
    need(all(m.dict_prefill for m in batch.metas[4:]),
         "chained small: dictionary frames without a prefill")
    d = dec.stage(batch)
    case, _ = window_case(d)
    compare("execute_window", *case)
    res = dec.decode_frames(frames)
    for i in range(3):
        need(res[i] == payloads[i], f"chained small: frame {i} decoded wrong")
    need(res[3] is None and res[3] == _oracle(frames[3]),
         "chained small: broken frame differs from the host oracle")
    dicts = [Dictionary.decode_dict(raw)]
    for r, f, dg in zip(res[4:], dict_frames, digests):
        need(matches_digest(r, dg) and r == _oracle(f, dicts),
             "chained small: a dictionary frame decoded wrong")
    _, _, ok = dec.run_device(batch, d)
    bad = [i for i, m in enumerate(batch.metas) if not ok[m.rows[0]]]
    need(bad == [3], f"chained small: lanes {bad} failed, expected [3]")
    need(dec.host_frames == 0, f"chained small: {dec.host_frames} host frames")
    say(f"chained small: window kernel bit-equal to its plain version on "
        f"{len(frames)} chained frames (3 x 2.5 MiB, 1 broken, "
        f"{len(dict_frames)} dictionary frames); bytes exact, the broken "
        f"frame None as the oracle says, only its lane failed, host_frames 0")


def phase_chained():
    import torch

    from zstd_tpu_torch.common.config import CompressionLevel
    from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder

    t0 = time.perf_counter()
    payloads = make_corpus(128, frame_kb=8192)
    frames = [bytes(compress_to_vec(p, CompressionLevel.FASTEST))
              for p in payloads]
    n_bytes = sum(len(p) for p in payloads)
    say(f"chained path input: {len(frames)} frames, {n_bytes} bytes, ratio "
        f"{sum(map(len, frames)) / n_bytes:.4f}, made in "
        f"{time.perf_counter() - t0:.1f} s")
    dec = BatchDecoder()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = dec.decode_frames(frames)
    t_decode = time.perf_counter() - t0
    decode_launches = {k: fn.launches for k, fn in counters.items()}
    t0 = time.perf_counter()
    batch = dec.prepare(frames)
    t_prepare = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged = dec.stage(batch)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    _, _, ok = dec.run_device(batch, staged, pull_outputs=False)
    launches = {k: fn.launches for k, fn in counters.items()}

    need(len(res) == len(payloads)
         and all(r == p for r, p in zip(res, payloads)),
         "chained path: decoded bytes differ from the payloads")
    need(bool(np.all(ok)), "chained path: a frame failed in serving mode")
    need(dec.host_frames == 0, f"chained path: {dec.host_frames} host frames")
    groups = [len(m.rows) for m in batch.metas]
    need(min(groups) > 1, "chained path: a frame is not chained")
    for k in ("huffman", "sequence", "resolve", "execute_window"):
        need(decode_launches[k] > 0 and launches[k] > 0,
             f"chained path: kernel {k} was not launched")
    widths = [g["width"] for g in staged["chains"]]
    acc_bytes = sum(len(g["first"]) * g["width"] for g in staged["chains"])
    window = batch.metas[0].window
    say(f"chained path: window {window} bytes, block groups per frame "
        f"{min(groups)}-{max(groups)}, {int((batch.huff_nsym > 0).sum())} "
        f"Huffman lanes, {int((batch.seq_n > 0).sum())} sequence lanes, "
        f"{int(batch.seq_n.sum())} sequences (longest lane "
        f"{int(batch.seq_n.max())}), {len(widths)} chain width group(s) "
        f"of accumulator widths {widths} bytes, {acc_bytes} bytes in all")
    say(f"chained path: host prepare {t_prepare * 1e3:.3f} ms, stage "
        f"{t_stage * 1e3:.3f} ms, decode_frames {t_decode:.2f} s, all "
        f"{len(frames)} frames byte-exact, host_frames 0, launches "
        f"{decode_launches}")
    say(f"chained path: one serving run, launches {launches}")
    return dec, batch, staged, n_bytes, launches


def phase_far():
    import torch

    from zstd_tpu_torch.bench import bigwindow_body
    from zstd_tpu_torch.common.config import CodecConfig, CompressionLevel
    from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
    from zstd_tpu_torch.models import framer
    from zstd_tpu_torch.models.batch_decoder import (BatchDecoder,
                                                     _resolve_chained)

    # bench.py's bigwindow body: 9 MiB, its first MiB again, 1 MiB more,
    # then MiB 2-3 again: matches 9+ MiB back
    body = bigwindow_body(12)
    frame = bytes(compress_to_vec(body, CompressionLevel.FASTEST,
                                  CodecConfig(window_log=24)))
    dec = BatchDecoder()
    batch = dec.prepare([frame])
    m = batch.metas[0]
    need(m.window > framer.STREAM_WINDOW_CAP,
         f"far: window {m.window} is not past {framer.STREAM_WINDOW_CAP}")
    need(dec.decode_frames([frame]) == [body], "far: decoded bytes differ")
    need(dec.host_frames == 0, "far: the frame went to the host")
    d = dec.stage(batch)
    _, ll, ml, of = stage_outputs(d)
    offsets, _, _ = _resolve_chained(ll, ml, of, d["is_real"],
                                     d["init_hist"], d["chain_rows"],
                                     d["chain_row_cont"])
    far = (ml > 0) & (offsets > framer.STREAM_WINDOW_CAP)
    n_far = int(far.sum())
    longest = int(torch.where(ml > 0, offsets, 0).max())
    if n_far:
        say(f"far: {n_far} resolved matches reach past "
            f"{framer.STREAM_WINDOW_CAP} bytes (longest offset {longest})")
    else:
        say(f"far: the port's encoder made no match past "
            f"{framer.STREAM_WINDOW_CAP} bytes (longest offset {longest}); "
            f"the far reach is not exercised by this frame")
    say(f"far: window {m.window}, {len(m.rows)} block groups, "
        f"{len(body)} bytes exact, host_frames 0, "
        f"{int((batch.seq_n > 0).sum())} sequence lanes, "
        f"{int(batch.seq_n.sum())} sequences (longest lane "
        f"{int(batch.seq_n.max())})")
    phase_serving(dec, batch, d, len(body), label="far serving", runs=3)
    need([int(c) for g in d["chains"] for c in g["cap"]] == [m.window],
         "far: the chain's cap is not the real window")
    return d, frame, body


def _window_bound(d, inputs, written):
    """Least time of the window kernel on these inputs: 12 bytes a record
    (up to each row's last active slot), the literal bytes, the plan and
    the output bytes over the memory rate, or an operation per output byte
    over the ALU rate, whichever is larger."""
    import torch

    rows = torch.cat([g["rows"].long().flatten() for g in d["chains"]])
    run = (inputs["ll"] + inputs["ml"])[rows] > 0
    idx = torch.arange(1, run.shape[1] + 1, device=run.device)[None, :]
    records = int(torch.where(run, idx, 0).max(dim=1).values.sum())
    n_out = int(written.sum())
    nbytes = (12 * records + int(d["row_lit_len"][rows].long().sum())
              + 16 * rows.numel() + n_out)
    return _bound(nbytes, n_out)


def _resolve_run(label, staged):
    """The resolve kernel with the chain plan of a staged chained batch:
    bit-equal to its plain version, both timed, beside its bound."""
    import torch

    from zstd_tpu_torch.ops.sequence import resolve_frames

    _, ll, ml, of = stage_outputs(staged)
    case = resolve_case(staged, ll, ml, of)
    err = compare(f"resolve ({label})", *case)
    setup, call, kern, plain = case
    ms = cuda_ms(setup, call, kern, reps=5)
    plain_ms = cuda_ms(setup, call, plain, reps=1)
    bound, bound_by = _bound(*resolve_work(staged))
    say(f"kernel resolve, {label}: {ms:.4f} ms (plain {plain_ms:.2f} ms, "
        f"bound {bound:.4f} ms by {bound_by}), max abs err {err} (tolerance "
        f"0: integer codec), {resolve_frames.last_cuda_launches} CUDA "
        f"launches per call, {staged['chain_rows'].shape[0]} chains of up "
        f"to {staged['chain_rows'].shape[1]} rows, slot rows "
        f"{tuple(ll.shape)}")
    torch.cuda.empty_cache()
    return err


def phase_resolve_chained(staged, far_staged):
    """The resolve kernel on the chained path's and the far frame's
    batches; the larger error."""
    return max(_resolve_run("chained path", staged),
               _resolve_run("far frame", far_staged))


WINDOW_PHASES = ("validate", "chains", "seed", "jump", "gather")


def window_phases(setup, call, kern):
    """Device ms of each phase of one window kernel call: a torch.profiler
    capture of two calls, of which the second is read (the kernels after
    the first call's gather; the tracer can miss a capture's first
    kernels), kernels matched by name; {} if it saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            call(kern, setup())
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type != DeviceType.CPU
                  and any(f"{k}_kernel" in e.name for k in WINDOW_PHASES)),
                 key=lambda e: e.time_range.start)
    first = [i for i, e in enumerate(evs) if "gather_kernel" in e.name]
    ms = dict.fromkeys(WINDOW_PHASES, 0.0)
    for e in evs[first[0] + 1:] if len(first) == 2 else []:
        for k in WINDOW_PHASES:
            if f"{k}_kernel" in e.name:
                ms[k] += e.time_range.elapsed_us() / 1e3
    return ms if any(ms.values()) else {}


def _window_run(label, staged):
    """The window kernel on a staged chained batch: bit-equal to its plain
    version, its design's counts for one call, both timed, its bound."""
    import torch

    from zstd_tpu_torch.ops import execute_window as ew

    need(len(staged["chains"]) == 1,
         f"{label}: {len(staged['chains'])} chain width groups, expected 1")
    case, inputs = window_case(staged)
    err = compare(f"execute_window ({label})", *case)
    setup, call, kern, plain = case
    written = call(kern, setup())[1]
    fn = ew.execute_window
    rounds = ew.rounds_used()
    bound, bound_by = _window_bound(staged, inputs, written)
    ms = cuda_ms(setup, call, kern, reps=3)
    plain_ms = cuda_ms(setup, call, plain, reps=1)
    phases = window_phases(setup, call, kern)
    say(f"kernel execute_window, {label}: phases (device ms, torch.profiler,"
        f" 1 call) " + (json.dumps(phases) if phases else "not measured"))
    say(f"kernel execute_window, {label}: {ms:.4f} ms (plain {plain_ms:.2f} "
        f"ms, bound {bound:.4f} ms by {bound_by}), max abs err {err} "
        f"(tolerance 0: integer codec), {int(written.sum())} bytes; "
        f"{rounds} jump rounds of {fn.last_cuda_launches - 4}, "
        f"{fn.last_cuda_launches} CUDA launches per call, "
        f"{fn.last_scratch_bytes} scratch bytes")
    torch.cuda.empty_cache()
    return err, ms, plain_ms, bound, bound_by


def phase_window_kernel(staged, launches, far_staged):
    far_err = _window_run("far frame", far_staged)[0]
    err, ms, plain_ms, bound, bound_by = _window_run("chained path", staged)
    err = max(err, far_err)
    return {"name": "execute_window", "route": "cuda",
            "source": "zstd_tpu_torch/csrc/execute_window.cu",
            "replaces": "zstd_tpu/ops/pallas_execute.py:1076",
            "launches": launches["execute_window"], "max_abs_err": err,
            "ms": round(ms, 6), "plain_ms": round(plain_ms, 6),
            "bound_ms": round(bound, 6), "bound_by": bound_by,
            "library_ms": None}


# --- device encoder ----------------------------------------------------------

ENCODE_SCOPES = ("find_candidates", "parse", "huffman_pack", "fse_encode")


def _encode_counters():
    from zstd_tpu_torch.ops import fse_encode, match_finder

    return {"parse": match_finder.parse_lanes,
            "fse_encode": fse_encode.encode_sequences_packed}


def phase_encode_host():
    """11. The entropy path: bench.py's encode scenario (64 frames of
    128 KiB) through BatchEncoder() with the host matcher; every frame
    equal to the host encoder's."""
    from zstd_tpu_torch.common.config import CompressionLevel
    from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
    from zstd_tpu_torch.models.batch_encoder import BatchEncoder

    payloads = make_corpus(8, seed=5)
    n_bytes = sum(map(len, payloads))
    enc = BatchEncoder()
    counters = _encode_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    frames = enc.compress_frames(payloads)
    t = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    need(len(frames) == len(payloads) and all(
        f == compress_to_vec(p, CompressionLevel.FASTEST)
        for f, p in zip(frames, payloads)),
        "entropy path: a frame differs from the host encoder's")
    need(launches["fse_encode"] > 0, "entropy path: fse_encode not launched")
    ratio = sum(map(len, frames)) / n_bytes
    say(f"entropy path: {len(frames)} frames, {n_bytes} bytes, ratio "
        f"{ratio:.4f}, every frame equal to compress_to_vec; "
        f"{t:.3f} s ({n_bytes / t / 1e6:.3f} MB/s), split "
        f"{json.dumps(enc.last_stats)}, launches {launches}")
    return payloads, frames, ratio


def _recorded(module, name, calls: list):
    """Route module.name through a wrapper that appends each call's
    (arguments, result) to `calls`; returns the function that restores it.
    Only callers that look the name up in `module` see the wrapper."""
    fn = getattr(module, name)

    def rec(*args):
        out = fn(*args)
        calls.append((args, out))
        return out

    setattr(module, name, rec)
    return lambda: setattr(module, name, fn)


def phase_encode_device(payloads, host_ratio):
    """12. The device-matched main path: BatchEncoder(matcher=
    DeviceMatcher()) on the same corpus; every frame decoded by the oracle
    and by BatchDecoder() on the card; a warm-up (the counted run, whose
    kernel arguments are kept for phase 14), 3 timed runs and the scopes'
    device times."""
    from zstd_tpu_torch.encoding.device_matcher import DeviceMatcher
    from zstd_tpu_torch.models import batch_encoder
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder
    from zstd_tpu_torch.ops import match_finder
    from zstd_tpu_torch.oracle import decode_all

    n_bytes = sum(map(len, payloads))
    enc = batch_encoder.BatchEncoder(matcher=DeviceMatcher())
    counters = _encode_counters()
    for fn in counters.values():
        fn.launches = 0
    # the parse's arguments are find_candidates' (its kernel wrapper counts
    # its launches through its own module name, so it is not wrapped)
    calls = {"parse": [], "fse_encode": []}
    restore = [_recorded(match_finder, "find_candidates", calls["parse"]),
               _recorded(batch_encoder, "encode_sequences_packed",
                         calls["fse_encode"])]
    frames = enc.compress_frames(payloads)
    for undo in restore:
        undo()
    launches = {k: fn.launches for k, fn in counters.items()}
    for k in ("parse", "fse_encode"):
        need(launches[k] > 0, f"device encode: kernel {k} was not launched")
        need(len(calls[k]) == 1,
             f"device encode: {k} called {len(calls[k])} times, expected 1")
    for i, (f, p) in enumerate(zip(frames, payloads)):
        need(decode_all(f) == p, f"device encode: oracle frame {i} differs")
    dec = BatchDecoder()
    need(dec.decode_frames(frames) == payloads,
         "device encode: BatchDecoder's bytes differ")
    need(dec.host_frames == 0, f"device encode: {dec.host_frames} host frames")
    ratio = sum(map(len, frames)) / n_bytes
    say(f"device encode: {len(frames)} frames byte-exact through the oracle "
        f"and BatchDecoder() on the card, host_frames 0; ratio {ratio:.4f} "
        f"(host matcher {host_ratio:.4f}); launches {launches}")

    times, stats = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        again = enc.compress_frames(payloads)
        times.append(time.perf_counter() - t0)
        stats.append({**enc.last_stats, **{
            f"match_{k}": v for k, v in enc.matcher.last_stats.items()}})
        need(again == frames, "device encode: a timed run's frames differ")
    t = sum(times) / len(times)
    split = {k: sum(s[k] for s in stats) / len(stats) for k in stats[0]}
    say(f"device encode: 3 runs, mean {t:.4f} s, {n_bytes / t / 1e6:.4f} MB/s"
        f", split (mean s; match_device_s and match_records_s are parts of "
        f"match_s) {json.dumps(split)}")
    scope_ms, busy_ms = profiled_scopes(
        lambda: enc.compress_frames(payloads), ENCODE_SCOPES, runs=1)
    if busy_ms == 0:
        say("device encode scopes: the profiler saw no device time; "
            "not measured")
    else:
        say(f"device encode scopes (device ms per run, torch.profiler, 1 "
            f"run): {json.dumps(scope_ms)}; device busy {busy_ms:.3f} ms "
            f"of {t * 1e3:.3f} ms wall, idle share "
            f"{1 - busy_ms / (t * 1e3):.4f}")
    (data, n_valid), (cand, lcp) = calls["parse"][0]
    return launches, {"parse": (data, cand, lcp, n_valid),
                      "fse_encode": calls["fse_encode"][0][0]}


def phase_cli():
    """13. `python -m zstd_tpu_torch.cli compress --gpu` then `decompress
    --gpu` on one 8 MiB frame (its decode takes the chained path)."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    data = b"".join(make_corpus(8, seed=3))
    env = {**os.environ, "PYTHONPATH": root}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.bin")
        with open(src, "wb") as f:
            f.write(data)
        t = {}
        for cmd, args in (("compress", [src, src + ".zst"]),
                          ("decompress", [src + ".zst", src + ".out"])):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "zstd_tpu_torch.cli", cmd, *args,
                 "--gpu"], cwd=root, env=env, capture_output=True,
                text=True, timeout=600)
            t[cmd] = time.perf_counter() - t0
            need(res.returncode == 0,
                 f"cli {cmd} --gpu exited {res.returncode}: {res.stderr}")
        with open(src + ".out", "rb") as f:
            need(f.read() == data, "cli: decompressed bytes differ")
        n_z = os.path.getsize(src + ".zst")
    say(f"cli: compress --gpu {t['compress']:.2f} s, decompress --gpu "
        f"{t['decompress']:.2f} s (each a fresh process), {len(data)} bytes "
        f"-> {n_z} -> {len(data)} exact")


def encode_cases(args):
    """(setup, call, kernel, plain) of the parse and fse_encode kernels on
    the arguments phase 12's counted run gave them."""
    from zstd_tpu_torch.ops import bitpack, fse_encode, match_finder

    def call_parse(fn, _):
        return list(fn(*args["parse"]))

    def call_fse(fn, _):
        return list(fn(*args["fse_encode"]))

    def fse_plain(*a):
        return bitpack.pack_bits_lanes(
            *fse_encode.encode_sequence_lanes_plain(*a[:-1]), a[-1])

    return {
        "parse": (list, call_parse, match_finder.parse_lanes,
                  match_finder.parse_lanes_plain),
        "fse_encode": (list, call_fse, fse_encode.encode_sequences_packed,
                       fse_plain),
    }


def _parse_work(n_valid, ll, ml, nseq, anchor):
    """(positions, extended) of the greedy walk, replayed from its records:
    the positions whose candidate and lcp it reads, and the bytes it
    compares past an 8-byte lcp. A literal run of length r costs the skip
    rule's steps t_k < r (t_0 = 0, t_k+1 = t_k + 1 + (t_k >> 8)), a match
    one more, and the trailing run from anchor to n_valid its steps (none
    when the lane stopped at MAX_SEQS). A match longer than 8 had lcp 8
    and compared its length past 8."""
    from zstd_tpu_torch.ops.match_finder import MAX_SEQS

    nv = n_valid.cpu().numpy().astype(np.int64)
    ns = nseq.cpu().numpy().astype(np.int64)
    rest = np.where(ns < MAX_SEQS, nv - anchor.cpu().numpy(), 0)
    steps = [0]
    while steps[-1] < max(int(nv.max()), 1):
        steps.append(steps[-1] + 1 + (steps[-1] >> 8))
    steps = np.asarray(steps)
    live = np.arange(ll.shape[1])[None, :] < ns[:, None]
    runs = ll.cpu().numpy()[live]
    lengths = ml.cpu().numpy()[live].astype(np.int64)
    positions = int(np.searchsorted(steps, runs).sum() + live.sum()
                    + np.searchsorted(steps, rest).sum())
    return positions, int(np.clip(lengths - 8, 0, None).sum())


def _encode_bounds(args, outputs):
    """Least time of each encode kernel on this run's data. parse reads the
    candidate and lcp (8 bytes) of each position the walk visits, two data
    bytes per byte a match extension compares and n_valid, and writes 12
    bytes per record and nseq and anchor; operations, one per position and
    per compared byte. fse_encode reads 12 bytes per sequence, each lane's
    nseq and logs and each of its non-RLE streams' tables (next states at
    u16, 1 << log of them; deltaNbBits and deltaFindState at 4 bytes for
    each code of the stream's alphabet) and writes the output words and
    total; operations, ~40 per sequence."""
    from zstd_tpu_torch.common import constants as C

    data, _, _, n_valid = args["parse"]
    ll, ml, _, nseq, anchor = outputs["parse"]
    B = data.shape[0]
    positions, extended = _parse_work(n_valid, ll, ml, nseq, anchor)
    records = int(nseq.long().sum())
    parse_bytes = 8 * positions + 2 * extended + 12 * records + 12 * B
    arrays = args["fse_encode"]
    seq_lanes = arrays[0].shape[0]
    n_seq = int(arrays[3].long().sum())
    logs = arrays[7].cpu().numpy().astype(np.int64)  # (B, 3): ll, ml, of
    alphabet = np.array([C.LL_MAX_CODE + 1, C.ML_MAX_CODE + 1, 32])
    used = logs > 0                                  # log 0: an RLE stream
    tables = int(((2 << logs) * used).sum() + (8 * alphabet * used).sum())
    total = outputs["fse_encode"][1].long()
    out_bytes = int(((total + 31) // 32).sum()) * 4
    fse_bytes = 12 * n_seq + tables + out_bytes + 20 * seq_lanes
    out = {"parse": _bound(parse_bytes, positions + extended),
           "fse_encode": _bound(fse_bytes, 40 * n_seq)}
    return out, dict(lanes=B, valid_bytes=int(n_valid.long().sum()),
                     visited_positions=positions, extended_bytes=extended,
                     records=records, sequence_lanes=seq_lanes,
                     sequences=n_seq, S=int(arrays[0].shape[1]),
                     table_bytes=tables, parse_bound_bytes=parse_bytes,
                     fse_bound_bytes=fse_bytes)


def phase_encode_kernels(args, launches):
    """14. Both encode kernels on the arguments phase 12's counted run gave
    them: bit-equal to their plain versions, both timed, beside their
    bounds."""
    import torch

    cases = encode_cases(args)
    outputs = {k: call(kern, setup())
               for k, (setup, call, kern, _) in cases.items()}
    bounds, shape = _encode_bounds(args, outputs)
    say(f"encode kernels' inputs: {json.dumps(shape)}")
    replaces = {"parse": "zstd_tpu/ops/match_finder.py:98",
                "fse_encode": "zstd_tpu/ops/fse_encode.py:45"}
    rows = []
    for name, (setup, call, kern, plain) in cases.items():
        err = compare(name, setup, call, kern, plain)
        ms = cuda_ms(setup, call, kern, reps=5)
        plain_ms = cuda_ms(setup, call, plain, reps=1)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"zstd_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err, "ms": round(ms, 6),
            "plain_ms": round(plain_ms, 6),
            "bound_ms": round(bounds[name][0], 6),
            "bound_by": bounds[name][1], "library_ms": None})
        say(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.2f} ms, bound "
            f"{bounds[name][0]:.4f} ms by {bounds[name][1]}), max abs err "
            f"{err} (tolerance 0: integer codec)")
        if name == "parse":
            parse_counts(setup, call, kern)
        torch.cuda.empty_cache()
    return rows


def parse_counts(setup, call, kern):
    """One parse kernel call on phase 12's lanes: its segments, re-walk
    rounds, serially walked and truncated lanes; no lane may be walked
    serially."""
    from zstd_tpu_torch.ops import match_finder

    call(kern, setup())
    st = match_finder.parse_stats()
    settled = st["lanes"] - st["serial_lanes"]
    say(f"kernel parse, device-encode lanes: {st['lanes']} lanes, "
        f"{st['segments']} segments; re-walk rounds a lane mean "
        f"{st['rounds_sum'] / max(settled, 1):.4f}, max {st['rounds_max']}; "
        f"{st['serial_lanes']} lanes walked serially, "
        f"{st['truncated_lanes']} past MAX_SEQS")
    need(st["lanes"] > 0 and st["serial_lanes"] == 0,
         f"parse: {st['serial_lanes']} lanes took the serial walk")


# --- the fused step, decoding across ranks, process-parallel encode ----------

FUSED_SCOPES = ("huffman_decode", "sequence_decode", "offset_resolution",
                "lz77_execute")


def phase_fused(batch, payloads, serving_gbps):
    """15. models/fused.py's fused_decode_step on phase 4's batch (1024
    frames of 128 KiB) at out_width 131072, on the card: every frame's bytes
    and out_len equal its payload, frames_bad 0, bytes_out the payloads'
    total; one counted call launches the Huffman, sequence, resolve and
    execute kernels; the mean of 5 synchronised runs beside phase 5's
    serving GB/s, and its stages' device ms (torch.profiler, 3 runs)."""
    import torch

    from zstd_tpu_torch.models.fused import (fused_decode_step, fused_static,
                                             to_fused_kwargs)

    t0 = time.perf_counter()
    kw = to_fused_kwargs(batch, "cuda")
    static = fused_static(batch, 1 << 17)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    out, out_len, ok, metrics = fused_decode_step(**kw, **static)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for k in ("huffman", "sequence", "resolve", "execute"):
        need(launches[k] == 1, f"fused step: kernel {k} launched "
                               f"{launches[k]} times, expected 1")
    n = len(payloads)
    n_bytes = sum(map(len, payloads))
    m = {k: int(v) for k, v in metrics.items()}
    need(m["frames_bad"] == 0, f"fused step: {m['frames_bad']} bad frames")
    need(m["bytes_out"] == n_bytes,
         f"fused step: bytes_out {m['bytes_out']}, expected {n_bytes}")
    need(out.shape == (n + 1, 1 << 17), f"fused step: out {out.shape}")
    lens = out_len.cpu().numpy()
    rows = out.cpu().numpy()
    for i, p in enumerate(payloads):
        need(int(lens[i]) == len(p) and rows[i, :len(p)].tobytes() == p,
             f"fused step: frame {i} differs from its payload")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_decode_step(**kw, **static)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t = sum(times) / len(times)
    say(f"fused step: {n} frames of 128 KiB + the inert row, out_width "
        f"{static['out_width']}, every byte exact, metrics {m}; launches "
        f"{launches}; upload {t_up * 1e3:.3f} ms")
    say(f"fused step: 5 runs, mean {t * 1e3:.3f} ms, {n_bytes / t / 1e9:.4f} "
        f"GB/s (serving, phase 5: {serving_gbps:.4f} GB/s)")
    scope_ms, busy_ms = profiled_scopes(
        lambda: fused_decode_step(**kw, **static), FUSED_SCOPES, runs=3)
    if busy_ms == 0:
        say("fused step stages: the profiler saw no device time; not "
            "measured")
    else:
        say(f"fused step stages (device ms per run, torch.profiler, 3 runs):"
            f" {json.dumps(scope_ms)}; device busy {busy_ms:.3f} ms of "
            f"{t * 1e3:.3f} ms wall, idle share {1 - busy_ms / (t * 1e3):.4f}")
    del kw, out
    torch.cuda.empty_cache()


RANKS = 2
SHARDED_FRAMES = 256


def phase_ranks(frames):
    """16. Decoding across two ranks on the one card: two child processes
    (`chip_smoke.py --rank R DIR`, started after phase 2 built every
    kernel, which they load and never rebuild) join a gloo group over a
    file:// store under build/; each decodes the main corpus plus one
    truncated frame with decode_frames_multihost and 256 of its frames
    with sharded_decode on make_mesh(2), checks both in frame order, and
    runs scaling_report. Each path is counted on its own: the counts are
    zeroed just before it and read just after; decode_frames_multihost
    must launch each of the four decode kernels, sharded_decode each
    exactly once. The run fails unless both exit 0. World 1 is
    scaling_report here, without a group. One card either way: this is
    not a scaling measurement."""
    import pickle
    import shutil

    from zstd_tpu_torch.parallel.multihost import scaling_report

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(os.path.join(work, "frames.pkl"), "wb") as f:
        pickle.dump(frames, f)
    one = scaling_report(frames)
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.path.dirname(
        os.path.abspath(__file__))}
    logs = [open(os.path.join(work, f"rank{r}.log"), "w")
            for r in range(RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r), work],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(RANKS)]
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    t = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(work, f"rank{r}.log")) as f:
                tail = f.read()[-4000:]
            raise Check(f"rank {r} of {RANKS} exited {p.returncode}:\n{tail}")
    reports = []
    for r in range(RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    say(f"ranks: {RANKS} processes on one card, both exit 0 in {t:.1f} s "
        f"(start included); each checked {len(frames) + 1} frames in frame "
        f"order (the truncated one None) and {SHARDED_FRAMES} frames of "
        f"sharded_decode; launches per rank, decode_frames_multihost "
        f"{[rep['multihost_launches'] for rep in reports]}, sharded_decode "
        f"(one each required) {[rep['sharded_launches'] for rep in reports]}")
    say(f"scaling_report, world 1 (this process, no group): "
        f"{json.dumps(one)}")
    for rep in reports:
        say(f"scaling_report, world {RANKS}, rank {rep['report']['process']}"
            f": {json.dumps(rep['report'])}")


def rank_child(rank: int, work: str) -> int:
    """One rank of phase 16 (see phase_ranks); raises on any mismatch."""
    import pickle

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zstd_tpu_torch.models.framer import Framer
    from zstd_tpu_torch.models.fused import fused_static
    from zstd_tpu_torch.ops import _kernels
    from zstd_tpu_torch.parallel.mesh import make_mesh, sharded_decode
    from zstd_tpu_torch.parallel.multihost import (decode_frames_multihost,
                                                   initialize_distributed,
                                                   scaling_report)

    stale = [n for n in _kernels.NAMES if _kernels._stale(n)]
    need(not stale, f"rank {rank}: kernels not built: {stale}")
    initialize_distributed(f"file://{os.path.join(work, 'store')}", RANKS,
                           rank)
    with open(os.path.join(work, "frames.pkl"), "rb") as f:
        frames = pickle.load(f)
    payloads = make_corpus(128)
    counters = _counters()
    path = ("huffman", "sequence", "resolve", "execute")
    for fn in counters.values():
        fn.launches = 0
    got = decode_frames_multihost(frames + [frames[0][:len(frames[0]) // 2]])
    multihost = {k: fn.launches for k, fn in counters.items()}
    need(len(got) == len(frames) + 1 and got[-1] is None,
         f"rank {rank}: the truncated frame is not None")
    for i, p in enumerate(payloads):
        need(got[i] == p, f"rank {rank}: frame {i} differs")
    for k in path:
        need(multihost[k] > 0, f"rank {rank}: decode_frames_multihost never "
                               f"launched kernel {k}")

    framer = Framer()
    for i, fr in enumerate(frames[:SHARDED_FRAMES]):
        framer.add_frame(fr, i)
    batch = framer.build()
    static = fused_static(batch, 1 << 17)
    mesh = make_mesh(RANKS)
    for fn in counters.values():
        fn.launches = 0
    out, out_len, ok, metrics = sharded_decode(batch, static, mesh)
    sharded = {k: fn.launches for k, fn in counters.items()}
    for k in path:
        need(sharded[k] == 1, f"rank {rank}: sharded_decode launched kernel "
                              f"{k} {sharded[k]} times, expected 1")
    rows = SHARDED_FRAMES + 1 + (-(SHARDED_FRAMES + 1)) % RANKS
    need(out.shape == (rows, 1 << 17) and bool(ok.all()),
         f"rank {rank}: sharded_decode out {out.shape}, ok {ok.all()}")
    need(int(metrics["frames_ok"]) == rows
         and int(metrics["frames_bad"]) == 0
         and int(metrics["bytes_out"]) == sum(
             map(len, payloads[:SHARDED_FRAMES])),
         f"rank {rank}: sharded_decode metrics {metrics}")
    for i, p in enumerate(payloads[:SHARDED_FRAMES]):
        need(int(out_len[i]) == len(p) and out[i, :len(p)].tobytes() == p,
             f"rank {rank}: sharded frame {i} differs")
    report = scaling_report(frames)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump({"report": report, "multihost_launches": multihost,
                   "sharded_launches": sharded}, f)
    dist.destroy_process_group()
    return 0


def phase_parallel_encode(payloads, frames):
    """17. encoding.parallel.compress_frames_parallel on phase 11's corpus
    (64 x 128 KiB: the pool branch), workers started with `spawn`; every
    frame equal to compress_to_vec's (phase 11's frames). The rate is the
    host's cores', not the card's: a warm-up call starts the pool, then 3
    timed calls."""
    from zstd_tpu_torch.encoding import parallel

    n_bytes = sum(map(len, payloads))
    workers = min(os.cpu_count() or 4, 16)
    t0 = time.perf_counter()
    got = parallel.compress_frames_parallel(payloads, workers=workers)
    t_first = time.perf_counter() - t0
    need(got == frames, "parallel encode: a frame differs from "
                        "compress_to_vec's")
    times = []
    try:
        for _ in range(3):
            t0 = time.perf_counter()
            again = parallel.compress_frames_parallel(payloads,
                                                      workers=workers)
            times.append(time.perf_counter() - t0)
            need(again == frames, "parallel encode: a timed run differs")
    finally:
        parallel.shutdown_pool()
    t = sum(times) / len(times)
    say(f"parallel encode: {len(payloads)} frames, {n_bytes} bytes, "
        f"{workers} spawned workers (os.cpu_count() {os.cpu_count()}), every "
        f"frame equal to compress_to_vec; first call (pool start) "
        f"{t_first:.3f} s; 3 runs, mean {t:.4f} s, {n_bytes / t / 1e6:.3f} "
        f"MB/s (host cores, not the card)")


MESH_DEVICES = ("cuda:0", "cuda:0")


def _pulled_handles(outputs, out_len, metas) -> list:
    """Each frame's bytes from serving-mode handles, every device tensor
    read back once."""
    host = {}
    got = []
    for m in metas:
        if not m.rows:
            got.append(None)
            continue
        r = m.rows[0]
        h = outputs[r]
        if id(h[0]) not in host:
            host[id(h[0])] = h[0].cpu().numpy()
        a = host[id(h[0])]
        got.append(a[h[1], h[2]:h[2] + int(out_len[r])].tobytes()
                   if len(h) == 3
                   else a[h[1], m.dict_skip:int(out_len[r])].tobytes())
    return got


def _device_span(dec, batch, staged, runs: int = 5) -> float:
    """Mean ms from before a serving run's first launch to after its last,
    CUDA events on the current stream (gaps between kernels included)."""
    import torch

    spans = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state = dec.run_device(batch, staged, pull_outputs=False, sync=False)
        end.record()
        dec._finalize(state, pull_outputs=False)
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
    return sum(spans) / runs


def phase_mesh(frames, payloads, far_frame, far_body, card, serving_gbps):
    """18. The local mesh, one process: make_mesh(devices=MESH_DEVICES),
    two shards on the one card.
    (a) phase 4's 1024 x 128 KiB frames through stage(batch, mesh=) and
    run_device: every frame exact, out_len and ok equal to the
    single-device serving run on the same batch, the four decode kernels
    launched once per shard (counts zeroed just before, read just after),
    serving handles (xxhash64 once per shard too) giving the same bytes;
    phase 5's serving measurement of the single-device and the mesh
    staging (5 timed runs, stage and busy ms by torch.profiler), and each
    one's device span a run by CUDA events. Two shards on one card
    measure the partition and the reassembly, not scaling.
    (b) a mixed batch over the same mesh: 16 main frames, a 2.5 MiB chained
    frame, the committed dictionary frames, phase 9's window_log-24 frame
    and a truncated frame: every lane right, the truncated one None, the
    window kernel launched once per width group of each shard holding
    chains.
    (c) sharded_decode over the mesh on phase 15's batch (out_width
    131072): equal to the unsharded fused step, padding row included,
    each kernel launched once per shard."""
    import torch

    from zstd_tpu_torch.common.config import CompressionLevel
    from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
    from zstd_tpu_torch.models import framer
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder
    from zstd_tpu_torch.models.fused import (fused_decode_step, fused_static,
                                             to_fused_kwargs)
    from zstd_tpu_torch.parallel.mesh import make_mesh, sharded_decode
    from zstd_tpu_torch.testdata import load_dict_fixture, matches_digest

    mesh = make_mesh(devices=MESH_DEVICES)
    n = len(mesh.devices)
    counters = _counters()
    path = ("huffman", "sequence", "resolve", "execute")

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        return out, {k: c.launches for k, c in counters.items()}

    # (a) the main batch
    dec = BatchDecoder()
    batch = dec.prepare(frames)
    single = dec.stage(batch)
    _, one_len, one_ok = dec.run_device(batch, single, pull_outputs=False)
    t0 = time.perf_counter()
    staged = dec.stage(batch, mesh=mesh)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    shards = [len(p[1]) for p in staged["shards"] if p is not None]
    need(len(shards) == n, f"mesh: {shards} frames a shard, expected {n} "
                           f"shards")
    (outputs, out_len, ok), launches = counted(
        lambda: dec.run_device(batch, staged))
    for k in path:
        need(launches[k] == n, f"mesh: kernel {k} launched {launches[k]} "
                               f"times, expected once per shard ({n})")
    need(np.array_equal(out_len, one_len) and np.array_equal(ok, one_ok),
         "mesh: out_len or ok differ from the single-device run")
    res = dec._postprocess(frames, batch, outputs, out_len, ok)
    need(res == payloads, "mesh: decoded bytes differ from the payloads")
    (h_out, h_len, h_ok), serve_launches = counted(
        lambda: dec.run_device(batch, staged, pull_outputs=False))
    for k in SINGLE_GROUP:
        need(serve_launches[k] == n, f"mesh serving: kernel {k} launched "
                                     f"{serve_launches[k]} times")
    need(bool(np.all(h_ok)), "mesh serving: a checksum or lane failed")
    need(_pulled_handles(h_out, h_len, batch.metas) == payloads,
         "mesh serving: handles give other bytes")
    del outputs, h_out, res
    n_bytes = sum(map(len, payloads))
    t_one, _ = phase_serving(dec, batch, single, n_bytes,
                             label="mesh phase, single device serving")
    t_mesh, _ = phase_serving(dec, batch, staged, n_bytes,
                              label="mesh phase, mesh serving")
    span_one = _device_span(dec, batch, single)
    span_mesh = _device_span(dec, batch, staged)
    say(f"mesh: {len(frames)} frames over {n} shards on {MESH_DEVICES} "
        f"({shards} frames a shard), stage {t_stage * 1e3:.3f} ms, every "
        f"byte exact, out_len and ok equal to the single-device run; "
        f"launches {launches}, serving {serve_launches}")
    say(f"mesh serving on {card}: mesh mean {t_mesh * 1e3:.3f} ms, "
        f"{n_bytes / t_mesh / 1e9:.4f} GB/s, single device mean "
        f"{t_one * 1e3:.3f} ms, {n_bytes / t_one / 1e9:.4f} GB/s (phase 5: "
        f"{serving_gbps:.4f} GB/s); device span a run (CUDA events, first "
        f"launch to last, mean of 5) mesh {span_mesh:.3f} ms, single "
        f"{span_one:.3f} ms; two shards on one card measure the partition "
        f"and the reassembly, not scaling")
    del staged, single, dec

    # (b) the mixed batch
    raw, dict_frames, digests = load_dict_fixture()
    big = make_corpus(3, frame_kb=2560, seed=3)[0]
    mixed = list(frames[:16]) + [bytes(compress_to_vec(
        big, CompressionLevel.FASTEST))]
    at_dict = len(mixed)
    mixed += dict_frames + [far_frame, frames[0][:len(frames[0]) // 2]]
    expected = list(payloads[:16]) + [big] + [None] * len(dict_frames)
    expected += [far_body, None]
    dec = BatchDecoder()
    dec.add_dict(raw)
    mbatch = dec.prepare(mixed)
    metas = mbatch.metas
    need(len(metas[16].rows) > 1, "mesh mixed: the 2.5 MiB frame is not "
                                  "chained")
    need(all(metas[at_dict + i].dict_prefill for i in range(len(digests))),
         "mesh mixed: a dictionary frame without its prefill")
    need(metas[-2].window > framer.STREAM_WINDOW_CAP,
         "mesh mixed: the window_log-24 frame is not far")
    _, one_len, one_ok = dec.run_device(mbatch)
    mstaged = dec.stage(mbatch, mesh=mesh)
    (outputs, out_len, ok), launches = counted(
        lambda: dec.run_device(mbatch, mstaged))
    res = dec._postprocess(mixed, mbatch, outputs, out_len, ok)
    for i, (r, e) in enumerate(zip(res, expected)):
        if at_dict <= i < at_dict + len(digests):
            need(matches_digest(r, digests[i - at_dict]),
                 f"mesh mixed: dictionary frame {i} decoded wrong")
        else:
            need(r == e, f"mesh mixed: lane {i} decoded wrong")
    need(res[-1] is None, "mesh mixed: the truncated frame is not None")
    need(np.array_equal(out_len, one_len) and np.array_equal(ok, one_ok),
         "mesh mixed: out_len or ok differ from the single-device run")
    need(dec.host_frames == 0, f"mesh mixed: {dec.host_frames} host frames")
    groups = [len(p[2]["chains"] or ()) for p in mstaged["shards"]
              if p is not None]
    need(launches["execute_window"] == sum(groups) and all(groups),
         f"mesh mixed: window kernel launched {launches['execute_window']}"
         f" times for chain width groups {groups} a shard")
    for k in path[:3]:
        need(launches[k] == n, f"mesh mixed: kernel {k} launched "
                               f"{launches[k]} times, expected {n}")
    say(f"mesh mixed: {len(mixed)} frames (16 simple, chained, "
        f"{len(dict_frames)} dictionary, window_log-24 far, truncated) over "
        f"{n} shards ({[len(p[1]) for p in mstaged['shards'] if p]} frame "
        f"rows a shard, chain width groups {groups}); every lane exact, the "
        f"truncated one None, out_len and ok equal to the single-device "
        f"run; launches {launches}")
    del dec, mbatch, mstaged, outputs, res

    # (c) the fused step over the mesh
    static = fused_static(batch, 1 << 17)
    kw = to_fused_kwargs(batch, "cuda")
    out1, len1, ok1, m1 = fused_decode_step(**kw, **static)
    out1, len1, ok1 = out1.cpu().numpy(), len1.cpu().numpy(), \
        ok1.cpu().numpy()
    del kw
    (out, out_len, ok, metrics), launches = counted(
        lambda: sharded_decode(batch, static, mesh))
    rows = len1.shape[0]
    pad = out.shape[0] - rows
    need(pad == (-rows) % n and np.array_equal(out[:rows], out1)
         and np.array_equal(out_len[:rows], len1)
         and np.array_equal(ok[:rows], ok1) and bool(ok[rows:].all())
         and not out[rows:].any(),
         "mesh sharded_decode: differs from the unsharded fused step")
    m = {k: int(v) for k, v in metrics.items()}
    need(m == {"bytes_out": int(m1["bytes_out"]),
               "frames_ok": int(m1["frames_ok"]) + pad,
               "frames_bad": int(m1["frames_bad"])},
         f"mesh sharded_decode: metrics {m}")
    for k in path:
        need(launches[k] == n, f"mesh sharded_decode: kernel {k} launched "
                               f"{launches[k]} times, expected {n}")
    say(f"mesh sharded_decode: {rows} frame rows + {pad} padding over {n} "
        f"shards, equal to the unsharded fused step; metrics {m}; launches "
        f"{launches}")
    del out, out1
    torch.cuda.empty_cache()


# --- libzstd frames on the card ----------------------------------------------

MAIN_TILE = 64         # the 16 main frames 64 times: 1024 x 128 KiB
FUZZ_MUTANTS = 512
FUZZ_BATCH = 64        # mutants a batch, each beside a valid frame
FUZZ_SEED = 19
DECODE_KERNELS = ("huffman", "sequence", "resolve", "execute")


def libzstd_fixture() -> dict:
    """The committed libzstd frames (zstd_tpu_torch/testdata/libzstd) by
    group, each entry with its payload, made again from its recipe and held
    to its manifest digest, under "data"; the stream under "stream"."""
    from zstd_tpu_torch.testdata import (libzstd_payload, load_libzstd_fixture,
                                         load_libzstd_stream, matches_digest)
    from zstd_tpu_torch.testdata.payloads import payload

    cache, groups = {}, {}
    for e in load_libzstd_fixture():
        p = libzstd_payload(e, cache)
        need(matches_digest(p, e["digest"]),
             f"libzstd fixture: the payload of {e['file']} differs from its "
             f"manifest digest")
        groups.setdefault(e["group"], []).append({**e, "data": p})
    s = load_libzstd_stream()
    s["data"] = [payload(spec, cache) for spec in s["payloads"]]
    need(matches_digest(b"".join(s["data"]), s["digest"]),
         "libzstd fixture: the stream's payloads differ from its digest")
    groups["stream"] = s
    return groups


def _row_good(m, p, outputs, out_len, ok, pulled: bool) -> bool:
    """A frame's own device row: parsed for the device, ok, out_len its
    payload's length and, pulled, its payload's bytes."""
    if not m.ok or m.fallback or not m.rows:
        return False
    r = m.rows[0]
    good = bool(ok[r]) and int(out_len[r]) == m.dict_skip + len(p)
    if good and pulled:
        good = outputs[r][m.dict_skip:m.dict_skip + len(p)].tobytes() == p
    return good


def device_rows(label, dec, batch, staged, payloads, pull: bool = True):
    """run_device's rows of a staged batch held to the payloads. Read from
    the rows, a frame the device rejected fails here, where decode_frames
    would have decoded it again on the host."""
    outputs, out_len, ok = dec.run_device(batch, staged, pull_outputs=pull)
    bad = [i for i, (m, p) in enumerate(zip(batch.metas, payloads))
           if not _row_good(m, p, outputs, out_len, ok, pull)]
    need(not bad, f"{label}: {len(bad)} frames not ok or wrong in their "
                  f"device rows ({'pulled' if pull else 'serving'}), first "
                  f"{bad[:8]}")


def _rows_of(t, n: int, tile: int):
    """t's rows for frames held `tile` times over, as a batch of the n
    frames once holds them: its first n rows and, where t has one more
    (the inert row), that row."""
    import torch

    if tile == 1:
        return t
    return torch.cat([t[:n], t[n * tile:]])


HOST_PLAIN = ("huffman", "sequence")


def host_plain(frames: list) -> dict:
    """The plain versions of the two step loops (HOST_PLAIN) on a CPU
    batch of `frames`: {name: [its outputs as numpy arrays]} and "rows",
    the batch's frame rows. A job for a spawned worker: on the card a
    step costs a few launches, so there the plain sequence stage of a
    128 KiB block takes tens of seconds; on the host a few, beside the
    phase."""
    import torch

    from zstd_tpu_torch.models.batch_decoder import BatchDecoder

    torch.set_num_threads(2)
    dec = BatchDecoder(device="cpu")
    d = dec.stage(dec.prepare(frames))
    out = {"rows": d["lit_base"].shape[0] - 1}
    for name, (setup, call, _, plain) in (("huffman", huffman_case(d)),
                                          ("sequence", sequence_case(d))):
        out[name] = [t.numpy() for t in call(plain, setup())]
    return out


def decode_kernel_runs(d) -> dict:
    """Each decode kernel once on the staged batch d, each given the
    outputs of the kernels before it: {name: (its outputs, its case)};
    an output's last tensor is its ok flags, one a frame row (execute:
    one an executed row)."""
    cases, _ = kernel_cases(d, stage_outputs(d))
    runs = {}
    for name in DECODE_KERNELS:
        setup, call, kern, _ = cases[name]
        runs[name] = (call(kern, setup()), cases[name])
    return runs


def kernels_vs_plain(label, runs: dict, host: dict, tile: int = 1):
    """decode_kernel_runs' outputs on the card against the plain versions,
    bit-equal, ok flags included, or raise. The plain Huffman and sequence
    stages are `host` (host_plain of the batch's frames, which the batch
    holds `tile` times over); resolve and execute run their plain versions
    on the card, on the same inputs as their kernels."""
    import torch

    n = host["rows"]
    for name, (got, (setup, call, _, plain)) in runs.items():
        if name in HOST_PLAIN:
            exp = [torch.from_numpy(a) for a in host[name]]
            err = max_abs_err([_rows_of(a, n, tile).cpu() for a in got], exp)
            if tile > 1:
                err = max(err, max_abs_err(
                    [a[:n * tile].cpu() for a in got],
                    [b[:n].repeat(tile, *[1] * (b.dim() - 1)) for b in exp]))
        else:
            exp = call(plain, setup())
            torch.cuda.synchronize()
            err = max_abs_err(got, exp)
        need(err == 0, f"{label}: kernel {name} differs from its plain "
                       f"version (max abs err {err})")


def _oracle_frame(frame):
    """oracle.decode_frame's bytes, None where it raises ZstdError."""
    from zstd_tpu_torch.common.errors import ZstdError
    from zstd_tpu_torch.oracle import decode_frame

    try:
        return decode_frame(frame)
    except ZstdError:
        return None


def _libzstd_batch(label, frames, payloads, kernels=DECODE_KERNELS):
    """A batch of libzstd frames on the card: decode_frames equal to the
    payloads, the device rows pulled and in serving mode, host_frames 0,
    `kernels` launched in the serving run. Returns (decoder, batch,
    staged, the serving run's launches)."""
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder

    dec = BatchDecoder()
    counters = _counters()
    need(dec.decode_frames(frames) == payloads,
         f"{label}: decode_frames' bytes differ from the payloads")
    batch = dec.prepare(frames)
    staged = dec.stage(batch)
    device_rows(label, dec, batch, staged, payloads)
    for fn in counters.values():
        fn.launches = 0
    device_rows(label, dec, batch, staged, payloads, pull=False)
    launches = {k: fn.launches for k, fn in counters.items()}
    need(dec.host_frames == 0, f"{label}: {dec.host_frames} host frames")
    for k in kernels:
        need(launches[k] > 0, f"{label}: serving never launched kernel {k}")
    return dec, batch, staged, launches


def _cli_start(work, entry):
    """Start `python -m zstd_tpu_torch.cli decompress --gpu` on one fixture
    frame written under `work`; returns (process, its output path, start
    time). It runs beside the rest of the phase."""
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, entry["file"])
    with open(src, "wb") as f:
        f.write(entry["frame"])
    proc = subprocess.Popen(
        [sys.executable, "-m", "zstd_tpu_torch.cli", "decompress", src,
         src + ".out", "--gpu"], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": root})
    return proc, src + ".out", time.perf_counter()


def _cli_finish(proc, out_path, t0, want: bytes) -> float:
    """Wait for _cli_start's process; its output must be `want`."""
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    t = time.perf_counter() - t0
    need(proc.returncode == 0, f"libzstd cli: exited {proc.returncode}: "
                               f"{err}")
    with open(out_path, "rb") as f:
        need(f.read() == want, "libzstd cli: bytes differ")
    return t


def _oracle_frames(frames) -> list:
    """_oracle_frame of each frame, in threads (the native decode loops
    release the interpreter lock)."""
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        return list(pool.map(_oracle_frame, frames))


def phase_libzstd(card, serving_gbps):
    """19. libzstd frames on the card (zstd_tpu_torch/testdata/libzstd,
    written by scripts/make_torch_libzstd_fixture.py; payloads made again
    from their recipes and held to the manifest's digests). Every device
    check reads run_device's rows (device_rows), not decode_frames alone,
    which decodes a frame the device rejected again on the host.
    (a) main: the 16 level-3 frames with checksums 64 times, 1024 x 128
    KiB: decode_frames exact; the device rows pulled (each ok, its out_len
    and bytes right) and in serving mode (each ok, checksums verified on
    the device); host_frames 0; the five kernels of the path launched in
    the serving run; serving GB/s beside phase 5's FASTEST number.
    (b) the level and edge frames as one batch, the same checks; the
    stream with a skippable frame through decode_all_device and its frames'
    rows; one level-19 frame through `python -m zstd_tpu_torch.cli
    decompress --gpu`, a subprocess started at the phase's start.
    (c) the chained (4 MiB, window 2 MiB) and far (window past 8 MiB)
    frames, each alone: the same checks, the window kernel launched and
    bit-equal to its plain version, the far frame's matches past 8 MiB.
    (d) targeted fuzz: FUZZ_MUTANTS mutants of the checksum-less frames
    (testdata/anatomy.py::targeted_mutants, random.Random(FUZZ_SEED)), in
    batches of FUZZ_BATCH, each mutant beside a valid frame: no CUDA error;
    every result equal to oracle.decode_frame's (None where it raises);
    every valid frame's device row ok and exact; the four decode kernels
    bit-equal to their plain versions on the first batch; the corrupted
    lanes that reach the Huffman and the sequence kernel (each at least
    128) and the mutants each kernel flagged.
    (e) the main batch once more, exact: the context survived; its four
    decode kernels bit-equal to their plain versions (kernels_vs_plain)."""
    import concurrent.futures as cf
    import multiprocessing
    import random

    from zstd_tpu_torch.testdata.anatomy import targeted_mutants

    t_phase = time.perf_counter()
    fx = libzstd_fixture()
    t_fixture = time.perf_counter() - t_phase
    e19 = next(e for e in fx["levels"] if e["level"] == 19)
    bases = [e for g in ("levels", "edge") for e in fx[g]
             if not e["checksum"]]
    valid = fx["main"] + fx["levels"] + fx["edge"]
    mutants = targeted_mutants([e["frame"] for e in bases],
                               random.Random(FUZZ_SEED), FUZZ_MUTANTS)
    batches = []
    for b in range(0, len(mutants), FUZZ_BATCH):
        chunk = mutants[b:b + FUZZ_BATCH]
        beside = [valid[(b + j) % len(valid)] for j in range(len(chunk))]
        batches.append((chunk, beside, [x for mut, v in zip(chunk, beside)
                                        for x in (mut[3], v["frame"])]))
    # beside the phase: the CLI in a subprocess and the plain Huffman and
    # sequence stages of the two batches they are held to in spawned
    # workers, the pool closed (its workers stopped) when the phase ends
    cli = _cli_start(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "build", "chip_smoke_cli"), e19)
    with cf.ProcessPoolExecutor(
            max_workers=2,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        plain = {"main": pool.submit(host_plain,
                                     [e["frame"] for e in fx["main"]]),
                 "fuzz": pool.submit(host_plain, batches[0][2])}
        _phase_libzstd(card, serving_gbps, fx, batches, plain)
    t_cli = _cli_finish(*cli, e19["data"])
    say(f"libzstd: cli decompress --gpu of {e19['file']} exact ({t_cli:.1f} "
        f"s, beside the phase); fixture made in {t_fixture:.1f} s; phase 19 "
        f"{time.perf_counter() - t_phase:.1f} s")


def _phase_libzstd(card, serving_gbps, fx, batches, plain):
    """phase_libzstd's checks (a)-(e) on the fixture `fx`, the fuzz
    `batches` ((mutants, valid frames beside them, the batch's frames))
    and the futures of host_plain of the main frames and the first fuzz
    batch."""
    import torch

    from zstd_tpu_torch.models import framer
    from zstd_tpu_torch.models.batch_decoder import (BatchDecoder,
                                                     _resolve_chained)
    from zstd_tpu_torch.models.splitter import decode_all_device, split_frames
    from zstd_tpu_torch.testdata.anatomy import REGION_KERNEL

    # (a) main
    t0 = time.perf_counter()
    main = fx["main"]
    frames = [e["frame"] for e in main] * MAIN_TILE
    payloads = [e["data"] for e in main] * MAIN_TILE
    n_bytes = sum(map(len, payloads))
    main_dec, main_batch, main_staged, launches = _libzstd_batch(
        "libzstd main", frames, payloads, SINGLE_GROUP)
    t_serve, _ = phase_serving(main_dec, main_batch, main_staged, n_bytes,
                               label="libzstd main serving")
    say(f"libzstd main: {len(frames)} frames ({len(main)} level-3 frames "
        f"with checksums x {MAIN_TILE}), {n_bytes} bytes, ratio "
        f"{sum(map(len, frames)) / n_bytes:.4f}; decode_frames exact, every "
        f"device row ok and exact, pulled and serving, host_frames 0; "
        f"serving launches {launches}; {time.perf_counter() - t0:.1f} s")
    span = _device_span(main_dec, main_batch, main_staged)
    say(f"libzstd main serving on {card}: {n_bytes / t_serve / 1e9:.4f} "
        f"GB/s (mean of 5), device span a run {span:.3f} ms (CUDA events, "
        f"first launch to last, mean of 5); FASTEST frames, phase 5: "
        f"{serving_gbps:.4f} GB/s (a record, not a claim: 16 distinct "
        f"frames, tiled)")

    # (b) levels and edge, the stream, the CLI
    t0 = time.perf_counter()
    other = fx["levels"] + fx["edge"]
    _libzstd_batch("libzstd levels and edge", [e["frame"] for e in other],
                   [e["data"] for e in other])
    s = fx["stream"]
    parts = split_frames(s["stream"])
    _libzstd_batch("libzstd stream frames", parts, s["data"],
                   DECODE_KERNELS[1:])
    dec = BatchDecoder()
    need(decode_all_device(s["stream"], decoder=dec) == b"".join(s["data"])
         and dec.host_frames == 0, "libzstd stream: decode_all_device differs")
    say(f"libzstd levels and edge: {len(other)} frames (levels 19, 1, -5; "
        f"{', '.join(e['file'] for e in fx['edge'])}) exact, every device "
        f"row ok, host_frames 0; the stream ({len(parts)} frames around a "
        f"skippable one) exact through decode_all_device and its rows; "
        f"{time.perf_counter() - t0:.1f} s")

    # (c) chained and far
    for label in ("chained", "far"):
        t0 = time.perf_counter()
        e = fx[label][0]
        dec, batch, staged, launches = _libzstd_batch(
            f"libzstd {label}", [e["frame"]], [e["data"]],
            ("huffman", "sequence", "resolve", "execute_window"))
        m = batch.metas[0]
        need(len(m.rows) > 1, f"libzstd {label}: not chained")
        if label == "chained":
            need(m.window < len(e["data"]),
                 f"libzstd chained: window {m.window} not below the frame")
        _window_run(f"libzstd {label}", staged)
        _, ll, ml, of = stage_outputs(staged)
        offsets, _, _ = _resolve_chained(ll, ml, of, staged["is_real"],
                                         staged["init_hist"],
                                         staged["chain_rows"],
                                         staged["chain_row_cont"])
        n_far = int(((ml > 0) & (offsets > framer.STREAM_WINDOW_CAP)).sum())
        if label == "far":
            need(m.window > framer.STREAM_WINDOW_CAP and n_far > 0,
                 f"libzstd far: window {m.window}, {n_far} matches past "
                 f"{framer.STREAM_WINDOW_CAP} bytes")
        say(f"libzstd {label}: {len(e['data'])} bytes, window {m.window}, "
            f"{len(m.rows)} block groups, exact, device row ok pulled and "
            f"serving, host_frames 0, launches {launches}; {n_far} matches "
            f"past {framer.STREAM_WINDOW_CAP} bytes; "
            f"{time.perf_counter() - t0:.1f} s")
        del dec, batch, staged

    # (d) targeted fuzz
    t0 = time.perf_counter()
    lanes = {"huffman": 0, "sequence": 0}
    flagged = dict.fromkeys(DECODE_KERNELS, 0)
    on_device = decoded = 0
    t_plain = 0.0
    for i, (chunk, beside, frames) in enumerate(batches):
        dec = BatchDecoder()
        batch = dec.prepare(frames)
        staged = dec.stage(batch)
        outputs, out_len, ok = dec.run_device(batch, staged)
        res = dec._postprocess(frames, batch, outputs, out_len, ok)
        torch.cuda.synchronize()
        label = f"libzstd fuzz batch {i + 1}"
        for j, v in enumerate(beside):
            need(_row_good(batch.metas[2 * j + 1], v["data"], outputs,
                           out_len, ok, True) and res[2 * j + 1] == v["data"],
                 f"{label}: valid frame {v['file']} beside mutant {j} is "
                 f"not ok or wrong in its device row")
        for j, want in enumerate(_oracle_frames([m[3] for m in chunk])):
            _, how, region, _ = chunk[j]
            need(res[2 * j] == want,
                 f"{label}: mutant {j} ({how} in {region.kind}) gives "
                 f"{'None' if res[2 * j] is None else 'other bytes'}, the "
                 f"oracle {'None' if want is None else 'bytes'}")
            decoded += want is not None
        runs = decode_kernel_runs(staged)
        flags = {k: out[-1].cpu().numpy() for k, (out, _) in runs.items()}
        if i == 0:
            t1 = time.perf_counter()
            kernels_vs_plain(label, runs, plain["fuzz"].result())
            t_plain = time.perf_counter() - t1
        exec_at = {r: i for i, r in enumerate(staged["exec_rows_list"])}
        for j, (_, _, region, _) in enumerate(chunk):
            m = batch.metas[2 * j]
            if not m.ok or m.fallback or not m.rows:
                continue
            on_device += 1
            lanes[REGION_KERNEL[region.kind]] += region.lanes
            for k in DECODE_KERNELS:
                rows = ([exec_at[r] for r in m.rows if r in exec_at]
                        if k == "execute" else m.rows)
                flagged[k] += not all(flags[k][r] for r in rows)
        del dec, batch, staged, outputs, res, runs
    mutants = [m for chunk, _, _ in batches for m in chunk]
    kinds = {}
    for _, how, region, _ in mutants:
        key = f"{how}/{region.kind}"
        kinds[key] = kinds.get(key, 0) + 1
    say(f"libzstd fuzz: {len(mutants)} mutants of the checksum-less frames, "
        f"{FUZZ_BATCH} a batch beside as many valid frames, "
        f"{time.perf_counter() - t0:.1f} s (the comparison with the plain "
        f"versions on batch 1 {t_plain:.1f} s); no CUDA error; every result equal to "
        f"oracle.decode_frame's ({decoded} decoded, {len(mutants) - decoded} "
        f"None); every valid frame ok and exact; the four decode kernels "
        f"bit-equal to their plain versions on batch 1; kinds "
        f"{json.dumps(kinds)}")
    say(f"libzstd fuzz: {on_device} mutants reached the device; corrupted "
        f"lanes reaching huffman {lanes['huffman']}, sequence "
        f"{lanes['sequence']}; mutants flagged by {json.dumps(flagged)}")
    for k, n in lanes.items():
        need(n >= 128, f"libzstd fuzz: only {n} corrupted lanes reached the "
                       f"{k} kernel")

    # (e) the main batch again, and its kernels against their plain
    # versions (last: their host half is the longest job beside the phase)
    device_rows("libzstd main after the fuzz", main_dec, main_batch,
                main_staged, payloads)
    t0 = time.perf_counter()
    kernels_vs_plain("libzstd main", decode_kernel_runs(main_staged),
                     plain["main"].result(), tile=MAIN_TILE)
    say(f"libzstd: the main batch exact again after the fuzz; its huffman, "
        f"sequence, resolve and execute kernels bit-equal to their plain "
        f"versions ({time.perf_counter() - t0:.1f} s, the wait for the host "
        f"half included)")


# the kernels each scenario of zstd_tpu_torch.bench must launch
BENCH_KERNELS = {"headline": SINGLE_GROUP,
                 "libzstd": SINGLE_GROUP + ("execute_window",),
                 "longframe": ("huffman", "sequence", "resolve",
                               "execute_window"),
                 "bigwindow": ("huffman", "sequence", "resolve",
                               "execute_window"),
                 "encode": ("parse", "fse_encode")}


def phase_bench(payloads, frames, card):
    """20. zstd_tpu_torch.bench's scenarios (bench.py's on the card), the
    headline on phase 4's FASTEST frames: the bench's JSON line, which must
    hold every key of BENCH_r05.json's `parsed` and every correctness key
    true; each scenario run on its own, the kernels of BENCH_KERNELS
    launched in it; a pipelined round beside its host prepare and a
    serving run."""
    from zstd_tpu_torch import bench

    t0 = time.perf_counter()
    counters = {**_counters(), **_encode_counters()}
    res, launched = {}, {}
    for name in bench.SCENARIOS:
        for fn in counters.values():
            fn.launches = 0
        res.update(bench.run_scenarios(
            [name], headline_frames=(payloads, frames, "fastest")))
        launched[name] = {k: fn.launches for k, fn in counters.items()
                          if fn.launches}
        missing = set(BENCH_KERNELS[name]) - set(launched[name])
        need(not missing, f"bench: scenario {name} never launched kernels "
                          f"{sorted(missing)}")
    res["device"] = card
    say("bench: " + json.dumps(res))
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "BENCH_r05.json")) as f:
        missing = [k for k in json.load(f)["parsed"] if k not in res]
    need(not missing, f"bench: the line lacks bench.py's keys {missing}")
    bad = bench.failed_checks(res)
    need(not bad, f"bench: correctness keys not true: {bad}")
    t_round = res["decoded_mb"] * 1e6 / (res["pipelined_gbps"] * 1e9)
    say(f"bench: launches per scenario {json.dumps(launched)}")
    say(f"bench: every correctness key true; a pipelined round "
        f"{t_round * 1e3:.3f} ms ({res['pipelined_gbps']:.4f} GB/s), a "
        f"warm host prepare {res['pipelined_prepare_s'] * 1e3:.3f} ms, a "
        f"serving run {res['device_s'] * 1e3:.3f} ms ({res['value']:.4f} GB/s), end "
        f"to end {res['end_to_end_gbps']:.4f} GB/s; phase 20 "
        f"{time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card, name = phase_card()
    phase_build()
    phase_small()
    dec, batch, staged, n_bytes, launches, main_payloads, main_frames = \
        phase_main()
    t_serving, _ = phase_serving(dec, batch, staged, n_bytes)
    rows = phase_kernels(batch, staged, launches)
    serving_gbps = n_bytes / t_serving / 1e9
    phase_fused(batch, main_payloads, serving_gbps)
    del dec, batch, staged
    phase_chained_small()
    dec, batch, staged, n_bytes, launches = phase_chained()
    phase_serving(dec, batch, staged, n_bytes, label="chained serving")
    far, far_frame, far_body = phase_far()
    rows.append(phase_window_kernel(staged, launches, far))
    res = next(r for r in rows if r["name"] == "resolve")
    res["max_abs_err"] = max(res["max_abs_err"],
                             phase_resolve_chained(staged, far))
    huff = next(r for r in rows if r["name"] == "huffman")
    huff["max_abs_err"] = max(huff["max_abs_err"],
                              phase_huffman_chained(staged, far))
    del dec, batch, staged, far
    phase_mesh(main_frames, main_payloads, far_frame, far_body, card,
               serving_gbps)
    phase_libzstd(card, serving_gbps)
    payloads, host_frames, host_ratio = phase_encode_host()
    launches, args = phase_encode_device(payloads, host_ratio)
    phase_cli()
    rows += phase_encode_kernels(args, launches)
    phase_ranks(main_frames)
    phase_parallel_encode(payloads, host_frames)
    phase_bench(main_payloads, main_frames, card)
    say(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_child(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
