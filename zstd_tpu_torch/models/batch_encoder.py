"""Batched frame encoder with device entropy coding.

Port of zstd_tpu/models/batch_encoder.py. It mirrors the host
FrameCompressor (Fastest level) with the bit production on the device,
batched across all blocks of all frames:

  host: block split, greedy match generation (or the device matcher's
        records), histogramming, table builds (tiny, irregular),
        section/frame assembly
  device: Huffman literal encoding for every (block, stream) lane — a
        gather + prefix-sum + scatter bit-pack, no sequential state, plain
        torch (ops/bitpack.py) — and the interleaved 3-state FSE sequence
        encoding per block lane, encoded and packed by one CUDA kernel
        (ops/fse_encode.py)

With the host matcher the output is byte-identical to the host encoder
(same tables, same greedy matcher), so every host-encoder gate (libzstd
decode interop, no-expansion) transfers; tests assert equality outright.
With encoding.device_matcher.DeviceMatcher the frames equal the
reference's device-matched frames.
"""

import dataclasses
import time

import numpy as np
import torch

from zstd_tpu_torch.common import constants as C
from zstd_tpu_torch.common.config import CodecConfig, CompressionLevel
from zstd_tpu_torch.common.errors import EncodeError
from zstd_tpu_torch.common.trace import scope
from zstd_tpu_torch.encoding import huff0_enc
from zstd_tpu_torch.encoding.block_enc import (
    _lit_header, _lit_header_byte, _lit_header_compressed, _mode_and_table,
    _seqnum_varint, _sim_bits, ll_code, make_triples, ml_code, of_code_of)
from zstd_tpu_torch.encoding.frame_enc import (BLOCK_SIZE, _block_header,
                                               _frame_header, compress_to_vec,
                                               effective_window_log)
from zstd_tpu_torch.encoding.match_gen import (FrameMatchCtx, find_sequences,
                                               find_sequences_ctx)
from zstd_tpu_torch.models.batch_decoder import resolve_device
from zstd_tpu_torch.ops.bitpack import finalize_streams, pack_bits_lanes
from zstd_tpu_torch.ops.fse_encode import (encode_sequences_packed,
                                           out_words_for, seq_lane_arrays)
from zstd_tpu_torch.utils.bitio import BitWriter
from zstd_tpu_torch.utils.xxhash64 import FastXxh64 as Xxh64


def _is_rle(block: bytes) -> bool:
    """A block of one repeated byte, emitted as an RLE block."""
    return block.count(block[0]) == len(block)


def matched_blocks(payloads: list) -> list:
    """The blocks a batched matcher parses: every block of every payload
    except the RLE ones."""
    blocks = []
    for p in map(bytes, payloads):
        for off in range(0, len(p), BLOCK_SIZE):
            blk = p[off:off + BLOCK_SIZE]
            if blk and not _is_rle(blk):
                blocks.append(blk)
    return blocks


@dataclasses.dataclass
class _HuffLane:
    codes: np.ndarray    # (n,) u32 per-literal code values (reverse order)
    nbits: np.ndarray    # (n,) i32


@dataclasses.dataclass
class _SeqLane:
    triples: list
    tables: tuple        # (ll_table|None, of_table|None, ml_table|None) None=RLE
    logs: tuple


class BatchEncoder:
    """Compress many payloads, device-batched entropy coding.

    matcher=None uses the host greedy matcher (byte-identical to the host
    FrameCompressor); pass encoding.device_matcher.DeviceMatcher() to run
    match finding on the device too (valid streams, gated by round trip /
    interop / size rather than stream equality). `device` None means the
    GPU (raises without one); "cpu" runs the plain versions.

    last_stats after compress_frames: match_s (the device matcher's
    batched round, 0 without one), plan_s, entropy_s (device entropy
    coding, transfers and the host sync included), assemble_s, lanes.
    """

    def __init__(self, config: CodecConfig | None = None, matcher=None,
                 device=None):
        self.config = config or CodecConfig()
        self.matcher = matcher
        self.device = resolve_device(device)
        self.last_stats = {}

    def compress_frames(self, payloads: list) -> list:
        level = self.config.level
        if level == CompressionLevel.UNCOMPRESSED:
            return [compress_to_vec(p, level) for p in payloads]
        t0 = time.perf_counter()
        if self.matcher is not None and hasattr(self.matcher, "precompute"):
            self.matcher.precompute(matched_blocks(payloads))
        t_match = time.perf_counter() - t0
        if level != CompressionLevel.FASTEST:
            raise NotImplementedError(f"level {level.name} not implemented")

        # ---- host pass: plan every block -----------------------------------
        t0 = time.perf_counter()
        plans = []   # per frame: list of block plans
        huff_lanes: list[_HuffLane] = []
        seq_lanes: list[_SeqLane] = []
        for p in payloads:
            plans.append(self._plan_frame(bytes(p), huff_lanes, seq_lanes))
        t_plan = time.perf_counter() - t0

        # ---- device pass: batched entropy coding (host<->device transfers
        # and the final host sync included)
        t0 = time.perf_counter()
        huff_streams = self._encode_huff_lanes(huff_lanes)
        seq_streams = self._encode_seq_lanes(seq_lanes)
        t_entropy = time.perf_counter() - t0

        # ---- host pass: assemble frames ------------------------------------
        t0 = time.perf_counter()
        out = []
        for p, frame_plan in zip(payloads, plans):
            out.append(self._assemble_frame(bytes(p), frame_plan,
                                            huff_streams, seq_streams))
        self.last_stats = {"match_s": t_match, "plan_s": t_plan,
                           "entropy_s": t_entropy,
                           "assemble_s": time.perf_counter() - t0,
                           "lanes": len(huff_lanes) + len(seq_lanes)}
        return out

    # ------------------------------------------------------------------ plan

    def _plan_frame(self, payload: bytes, huff_lanes, seq_lanes):
        blocks = []
        if len(payload) == 0:
            return [("empty",)]
        offset_hist = list(C.INITIAL_REPEAT_OFFSETS)
        # cross-block matcher window (byte parity with the host
        # FrameCompressor): the whole payload is in memory, so the ctx view
        # is just (payload, 0, off, off+len) with the frame-lifetime table
        mctx = FrameMatchCtx(
            1 << effective_window_log(len(payload), self.config.window_log))
        for off in range(0, len(payload), BLOCK_SIZE):
            block = payload[off:off + BLOCK_SIZE]
            if _is_rle(block):
                blocks.append(("rle", block[0], len(block)))
                continue
            view = (payload, 0, off, off + len(block))
            hist = list(offset_hist)
            plan = self._plan_compressed_block(block, huff_lanes, seq_lanes,
                                               hist, fctx=(mctx, view))
            if plan is not None:
                offset_hist = hist  # commit: the block will be emitted compressed
                blocks.append(plan)
            else:
                blocks.append(("raw", block))
        return blocks

    def _plan_compressed_block(self, block, huff_lanes, seq_lanes,
                               offset_hist, fctx=None):
        """Returns a plan whose exact assembled size beats raw, else None.

        Sizes are computed exactly at plan time (sum of code lengths /
        simulated state bits) so the raw-vs-compressed decision — and the
        repeat-offset history commit — happen before any device work,
        keeping output byte-identical to the host FrameCompressor."""
        if self.matcher is not None:
            seqs = self.matcher.find(block)
        elif fctx is not None:
            ctx, (buf, base, lo, hi) = fctx
            seqs = find_sequences_ctx(buf, base, lo, hi, ctx.table,
                                      ctx.max_off)
        else:
            seqs = find_sequences(block)
        lits = b"".join(s.literals for s in seqs)

        # literals representation + exact section size
        lit_plan = None
        lit_size = None
        n = len(lits)
        pending_huff = None
        if n == 0:
            lit_plan = ("rawlit", b"")
            lit_size = 1
        elif lits.count(lits[0]) == n:
            lit_plan = ("rlelit", lits[0], n)
            lit_size = len(_lit_header(C.LIT_RLE, n)) + 1
        elif n > 63:
            counts = np.bincount(np.frombuffer(lits, np.uint8), minlength=256)
            try:
                table = huff0_enc.build_from_counts(counts)
                tw = BitWriter()
                huff0_enc.write_table_description(table, tw)
                desc = tw.dump()
                four = n >= 256
                if four:
                    split = (n + 3) // 4
                    parts = [lits[i * split:(i + 1) * split] for i in range(4)]
                else:
                    parts = [lits]
                # exact stream sizes: sum of code lengths + sentinel, padded
                sizes = [int(np.sum(table.lengths[np.frombuffer(p, np.uint8)])
                             + 1 + 7) // 8 for p in parts]
                payload_size = (6 if four else 0) + sum(sizes)
                comp = len(desc) + payload_size
                header = _lit_header_compressed(C.LIT_COMPRESSED, n, comp, four)
                raw_cost = len(_lit_header(C.LIT_RAW, n)) + n
                if (header is not None and len(header) + comp < raw_cost
                        and all(s <= 0xFFFF for s in sizes[:3])):
                    pending_huff = (table, desc, four, parts)
                    lit_size = len(header) + comp
            except EncodeError:
                pending_huff = None
        if lit_plan is None and pending_huff is None:
            lit_plan = ("rawlit", lits)
            lit_size = len(_lit_header(C.LIT_RAW, n)) + n if n else 1

        # sequences representation + exact section size
        triples = make_triples(seqs, offset_hist)
        seq_pending = None
        if triples:
            llc = [ll_code(a) for a, _, _ in triples]
            mlc = [ml_code(m) for _, m, _ in triples]
            ofc = [of_code_of(o) for _, _, o in triples]
            tw = BitWriter()
            ll_mode, ll_t = _mode_and_table(llc, C.LL_MAX_LOG, tw, "ll")
            of_mode, of_t = _mode_and_table(ofc, C.OF_MAX_LOG, tw, "of")
            ml_mode, ml_t = _mode_and_table(mlc, C.ML_MAX_LOG, tw, "ml")
            table_bytes = tw.dump()
            # exact bitstream size: per-stream state bits (incl flush) +
            # extras + sentinel, padded to bytes. RLE-mode streams are free.
            bits = 0
            for mode, tab, codes in ((ll_mode, ll_t, llc), (of_mode, of_t, ofc),
                                     (ml_mode, ml_t, mlc)):
                if mode != C.MODE_RLE:
                    bits += _sim_bits(tab, codes)
            for lc, mc, oc in zip(llc, mlc, ofc):
                bits += C.LL_CODE_EXTRA_BITS[lc] + C.ML_CODE_EXTRA_BITS[mc] + oc
            stream_size = (bits + 1 + 7) // 8
            seq_size = (len(_seqnum_varint(len(triples))) + 1
                        + len(table_bytes) + stream_size)
            seq_pending = (triples, ll_mode, ll_t, of_mode, of_t, ml_mode,
                           ml_t, table_bytes)
        else:
            seq_size = 1  # the 0 varint

        total = lit_size + seq_size
        if total >= len(block):
            return None  # raw block wins; caller reverts the offset history

        # commit lanes now that the block is definitely compressed
        if pending_huff is not None:
            table, desc, four, parts = pending_huff
            lanes = []
            for part in parts:
                rev = np.frombuffer(part, np.uint8)[::-1]
                lanes.append(len(huff_lanes))
                huff_lanes.append(_HuffLane(
                    codes=table.codes[rev].astype(np.uint32),
                    nbits=table.lengths[rev].astype(np.int32)))
            lit_plan = ("huff", n, desc, four, lanes, lits)
        if seq_pending is not None:
            triples, ll_mode, ll_t, of_mode, of_t, ml_mode, ml_t, tb = seq_pending
            lane_id = len(seq_lanes)
            seq_lanes.append(_SeqLane(
                triples=triples,
                tables=(None if ll_mode == C.MODE_RLE else ll_t,
                        None if of_mode == C.MODE_RLE else of_t,
                        None if ml_mode == C.MODE_RLE else ml_t),
                logs=(0 if ll_mode == C.MODE_RLE else ll_t.table_log,
                      0 if of_mode == C.MODE_RLE else of_t.table_log,
                      0 if ml_mode == C.MODE_RLE else ml_t.table_log)))
            seq_plan = ("seqs", len(triples),
                        (ll_mode << 6) | (of_mode << 4) | (ml_mode << 2),
                        tb, lane_id)
        else:
            seq_plan = ("noseq",)
        return ("compressed", block, lit_plan, seq_plan)

    # -------------------------------------------------------------- device

    def _encode_huff_lanes(self, lanes) -> list:
        if not lanes:
            return []
        B = len(lanes)
        N = max(1, 1 << (max(len(l.codes) for l in lanes) - 1).bit_length())
        vals = np.zeros((B, N), np.int64)
        nbs = np.zeros((B, N), np.int32)
        for i, l in enumerate(lanes):
            vals[i, :len(l.codes)] = l.codes
            nbs[i, :len(l.nbits)] = l.nbits
        out_words = (N * 11 + 64) // 32 + 2
        with scope("huffman_pack"):
            words, total = pack_bits_lanes(
                torch.from_numpy(vals).to(self.device),
                torch.from_numpy(nbs).to(self.device), out_words)
            return finalize_streams(words, total)

    def _encode_seq_lanes(self, lanes) -> list:
        if not lanes:
            return []
        arrays = seq_lane_arrays(lanes, self.device)
        with scope("fse_encode"):
            words, total = encode_sequences_packed(
                *arrays, out_words_for(arrays[0].shape[1]))
            return finalize_streams(words, total)

    # ------------------------------------------------------------- assemble

    def _assemble_frame(self, payload, frame_plan, huff_streams, seq_streams):
        cfg = self.config
        out = bytearray(_frame_header(
            effective_window_log(len(payload), cfg.window_log),
            cfg.write_checksum))
        hasher = Xxh64() if cfg.write_checksum else None
        if hasher is not None:
            hasher.update(payload)
        nblocks = len(frame_plan)
        for bi, plan in enumerate(frame_plan):
            last = bi == nblocks - 1
            kind = plan[0]
            if kind == "empty":
                out += _block_header(True, C.BLOCK_RAW, 0)
            elif kind == "rle":
                _, byte, n = plan
                out += _block_header(last, C.BLOCK_RLE, n)
                out.append(byte)
            elif kind == "raw":
                out += _block_header(last, C.BLOCK_RAW, len(plan[1]))
                out += plan[1]
            else:
                _, block, lit_plan, seq_plan = plan
                content = self._assemble_block(lit_plan, seq_plan,
                                               huff_streams, seq_streams)
                if content is None or len(content) >= len(block):
                    out += _block_header(last, C.BLOCK_RAW, len(block))
                    out += block
                else:
                    out += _block_header(last, C.BLOCK_COMPRESSED, len(content))
                    out += content
        if hasher is not None:
            out += (hasher.digest() & 0xFFFFFFFF).to_bytes(4, "little")
        return bytes(out)

    def _assemble_block(self, lit_plan, seq_plan, huff_streams, seq_streams):
        out = bytearray()
        kind = lit_plan[0]
        if kind == "rawlit":
            lits = lit_plan[1]
            out += _lit_header(C.LIT_RAW, len(lits)) if lits else bytes(
                [_lit_header_byte(C.LIT_RAW, 0)])
            out += lits
        elif kind == "rlelit":
            _, byte, n = lit_plan
            out += _lit_header(C.LIT_RLE, n)
            out.append(byte)
        else:
            _, n, desc, four, lanes, lits = lit_plan
            blobs = [huff_streams[i] for i in lanes]
            payload = None
            if four:
                if all(len(b) <= 0xFFFF for b in blobs[:3]):
                    payload = b"".join(len(b).to_bytes(2, "little")
                                       for b in blobs[:3]) + b"".join(blobs)
            else:
                payload = blobs[0]
            header = None
            if payload is not None:
                comp = len(desc) + len(payload)
                header = _lit_header_compressed(C.LIT_COMPRESSED, n, comp, four)
                raw_cost = len(_lit_header(C.LIT_RAW, n)) + n
                if header is not None and len(header) + comp >= raw_cost:
                    header = None
            if header is not None:
                out += header + desc + payload
            else:
                # huffman did not pay: raw literals inside the compressed
                # block, mirroring encode_literals_section's rollback
                out += _lit_header(C.LIT_RAW, n)
                out += lits

        if seq_plan[0] == "noseq":
            out += _seqnum_varint(0)
            return bytes(out)
        _, nseq, mode_byte, table_bytes, lane_id = seq_plan
        out += _seqnum_varint(nseq)
        out.append(mode_byte)
        out += table_bytes
        out += seq_streams[lane_id]
        return bytes(out)
