"""Batched frame decoder on the GPU — the main decode pipeline.

decode_frames(list_of_frames) frames the batch on the host, then runs one
launch per device stage over all live lanes:

  stage 1a: Huffman literal lanes -> frame literal rows (ops/huffman.py)
  stage 1b: tANS sequence lanes -> frame slot arrays, trailing-literal fill
            (ops/sequence.py)
  stage 2:  repeat-offset resolution and exact output lengths; the block
            groups of a chained frame compose their histories in order
            (ops/sequence.py::resolve_frames)
  stage 3:  LZ77 execution of every single-group frame (ops/execute.py)
  stage 3a': with pull_outputs=False, the frame checksums on the device
            (ops/xxhash64.py)
  stage 3b: LZ77 execution of every chained frame, all block groups of the
            chains of one width group in one launch (ops/execute_window.py)

A frame is chained when the framer split it into several block groups (its
output passes the group caps, models/framer.py), or when it references a
dictionary whose content seeds its history and its size is unknown. Frames
the framer marks `fallback` decode on the host oracle and are counted in
`host_frames`. Frames whose lane flags tripped fall back to the oracle too:
a bad frame poisons only its own lane (its result is None when the oracle
rejects it).

The batch crossing into `stage()` is any object with the framer's
DeviceBatch fields as NumPy arrays, so the same batch can be fed to this
package and to the reference package. `stage(batch, mesh=)` splits it over
the devices of a parallel.mesh.LocalMesh, one shard of whole frames each
(split_batch), and run_device runs every shard on its device.
"""

import contextlib
import dataclasses
import os
import types

import numpy as np
import torch

from zstd_tpu_torch.common.errors import ZstdError
from zstd_tpu_torch.common.trace import scope, vprint
from zstd_tpu_torch.models import framer as framer_mod
from zstd_tpu_torch.models.framer import DeviceBatch, Framer
from zstd_tpu_torch.ops.execute import execute_lanes
from zstd_tpu_torch.ops.execute_window import execute_window
from zstd_tpu_torch.ops.huffman import huffman_lanes
from zstd_tpu_torch.ops.sequence import resolve_frames, sequence_lanes
from zstd_tpu_torch.ops.xxhash64 import xxh64_low32_lanes
from zstd_tpu_torch.utils.xxhash64 import xxhash64 as _host_xxh64

# batch arrays staged as they are (int32 / uint8 / bool)
_LANE = ("huff_streams", "huff_pos", "huff_tid", "huff_nsym",
         "huff_dst_frame", "huff_dst_off", "seq_streams", "seq_pos",
         "seq_n", "ll_tid", "of_tid", "ml_tid", "seq_dst_frame",
         "seq_dst_off", "seq_lit_total", "seq_trail_slot")
_TABLES = ("huff_tables", "huff_maxbits", "ll_tables", "of_tables",
           "ml_tables", "ll_logs", "of_logs", "ml_logs")
_FRAME = ("lit_base", "ll_base", "ml_base", "of_base", "is_real")
# every array a frame row indexes, and each lane kind's arrays
_ROW = _FRAME + ("frame_hist", "row_lit_len", "out_len")
_LANE_KINDS = {"huff": _LANE[:6], "seq": _LANE[6:]}


def resolve_device(device=None) -> torch.device:
    """`None` means the GPU; raises when the requested device is absent.
    The decoder, the encoder, the device matcher and the CLI's --gpu paths
    all resolve their device here."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available (pass device='cpu' to run the plain "
            "torch versions on the host)")
    return dev


def on_device(device):
    """The context in which `device` is the current CUDA device, so that a
    kernel launches on its current stream; nothing for a CPU device."""
    dev = torch.device(device)
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def split_batch(batch, n: int) -> list:
    """The batch in n shards of whole frames, for BatchDecoder.stage(batch,
    mesh=): per shard None (no frame) or (sub_batch, rows), rows the
    batch's frame rows the shard holds, in order.

    Frames (those with rows) split in batch order into n contiguous blocks
    balanced by output bytes (a frame goes to the block that holds the
    middle of its share of the total out_len), so one long chained frame
    does not sit beside half the batch. A sub_batch holds all of its
    frames' rows (every block group of a chain), the Huffman and sequence
    lanes whose destination row is one of them, the replicated tables, and
    the trailing inert row and lane; every row index (the lanes'
    destinations, row_meta, the metas' rows) is renumbered to the shard."""
    metas = [m for m in batch.metas if m.rows]
    out_len = np.asarray(batch.out_len)
    weight = np.array([max(int(out_len[m.rows].sum()), 1) for m in metas],
                      np.float64)
    middle = np.cumsum(weight) - weight / 2
    shard = np.minimum((middle * n / max(weight.sum(), 1.0)).astype(np.int64),
                       n - 1)
    return [_sub_batch(batch, [m for m, s in zip(metas, shard) if s == k])
            for k in range(n)]


def _sub_batch(batch, metas):
    """split_batch's share of `batch` holding `metas`, or None."""
    if not metas:
        return None
    Bf = batch.lit_base.shape[0]
    rows = np.asarray(sorted(r for m in metas for r in m.rows), np.int64)
    local = np.full(Bf, -1, np.int64)
    local[rows] = np.arange(len(rows))
    take = np.append(rows, Bf - 1)  # the inert row closes the shard
    sub = {k: np.asarray(getattr(batch, k))[take] for k in _ROW}
    sub.update({k: np.asarray(getattr(batch, k)) for k in _TABLES})
    for kind, keys in _LANE_KINDS.items():
        dst = np.asarray(getattr(batch, f"{kind}_dst_frame"))
        inert = dst.shape[0] - 1
        lanes = np.nonzero(local[dst[:inert]] >= 0)[0]
        sub.update({k: np.asarray(getattr(batch, k))[np.append(lanes, inert)]
                    for k in keys})
        sub[f"{kind}_dst_frame"][:-1] = local[dst[lanes]]
    metas = [dataclasses.replace(m, rows=[int(local[r]) for r in m.rows])
             for m in metas]
    row_meta = np.full(len(take), -1, np.int32)
    for i, m in enumerate(metas):
        row_meta[m.rows] = i
    return types.SimpleNamespace(**sub, row_meta=row_meta, metas=metas), rows


def chained_metas(batch) -> list:
    """Frames whose decode needs the windowed chain executor: more than one
    block group, or a dictionary prefill seeding the window."""
    return [m for m in batch.metas
            if len(m.rows) > 1 or (m.dict_prefill and m.rows)]


def chain_plan(batch) -> dict | None:
    """The host-side plan of the batch's chained frames, None without any.

    For the resolution, over all chains: rows (C, K) i32, each chain's rows
    in order, padded with the inert row (no records, no output); row_cont
    (Bf,) bool, a chain's rows after its first.

    For the execution, groups: the chains grouped by pow2(hist0 + bound) of
    each chain (hist0 its dictionary content's length, bound the sum of its
    groups' output bounds), narrowest first, each group one window-kernel
    call into its own accumulator, so a short chain never pays for a long
    one's width. A group holds first (its chains' first rows), rows (C_g,
    K_g) i32, hist0 (C_g,) i32, prefill (C_g, base) u8 (each chain's
    dictionary content, right-aligned), cap (C_g,) i64 (the history a
    block group may reach: W for a near chain and the real window for a far
    one, W = pow2(max(window, dictionary length, 1024)), far when W >
    STREAM_WINDOW_CAP), base (its largest prefill) and width (base + its
    largest bound, at least 1): the accumulator row holds the prefill
    before `base` and the chain's output after it."""
    chained = chained_metas(batch)
    if not chained:
        return None
    inert = batch.lit_base.shape[0] - 1
    C, K = len(chained), max(len(m.rows) for m in chained)
    rows = np.full((C, K), inert, np.int32)
    cont = np.zeros(inert + 1, bool)
    for c, m in enumerate(chained):
        rows[c, :len(m.rows)] = m.rows
        cont[m.rows[1:]] = True
    hist0 = [len(m.dict_prefill) for m in chained]
    bound = [sum(int(batch.out_len[r]) for r in m.rows) for m in chained]
    by_width = {}
    for c in range(C):
        key = framer_mod._round_pow2(hist0[c] + bound[c])
        by_width.setdefault(key, []).append(c)
    groups = [_chain_group([chained[c] for c in members], rows[members],
                           [hist0[c] for c in members],
                           max(bound[c] for c in members))
              for _, members in sorted(by_width.items())]
    return dict(rows=rows, row_cont=cont, groups=groups)


def _chain_group(metas, rows, hist0, bound: int) -> dict:
    """One width group of chain_plan: its chains' rows (cut to its longest
    chain), prefills and caps at the group's own base and width."""
    base = max(hist0)
    prefill = np.zeros((len(metas), base), np.uint8)
    cap = np.zeros(len(metas), np.int64)
    for i, m in enumerate(metas):
        # with a dictionary, offsets reach its whole content whatever the
        # window says (decode_buffer.rs:143-179), so W covers it
        W = 1 << (max(int(m.window), hist0[i], 1024) - 1).bit_length()
        cap[i] = int(m.window) if W > framer_mod.STREAM_WINDOW_CAP else W
        if hist0[i]:
            prefill[i, base - hist0[i]:] = np.frombuffer(m.dict_prefill,
                                                         np.uint8)
    K = max(len(m.rows) for m in metas)
    return dict(first=[m.rows[0] for m in metas],
                rows=np.ascontiguousarray(rows[:, :K]),
                hist0=np.asarray(hist0, np.int32), cap=cap, prefill=prefill,
                base=base, width=max(base + bound, 1))


def _resolve(ll_full, ml_full, of_full, is_real, init_hist):
    """Stage 2: offsets, exact output lengths and ok per frame row
    (ops/sequence.py::resolve_frames)."""
    return resolve_frames(ll_full, ml_full, of_full, is_real, init_hist)


def _resolve_chained(ll_full, ml_full, of_full, is_real, init_hist, rows,
                     cont):
    """Stage 2 when the batch holds chained frames: each chain's groups
    (rows (C, K)) carry their outgoing history into the next group (`cont`
    marks those rows). The same outputs as
    zstd_tpu/models/batch_decoder.py::_resolve_chained, whose scan runs
    over every row instead."""
    return resolve_frames(ll_full, ml_full, of_full, is_real, init_hist,
                          rows, cont)


def decode_records(d, chain_rows=None, chain_cont=None):
    """Stages 1a, 1b and 2 on the staged arrays `d` (the keys of
    BatchDecoder.stage, which are models/fused.py's keyword names):
    (lit_full, ll_full, ml_full, offsets, out_len, ok) of every frame row,
    ok False where a lane of the row or its resolution failed. With chained
    frames, chain_rows and chain_cont as resolve_frames takes them."""
    # the stages write in place: start from copies of the staged bases
    lit_full = d["lit_base"].clone()
    ll_full = d["ll_base"].clone()
    ml_full = d["ml_base"].clone()
    of_full = d["of_base"].clone()
    frame_ok = torch.ones(lit_full.shape[0], dtype=torch.bool,
                          device=lit_full.device)

    with scope("huffman_decode"):
        huffman_lanes(d["huff_streams"], d["huff_pos"], d["huff_tid"],
                      d["huff_nsym"], d["huff_dst_frame"], d["huff_dst_off"],
                      d["huff_tables"], d["huff_maxbits"], lit_full, frame_ok)
    with scope("sequence_decode"):
        sequence_lanes(d["seq_streams"], d["seq_pos"], d["seq_n"],
                       d["ll_tid"], d["of_tid"], d["ml_tid"], d["ll_tables"],
                       d["of_tables"], d["ml_tables"], d["ll_logs"],
                       d["of_logs"], d["ml_logs"], d["seq_dst_frame"],
                       d["seq_dst_off"], d["seq_lit_total"],
                       d["seq_trail_slot"], ll_full, ml_full, of_full,
                       frame_ok)
    with scope("offset_resolution"):
        if chain_rows is None:
            offsets, out_len, res_ok = _resolve(
                ll_full, ml_full, of_full, d["is_real"], d["init_hist"])
        else:
            offsets, out_len, res_ok = _resolve_chained(
                ll_full, ml_full, of_full, d["is_real"], d["init_hist"],
                chain_rows, chain_cont)
    return lit_full, ll_full, ml_full, offsets, out_len, frame_ok & res_ok


class BatchDecoder:
    """Decode many independent frames data-parallel on the device."""

    def __init__(self, verify_checksums: bool = True, device=None):
        self.device = resolve_device(device)
        self.verify_checksums = verify_checksums
        self.dicts = {}
        self.host_frames = 0  # frames the framer sent to the host oracle

    def add_dict(self, raw: bytes) -> int:
        """Register a dictionary (zstd format or raw content). Frames whose
        header references its id decode on device (parity with
        FrameDecoder::add_dict, frame_decoder.rs:221-224)."""
        from zstd_tpu_torch.oracle.dictionary import Dictionary

        d = Dictionary.decode_dict(raw)
        self.dicts[d.dict_id] = d
        return d.dict_id

    def prepare(self, frames: list) -> DeviceBatch:
        framer = Framer(dicts=self.dicts)
        for i, f in enumerate(frames):
            framer.add_frame(bytes(f), i)
        return framer.build()

    def stage(self, batch, mesh=None) -> dict:
        """Upload the batch's arrays to the device once; returns the staged
        dict. Also stages the per-run index arrays (the executed frame rows
        and their checksum fields), the single-group executor's output
        width (pow2 of its rows' own bounds, `exec_width`) and the chain
        plan (chain_plan()), so repeated runs (serving) upload nothing.

        With `mesh` (a parallel.mesh.LocalMesh), the batch splits into one
        shard of whole frames per mesh device (split_batch), each staged as
        above on its device, entropy tables replicated; run_device then
        runs every shard and returns the batch's own frame rows. The
        reference (zstd_tpu's stage(batch, mesh=)) pads the row and lane
        arrays to the mesh size, splits them into equal blocks and lets
        GSPMD gather and scatter across blocks; this splits by frame, with
        each frame's lanes, so no scatter crosses a shard and each shard
        runs the single-device stages as they are."""
        if mesh is None:
            return self._stage_on(batch, self.device)
        from zstd_tpu_torch.parallel.mesh import LocalMesh

        if not isinstance(mesh, LocalMesh):
            raise TypeError(
                f"stage(mesh=): a parallel.mesh.LocalMesh, not "
                f"{type(mesh).__name__}; across torch.distributed ranks, "
                f"decode with parallel.multihost.decode_frames_multihost")
        shards = []
        for dev, part in zip(mesh.devices,
                             split_batch(batch, len(mesh.devices))):
            if part is not None:
                sub, rows = part
                part = (sub, rows, self._stage_on(sub, dev))
            shards.append(part)
        return {"shards": shards, "frame_rows": batch.lit_base.shape[0] - 1}

    def _stage_on(self, batch, dev) -> dict:
        """stage() of the whole batch on device `dev`."""
        host = {name: np.asarray(getattr(batch, name))
                for name in _LANE + _FRAME}
        for name in _TABLES:
            host[name] = np.asarray(getattr(batch, name)).astype(np.int32)
        host["init_hist"] = np.asarray(batch.frame_hist, np.int32)
        host["row_lit_len"] = np.asarray(batch.row_lit_len, np.int32)

        frame_inert = batch.lit_base.shape[0] - 1
        plan = chain_plan(batch)
        chain_rows = set() if plan is None else set(plan["rows"].flat)
        rows = [i for i in range(frame_inert) if i not in chain_rows]
        ck = {m.rows[0]: (m.checksum, m.dict_skip) for m in batch.metas
              if len(m.rows) == 1 and m.checksum is not None
              and m.ok and not m.fallback}
        host["exec_rows"] = np.asarray(rows, np.int32)
        # the single-group executor's width: its own rows' bounds, not the
        # batch's widest (a chained frame's bound would inflate every row)
        exec_width = framer_mod._round_pow2(
            int(np.max(np.asarray(batch.out_len)[rows], initial=1)))
        host["ck_has"] = np.asarray([r in ck for r in rows], bool)
        host["ck_exp"] = np.asarray([ck.get(r, (0, 0))[0] for r in rows],
                                    np.int64)
        host["ck_skip"] = np.asarray([ck.get(r, (0, 0))[1] for r in rows],
                                     np.int32)
        if plan is not None:
            host["chain_rows"] = plan["rows"]
            host["chain_row_cont"] = plan["row_cont"]
        d = {name: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for name, v in host.items()}
        d["exec_rows_list"] = rows
        d["exec_width"] = exec_width
        # per width group: its plan arrays on the device, base, width, first
        d["chains"] = None if plan is None else [
            {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                 else v) for k, v in g.items()} for g in plan["groups"]]
        return d

    def run_device(self, batch, staged: dict | None = None,
                   pull_outputs: bool = True, sync: bool = True):
        """Full device decode. Returns (outputs, out_len, ok) per frame row.

        outputs holds np.uint8 rows, or with pull_outputs=False
        device-resident handles: (tensor, row) for a single-group frame,
        its bytes tensor[row, :out_len]; (acc, lane, base) for a chained
        frame, its bytes acc[lane, base:base + out_len]. In that mode the
        single-group frames' checksums are verified on the device and
        folded into ok; chained frames are not hashed on the device (as in
        the reference). sync=False returns an opaque state with all device
        work enqueued but not waited on; pass it to _finalize() (or use
        decode_frames_pipelined) to overlap host framing with device
        compute. A mesh-staged dict (stage(batch, mesh=)) queues every
        shard, each on its device, before any is read back; the result is
        indexed by the batch's own frame rows all the same."""
        d = staged if staged is not None else self.stage(batch)
        self.host_frames += sum(1 for m in batch.metas if m.fallback)
        if "shards" in d:
            state = {"frame_rows": d["frame_rows"], "shards": [
                None if part is None
                else (part[1], self._launch(part[2], pull_outputs))
                for part in d["shards"]]}
        else:
            state = self._launch(d, pull_outputs)
        if not sync:
            return state
        return self._finalize(state, pull_outputs)

    def _launch(self, d: dict, pull_outputs: bool):
        """Queue every stage of one staged dict on its device; the state
        _finalize reads."""
        dev = d["lit_base"].device
        Bf = d["lit_base"].shape[0]
        frame_inert = Bf - 1
        vprint(f"run_device: {Bf - 1} frame rows, "
               f"{d['huff_streams'].shape[0] - 1} huffman lanes, "
               f"{d['seq_streams'].shape[0] - 1} sequence lanes on {dev}")
        chains = d["chains"]
        chain_args = (() if chains is None
                      else (d["chain_rows"], d["chain_row_cont"]))
        with on_device(dev):
            lit_full, ll_full, ml_full, offsets, out_len, ok_dev = \
                decode_records(d, *chain_args)

            out = None
            if d["exec_rows_list"]:
                rows = d["exec_rows"]
                rows_l = rows.long()
                with scope("lz77_execute"):
                    out, exec_ok = execute_lanes(ll_full, ml_full, offsets,
                                                 lit_full, out_len, rows,
                                                 d["exec_width"])
                ok_rows = ok_dev[rows_l] & exec_ok
                if self.verify_checksums and not pull_outputs:
                    # serving mode never reaches _postprocess's host xxh64:
                    # verify each frame's checksum field on the device
                    with scope("device_checksum"):
                        skip = d["ck_skip"]
                        got = xxh64_low32_lanes(out, out_len[rows_l] - skip,
                                                skip)
                    ok_rows = ok_rows & (~d["ck_has"] | (got == d["ck_exp"]))
                ok_dev = ok_dev.index_put((rows_l,), ok_rows)

            done = None
            if chains is not None:
                # Stage 3b, chained frames (zstd_tpu/models/batch_decoder.py:
                # 975-1331): one launch per width group of chain_plan runs
                # every block group of its chains, each chain's history
                # whole in its accumulator row (the reference pads within
                # its window buckets, :1016-1032; these group by the chain's
                # own width). Not carried over, since each exists for the
                # TPU's VMEM, Mosaic or call overheads: the jumbo-group
                # guard and its size floor (:984-1001), the `li` lockstep
                # chooser with LOCKSTEP_BLOCK_CAP and _NOALIAS
                # (:1033-1122), the exact-size sync (:1035-1066), the
                # super-group packing and its rows cache (:1149-1280), and
                # the far-stream pre-gather (_far_prep, _far_row_totals,
                # _far_gather, :351-409, used at :1129-1148): the kernel
                # reads far history from the accumulator itself.
                done = []
                with scope("lz77_window_execute"):
                    for g in chains:
                        acc = torch.zeros((len(g["first"]), g["width"]),
                                          dtype=torch.uint8, device=dev)
                        if g["base"]:
                            acc[:, :g["base"]] = g["prefill"]
                        written, chain_ok = execute_window(
                            ll_full, ml_full, offsets, lit_full, out_len,
                            d["row_lit_len"], g["rows"], acc, g["base"],
                            g["hist0"], g["cap"])
                        # a chain is ok when every group executed and every
                        # row's entropy stages and resolution were
                        chain_ok = chain_ok & ok_dev[g["rows"].long()].all(
                            dim=1)
                        done.append((acc, written, chain_ok, g["base"],
                                     g["first"]))
        return (out_len, ok_dev, out, d["exec_rows_list"], done,
                frame_inert)

    def _finalize(self, state, pull_outputs: bool = True):
        """Second half of run_device: the single host sync + unpack."""
        if isinstance(state, dict):
            return self._finalize_shards(state, pull_outputs)
        out_len, ok_dev, out, rows, chains, frame_inert = state
        parts = [out_len.long(), ok_dev.long()]
        for _, written, chain_ok, _, _ in chains or ():
            parts += [written, chain_ok.long()]
        host = torch.cat(parts).cpu().numpy()
        Bf = frame_inert + 1
        out_len_h = host[:Bf].copy()
        ok_h = host[Bf:2 * Bf].astype(bool)
        outputs = [None] * Bf
        if pull_outputs and rows:
            out_h = out.cpu().numpy()
            for i, lane in enumerate(rows):
                outputs[lane] = out_h[i]
        elif rows:
            # device-resident (tensor, row) handles: no per-row slicing
            for i, lane in enumerate(rows):
                outputs[lane] = (out, i)
        at = 2 * Bf
        for acc, _, _, base, first in chains or ():
            C = len(first)
            written = host[at:at + C]
            chain_ok = host[at + C:at + 2 * C].astype(bool)
            at += 2 * C
            acc_h = acc.cpu().numpy() if pull_outputs else None
            for c, r0 in enumerate(first):
                out_len_h[r0] = written[c]
                ok_h[r0] = chain_ok[c]
                outputs[r0] = (acc_h[c, base:base + written[c]]
                               if pull_outputs else (acc, c, base))
        return (outputs[:frame_inert], out_len_h[:frame_inert],
                ok_h[:frame_inert])

    def _finalize_shards(self, state: dict, pull_outputs: bool):
        """_finalize of a mesh-staged run: each shard's rows put back at
        the batch's frame rows."""
        n = state["frame_rows"]
        outputs = [None] * n
        out_len = np.zeros(n, np.int64)
        ok = np.zeros(n, bool)
        for part in state["shards"]:
            if part is None:
                continue
            rows, shard_state = part
            o, length, good = self._finalize(shard_state, pull_outputs)
            out_len[rows] = length
            ok[rows] = good
            for r, x in zip(rows, o):
                outputs[r] = x
        return outputs, out_len, ok

    def decode_frames(self, frames: list, mesh=None) -> list:
        """Returns decoded bytes per frame (device path, host oracle
        fallback); with `mesh` (a parallel.mesh.LocalMesh) the batch is
        split over its devices (stage(batch, mesh=))."""
        batch = self.prepare(frames)
        outputs, out_len, ok = self.run_device(batch,
                                               self.stage(batch, mesh))
        return self._postprocess(frames, batch, outputs, out_len, ok)

    def decode_frames_pipelined(self, frame_batches, pull_outputs=True,
                                prestaged=None):
        """Generator over decoded-bytes lists, one per input batch — the
        serving loop. Host framing of batch k+1 overlaps the device
        crunching batch k (kernel launches return at once; the sync happens
        one batch late).

        pull_outputs=False is the throughput/serving mode: yields raw
        (outputs, out_len, ok) triples with device-resident handles
        instead of postprocessed bytes (see run_device). `prestaged` reuses
        an existing staged dict for every batch (all batches must share the
        staged batch's content, e.g. rotating replays of one upload)."""
        prev = None
        for frames in frame_batches:
            batch = self.prepare(frames)
            staged = prestaged if prestaged is not None else self.stage(batch)
            st = self.run_device(batch, staged, pull_outputs=pull_outputs,
                                 sync=False)
            if prev is not None:
                pf, pb, pst = prev
                fin = self._finalize(pst, pull_outputs=pull_outputs)
                yield self._postprocess(pf, pb, *fin) if pull_outputs else fin
            prev = (frames, batch, st)
        if prev is not None:
            pf, pb, pst = prev
            fin = self._finalize(pst, pull_outputs=pull_outputs)
            yield self._postprocess(pf, pb, *fin) if pull_outputs else fin

    def _postprocess(self, frames, batch, outputs, out_len, ok) -> list:
        results = []
        fallback_idx = []
        for i, meta in enumerate(batch.metas):
            r = meta.rows[0] if meta.rows else -1
            good = (meta.ok and not meta.fallback and r >= 0
                    and bool(ok[r]))
            if (good and meta.out_len >= 0
                    and meta.out_len + meta.dict_skip != int(out_len[r])):
                good = False
            data = None
            if good:
                data = outputs[r][meta.dict_skip:int(out_len[r])].tobytes()
                if self.verify_checksums and meta.checksum is not None:
                    if (_host_xxh64(data) & 0xFFFFFFFF) != meta.checksum:
                        good = False
            if not good:
                fallback_idx.append(i)
                data = None
            results.append(data)
        if len(fallback_idx) > 1:
            # frames are independent and the native hot loops release the
            # GIL during their C calls — thread the host fallbacks
            import concurrent.futures as cf

            with cf.ThreadPoolExecutor(
                    max_workers=min(len(fallback_idx), os.cpu_count() or 4)
            ) as pool:
                for i, data in zip(fallback_idx, pool.map(
                        self._host_fallback,
                        [frames[i] for i in fallback_idx])):
                    results[i] = data
        elif fallback_idx:
            results[fallback_idx[0]] = self._host_fallback(
                frames[fallback_idx[0]])
        return results

    def _host_fallback(self, frame_bytes: bytes):
        from zstd_tpu_torch.oracle import FrameDecoder
        import io

        try:
            dec = FrameDecoder()
            for d in self.dicts.values():
                dec.add_dict(d)
            src = io.BytesIO(bytes(frame_bytes))
            dec.init(src)
            dec.decode_blocks(src)
            return dec.collect()
        except ZstdError:
            return None  # malformed frame: poisoned lane, reported as None
