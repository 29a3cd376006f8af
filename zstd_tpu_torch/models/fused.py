"""The fused decode step over fixed shapes.

The whole device pipeline as one function (Huffman → sequence tANS →
offset resolution → LZ77 execution → per-batch metrics) over the arrays of
one framed batch, every lane and frame array with a leading batch
dimension. It is models/batch_decoder.py's run_device without the chained
frames and the checksums: the same stage calls (`decode_records`), then the
executor over every frame row at one output width. On CUDA tensors each
stage launches its kernel (csrc/huffman.cu, sequence.cu, resolve.cu,
execute.cu); on CPU tensors each runs its plain torch version. The
parallel package shards it over torch.distributed ranks
(parallel/mesh.py::sharded_decode).

`to_fused_kwargs` maps a framed batch (a DeviceBatch, or the keyword dict
of zstd_tpu.models.fused.example_batch as numpy arrays) to the step's
tensors, so one batch can be fed to both packages.
"""

import numpy as np
import torch

from zstd_tpu_torch.common.trace import scope
from zstd_tpu_torch.models.batch_decoder import decode_records, resolve_device
from zstd_tpu_torch.ops.execute import execute_lanes

# the step's keyword arguments, in zstd_tpu/models/fused.py's order
KEYS = (
    "huff_streams", "huff_pos", "huff_tid", "huff_tables", "huff_maxbits",
    "huff_nsym", "huff_dst_frame", "huff_dst_off", "seq_streams", "seq_pos",
    "seq_n", "ll_tid", "of_tid", "ml_tid", "ll_tables", "of_tables",
    "ml_tables", "ll_logs", "of_logs", "ml_logs", "seq_dst_frame",
    "seq_dst_off", "seq_lit_total", "seq_trail_slot", "lit_base", "ll_base",
    "ml_base", "of_base", "is_real", "init_hist",
)
# every other key is int32 (the tables cast as BatchDecoder.stage does)
_DTYPES = {"huff_streams": np.uint8, "seq_streams": np.uint8,
           "lit_base": np.uint8, "is_real": np.bool_}


def fused_arrays(arrays) -> dict:
    """The step's arguments as host numpy arrays of their dtypes, from a
    DeviceBatch (init_hist its frame_hist) or a dict with the step's keys
    (numpy arrays or tensors)."""
    if isinstance(arrays, dict):
        src = arrays
    else:
        src = {k: getattr(arrays, k) for k in KEYS if k != "init_hist"}
        src["init_hist"] = arrays.frame_hist
    out = {}
    for k in KEYS:
        v = src[k]
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        out[k] = np.ascontiguousarray(
            np.asarray(v).astype(_DTYPES.get(k, np.int32), copy=False))
    return out


def to_fused_kwargs(arrays, device) -> dict:
    """fused_decode_step's keyword tensors on `device` from a DeviceBatch or
    a dict with the step's keys (see fused_arrays)."""
    dev = torch.device(device)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in fused_arrays(arrays).items()}


def fused_decode_step(huff_streams, huff_pos, huff_tid, huff_tables,
                      huff_maxbits, huff_nsym, huff_dst_frame, huff_dst_off,
                      seq_streams, seq_pos, seq_n, ll_tid, of_tid, ml_tid,
                      ll_tables, of_tables, ml_tables, ll_logs, of_logs,
                      ml_logs, seq_dst_frame, seq_dst_off, seq_lit_total,
                      seq_trail_slot, lit_base, ll_base, ml_base, of_base,
                      is_real, init_hist, *, max_huff_symbols: int,
                      max_seqs: int, out_width: int):
    """Decode every frame row of the batch; returns (out (Bf, out_width)
    u8, out_len (Bf,) i32, ok (Bf,) bool, metrics), all on the arguments'
    device, Bf the frame rows (the inert last row of a framed batch
    included).

    As in zstd_tpu/models/fused.py: a Huffman lane decodes at most
    max_huff_symbols symbols and a sequence lane at most max_seqs
    sequences (a framed batch's own caps never cut a lane; a lane cut short
    fails its frame); out_len is each row's sum of ll + ml; metrics holds
    bytes_out (out_len summed over ok rows), frames_ok and frames_bad as
    0-d int64 tensors, the inert row counted among frames_ok. A row that
    is not ok comes back all zero (the reference leaves it unspecified)."""
    # the array arguments by name, as decode_records takes them
    d = {k: v for k, v in locals().items() if k in KEYS}
    d["huff_nsym"] = huff_nsym.clamp(max=max_huff_symbols)
    d["seq_n"] = seq_n.clamp(max=max_seqs)
    lit_full, ll_full, ml_full, offsets, out_len, ok = decode_records(d)
    # the reference's scan stops at the cap: a lane past it fails its frame
    whole = torch.ones_like(out_len).scatter_reduce_(
        0, seq_dst_frame.long(), (seq_n <= max_seqs).int(), "amin")
    ok = ok & whole.bool()
    rows = torch.arange(lit_base.shape[0], dtype=torch.int32,
                        device=lit_base.device)
    with scope("lz77_execute"):
        out, exec_ok = execute_lanes(ll_full, ml_full, offsets, lit_full,
                                     out_len, rows, out_width)
    ok = ok & exec_ok
    # zero the failed rows alone (usually none), not the whole output
    out.index_fill_(0, (~ok).nonzero().squeeze(1), 0)
    metrics = {
        "bytes_out": torch.where(ok, out_len, 0).sum(),
        "frames_ok": ok.sum(),
        "frames_bad": (~ok).sum(),
    }
    return out, out_len, ok, metrics


def fused_static(batch, out_width: int) -> dict:
    """The step's static arguments for a DeviceBatch: its lane caps and
    `out_width`."""
    return dict(max_huff_symbols=int(batch.max_huff_symbols),
                max_seqs=int(batch.max_seqs), out_width=int(out_width))


def example_batch(n_frames: int = 8, seed: int = 0, device=None):
    """A small real batch and its payloads: (kwargs, static, payloads), the
    kwargs tensors on `device` (None means the GPU, and raises without
    one), the frames from the package's own encoder at FASTEST (the
    reference's fallback when libzstd is absent)."""
    from zstd_tpu_torch.common.config import CompressionLevel
    from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
    from zstd_tpu_torch.models.framer import Framer

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    payloads = []
    for _ in range(n_frames):
        base = bytes(rng.randint(32, 96, size=rng.randint(200, 2000),
                                 dtype=np.uint8))
        payloads.append(base * rng.randint(2, 6))
    framer = Framer()
    for i, p in enumerate(payloads):
        framer.add_frame(compress_to_vec(p, CompressionLevel.FASTEST), i)
    batch = framer.build()
    out_w = max(16, 1 << (max(len(p) for p in payloads) - 1).bit_length())
    return (to_fused_kwargs(batch, dev), fused_static(batch, out_w),
            payloads)
