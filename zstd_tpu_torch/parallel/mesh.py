"""The fused decode step sharded over torch.distributed ranks.

A 1-D DeviceMesh names the ranks' data-parallel axis (`dp`). Every lane and
frame array of the step (leading dim: Huffman lanes, sequence lanes or
frame rows) is padded to a multiple of the mesh size; each rank takes the
contiguous block of frame rows that a P(axis) sharding of the frame arrays
gives it, and every Huffman and sequence lane whose destination frame falls
in that block, renumbered to its local rows, so every scatter is
rank-local. This replaces the reference's cross-shard scatters (GSPMD
collectives, zstd_tpu/parallel/mesh.py): a lane lands on the rank of its
frame wherever it stood in the batch. Entropy tables are replicated; the
outputs are all-gathered in frame order and the metrics all-reduced, over
the mesh's gloo group as CPU tensors.
"""

import numpy as np
import torch
import torch.distributed as dist

from zstd_tpu_torch.models.fused import (fused_arrays, fused_decode_step,
                                         to_fused_kwargs)
from zstd_tpu_torch.parallel.multihost import all_gather, rank_device

# replicated entropy tables
_REPLICATED_KEYS = (
    "huff_tables", "huff_maxbits", "ll_tables", "of_tables", "ml_tables",
    "ll_logs", "of_logs", "ml_logs",
)
# padding fills: inert lanes (no position, no symbols, the trailing run
# dropped) and empty frame rows
_FILLS = {"huff_pos": -1, "seq_pos": -1, "seq_trail_slot": 1 << 30}
_FRAME_KEYS = ("lit_base", "ll_base", "ml_base", "of_base", "is_real",
               "init_hist")
# each lane kind's destination-frame key and its keys
_LANES = {
    "huff_dst_frame": ("huff_streams", "huff_pos", "huff_tid", "huff_nsym",
                       "huff_dst_frame", "huff_dst_off"),
    "seq_dst_frame": ("seq_streams", "seq_pos", "seq_n", "ll_tid", "of_tid",
                      "ml_tid", "seq_dst_frame", "seq_dst_off",
                      "seq_lit_total", "seq_trail_slot"),
}
# kwargs whose leading dim is a lane/frame batch -> sharded over dp
_BATCH_KEYS = _FRAME_KEYS + sum(_LANES.values(), ())


def make_mesh(n_devices: int | None = None, axis: str = "dp"):
    """A 1-D DeviceMesh named `axis` over the ranks of the initialised
    default group (its device type "cpu": the collectives run on gloo).
    Raises if n_devices differs from the world size or no group is
    initialised."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.multihost.initialize_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the group has {world} "
                         f"ranks")
    return init_device_mesh("cpu", (world,), mesh_dim_names=(axis,))


def _pad_rows(arr: np.ndarray, mult: int, fill=0) -> np.ndarray:
    rem = (-arr.shape[0]) % mult
    if rem == 0:
        return arr
    pad = np.full((rem,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def shard_arrays(kwargs, n: int, rank: int) -> dict:
    """Rank `rank` of `n`'s share of the step's arguments as host numpy
    arrays (see the module docstring); kwargs as fused_arrays takes them."""
    host = fused_arrays(kwargs)
    for k in _BATCH_KEYS:
        host[k] = _pad_rows(host[k], n, _FILLS.get(k, 0))
    per = host["lit_base"].shape[0] // n
    lo = rank * per
    out = {k: host[k] for k in _REPLICATED_KEYS}
    for k in _FRAME_KEYS:
        out[k] = host[k][lo:lo + per]
    for dst, keys in _LANES.items():
        mine = (host[dst] >= lo) & (host[dst] < lo + per)
        if mine.any():
            out.update({k: host[k][mine] for k in keys})
            out[dst] = out[dst] - lo
        else:
            # no lane of this block: one inert lane keeps the shapes whole
            out.update({k: np.full_like(host[k][:1], _FILLS.get(k, 0))
                        for k in keys})
    return out


def shard_fused_kwargs(kwargs, mesh, axis: str = "dp", device=None) -> dict:
    """This rank's share of the step's arguments (shard_arrays) as tensors
    on `device` (default: this rank's card, rank_device)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    rank = mesh.get_local_rank(axis)
    return to_fused_kwargs(shard_arrays(kwargs, n, rank), rank_device(device))


def sharded_decode(kwargs, static: dict, mesh, axis: str = "dp",
                   device=None):
    """Run the fused decode step over the mesh: each rank its share on its
    device, then out, out_len and ok all-gathered in frame order and the
    metrics all-reduced. Returns host numpy arrays on every rank, shaped as
    zstd_tpu.parallel.mesh.sharded_decode's: the padding rows included
    (empty and ok, counted in frames_ok)."""
    local = shard_fused_kwargs(kwargs, mesh, axis, device)
    out, out_len, ok, metrics = fused_decode_step(**local, **static)
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    gathered = [all_gather(t.cpu(), n, group).reshape(-1, *t.shape[1:])
                for t in (out, out_len, ok)]
    names = sorted(metrics)
    totals = torch.stack([metrics[k].cpu().long() for k in names])
    dist.all_reduce(totals, group=group)
    return (*gathered, {k: np.asarray(v) for k, v in zip(names,
                                                          totals.numpy())})
