"""The fused decode step sharded over a mesh: the cards of one process
(LocalMesh) or the ranks of a torch.distributed group (a DeviceMesh).

A 1-D mesh names the data-parallel axis (`dp`). Every lane and frame
array of the step (leading dim: Huffman lanes, sequence lanes or frame
rows) is padded to a multiple of the mesh size; shard k takes the
contiguous block of frame rows that a P(axis) sharding of the frame arrays
gives it, and every Huffman and sequence lane whose destination frame falls
in that block, renumbered to its local rows, so every scatter is
shard-local. This replaces the reference's cross-shard scatters (GSPMD
collectives, zstd_tpu/parallel/mesh.py): a lane lands on the shard of its
frame wherever it stood in the batch. Entropy tables are replicated.

Over a LocalMesh one process places shard k on mesh.devices[k], queues
every shard's step before it reads any back, and concatenates the outputs
in frame order and sums the metrics. Over a rank mesh each rank runs its
own shard, and the outputs are all-gathered in frame order and the metrics
all-reduced over the mesh's gloo group as CPU tensors.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from zstd_tpu_torch.models.batch_decoder import on_device, resolve_device
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


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A 1-D mesh over devices of this process: shard k of a batch runs on
    devices[k] (a device may appear more than once). `shape` reads as
    jax.sharding.Mesh.shape does."""
    devices: tuple
    axis: str = "dp"

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              devices=None):
    """A 1-D mesh named `axis`.

    With `devices`, a LocalMesh over exactly those devices (e.g. ["cpu"] *
    n, or ["cuda:0"] * 2 to split a batch in two on one card). Else, inside
    an initialised process group, a DeviceMesh over its ranks (its device
    type "cpu": the collectives run on gloo), raising if n_devices differs
    from the world size. Else a LocalMesh over the first n_devices cards
    (all of them by default), raising when there are fewer cards than
    asked for or none: it never falls back to the CPU."""
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
        if not devs or n_devices not in (None, len(devs)):
            raise ValueError(f"make_mesh({n_devices}): {len(devs)} devices "
                             f"given")
        return LocalMesh(devs, axis)
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"make_mesh({n_devices}): the group has "
                             f"{world} ranks")
        return init_device_mesh("cpu", (world,), mesh_dim_names=(axis,))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = cards if n_devices is None else n_devices
    if cards == 0 or not 1 <= n <= cards:
        raise RuntimeError(
            f"make_mesh({n_devices}): {cards} CUDA cards and no process "
            f"group (name the devices with devices=[...], e.g. ['cpu'] * n)")
    return LocalMesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


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
    """Run the fused decode step over the mesh. Returns host numpy arrays,
    shaped as zstd_tpu.parallel.mesh.sharded_decode's: out, out_len and ok
    in frame order, the padding rows included (empty and ok, counted in
    frames_ok), and the metrics summed.

    Over a LocalMesh (this process's devices), every shard is uploaded to
    its device, then every shard's step queued, each under its device, and
    only then read back. Over a rank mesh, each rank runs its share on
    `device` (default: this rank's card, rank_device) and the results are
    all-gathered on every rank."""
    if isinstance(mesh, LocalMesh):
        return _local_decode(kwargs, static, mesh)
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


def _local_decode(kwargs, static: dict, mesh: LocalMesh):
    n = len(mesh.devices)
    shards = [to_fused_kwargs(shard_arrays(kwargs, n, k), dev)
              for k, dev in enumerate(mesh.devices)]
    runs = []
    for dev, local in zip(mesh.devices, shards):
        with on_device(dev):
            runs.append(fused_decode_step(**local, **static))
    out, out_len, ok = (np.concatenate([r[i].cpu().numpy() for r in runs])
                        for i in range(3))
    metrics = {k: np.asarray(sum(r[3][k].cpu().long() for r in runs).item())
               for k in runs[0][3]}
    return out, out_len, ok, metrics
