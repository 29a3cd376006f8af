"""Multi-process batch codec over torch.distributed (zstd_tpu's multihost
module on PyTorch's process groups).

Design: the unit of parallelism is the independent frame. Frames are
assigned round-robin by global index; each process frames and decodes its
local shard on its own card (all heavy traffic stays on the card), and the
outputs are gathered **in frame order** across processes. Only metadata
(lengths, ok flags) and final bytes cross processes, as CPU tensors over
the gloo backend: one card cannot hold two NCCL ranks, and what crosses is
host data in any case. Dictionaries and predefined tables replicate by
construction (every process builds them from the same bytes).

The module runs unchanged in a single process (the gather degenerates to
identity); several processes call initialize_distributed first.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist


def process_info():
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str = "gloo") -> None:
    """Join the default process group (a no-op for a single process).
    `coordinator` is host:port of rank 0's TCP store, or an init URL such
    as file:///path/to/store; None reads MASTER_ADDR and MASTER_PORT from
    the environment (env://, as torchrun sets them). num_processes and
    process_id default to WORLD_SIZE (unset means one process) and RANK."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if num_processes == 1:
        return
    if process_id is None:
        # -1: torch reads RANK itself and names it when it is missing
        process_id = int(os.environ.get("RANK", -1))
    if coordinator is None:
        url = "env://"
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def shard_indices(n_frames: int, pid: int, nproc: int) -> list:
    """Round-robin assignment keeps shards balanced for heterogeneous
    frame sizes."""
    return list(range(pid, n_frames, nproc))


def rank_device(device=None) -> torch.device:
    """`device`, or this rank's card: cuda:{local rank % cards}, the local
    rank LOCAL_RANK when a launcher sets it, else the global rank. Raises
    without a card unless a device is given."""
    from zstd_tpu_torch.models.batch_decoder import resolve_device

    if device is not None or not torch.cuda.is_available():
        return resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", process_info()[0]))
    return torch.device("cuda", local % torch.cuda.device_count())


def all_gather(t: torch.Tensor, nproc: int, group=None) -> np.ndarray:
    """(nproc, *t.shape): every rank's CPU tensor `t`, in rank order."""
    parts = [torch.empty_like(t) for _ in range(nproc)]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts).numpy()


def decode_frames_multihost(frames: list, decoder=None) -> list:
    """Decode `frames` across all processes; every process returns the full
    ordered result list (byte-exact, frame order preserved, None for a
    frame that failed). The default decoder is BatchDecoder() on this
    rank's card (rank_device)."""
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder

    pid, nproc = process_info()
    mine = shard_indices(len(frames), pid, nproc)
    dec = decoder or BatchDecoder(device=rank_device())
    local = dec.decode_frames([frames[i] for i in mine]) if mine else []

    if nproc == 1 or not frames:
        return local

    # Exchange lengths first (-1 no frame, -2 a failed one), then the
    # padded payload matrix: ordered reassembly is by global frame index,
    # never by process arrival order.
    max_local = (len(frames) + nproc - 1) // nproc
    lens = torch.full((max_local,), -1, dtype=torch.int64)
    for j, r in enumerate(local):
        lens[j] = -2 if r is None else len(r)
    all_lens = all_gather(lens, nproc)
    width = max(1, int(all_lens.max()))
    payload = np.zeros((max_local, width), np.uint8)
    for j, r in enumerate(local):
        if r is not None:
            payload[j, :len(r)] = np.frombuffer(r, np.uint8)
    all_payload = all_gather(torch.from_numpy(payload), nproc)

    results: list = [None] * len(frames)
    for p in range(nproc):
        for j, gi in enumerate(shard_indices(len(frames), p, nproc)):
            n = int(all_lens[p, j])
            results[gi] = None if n == -2 else all_payload[p, j, :n].tobytes()
    return results


def scaling_report(frames: list, repeats: int = 1, decoder=None) -> dict:
    """Per-process decode throughput (host clock around
    decode_frames_multihost, gather included) and the decoded bytes."""
    pid, nproc = process_info()
    t0 = time.time()
    out = None
    for _ in range(repeats):
        out = decode_frames_multihost(frames, decoder)
    dt = (time.time() - t0) / repeats
    total = sum(len(r) for r in out if r is not None)
    return {
        "process": pid,
        "processes": nproc,
        "frames": len(frames),
        "bytes": total,
        "seconds": dt,
        "gbps": total / dt / 1e9 if dt else 0.0,
    }
