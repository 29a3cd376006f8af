"""Process-parallel frame compression.

Frames are compression-independent (the format's own parallelism unit, like
the decode side's frame batching), and the host encoder's Python glue holds
the GIL between its native hot loops, so scale-out uses processes. Workers
import only the numpy + native encoder stack (zstd_tpu_torch.encoding and
common, never torch), keeping their start cost low.

The pool's processes start with the `spawn` method. Its callers on the card
(the CLI, chip_smoke.py) start it after CUDA and torch's thread pools are
up, and `fork` would copy that parent — live CUDA state and threads it
cannot carry into a child. `spawn` starts each worker from a fresh
interpreter that imports only what `_compress_one` needs; the frames are
the same whichever method starts the workers.
"""

import multiprocessing
import os

from zstd_tpu_torch.common.config import CodecConfig, CompressionLevel
from zstd_tpu_torch.encoding.frame_enc import compress_to_vec

_POOL = None
_POOL_WORKERS = 0


def _compress_one(args):
    data, level_val, checksum = args
    cfg = CodecConfig(level=CompressionLevel(level_val),
                      write_checksum=checksum)
    return compress_to_vec(data, cfg.level, cfg)


def _get_pool(workers: int):
    global _POOL, _POOL_WORKERS
    if _POOL is not None and _POOL_WORKERS == workers:
        return _POOL
    shutdown_pool()
    import concurrent.futures as cf

    _POOL = cf.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
    _POOL_WORKERS = workers
    return _POOL


def shutdown_pool() -> None:
    """Stop the worker processes, if any (the next parallel call starts a
    new pool)."""
    global _POOL, _POOL_WORKERS
    if _POOL is not None:
        _POOL.shutdown(wait=True)
    _POOL, _POOL_WORKERS = None, 0


def compress_frames_parallel(payloads: list,
                             level: CompressionLevel = CompressionLevel.FASTEST,
                             write_checksum: bool = True,
                             workers: int | None = None) -> list:
    """Compress each payload into its own frame, fanned out over worker
    processes; falls back to in-process encoding for tiny batches (under
    1 MiB, under 2 frames, or under 2 workers)."""
    workers = workers or min(os.cpu_count() or 4, 16)
    total = sum(len(p) for p in payloads)
    if len(payloads) < 2 or total < (1 << 20) or workers < 2:
        cfg = CodecConfig(level=level, write_checksum=write_checksum)
        return [compress_to_vec(p, level, cfg) for p in payloads]
    pool = _get_pool(workers)
    return list(pool.map(
        _compress_one,
        [(bytes(p), int(level.value), write_checksum) for p in payloads],
        chunksize=max(1, len(payloads) // (workers * 4))))
