"""Decode across several devices: the cards of one process, or the ranks of
a torch.distributed group.

The unit of parallelism is the independent frame (the format guarantees
decode independence across frames). In one process, a LocalMesh
(make_mesh(devices=...), or make_mesh() over the cards) splits a batch into
shards of whole frames, one per device: BatchDecoder.stage(batch, mesh=)
for the production pipeline, sharded_decode for the fused step. Across
ranks, `multihost` decodes a frame list round-robin over the ranks, each
on its own card, and gathers the results in frame order, and
sharded_decode runs the fused step over a rank DeviceMesh; only host
metadata and final bytes cross ranks, over gloo. Entropy tables are
replicated and metrics summed either way.
"""

from zstd_tpu_torch.parallel.mesh import (
    LocalMesh,
    make_mesh,
    shard_fused_kwargs,
    sharded_decode,
)

__all__ = ["LocalMesh", "make_mesh", "shard_fused_kwargs", "sharded_decode"]
