"""Decode across torch.distributed ranks.

The unit of parallelism is the independent frame (the format guarantees
decode independence across frames). `multihost` decodes a frame list
round-robin over the ranks, each on its own card, and gathers the results
in frame order; `mesh` shards the fused decode step over a 1-D DeviceMesh,
with entropy tables replicated and metrics all-reduced. Only host metadata
and final bytes cross ranks, over gloo.

The reference's BatchDecoder.stage(batch, mesh=) has no counterpart: one
BatchDecoder per rank on that rank's frames is decode_frames_multihost.
"""

from zstd_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_fused_kwargs,
    sharded_decode,
)

__all__ = ["make_mesh", "shard_fused_kwargs", "sharded_decode"]
