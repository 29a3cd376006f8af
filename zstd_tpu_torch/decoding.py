"""`zstd_tpu_torch.decoding` — the reference's module path for the decode
API (decoding::{FrameDecoder, StreamingDecoder, BlockDecodingStrategy,
Dictionary, DEFAULT_MAX_WINDOW_SIZE, errors}, ruzstd/src/decoding/mod.rs:3-9).
The implementations live in zstd_tpu_torch.oracle (host path) and
zstd_tpu_torch.models (batched GPU path); this module is the stable import
surface for users coming from the reference."""

from zstd_tpu_torch.common import errors
from zstd_tpu_torch.oracle import (
    DEFAULT_MAX_WINDOW_SIZE,
    BlockDecodingStrategy,
    Dictionary,
    FrameDecoder,
    StreamingDecoder,
    decode_all,
    decode_all_to_vec,
    decode_from_to,
    decode_frame,
)

__all__ = [
    "FrameDecoder",
    "StreamingDecoder",
    "BlockDecodingStrategy",
    "Dictionary",
    "DEFAULT_MAX_WINDOW_SIZE",
    "decode_all",
    "decode_all_to_vec",
    "decode_from_to",
    "decode_frame",
    "errors",
]
