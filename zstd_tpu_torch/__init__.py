"""zstd_tpu_torch: the Zstandard (RFC 8878) batched codec on PyTorch + CUDA.

A port of `zstd_tpu` to one NVIDIA H100: the host layers (oracle, framer,
native runtime, host encoder) are carried over unchanged. Each stage that
is a Pallas kernel in the reference (Huffman and sequence decode, LZ77
execute, windowed execute, greedy parse), the xxh64 checksum, the offset
resolution and the FSE sequence encode run as hand-written CUDA kernels
(`csrc/*.cu`), each with a plain torch version beside it for CPU tensors.
Two stages that are XLA in the reference stay plain torch on the card
too: the match finder's candidates (`find_candidates`) and the Huffman
bit pack (`ops/bitpack.pack_bits_lanes`).

  - decoding: FrameDecoder, StreamingDecoder, decode_all (host oracle)
  - encoding: compress, compress_to_vec, FrameCompressor (host encoder)
  - models: BatchDecoder, decode_all_device (the device decode pipeline),
    BatchEncoder (the device encoder; with encoding.device_matcher's
    DeviceMatcher the match finding runs on the device too),
    create_raw_dict_from_source / _from_dir (the dictionary trainer),
    models.fused (the decode pipeline as one step over fixed shapes)
  - parallel: decode across torch.distributed ranks (multihost, mesh);
    encoding.parallel: compression across worker processes
"""

from zstd_tpu_torch.common import constants
from zstd_tpu_torch.common import errors
from zstd_tpu_torch.common.config import CompressionLevel
from zstd_tpu_torch.oracle import (
    DEFAULT_MAX_WINDOW_SIZE,
    BlockDecodingStrategy,
    Dictionary,
    FrameDecoder,
    StreamingDecoder,
    decode_all,
    decode_all_to_vec,
    decode_frame,
)

__version__ = "0.1.0"

__all__ = [
    "constants", "errors", "__version__",
    "FrameDecoder", "StreamingDecoder", "BlockDecodingStrategy",
    "Dictionary", "DEFAULT_MAX_WINDOW_SIZE",
    "decode_all", "decode_all_to_vec", "decode_frame",
    "CompressionLevel", "compress", "compress_to_vec", "FrameCompressor",
    "BatchDecoder", "decode_all_device", "BatchEncoder",
    "create_raw_dict_from_source", "create_raw_dict_from_dir",
]

_LAZY = {
    "compress": ("zstd_tpu_torch.encoding", "compress"),
    "compress_to_vec": ("zstd_tpu_torch.encoding", "compress_to_vec"),
    "FrameCompressor": ("zstd_tpu_torch.encoding", "FrameCompressor"),
    "BatchDecoder": ("zstd_tpu_torch.models.batch_decoder", "BatchDecoder"),
    "decode_all_device": ("zstd_tpu_torch.models.splitter",
                          "decode_all_device"),
    "BatchEncoder": ("zstd_tpu_torch.models.batch_encoder", "BatchEncoder"),
    "create_raw_dict_from_source": ("zstd_tpu_torch.models.dict_trainer",
                                    "create_raw_dict_from_source"),
    "create_raw_dict_from_dir": ("zstd_tpu_torch.models.dict_trainer",
                                 "create_raw_dict_from_dir"),
}


def __getattr__(name):
    """Lazy imports: the encoder and the torch pipeline load on first use,
    so `import zstd_tpu_torch` stays light."""
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module 'zstd_tpu_torch' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(target[0]), target[1])
    globals()[name] = value
    return value
