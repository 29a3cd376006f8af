"""Command-line frontend.

Port of zstd_tpu/cli.py. Capability parity with cli/src/main.rs
(compress/decompress subcommands, levels 0-4 mapping, output-name
derivation, ratio/throughput summaries) and cli/src/progress.rs (periodic
progress + final summary).

    python -m zstd_tpu_torch.cli compress   <input> [output] -l 1 [--gpu]
    python -m zstd_tpu_torch.cli decompress <input> [output] [--gpu]
    python -m zstd_tpu_torch.cli train-dict <dir> -o dict.bin --size 112640

--gpu compresses with the device matcher and batched entropy coding
(BatchEncoder(matcher=DeviceMatcher())) and decompresses with the batched
device decoder (decode_all_device). It runs on the CUDA device and fails
without one; --device cpu runs the same path on the host's plain versions.
"""

import argparse
import os
import sys
import time

from zstd_tpu_torch.common.config import CompressionLevel

_LEVELS = {
    0: CompressionLevel.UNCOMPRESSED,
    1: CompressionLevel.FASTEST,
    2: CompressionLevel.DEFAULT,
    3: CompressionLevel.BETTER,
    4: CompressionLevel.BEST,
}


class ProgressReader:
    """Read wrapper that reports live progress at ~8 Hz (the reference's
    indicatif ProgressMonitor, cli/src/progress.rs:14-151)."""

    def __init__(self, f, total: int, label: str, stream=None):
        self.f = f
        self.total = total
        self.label = label
        self.done = 0
        self.t0 = time.time()
        self._last = 0.0
        self.stream = stream if stream is not None else sys.stderr

    def read(self, n: int = -1) -> bytes:
        chunk = self.f.read(n)
        self.done += len(chunk)
        now = time.time()
        if now - self._last >= 0.125 and self.stream.isatty():
            self._last = now
            dt = max(now - self.t0, 1e-9)
            pct = 100.0 * self.done / self.total if self.total else 100.0
            self.stream.write(
                f"\r{self.label}: {pct:5.1f}%  {self.done / 1e6:8.1f} MB  "
                f"{self.done / dt / 1e6:7.1f} MB/s")
            self.stream.flush()
        return chunk

    def finish(self) -> None:
        if self.stream.isatty():
            self.stream.write("\r" + " " * 60 + "\r")
            self.stream.flush()


def cmd_compress(args) -> int:
    out_path = args.output or args.input + ".zst"
    total = os.path.getsize(args.input)
    t0 = time.time()
    level = _LEVELS[args.level]
    if args.gpu:
        # device batching needs the whole payload resident
        with open(args.input, "rb") as f:
            data = f.read()
        from zstd_tpu_torch.common.config import CodecConfig
        from zstd_tpu_torch.encoding.device_matcher import DeviceMatcher
        from zstd_tpu_torch.models.batch_encoder import BatchEncoder

        if args.content_size:
            sys.stderr.write("--content-size is not supported with --gpu "
                             "(device frames omit FCS); ignoring\n")
        enc = BatchEncoder(CodecConfig(level=level),
                           matcher=DeviceMatcher(device=args.device),
                           device=args.device)
        (z,) = enc.compress_frames([data])
        with open(out_path, "wb") as f:
            f.write(z)
        n_in, n_out = len(data), len(z)
    else:
        # stream file -> file in bounded memory with live progress
        # (main.rs:123-150 io::copy analog)
        from zstd_tpu_torch.encoding.frame_enc import compress as compress_stream

        with open(args.input, "rb") as src, open(out_path, "wb") as dst:
            from zstd_tpu_torch.common.config import CodecConfig
            from zstd_tpu_torch.encoding.frame_enc import effective_window_log

            # file size is known: shrink the advertised window to it
            cfg = CodecConfig(level=level)
            cfg = CodecConfig(**{**cfg.__dict__, "window_log":
                                 effective_window_log(total, cfg.window_log)})
            prog = ProgressReader(src, total, "compress")
            compress_stream(prog, dst, level, cfg,
                            content_size=total if args.content_size else None)
            prog.finish()
            n_in, n_out = prog.done, dst.tell()
    dt = time.time() - t0
    ratio = n_out / max(1, n_in)
    sys.stderr.write(
        f"{args.input}: {n_in} -> {n_out} bytes "
        f"(ratio {ratio:.3f}) in {dt:.2f}s ({n_in / max(dt, 1e-9) / 1e6:.1f} MB/s)"
        f" -> {out_path}\n")
    return 0


def cmd_decompress(args) -> int:
    out_path = args.output
    if out_path is None:
        out_path = (args.input[:-4] if args.input.endswith(".zst")
                    else args.input + ".out")
    total = os.path.getsize(args.input)
    t0 = time.time()
    if args.gpu:
        with open(args.input, "rb") as f:
            data = f.read()
        from zstd_tpu_torch.models.splitter import decode_all_device

        out = decode_all_device(data, device=args.device)
        with open(out_path, "wb") as f:
            f.write(out)
        n_in, n_out = len(data), len(out)
    else:
        # multi-frame streaming decode in bounded memory (window-retaining
        # drain, frame_decoder.rs:306-374 + decode_buffer.rs:182-218)
        from zstd_tpu_torch.common.errors import NotEnoughBytes, SkipFrame
        from zstd_tpu_torch.oracle.decoder import (BlockDecodingStrategy,
                                             FrameDecoder)

        n_out = 0
        with open(args.input, "rb") as src0, open(out_path, "wb") as dst:
            src = ProgressReader(src0, total, "decompress")
            dec = FrameDecoder()
            while True:
                try:
                    dec.init(src)
                except SkipFrame as sf:
                    if len(src.read(sf.length)) < sf.length:
                        raise NotEnoughBytes(sf.length, 0,
                                             "skippable frame content")
                    continue
                except NotEnoughBytes:
                    break  # end of stream
                while True:
                    done = dec.decode_blocks(
                        src, BlockDecodingStrategy.UPTO_BYTES,
                        amount=1 << 20)
                    if done:
                        break
                    chunk = dec.scratch.buffer.drain_to_window_size()
                    if chunk:
                        dst.write(chunk)
                        n_out += len(chunk)
                tail = dec.collect()
                dst.write(tail)
                n_out += len(tail)
                if src.done >= total:
                    break
            src.finish()
            n_in = src.done
            if n_in < total:
                from zstd_tpu_torch.common.errors import ZstdError

                raise ZstdError(
                    f"{total - n_in} trailing bytes are not a frame")
    dt = time.time() - t0
    sys.stderr.write(
        f"{args.input}: {n_in} -> {n_out} bytes in {dt:.2f}s "
        f"({n_out / max(dt, 1e-9) / 1e6:.1f} MB/s) -> {out_path}\n")
    return 0


def cmd_train_dict(args) -> int:
    from zstd_tpu_torch.models.dict_trainer import DictParams, create_raw_dict_from_dir

    d = create_raw_dict_from_dir(args.input, DictParams(dict_size=args.size))
    with open(args.output, "wb") as f:
        f.write(d)
    sys.stderr.write(f"trained {len(d)}-byte raw dictionary -> {args.output}\n")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="zstd_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flags(parser, what: str) -> None:
        parser.add_argument("--gpu", action="store_true", help=what)
        parser.add_argument("--device", default="cuda",
                            help="torch device of --gpu (default cuda; cpu "
                                 "runs the plain versions)")

    c = sub.add_parser("compress", help="compress a file")
    c.add_argument("input")
    c.add_argument("output", nargs="?")
    c.add_argument("-l", "--level", type=int, default=1, choices=sorted(_LEVELS))
    device_flags(c, "device match finding + batched entropy coding")
    c.add_argument("-C", "--content-size", action="store_true",
                   help="record the content size in the frame header")
    c.set_defaults(fn=cmd_compress)

    d = sub.add_parser("decompress", help="decompress a file")
    d.add_argument("input")
    d.add_argument("output", nargs="?")
    device_flags(d, "use the batched device pipeline")
    d.set_defaults(fn=cmd_decompress)

    t = sub.add_parser("train-dict", help="train a raw-content dictionary")
    t.add_argument("input", help="directory of sample files")
    t.add_argument("-o", "--output", required=True)
    t.add_argument("--size", type=int, default=112 * 1024)
    t.set_defaults(fn=cmd_train_dict)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
