"""Tracing / profiling hooks.

Host side: `vprint` mirrors the reference's compile-time `vprintln!` macro
(lib.rs:24-33) as an env-gated trace (ZSTD_TPU_VERBOSE=1). Device side:
`scope` wraps torch.profiler.record_function so every stage shows up named
in a torch.profiler capture, and `profile_to` captures one around a block
of work into a Chrome trace file.
"""

import contextlib
import os
import sys

VERBOSE = os.environ.get("ZSTD_TPU_VERBOSE", "") not in ("", "0")


def vprint(*args) -> None:
    if VERBOSE:
        print("[zstd-tpu-torch]", *args, file=sys.stderr)


def scope(name: str):
    """Named trace scope; costs a few microseconds of host time per use."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_to(trace_dir: str):
    """Capture a torch.profiler trace (host, and the GPU when there is one)
    around a block of work; on exit it is written to `trace_dir` as a
    Chrome trace (trace.json)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
