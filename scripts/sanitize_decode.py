#!/usr/bin/env python3
"""The six decode kernels under NVIDIA's compute-sanitizer.

    python scripts/sanitize_decode.py [--out DIR]   (one CUDA card, nvcc)

Builds the kernels, then runs this script again as a child (`--run`)
under `compute-sanitizer --tool T` for each tool T:

  memcheck   huffman, sequence, resolve, execute, xxhash64, window
  racecheck  the kernels that stage in shared memory: huffman, sequence,
             execute, window
  initcheck  the six

each restricted to those kernels (`--kernel-regex`), so PyTorch's own
kernels are not checked. The child runs every decode kernel once, in one
serving run (run_device(pull_outputs=False)), on two batches:

  a reduced batch of the libzstd fixture (zstd_tpu_torch/testdata/libzstd):
      64 main frames (the 16 level-3 frames 4 times), the chained frame
      (4 MiB, window 2 MiB), the far frame (window past 8 MiB) and the
      edge frames
  128 targeted mutants of its checksum-less frames
      (testdata/anatomy.py::targeted_mutants, random.Random(13))

Each tool's log goes to DIR/<tool>.log (default build/sanitize); the
script prints each tool's error count from its ERROR SUMMARY line and
exits 1 when a count is not 0 or a tool did not run to its end. Too slow
for chip_smoke.py's time limit: a tool slows each kernel many times over.
"""

import argparse
import os
import random
import re
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SANITIZER = "/usr/local/cuda/bin/compute-sanitizer"
# the device functions of each decode kernel (csrc/*.cu)
KERNELS = {"huffman": ["huff_kernel"], "sequence": ["seq_kernel"],
           "resolve": ["segment_kernel", "chains_kernel"],
           "execute": ["exec_kernel"], "xxhash64": ["xxh_kernel"],
           "window": ["validate_kernel", "chains_kernel", "seed_kernel",
                      "jump_kernel", "gather_kernel"]}
TOOLS = {"memcheck": tuple(KERNELS),
         "racecheck": ("huffman", "sequence", "execute", "window"),
         "initcheck": tuple(KERNELS)}
MUTANTS = 128
TIMEOUT = 900  # seconds a tool may take


def child() -> int:
    """Run every decode kernel once on the two batches; raise on a wrong
    result."""
    sys.path.insert(0, ROOT)
    import torch

    from zstd_tpu_torch.models.batch_decoder import BatchDecoder
    from zstd_tpu_torch.ops import (execute, execute_window, huffman,
                                    sequence, xxhash64)
    from zstd_tpu_torch.testdata import load_libzstd_fixture
    from zstd_tpu_torch.testdata.anatomy import targeted_mutants

    fx = load_libzstd_fixture()
    by = {}
    for e in fx:
        by.setdefault(e["group"], []).append(e)
    reduced = by["main"] * 4 + by["chained"] + by["far"] + by["edge"]
    bases = [e["frame"] for e in fx
             if e["group"] in ("levels", "edge") and not e["checksum"]]
    mutants = [m[3] for m in targeted_mutants(bases, random.Random(13),
                                              MUTANTS)]
    counters = (huffman.huffman_lanes, sequence.sequence_lanes,
                sequence.resolve_frames, execute.execute_lanes,
                xxhash64.xxh64_low32_lanes, execute_window.execute_window)
    for label, frames in (("fixture", [e["frame"] for e in reduced]),
                          ("mutants", mutants)):
        dec = BatchDecoder()
        batch = dec.prepare(frames)
        staged = dec.stage(batch)
        for fn in counters:
            fn.launches = 0
        _, out_len, ok = dec.run_device(batch, staged, pull_outputs=False)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        print(f"sanitize_decode: {label}: {len(frames)} frames, launches "
              f"{launches}, {int(ok.sum())} rows ok", flush=True)
        if label == "fixture":
            for e, m in zip(reduced, batch.metas):
                r = m.rows[0]
                if not (ok[r] and int(out_len[r]) == e["size"]):
                    raise RuntimeError(f"{e['file']}: not ok on the device")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", action="store_true",
                    help="the child: run the kernels once (under a tool)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sanitize"),
                    help="directory of the tools' logs")
    args = ap.parse_args()
    if args.run:
        return child()
    if not os.path.exists(SANITIZER):
        print(f"sanitize_decode: {SANITIZER} not found; nothing checked")
        return 1
    sys.path.insert(0, ROOT)
    from zstd_tpu_torch.ops import _kernels

    print(f"sanitize_decode: kernels built in {_kernels.build_all():.1f} s",
          flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"sanitize_decode: card {card.strip()}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    failed = False
    for tool, kernels in TOOLS.items():
        names = sorted({f for k in kernels for f in KERNELS[k]})
        cmd = [SANITIZER, "--tool", tool, "--kernel-regex",
               "kns=" + "|".join(names), sys.executable,
               os.path.abspath(__file__), "--run"]
        log = os.path.join(args.out, f"{tool}.log")
        t0 = time.perf_counter()
        with open(log, "w") as f:
            # its own process group: a tool cut at the timeout takes its
            # child with it
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                    cwd=ROOT, start_new_session=True)
            try:
                rc = proc.wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                rc = None
        with open(log) as f:
            text = f.read()
        summary = re.findall(r"ERROR SUMMARY: (\d+) error", text)
        errors = int(summary[-1]) if summary else None
        ran = "sanitize_decode: mutants:" in text
        refused = re.search(r"Error: (Device not supported[^\n]*)", text)
        print(f"sanitize_decode: {tool} over {', '.join(kernels)}: "
              f"{errors if errors is not None else 'no summary'} errors, "
              f"exit {rc}, the child "
              f"{'ran to its end' if ran else 'did not finish'}, "
              f"{time.perf_counter() - t0:.1f} s, log {log}"
              + (f"; the tool refused the card: {refused.group(1)} (every "
                 f"CUDA call then fails, so the count is not the kernels')"
                 if refused else ""), flush=True)
        failed |= errors != 0 or not ran or rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
