"""Where the single-group LZ77 kernel (zstd_tpu_torch/csrc/execute.cu)
spends its time, on one NVIDIA GPU, at the main path's shapes.

    python scripts/execute_profile.py [variant.cu ...]

Stages chip_smoke.py's main batch (1024 frames of 128 KiB, FASTEST) and
builds, each with nvcc into build/execute_profile/:

  - the kernel as it is;
  - the kernel with its shared-memory ring forced to 8, 16, 32 and 64 KiB
    (the source's ring bounds rewritten);
  - an instrumented copy that records, per frame row, its SM cycles
    (clock64), its chunks and match rounds, the cycles inside the round
    loops, in segment set-up and literal placement, in records longer than
    64 bytes, in validation and dependency masks, and after its last chunk
    that holds a record;
  - any other sources given (same C entry point), for comparisons.

Each is held bit-equal to the kernel's output and timed over 5 calls (CUDA
events; the first call, which loads the module, is dropped from the
median). The instrumented copy's counts are summed and fitted. Also the
same with only the first 132 rows (one frame per SM), which shows whether
frames slow each other down.
"""

import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from zstd_tpu_torch.common.config import CompressionLevel  # noqa: E402
from zstd_tpu_torch.encoding.frame_enc import compress_to_vec  # noqa: E402
from zstd_tpu_torch.models.batch_decoder import BatchDecoder  # noqa: E402
from zstd_tpu_torch.ops import _kernels  # noqa: E402

SRC = os.path.join(ROOT, "zstd_tpu_torch", "csrc", "execute.cu")
OUT = os.path.join(ROOT, "build", "execute_profile")
N_PROF = 4096  # rows the instrumented copy records


def instrument(src: str) -> str:
    """The kernel source with per-row cycle counters and zt_prof()."""
    edits = [
        ("__device__ unsigned long long g_stats[3];",
         "__device__ unsigned long long g_stats[3];\n"
         f"__device__ long long g_prof[{N_PROF} * 8];"),
        ("  int lane;\n};",
         "  int lane;\n  long long rcyc, scyc, lcyc, vcyc;\n};"),
        ("    // validate the chunk:",
         "    const long long tv0 = clock64();\n    // validate the chunk:"),
        ("    const unsigned longs =",
         "    f.vcyc += clock64() - tv0;\n    const unsigned longs ="),
        ("      run_long(f, ", "      const long long tl0 = clock64();\n"
         "      run_long(f, "),
        ("      ++rounds;\n      start = stop + 1;",
         "      f.lcyc += clock64() - tl0;\n      ++rounds;\n"
         "      start = stop + 1;"),
        ("  const int lane = f.lane;\n  const bool in =",
         "  const long long ts0 = clock64();\n  const int lane = f.lane;\n"
         "  const bool in ="),
        ("  int rounds = 0;\n  while (pending) {",
         "  int rounds = 0;\n  f.scyc += clock64() - ts0;\n"
         "  const long long tr0 = clock64();\n  while (pending) {"),
        ("    ++rounds;\n  }\n  return rounds;",
         "    ++rounds;\n  }\n  f.rcyc += clock64() - tr0;\n  return rounds;"),
        ("  const int r = blockIdx.x;\n  const int lane = threadIdx.x;",
         "  const long long t_start = clock64();\n"
         "  const int r = blockIdx.x;\n  const int lane = threadIdx.x;"),
        ("  f.lane = lane;\n",
         "  f.lane = lane;\n  f.rcyc = f.scyc = f.lcyc = f.vcyc = 0;\n"
         "  long long t_last = clock64();\n"),
        ("    ++chunks;\n", "    ++chunks;\n    t_last = clock64();\n"),
        ("  if (lane == 0) {\n    ok_out[r]",
         f"  if (lane == 0 && r < {N_PROF}) {{\n"
         "    long long* g = g_prof + r * 8;\n"
         "    g[0] = clock64() - t_start;\n    g[1] = (long long)chunks;\n"
         "    g[2] = (long long)rounds_sum;\n    g[3] = f.rcyc;\n"
         "    g[4] = f.scyc;\n    g[5] = clock64() - t_last;\n"
         "    g[6] = f.lcyc;\n    g[7] = f.vcyc;\n  }\n"
         "  if (lane == 0) {\n    ok_out[r]"),
    ]
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"instrument: the kernel no longer has {old!r}")
        src = src.replace(old, new, 1)
    return src + (
        "\nextern \"C\" int zt_prof(void* out) {\n  return (int)"
        f"cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * {N_PROF} * 8);"
        "\n}\n")


def ring(src: str, log: int) -> str:
    src, n = re.subn(r"kRingMinLog = \d+", f"kRingMinLog = {log}", src)
    src, k = re.subn(r"kRingMaxLog = \d+", f"kRingMaxLog = {log}", src)
    if n != 1 or k != 1:
        raise SystemExit("ring: the kernel no longer has its ring bounds")
    return src


def build(variants: dict) -> dict:
    """{name: source text} -> {name: (ctypes function, library)}."""
    os.makedirs(OUT, exist_ok=True)
    jobs = []
    for name, text in variants.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"{name}.so")
        cmd = [_kernels.nvcc(), *_kernels.NVCC_FLAGS, "-o", so, cu]
        jobs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        sym, argtypes = _kernels.SIGNATURES["execute"]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        out[name] = (fn, lib)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("execute_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    base = open(SRC).read()
    variants = {"kernel": base, "instrumented": instrument(base)}
    for log in (13, 14, 15, 16):
        variants[f"ring_{1 << (log - 10)}k"] = ring(base, log)
    for path in sys.argv[1:]:
        variants[os.path.splitext(os.path.basename(path))[0]] = \
            open(path).read()
    libs = build(variants)

    payloads = chip_smoke.make_corpus(128)
    dec = BatchDecoder()
    batch = dec.prepare([bytes(compress_to_vec(p, CompressionLevel.FASTEST))
                         for p in payloads])
    d = dec.stage(batch)
    _, inp = chip_smoke.kernel_cases(d)
    args = [inp[k] for k in ("ll", "ml", "offsets", "lit", "out_len")]
    width = d["exec_width"]

    def run(fn, rows):
        out = torch.zeros((rows.shape[0], width), dtype=torch.uint8,
                          device="cuda")
        ok = torch.empty(rows.shape[0], dtype=torch.bool, device="cuda")
        ll, ml, off, lit, out_len = args
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        err = fn(ll.data_ptr(), ml.data_ptr(), off.data_ptr(), ll.shape[1],
                 lit.data_ptr(), lit.shape[1], out_len.data_ptr(),
                 rows.data_ptr(), rows.shape[0], ll.shape[0], out.data_ptr(),
                 width, ok.data_ptr(), torch.cuda.current_stream().cuda_stream)
        b.record()
        torch.cuda.synchronize()
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")
        return out, ok, a.elapsed_time(b)

    for label, rows in (("all rows", d["exec_rows"]),
                        ("132 rows", d["exec_rows"][:132])):
        ref = run(libs["kernel"][0], rows)
        print(f"-- {label}: {rows.shape[0]} frame rows of width {width}")
        for name, (fn, lib) in libs.items():
            if label != "all rows" and name != "instrumented":
                continue
            times = []
            for rep in range(5):
                out, ok, ms = run(fn, rows)
                if rep == 0 and not (torch.equal(out, ref[0])
                                     and torch.equal(ok, ref[1])):
                    raise SystemExit(f"{name}: output differs")
                times.append(ms)
            print(f"{name}: median {sorted(times[1:])[1]:.4f} ms "
                  f"(calls {', '.join(f'{t:.4f}' for t in times)})")
        prof = (ctypes.c_longlong * (N_PROF * 8))()
        lib = libs["instrumented"][1]
        lib.zt_prof.argtypes = [ctypes.c_void_p]
        if lib.zt_prof(ctypes.addressof(prof)):
            raise SystemExit("zt_prof failed")
        p = np.frombuffer(prof, np.int64).reshape(N_PROF, 8)[:rows.shape[0]]
        cyc, chunks, rounds, rcyc, scyc, tail, lcyc, vcyc = p.T
        fit = np.linalg.lstsq(np.stack([rounds, chunks, np.ones_like(rounds)],
                                       1).astype(float),
                              cyc.astype(float), rcond=None)[0]
        print(f"instrumented, per frame row: SM cycles mean {cyc.mean():.0f}"
              f", max {cyc.max()}, min {cyc.min()}; chunks holding records "
              f"mean {chunks.mean():.1f}, max {chunks.max()}; match rounds "
              f"mean {rounds.mean():.1f}, max {rounds.max()}")
        print(f"instrumented, shares of the cycles: round loops "
              f"{rcyc.sum() / cyc.sum():.4f}, segment set-up and literals "
              f"{scyc.sum() / cyc.sum():.4f}, records longer than 64 bytes"
              f" {lcyc.sum() / cyc.sum():.4f}, validation and dependency "
              f"masks {vcyc.sum() / cyc.sum():.4f}, after the last chunk "
              f"{tail.sum() / cyc.sum():.4f}, the rest "
              f"{1 - (rcyc + scyc + tail + lcyc + vcyc).sum() / cyc.sum():.4f}"
              f"; cycles per round in the loops "
              f"{rcyc.sum() / max(rounds.sum(), 1):.1f}; least-squares fit: "
              f"{fit[0]:.1f} x rounds + {fit[1]:.1f} x chunks + {fit[2]:.0f}")
    print(f"done in {time.perf_counter() - T0:.1f} s on {card}")
    return 0


T0 = time.perf_counter()

if __name__ == "__main__":
    sys.exit(main())
