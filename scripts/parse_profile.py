#!/usr/bin/env python3
"""Time the parse kernel (zstd_tpu_torch/csrc/parse.cu) at the device-encode
path's shapes with several segment counts and staging choices, and split
its time into phases.

    python scripts/parse_profile.py        (needs a CUDA card)

Two batches of 64 lanes of 128 KiB, candidates from find_candidates on the
card: chip_smoke.py's phase 12 lanes (make_corpus(8, seed=5), one block a
lane), and an incompressible and mixed batch (16 lanes of random bytes, as
already-compressed data is; 48 corpus blocks with one to three random
stretches of 8-48 KiB written over them).

The package's kernel is timed beside copies of csrc/parse.cu with other
constants, built into build/parse_profile/: SEGMENTS segments a lane on
CTAS CTAs (a cluster), or staging turned off, so that lanes read their
bytes, lcp and skip set from global memory. Each copy must equal the plain
version's records; all are timed in turn, ROTATIONS times (CUDA events
around the call and its output allocation, mean of 5 calls each), and a
line gives each one's median, its times and its counters (serial lanes
among them). A copy with clock stamps then gives, on both batches, each
CTA's SM cycles in staging, its first walks, the wait for the other CTA's,
the first scan, the re-walks with later scans, and writing (mean and max
over CTAs, and the slowest CTA's split), and the cycles a record spends
in each step of a walk, summed over every walk.
"""

import ctypes
import faulthandler
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "zstd_tpu_torch", "csrc", "parse.cu")
OUT = os.path.join(ROOT, "build", "parse_profile")
ROTATIONS = 3
PHASES = ("staging", "first walk", "wait for the cluster", "first scan",
          "re-walks and later scans", "write")
NS = len(PHASES) + 1  # stamps a CTA
N_STAMPS = NS * 4096  # for up to 4,096 CTAs

# (name, SEGMENTS, CTAS, staged); None keeps the source's constant
VARIANTS = [("32 segments on 1 CTA", 32, 1, True),
            ("32 segments on 2 CTAs", 32, 2, True),
            ("128 segments on 4 CTAs", 128, 4, True),
            ("16 segments on 1 CTA", 16, 1, True),
            ("64 segments on 2 CTAs, global memory", None, None, False)]

STAMP_DEFS = f"""
__device__ unsigned long long g_stamp[{N_STAMPS}];
__device__ unsigned long long g_prof[6];
#define ZT_STAMP(j)                                                  \\
  do {{                                                              \\
    __syncthreads();                                                 \\
    if (threadIdx.x == 0 && {NS} * (blockIdx.x + 1) <= {N_STAMPS})     \\
      g_stamp[{NS} * blockIdx.x + (j)] = clock64();                  \\
  }} while (0)
"""
# the clock stamps: each CTA at its start and after staging, its first
# walks, the cluster barrier after them, the first scan, settling and
# writing; each walk's cycles finding the next match,
# keeping the match-start bitmap, reading an unextended and an extended
# length, with its records and extended ones
CYCLE_EDITS = [
    ("\nnamespace {\n", "\nnamespace {\n" + STAMP_DEFS),
    ("  if (b >= B) return;\n", "  if (b >= B) return;\n  ZT_STAMP(0);\n"),
    ("  if (wide) wide_flag = 1;\n  __syncthreads();\n",
     "  if (wide) wide_flag = 1;\n  __syncthreads();\n  ZT_STAMP(1);\n"),
    ("  // settle: Jacobi rounds", "  ZT_STAMP(2);\n  // settle: Jacobi rounds"),
    ("    cl.sync();  // the walks are done\n",
     "    cl.sync();  // the walks are done\n    if (rounds == 0) ZT_STAMP(3);\n"),
    ("    cl.sync();  // every scan has read the walks\n",
     "    cl.sync();  // every scan has read the walks\n"
     "    if (rounds == 0) ZT_STAMP(4);\n"),
    ("  // place the records", "  ZT_STAMP(5);\n  // place the records"),
    ("  cl.sync();  // no CTA leaves",
     "  ZT_STAMP(6);\n  cl.sync();  // no CTA leaves"),
    ("  while (i < e) {\n    const int p = next_match(L, i, a, e);\n",
     "  long long pf[6] = {};\n  while (i < e) {\n"
     "    const long long t0 = clock64();\n"
     "    const int p = next_match(L, i, a, e);\n"),
    ("    const int c = L.cand[p];\n",
     "    const int c = L.cand[p];\n    const long long t1 = clock64();\n"),
    ("    ++n;\n    const int m = match_len(L, p, c);\n",
     "    const long long t2 = clock64();\n    ++n;\n"
     "    const int m = match_len(L, p, c);\n"
     "    const bool extended = L.lcp_at(p) == 8;\n"
     "    pf[0] += t1 - t0;\n    pf[1] += t2 - t1;\n"
     "    pf[extended ? 3 : 2] += clock64() - t2;\n"
     "    pf[4] += 1;\n    pf[5] += extended;\n"),
    ("  if (!met) {  // no old match start",
     "  if (lane_id() == 0)\n    for (int j = 0; j < 6; ++j)\n"
     "      atomicAdd(&g_prof[j], (unsigned long long)pf[j]);\n"
     "  if (!met) {  // no old match start"),
]
PROF_FN = """
extern "C" int zt_parse_prof(void* stamps, void* prof) {
  cudaError_t e = cudaMemcpyFromSymbol(stamps, g_stamp, sizeof(g_stamp));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(prof, g_prof, sizeof(g_prof));
}
"""


def variant_source(segments=None, ctas=None, staged=True,
                   cycles=False) -> str:
    """parse.cu with other constants, staging off, or the clock stamps."""
    with open(SRC) as f:
        src = f.read()
    edits = []
    if segments is not None:
        edits.append(("constexpr int SEGMENTS = 64;",
                      f"constexpr int SEGMENTS = {segments};"))
    if ctas is not None:
        edits.append(("constexpr int CTAS = 2;", f"constexpr int CTAS = {ctas};"))
    if not staged:
        edits.append(("const bool staged = need_smem",
                      "const bool staged = false && need_smem"))
    if cycles:
        edits += CYCLE_EDITS
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"parse_profile: anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src + (PROF_FN if cycles else "")


def build(sources: dict) -> dict:
    """nvcc for every {name: source} at once; {name: CDLL}."""
    from zstd_tpu_torch.ops import _kernels

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for n, (name, src) in enumerate(sources.items()):
        cu = os.path.join(OUT, f"parse_v{n}.cu")
        so = os.path.join(OUT, f"libparse_v{n}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (so, subprocess.Popen(
            [_kernels.nvcc(), *_kernels.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"parse_profile: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def entry_of(lib):
    from zstd_tpu_torch.ops import _kernels

    sym, argtypes = _kernels.SIGNATURES["parse"]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def mixed_blocks(seed: int = 9):
    """64 blocks of 128 KiB: 16 of random bytes, 48 corpus blocks with one
    to three random stretches of 8-48 KiB written over them."""
    from chip_smoke import make_corpus

    rng = np.random.default_rng(seed)
    blocks = []
    for n, b in enumerate(make_corpus(8, seed=seed)):
        a = np.frombuffer(b, np.uint8).copy()
        if n % 4 == 0:
            a = rng.integers(0, 256, len(a), dtype=np.uint8)
        else:
            for _ in range(int(rng.integers(1, 4))):
                k = int(rng.integers(8 << 10, 48 << 10))
                at = int(rng.integers(0, len(a) - k))
                a[at:at + k] = rng.integers(0, 256, k, dtype=np.uint8)
        blocks.append(a.tobytes())
    return blocks


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("parse_profile: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import cuda_ms, make_corpus, phase_card
    from zstd_tpu_torch.encoding.device_matcher import block_lanes
    from zstd_tpu_torch.ops import _kernels
    from zstd_tpu_torch.ops import match_finder as mf

    card, _ = phase_card()
    _kernels.build_all()
    libs = build({name: variant_source(seg, ctas, staged)
                  for name, seg, ctas, staged in VARIANTS}
                 | {"cycles": variant_source(cycles=True)})
    fns = {"64 segments on 2 CTAs (the package's)": _kernels.entry("parse")}
    fns |= {name: entry_of(libs[name]) for name, *_ in VARIANTS}

    def runner(fn, data, cand, lcp, n_valid):
        def run(_, __):
            out, tb, scratch, stats = mf.parse_buffers(data)
            args = [data, data.shape[1], cand, lcp, n_valid, data.shape[0],
                    *out, tb, tb.numel(), scratch, stats]
            err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                       for a in args], torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"parse_profile: CUDA error {err}")
            return out, stats
        return run

    batches = {"phase 12 corpus": make_corpus(8, seed=5),
               "incompressible and mixed": mixed_blocks()}
    for batch, blocks in batches.items():
        data, n_valid = block_lanes(blocks, "cuda")
        cand, lcp = mf.find_candidates(data, n_valid)
        want = mf.parse_lanes_plain(data, cand, lcp, n_valid)
        torch.cuda.synchronize()
        print(f"parse_profile: {batch}: {data.shape[0]} lanes of "
              f"{data.shape[1]} bytes, {int(want[3].sum())} records, on "
              f"{card}", flush=True)
        times = {name: [] for name in fns}
        counters = {}
        for rotation in range(ROTATIONS):
            for name, fn in fns.items():
                run = runner(fn, data, cand, lcp, n_valid)
                if rotation == 0:
                    got, stats = run(None, None)
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        print(f"parse_profile: {name}: records differ from "
                              f"the plain version")
                        return 1
                    counters[name] = mf.parse_stats(stats)
                times[name].append(cuda_ms(list, run, None, reps=5))
        for name in fns:
            print(f"parse_profile: {batch}: {name}: median "
                  f"{float(np.median(times[name])):.6f} ms, runs "
                  f"{[round(t, 6) for t in times[name]]}, counters "
                  f"{json.dumps(counters[name])}", flush=True)
        if cycle_split(libs["cycles"], runner, data, cand, lcp, n_valid,
                       want, batch):
            return 1
    return 0


_SUMS = np.zeros(6, np.int64)  # the instrumented copy's sums so far


def cycle_split(lib, runner, data, cand, lcp, n_valid, want, batch) -> int:
    import torch

    from zstd_tpu_torch.ops import match_finder as mf

    got, _ = runner(entry_of(lib), data, cand, lcp, n_valid)(None, None)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        print("parse_profile: the instrumented copy's records differ")
        return 1
    stamps = (ctypes.c_ulonglong * N_STAMPS)()
    sums = (ctypes.c_ulonglong * 6)()
    lib.zt_parse_prof.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.zt_parse_prof.restype = ctypes.c_int
    err = lib.zt_parse_prof(ctypes.addressof(stamps), ctypes.addressof(sums))
    if err:
        print(f"parse_profile: reading the stamps: CUDA error {err}")
        return 1
    # the sums run on over the calls of this process: this call's part
    prof = np.frombuffer(sums, np.uint64).astype(np.int64) - _SUMS
    _SUMS[:] += prof
    ctas = 2  # the source's CTAS
    st = np.frombuffer(stamps, np.uint64).astype(np.int64).reshape(-1, NS)
    st = st[:data.shape[0] * ctas]
    live = np.repeat((n_valid > 0).cpu().numpy(), ctas)
    split = np.diff(st, axis=1)[live]
    total = st[live, -1] - st[live, 0]
    slow = int(np.argmax(total))
    print(f"parse_profile: {batch}: SM cycles a CTA ({ctas} a lane; "
          + ", ".join(f"{name} mean {split[:, j].mean():.0f} max "
                      f"{split[:, j].max()}"
                      for j, name in enumerate(PHASES))
          + f"); whole lane mean {total.mean():.0f}, max {total.max()}; the "
          f"slowest CTA {dict(zip(PHASES, split[slow].tolist()))}",
          flush=True)
    find, bits, short, long_, recs, ext = (int(v) for v in prof)
    print(f"parse_profile: {batch}: every walk of every warp (first walk, "
          f"re-walks): {recs} records, {ext} extended; SM cycles a record "
          f"finding the next match {find / max(recs, 1):.1f}, keeping the "
          f"match-start bitmap {bits / max(recs, 1):.1f}, reading an "
          f"unextended length {short / max(recs - ext, 1):.1f}, an extended "
          f"one {long_ / max(ext, 1):.1f}", flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.enable()
    sys.exit(main())
