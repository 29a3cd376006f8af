#!/usr/bin/env python3
"""Where the FSE-encode kernel (zstd_tpu_torch/csrc/fse_encode.cu) spends
its time, on one NVIDIA GPU, at the device encoder's shapes.

    python scripts/fse_profile.py

Encodes chip_smoke.py's encode corpus (make_corpus(8, seed=5), 64 frames of
128 KiB) with BatchEncoder(matcher=DeviceMatcher()) and keeps the FSE
kernel's arguments. Then builds, with nvcc into build/fse_profile/, an
instrumented copy of the kernel that records per lane (block) its SM cycles
(clock64) in all, in warp 1's state chains (step 2), in warp 0's codes and
packing (steps 1 and 3) and in its codes alone, and runs it on those
arguments (bit-equal to the kernel's output). Prints the kernel's time
(CUDA events, mean of 5) and, for the longest lane, cycles per sequence of
each part and their shares; the parts overlap, so the longer one and the
round barriers make the whole.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "zstd_tpu_torch", "csrc", "fse_encode.cu")
OUT = os.path.join(ROOT, "build", "fse_profile")
N_PROF = 4096  # lanes the instrumented copy records

EDITS = [
    ("namespace {\n", "namespace {\n"
     f"__device__ long long g_prof[4 * {N_PROF}];\n"),
    ("  int state = 0;    // warp 1, thread s < 3: the state of stream s\n",
     "  int state = 0;    // warp 1, thread s < 3: the state of stream s\n"
     "  long long c0 = 0, c1 = 0, cc = 0;\n"
     "  const long long t0 = clock64();\n"),
    ("    if (warp == 0) {\n",
     "    if (warp == 0) {\n      const long long tw = clock64();\n"),
    ("      if (r < chunks) coder.code(sh, sh.slot[r % 3], r, lane);\n",
     "      if (r < chunks) coder.code(sh, sh.slot[r % 3], r, lane);\n"
     "      __syncwarp();\n      cc += clock64() - tw;\n"),
    ("        out.advance(T, lane);\n      }\n",
     "        out.advance(T, lane);\n      }\n      c0 += clock64() - tw;\n"),
    ("      walk_states(sh, sh.slot[(r - 1) % 3], lane, r - 1, n, state);\n",
     "      const long long ts = clock64();\n"
     "      walk_states(sh, sh.slot[(r - 1) % 3], lane, r - 1, n, state);\n"
     "      c1 += clock64() - ts;\n"),
    ("  if (warp != 0) return;\n",
     f"  if (warp == 1 && lane == 0 && b < {N_PROF}) g_prof[4 * b] = c1;\n"
     "  if (warp != 0) return;\n"),
    ("  if (lane == 0) total[b] = (int32_t)T;\n",
     "  if (lane == 0) total[b] = (int32_t)T;\n"
     f"  if (lane == 0 && b < {N_PROF}) {{\n"
     "    g_prof[4 * b + 1] = c0;\n    g_prof[4 * b + 2] = clock64() - t0;\n"
     "    g_prof[4 * b + 3] = cc;\n"
     "  }\n"),
]
PROF_FN = """
extern "C" int zt_fse_prof(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
"""


def instrumented() -> str:
    with open(SRC) as f:
        src = f.read()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise SystemExit(f"fse_profile: anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src + PROF_FN


def build(src: str):
    from zstd_tpu_torch.ops import _kernels

    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "fse_prof.cu")
    so = os.path.join(OUT, "libfse_prof.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_kernels.nvcc(), *_kernels.NVCC_FLAGS, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    fn = lib.zt_fse_encode
    fn.argtypes = _kernels.SIGNATURES["fse_encode"][1]
    fn.restype = ctypes.c_int
    lib.zt_fse_prof.argtypes = [ctypes.c_void_p]
    lib.zt_fse_prof.restype = ctypes.c_int
    return fn, lib.zt_fse_prof


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fse_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from zstd_tpu_torch.encoding.device_matcher import DeviceMatcher
    from zstd_tpu_torch.models import batch_encoder
    from zstd_tpu_torch.ops import fse_encode

    card, _ = chip_smoke.phase_card()
    calls = []
    undo = chip_smoke._recorded(batch_encoder, "encode_sequences_packed",
                                calls)
    batch_encoder.BatchEncoder(matcher=DeviceMatcher()).compress_frames(
        chip_smoke.make_corpus(8, seed=5))
    undo()
    args = calls[0][0]
    ll, ml, of, nseq, ns, nbd, fs, logs, out_words = args
    B, S = ll.shape
    want = fse_encode.encode_sequences_packed(*args)
    ms = chip_smoke.cuda_ms(
        list, lambda fn, _: list(fn(*args)),
        fse_encode.encode_sequences_packed, reps=5)

    fn, prof = build(instrumented())
    words = torch.zeros((B, out_words), dtype=torch.int32, device=ll.device)
    total = torch.empty((B,), dtype=torch.int32, device=ll.device)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in (
        ll, ml, of, S, nseq, B, ns, nbd, fs, logs,
        fse_encode.code_tables(ll.device), words, out_words, total)]
    err = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err or not (torch.equal(words, want[0])
                   and torch.equal(total, want[1])):
        print(f"fse_profile: instrumented copy differs (error {err})")
        return 1
    buf = (ctypes.c_longlong * (4 * N_PROF))()
    if prof(ctypes.addressof(buf)):
        return 1
    cyc = np.frombuffer(buf, np.int64).reshape(-1, 4)[:B]
    n = nseq.cpu().numpy().astype(np.int64)
    top = int(np.argmax(n))
    per = {k: round(int(cyc[top, j]) / int(n[top]), 2) for j, k in
           enumerate(("states", "codes_pack", "all", "codes"))}
    print(json.dumps({
        "lanes": B, "sequences": int(n.sum()), "longest_lane": int(n[top]),
        "kernel_ms": round(ms, 6), "longest_cycles": int(cyc[top, 2]),
        "longest_cycles_per_sequence": per,
        "state_share_longest": round(cyc[top, 0] / cyc[top, 2], 4),
        "codes_pack_share_longest": round(cyc[top, 1] / cyc[top, 2], 4),
        "cycles_per_sequence_all": round(cyc[:, 2].sum() / n.sum(), 2)}),
        flush=True)
    print(f"fse_profile: done on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
