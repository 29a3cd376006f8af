#!/usr/bin/env python3
"""Time the Huffman kernel (zstd_tpu_torch/csrc/huffman.cu) at the main
path's shapes with several stream staging sizes.

    python scripts/huffman_profile.py [frames]      (needs a CUDA card)

The lanes are those of chip_smoke.py's main path (make_corpus(128), 1024
frames of 128 KiB at FASTEST; fewer with `frames`). For each number of
stream bytes staged in shared memory (a longer stream reads global memory)
the kernel's output must equal the default call's, which chip_smoke.py
holds to the plain version. The sizes are timed in turn, ROTATIONS times
(CUDA events, mean of 5 calls each); a line gives their median and each
time, the blocks an SM by shared memory, and the kernel's lane counters.
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# stream bytes staged, given to the kernel's C entry point; None: what
# huffman_lanes gives it
STAGES = [None, 2048, 4096, 16384]
ROTATIONS = 4  # every size timed in turn, this many times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("huffman_profile: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (_huff_args, cuda_ms, huffman_case, make_corpus,
                            phase_card)
    from zstd_tpu_torch.common.config import CompressionLevel
    from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder
    from zstd_tpu_torch.ops import _kernels, huffman

    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    card, _ = phase_card()
    payloads = make_corpus(1 + (frames - 1) // 8)[:frames]
    dec = BatchDecoder()
    batch = dec.prepare([bytes(compress_to_vec(p, CompressionLevel.FASTEST))
                         for p in payloads])
    d = dec.stage(batch)
    setup, call, kern, _ = huffman_case(d)
    want = call(kern, setup())
    width = d["huff_streams"].shape[1]
    print(f"huffman_profile: {frames} frames, "
          f"{int((batch.huff_nsym > 0).sum())} lanes, row width {width}, "
          f"longest lane {int(batch.huff_nsym.max())} symbols", flush=True)
    stats = torch.empty((4,), dtype=torch.int64, device="cuda")

    def runner(stage):
        def run(_, bufs):
            lit, ok = bufs
            s, pos, tid, nsym, frame, off, tab, mb = _huff_args(d)
            _kernels.launch("huffman", s, s.shape[1], s.shape[0], pos, tid,
                            nsym, frame, off, tab, tab.shape[0], mb, lit,
                            lit.shape[1], lit.shape[0], ok, stage, stats)
            return bufs
        return run

    stages = [s or min(width, huffman.STAGE_BYTES) for s in STAGES]
    times = [[] for _ in stages]
    for rotation in range(ROTATIONS):
        for i, stage in enumerate(stages):
            run = runner(stage)
            if rotation == 0:
                got = run(kern, setup())
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    print(f"huffman_profile: stage {stage} differs")
                    return 1
            times[i].append(cuda_ms(setup, run, kern, reps=5))
    counts = dict(zip(("warp_lanes", "serial_lanes", "rounds_sum",
                       "rounds_max"), stats.tolist()))
    for given, stage, ts in zip(STAGES, stages, times):
        smem = 4096 + 16 + stage + 16
        print(json.dumps({
            "stage_bytes": stage, "default": given is None,
            "ms_median": round(float(np.median(ts)), 6),
            "ms": [round(t, 6) for t in ts], "smem_bytes": smem,
            "blocks_per_sm": min(32, (228 << 10) // (smem + 1024)),
            **counts}), flush=True)
    print(f"huffman_profile: done on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
