#!/usr/bin/env python3
"""A wider fuzz of the card's decode path than chip_smoke.py's phase 19.

    python scripts/fuzz_decode.py        (one CUDA card, nvcc)

MUTANTS mutants a case (96 of the chained and far frames) of the libzstd
fixture (zstd_tpu_torch/testdata/libzstd), 64 a batch beside 64 valid
fixture frames, through BatchDecoder on the card:

  targeted     SEEDS seeds of testdata/anatomy.py::targeted_mutants of
               the checksum-less frames (seeds 100, 101, ...)
  checksummed  the same mutator over every level and edge frame, those
               with a checksum included (seed 7)
  untargeted   byte flips, truncations, insertions and splices of whole
               frames, as the reference's tests/test_mutation_fuzz.py
               mutates them (seeds 1 and 2)
  chained-far  targeted mutants of the 4 MiB and the far frame (seed 3;
               the window kernel on corrupted chains)

Each batch runs pulled and in serving mode; a mutant fails when its result
differs from the host oracle's decode_frame (None where it raises), a
valid frame when its own device row is not ok and exact; a CUDA error
stops the script. Failing mutants are written to build/fuzz_decode/. The
last line is the count of failures; the exit code is 1 when it is not 0.
"""

import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCH = 64
SEEDS = 6
MUTANTS = 512


def untargeted(frames: list, rng, n: int) -> list:
    """n mutants of whole frames: byte flips, a truncation, an insertion of
    random bytes, or a splice of two frames."""
    out = []
    for _ in range(n):
        z = bytearray(rng.choice(frames))
        kind = rng.random()
        if kind < 0.4:
            for _ in range(rng.randint(1, 8)):
                z[rng.randrange(len(z))] ^= rng.randrange(1, 256)
        elif kind < 0.6:
            z = z[:rng.randrange(1, len(z))]
        elif kind < 0.8:
            at = rng.randrange(len(z))
            z[at:at] = bytes(rng.randrange(256)
                             for _ in range(rng.randint(1, 16)))
        else:
            other = rng.choice(frames)
            z = z[:rng.randrange(1, len(z))] + other[
                rng.randrange(len(other)):]
        out.append(bytes(z))
    return out


def run(label: str, mutants: list, valid: list, out_dir: str) -> int:
    """The mutants through the card, BATCH a batch beside valid frames;
    returns the failures."""
    import torch

    from chip_smoke import _oracle_frames, _row_good
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder

    bad = 0
    for b in range(0, len(mutants), BATCH):
        chunk = mutants[b:b + BATCH]
        beside = [valid[(b + j) % len(valid)] for j in range(len(chunk))]
        frames = [x for m, v in zip(chunk, beside) for x in (m, v["frame"])]
        dec = BatchDecoder()
        batch = dec.prepare(frames)
        staged = dec.stage(batch)
        outputs, out_len, ok = dec.run_device(batch, staged)
        res = dec._postprocess(frames, batch, outputs, out_len, ok)
        dec.run_device(batch, staged, pull_outputs=False)
        torch.cuda.synchronize()
        for j, v in enumerate(beside):
            if not (_row_good(batch.metas[2 * j + 1], v["data"], outputs,
                              out_len, ok, True)
                    and res[2 * j + 1] == v["data"]):
                print(f"fuzz_decode: {label}: valid frame {v['file']} "
                      f"beside mutant {b + j} not ok or wrong", flush=True)
                bad += 1
        for j, want in enumerate(_oracle_frames(chunk)):
            if res[2 * j] != want:
                bad += 1
                path = os.path.join(out_dir, f"{label}_{b + j}.zst")
                with open(path, "wb") as f:
                    f.write(chunk[j])
                print(f"fuzz_decode: {label}: mutant {b + j} differs from "
                      f"the oracle, written to {path}", flush=True)
    print(f"fuzz_decode: {label}: {len(mutants)} mutants, {bad} failures",
          flush=True)
    return bad


def main() -> int:
    import torch

    from chip_smoke import libzstd_fixture
    from zstd_tpu_torch.ops import _kernels
    from zstd_tpu_torch.testdata.anatomy import targeted_mutants

    if not torch.cuda.is_available():
        print("fuzz_decode: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    _kernels.build_all()
    out_dir = os.path.join(ROOT, "build", "fuzz_decode")
    os.makedirs(out_dir, exist_ok=True)
    fx = libzstd_fixture()
    valid = fx["main"] + fx["levels"] + fx["edge"]
    small = [e["frame"] for g in ("levels", "edge") for e in fx[g]]
    bare = [e["frame"] for g in ("levels", "edge") for e in fx[g]
            if not e["checksum"]]
    chains = [fx["chained"][0]["frame"], fx["far"][0]["frame"]]
    bad = total = 0
    cases = [(f"targeted{s}", [m[3] for m in targeted_mutants(
        bare, random.Random(s), MUTANTS)])
        for s in range(100, 100 + SEEDS)]
    cases.append(("checksummed", [m[3] for m in targeted_mutants(
        small, random.Random(7), MUTANTS)]))
    cases += [(f"untargeted{s}", untargeted(small, random.Random(s),
                                            MUTANTS)) for s in (1, 2)]
    cases.append(("chained-far", [m[3] for m in targeted_mutants(
        chains, random.Random(3), 96)]))
    for label, mutants in cases:
        bad += run(label, mutants, valid, out_dir)
        total += len(mutants)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"fuzz_decode: {total} mutants on {card} in "
          f"{time.perf_counter() - t0:.1f} s, no CUDA error, {bad} failures")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
