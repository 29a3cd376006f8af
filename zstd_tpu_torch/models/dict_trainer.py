"""Raw-content dictionary trainer.

Capability parity with ruzstd/src/dictionary/ (feature
`dict_builder`): reservoir-sample the collection, estimate k-mer frequencies
with a rolling Karp-Rabin hash, score fixed-size segments per epoch as the
sum of estimated frequencies of their *distinct* k-mers, and emit the best
segment per epoch, lowest score first (best material last = smallest offsets
from the window end). Implements the same "Effective Construction of
Relative Lempel-Ziv Dictionaries" (Liao/Petri/Moffat/Wirth) recipe
(dictionary/mod.rs:76-202, cover.rs:17-132, frequency.rs:8-46,
reservoir.rs:8-107).

Device transposition: the hot part — hashing every k-mer of the sample and of
every candidate segment — is one vectorized rolling-hash over u64 lanes (the
same multiply-accumulate per byte for every position), here NumPy on the host
(a copy of zstd_tpu/models/dict_trainer.py, which is NumPy only too); the
per-epoch argmax is a reduction. The byte-shuffling (reservoir, final
assembly) stays host-side.
"""

import dataclasses
import heapq
import os

import numpy as np

KMER = 16
PRIME = 2654435761


@dataclasses.dataclass
class DictParams:
    dict_size: int = 112 * 1024
    segment_size: int = 2048
    sample_budget: int = 4 << 20   # max bytes sampled from the collection
    chunk_size: int = 4096         # reservoir chunk granularity
    seed: int = 0x5EED


def _rolling_hashes(data: np.ndarray, k: int = KMER) -> np.ndarray:
    """Karp-Rabin hash of every k-mer: h(i) = sum data[i+j] * PRIME^(k-1-j).

    Computed with a matrix-free vectorized shift-accumulate (k fixed small).
    """
    n = len(data)
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    d = data.astype(np.uint64)
    out = np.zeros(n - k + 1, dtype=np.uint64)
    p = np.uint64(PRIME)
    with np.errstate(over="ignore"):
        for j in range(k):
            out = out * p + d[j:n - k + 1 + j]
    return out


def reservoir_sample(sources, params: DictParams) -> bytes:
    """Uniform chunk reservoir over the concatenated sources (Algorithm L
    semantics: every chunk has equal probability; NumPy RNG instead of the
    reference's fastrand)."""
    rng = np.random.RandomState(params.seed)
    cs = params.chunk_size
    capacity = max(1, params.sample_budget // cs)
    reservoir: list[bytes] = []
    seen = 0
    for src in sources:
        for off in range(0, len(src), cs):
            chunk = bytes(src[off:off + cs])
            if len(reservoir) < capacity:
                reservoir.append(chunk)
            else:
                j = rng.randint(0, seen + 1)
                if j < capacity:
                    reservoir[j] = chunk
            seen += 1
    return b"".join(reservoir)


def _freq_table(sample_hashes: np.ndarray, bits: int = 22):
    """Approximate k-mer frequency: count hash occurrences in a 2^bits table
    (collisions over-estimate slightly, same nature as the reference's
    sampled estimate)."""
    mask = np.uint64((1 << bits) - 1)
    idx = (sample_hashes & mask).astype(np.int64)
    return np.bincount(idx, minlength=1 << bits), mask


def create_raw_dict_from_source(sources, params: DictParams | None = None) -> bytes:
    """Train a raw-content dictionary from an iterable of byte strings."""
    params = params or DictParams()
    sample = reservoir_sample(sources, params)
    if len(sample) < KMER:
        return b""
    data = np.frombuffer(sample, dtype=np.uint8)
    hashes = _rolling_hashes(data)
    counts, mask = _freq_table(hashes)

    seg = params.segment_size
    n_segments = max(1, params.dict_size // seg)
    # epoch partition of the sample (compute_epoch_info parity: every epoch
    # contributes one segment; epochs at least 10 KiB)
    epoch_size = max(10 * 1024, len(sample) // n_segments)
    chosen: list[tuple[float, int, bytes]] = []
    h_idx = (hashes & mask).astype(np.int64)

    for e in range(n_segments):
        lo = (e * epoch_size) % max(1, len(sample) - seg)
        hi = min(lo + epoch_size, len(sample) - KMER + 1)
        if hi - lo < seg:
            continue
        best_score, best_off = -1.0, lo
        # slide in seg/2 steps for tractability; score = sum of freq of
        # distinct k-mers in the window
        for off in range(lo, hi - seg + 1, seg // 2):
            window = h_idx[off:off + seg - KMER + 1]
            uniq = np.unique(window)
            score = float(counts[uniq].sum())
            if score > best_score:
                best_score, best_off = score, off
        segment = sample[best_off:best_off + seg]
        heapq.heappush(chosen, (best_score, e, segment))
        # suppress re-picking the same content: zero its contribution
        window = h_idx[best_off:best_off + seg - KMER + 1]
        counts[np.unique(window)] = 0

    if not chosen:
        return sample[:params.dict_size]
    # lowest score first -> best segments end up nearest the window end
    parts = [heapq.heappop(chosen)[2] for _ in range(len(chosen))]
    return b"".join(parts)[:params.dict_size]


def create_raw_dict_from_dir(path: str, params: DictParams | None = None) -> bytes:
    """Recursive-walk variant (dictionary/mod.rs:76-113)."""
    sources = []
    for root, _dirs, files in os.walk(path):
        for name in sorted(files):
            with open(os.path.join(root, name), "rb") as f:
                sources.append(f.read())
    return create_raw_dict_from_source(sources, params)
