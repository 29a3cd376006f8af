"""A numpy model of the single-group LZ77 kernel's schedule (csrc/execute.cu).

The CUDA kernel cannot run here, so its schedule runs here as a model,
step for step, and is held to execute_lanes_plain's bytes and ok flags:

  - one pass over a row's records, 32 at a time: prefix sums give each
    record's output and literal start and validate the chunk; a bad chunk
    stops the row, which then comes back all zero;
  - a match whose source lies wholly in the destination of one earlier
    short, not periodic match of its chunk reads that match's (redirected)
    source instead;
  - a chunk's records split at every record whose literal run or match is
    longer than K_LONG; the records between run as a segment: literals
    first, then matches in rounds, a match copying in the first round in
    which no pending match of its chunk writes into its source (all ready
    matches read before any writes, as lanes do); a long record is copied
    by the whole warp in pieces of K_PIECE bytes;
  - the output lives in a ring of R bytes flushed to the output row; the
    model tags every ring slot with the position it holds and asserts that
    each read finds its byte in the ring or already flushed, so a small R
    checks the kernel's flush rule.

It also counts the rounds per chunk (chunks that hold a record), the
number behind the kernel's predicted time. Run as a script it prints them
for the first frames of chip_smoke.py's main-path corpus:

    python tests/test_torch_execute_schedule.py [frames]
"""

import sys

import numpy as np
import pytest
import torch

from chip_smoke import random_records
from zstd_tpu_torch.ops.execute import execute_lanes_plain

CHUNK = 32
K_LONG = 64
K_PIECE = 1024
K_LIT_WIN = 4096


class _Ring:
    """The kernel's Frame: R bytes of recent output, tagged, and the output
    row they are flushed to."""

    def __init__(self, R: int, out_w: int):
        self.R = R
        self.ring = np.zeros(R, np.uint8)
        self.tag = np.full(R, -1, np.int64)
        self.dst = np.zeros(out_w, np.uint8)
        self.fl = 0

    def put(self, p: int, v: int) -> None:
        self.ring[p % self.R] = v
        self.tag[p % self.R] = p

    def get(self, q: int, lo: int) -> int:
        if q >= lo:
            assert self.tag[q % self.R] == q, f"ring lost byte {q}"
            return int(self.ring[q % self.R])
        assert 0 <= q < self.fl, f"byte {q} read before its flush"
        return int(self.dst[q])

    def flush(self, hi: int) -> None:
        if self.fl >= hi:
            return
        assert hi - self.R <= self.fl, "flush of bytes the ring lost"
        p = np.arange(self.fl, hi)
        assert np.array_equal(self.tag[p % self.R], p)
        self.dst[self.fl:hi] = self.ring[p % self.R]
        self.fl = hi


def _segment(f, lit, start, stop, l, m, o, os_, ls, d, src, dep) -> int:
    seg_os = int(os_[start])
    seg_end = int(d[stop - 1] + m[stop - 1])
    la, lb = int(ls[start]), int(ls[stop - 1] + l[stop - 1])
    if seg_end - f.R > f.fl:
        f.flush(seg_os)
    assert lb - la <= K_LIT_WIN - 15, "literal window too small"
    for k in range(start, stop):
        for i in range(int(l[k])):
            f.put(int(os_[k]) + i, lit[int(ls[k]) + i])
    lo = seg_end - f.R
    pending = {k for k in range(start, stop) if m[k] > 0}
    rounds = 0
    while pending:
        mask = sum(1 << k for k in pending)
        ready = [k for k in sorted(pending) if not dep[k] & mask]
        assert ready, "a round without progress"
        copies = []
        for k in ready:
            sk, ok_, mk = int(src[k]), int(o[k]), int(m[k])
            copies.append((int(d[k]), [f.get(sk + (i % ok_ if ok_ < mk else i),
                                             lo) for i in range(mk)]))
        for dk, vals in copies:
            for i, v in enumerate(vals):
                f.put(dk + i, v)
        pending -= set(ready)
        rounds += 1
    return rounds


def _long(f, lit, l, m, o, os_, ls) -> None:
    for x0 in range(os_, os_ + l, K_PIECE):
        n = min(K_PIECE, os_ + l - x0)
        if x0 + n - f.R > f.fl:
            f.flush(x0)
        for i in range(n):
            f.put(x0 + i, lit[ls + (x0 - os_) + i])
    d = os_ + l
    for x0 in range(d, d + m, K_PIECE):
        n = min(K_PIECE, d + m - x0)
        if x0 + n - f.R > f.fl:
            f.flush(x0)
        lo = x0 + n - f.R
        vals = [f.get(x0 + i - o if o >= n else x0 - o + i % o, lo)
                for i in range(n)]
        for i, v in enumerate(vals):
            f.put(x0 + i, v)


def model_row(l, m, o, lit, olen: int, out_w: int, R: int):
    """One frame row through the kernel's schedule: (out (out_w,) u8, ok,
    rounds of each chunk that holds a record)."""
    l, m, o = (np.asarray(a, np.int64) for a in (l, m, o))
    lit_w = len(lit)
    f = _Ring(R, out_w)
    bad = olen < 0 or olen > out_w
    op = lp = 0
    rounds = []
    for base in range(0, len(l), CHUNK):
        if bad:
            break
        lc, mc, oc = (np.pad(a[base:base + CHUNK], (0, CHUNK - len(
            a[base:base + CHUNK]))) for a in (l, m, o))
        if not ((lc | mc) != 0).any():
            continue
        run_incl = np.cumsum(lc + mc)
        l_incl = np.cumsum(lc)
        before = op + run_incl - mc
        rec_bad = (lc < 0) | (mc < 0) | ((mc != 0)
                                         & ~((oc > 0) & (oc <= before)))
        op_end, lp_end = op + int(run_incl[-1]), lp + int(l_incl[-1])
        if rec_bad.any() or op_end > olen or lp_end > lit_w:
            bad = True
            break
        d = before
        os_ = d - lc
        ls = lp + l_incl - lc
        lng = (lc > K_LONG) | (mc > K_LONG)
        ln = np.where(mc > 0, np.minimum(mc, oc), 0)
        s = np.where(mc > 0, d - oc, 0)
        for k in range(CHUNK):
            # the source is the output of one short, not periodic match j
            # of the chunk: read j's (redirected) source instead
            j = int(np.searchsorted(d, s[k], side="right")) - 1
            if (mc[k] > 0 and not lng[k] and 0 <= j < k and mc[j] > 0
                    and not lng[j] and oc[j] >= mc[j]
                    and s[k] + ln[k] <= d[j] + mc[j]):
                s[k] = s[j] + (s[k] - d[j])
        e = s + ln
        dend = np.where(mc > 0, d + mc, np.iinfo(np.int64).min)
        dep = [sum(1 << j for j in range(k) if d[j] < e[k] and dend[j] > s[k])
               for k in range(CHUNK)]
        longs = [k for k in range(CHUNK) if lng[k]]
        rc, start = 0, 0
        for stop in longs + [CHUNK]:
            if stop > start:
                rc += _segment(f, lit, start, stop, lc, mc, oc, os_, ls, d,
                               s, dep)
            if stop < CHUNK:
                _long(f, lit, int(lc[stop]), int(mc[stop]), int(oc[stop]),
                      int(os_[stop]), int(ls[stop]))
                rc += 1
            start = stop + 1
        rounds.append(rc)
        op, lp = op_end, lp_end
    good = not bad and op == olen
    if good:
        f.flush(olen)
    else:
        f.dst[:f.fl] = 0
    return f.dst, good, rounds


def model_lanes(ll, ml, off, lit, out_len, rows, out_w: int, R: int):
    """execute_lanes' arguments as numpy arrays; (out, ok, rounds)."""
    outs, oks, rounds = [], [], []
    for r in rows:
        row = min(max(int(r), 0), len(out_len) - 1)
        out, ok, rc = model_row(ll[row], ml[row], off[row], lit[row],
                                int(out_len[row]), out_w, R)
        outs.append(out)
        oks.append(ok)
        rounds += rc if ok else []
    return np.stack(outs), np.asarray(oks), rounds


def _plain(ll, ml, off, lit, out_len, rows, out_w: int):
    out, ok = execute_lanes_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                    for a in (ll, ml, off, lit, out_len,
                                              rows)), out_w)
    return out.numpy(), ok.numpy()


@pytest.mark.parametrize("R", [8192, 65536])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_model_matches_plain_on_random_records(seed, R):
    rec, lit, out_len, out_w, short = random_records(seed)
    rows = np.arange(rec.shape[1], dtype=np.int32)
    want, want_ok = _plain(rec[0], rec[1], rec[2], lit, out_len, rows, out_w)
    got, ok, rounds = model_lanes(rec[0], rec[1], rec[2], lit, out_len, rows,
                                  out_w, R)
    assert np.array_equal(ok, want_ok)
    assert np.array_equal(got, want)
    assert list(ok[-6:]) == [False, True] + [False] * 4 and ok[:-6].all()
    # too few literals: the same rows against a literal row cut short
    (b, n), = short.items()
    cut = lit[:, :n]
    want, want_ok = _plain(rec[0], rec[1], rec[2], cut, out_len, rows, out_w)
    got, ok, _ = model_lanes(rec[0], rec[1], rec[2], cut, out_len, rows,
                             out_w, R)
    assert np.array_equal(ok, want_ok) and not ok[b]
    assert np.array_equal(got, want)
    assert max(rounds) <= CHUNK


def test_model_matches_plain_on_edge_rows():
    """Offset 1 over more than a ring, a match exactly the ring back,
    copies of the copy before them (redirected to the first source: one
    round a chunk), copies that straddle two earlier outputs (a chain: one
    round each), a row that is only a long literal run, and a row given
    twice in `rows`."""
    R = 8192
    cases = [
        [(1, 3 * R, 1)],
        [(R, 50, R), (3, 2000, R + 53)],
        [(8, 0, 0)] + [(0, 8, 8)] * 64,
        [(5000, 0, 0)],
        [(12, 0, 0)] + [(0, 8, 12)] * 64,
    ]
    S = 72
    rec = np.zeros((3, len(cases), S), np.int32)
    for b, seqs in enumerate(cases):
        for i, r in enumerate(seqs):
            rec[:, b, i] = r
    lit = np.random.default_rng(0).integers(0, 256, (len(cases), 9000)
                                            ).astype(np.uint8)
    out_len = (rec[0] + rec[1]).sum(axis=1).astype(np.int32)
    rows = np.asarray([0, 1, 2, 3, 4, 2], np.int32)
    out_w = int(out_len.max())
    want, want_ok = _plain(rec[0], rec[1], rec[2], lit, out_len, rows, out_w)
    got, ok, rounds = model_lanes(rec[0], rec[1], rec[2], lit, out_len, rows,
                                  out_w, R)
    assert want_ok.all() and np.array_equal(ok, want_ok)
    assert np.array_equal(got, want)
    per_row = [model_row(rec[0, b], rec[1, b], rec[2, b], lit[b],
                         int(out_len[b]), out_w, R)[2] for b in (2, 4)]
    assert per_row == [[1, 1, 1], [31, CHUNK, 1]]


def main_batch(frames: int):
    """The first `frames` frames of chip_smoke.py's main-path corpus, staged
    on the CPU through the entropy stages and the resolution: execute_lanes'
    arguments as numpy arrays, the staged width and the payloads."""
    from chip_smoke import make_corpus, stage_outputs
    from zstd_tpu_torch.common.config import CompressionLevel
    from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder, _resolve

    payloads = make_corpus(1 + (frames - 1) // 8)[:frames]
    dec = BatchDecoder(device="cpu")
    batch = dec.prepare([bytes(compress_to_vec(p, CompressionLevel.FASTEST))
                         for p in payloads])
    d = dec.stage(batch)
    lit, ll, ml, of = stage_outputs(d)
    offsets, out_len, _ = _resolve(ll, ml, of, d["is_real"], d["init_hist"])
    args = [t.numpy() for t in (ll, ml, offsets, lit, out_len,
                                d["exec_rows"])]
    return args, d["exec_width"], payloads


@pytest.fixture(scope="module")
def main4():
    return main_batch(4)


@pytest.mark.parametrize("R", [8192, 16384])
def test_model_matches_plain_on_main_path_frames(main4, R):
    args, out_w, payloads = main4
    want, want_ok = _plain(*args, out_w)
    got, ok, rounds = model_lanes(*args, out_w, R)
    assert ok.all() and want_ok.all()
    assert np.array_equal(got, want)
    for row, p in zip(got, payloads):
        assert row[:len(p)].tobytes() == p
    assert len(rounds) > 4 * 200 and 1 < np.mean(rounds) < CHUNK


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    args, out_w, _ = main_batch(n)
    _, ok, rounds = model_lanes(*args, out_w, 16384)
    print(f"{n} main-path frames: {len(rounds)} chunks of {CHUNK} records, "
          f"rounds per chunk mean {np.mean(rounds):.4f}, max {max(rounds)}, "
          f"rounds per frame {len(rounds) and sum(rounds) / n:.1f}, "
          f"all ok {bool(ok.all())}")
