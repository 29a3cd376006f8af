"""A numpy model of the parse kernel's segmented walk (csrc/parse.cu).

The CUDA kernel cannot run here, so its schedule runs here as a model, step
for step, and is held to parse_lanes_plain's records, which
tests/test_torch_encoder.py holds in turn to the reference's Pallas
parse_blocks (interpret mode):

  - the walk's state is (position i, literal-run start anchor); the next
    match from it is the first p >= i with hit[p] (lcp >= 5, cand >= 0)
    and p - anchor in the skip set T (skip_words: the offsets a literal
    run visits);
  - [0, n_valid) is cut into K segments of G positions (G a multiple of
    32, at least SEG_MIN); each with a hit walks from its top, keeping its
    match starts in a bitmap;
  - in rounds, a scan in segment order gives each segment its entry: the
    exit of the segment above as it stood before the round, except that a
    segment with no hit at or past the state entering it forwards that
    state in closed form, (anchor + the least t in T >= end - anchor,
    anchor); every segment with a hit whose entry changed re-walks from
    it, clearing the old match starts it passes, and stops where it takes
    a match the old walk took;
  - after ROUND_CAP rounds an unsettled lane is finished in order
    (segment after segment: the serial walk);
  - an exclusive scan of the counts places the records; each segment walks
    once more from its settled entry and writes those below MAX_SEQS; the
    record MAX_SEQS - 1 gives the anchor, else the lane's exit.

The GPU tests (tests/test_torch_kernels_cuda.py) run the kernel on these
lanes and hold its counters to the model's. Run as a script it prints, for
the device-encode corpus of chip_smoke.py (make_corpus(8, seed=5): 64 lanes
of 128 KiB), the re-walk rounds and how far a re-walk goes before it meets
the old chain, for each segment count given:

    PYTHONPATH=. python tests/test_torch_parse_schedule.py [K ...]
"""

import sys

import numpy as np
import pytest
import torch

from zstd_tpu_torch.ops.match_finder import (EXTEND_CAP, EXTEND_STEP,
                                             MAX_SEQS, MIN_MATCH, ROUND_CAP,
                                             SEG_MIN, SEGMENTS,
                                             find_candidates,
                                             parse_lanes_plain, skip_words)


def skip_set(L: int) -> np.ndarray:
    """skip_words(L) as a bool array over offsets."""
    return np.unpackbits(skip_words(L).view(np.uint8),
                         bitorder="little").astype(bool)


def segments(nv: int, K: int = SEGMENTS):
    """(G, number of segments) of a lane of nv valid bytes."""
    G = -(-nv // K)
    G = max(SEG_MIN, (G + 31) & ~31)
    return G, -(-nv // G)


class LaneModel:
    """The kernel's schedule on one lane; run() gives its outputs."""

    def __init__(self, d, cand, lcp, nv: int, tset, K: int = SEGMENTS):
        self.d = np.asarray(d[:nv], np.uint8)
        self.cand = np.asarray(cand[:nv], np.int64)
        self.lcp = np.asarray(lcp[:nv], np.int64)
        self.nv = nv
        self.hits = np.nonzero((self.lcp >= MIN_MATCH)
                               & (self.cand >= 0))[0]
        self.t = tset
        self.tpos = np.nonzero(tset)[0]
        self.ms = np.zeros(nv, bool)
        self.G, self.K = segments(nv, K)
        self.last = []      # each segment's last hit, -1 if none
        for k in range(self.K):
            s, e = self.span(k)
            h = self.hits[(self.hits >= s) & (self.hits < e)]
            self.last.append(int(h[-1]) if len(h) else -1)
        self.exit = None    # the lane's exit once settled
        self.ent = [None] * self.K
        self.ex = [None] * self.K
        self.cnt = [0] * self.K
        self.rewalks = []   # (met, positions from the entry to the meeting)

    def span(self, k: int):
        s = k * self.G
        return s, min(s + self.G, self.nv)

    def next_match(self, i: int, a: int, e: int) -> int:
        j = int(np.searchsorted(self.hits, i))
        while j < len(self.hits) and self.hits[j] < e:
            p = int(self.hits[j])
            if self.t[p - a]:
                return p
            j += 1
        return -1

    def next_t(self, v: int) -> int:
        return int(self.tpos[np.searchsorted(self.tpos, v)])

    def match_len(self, p: int) -> int:
        m = int(self.lcp[p])
        if m != 8:
            return m
        o = p - int(self.cand[p])
        while True:
            q = p + m
            lim = min(self.nv - q, EXTEND_STEP)
            adv = lim
            if lim > 0:
                ne = np.nonzero(self.d[q:q + lim] != self.d[q - o:q - o + lim])[0]
                if len(ne):
                    adv = int(ne[0])
            m += adv
            if not (adv >= EXTEND_STEP and m < EXTEND_CAP):
                return m

    def seg_walk(self, k: int, i: int, a: int) -> None:
        s, e = self.span(k)
        i0, a0 = i, a
        clean, n, met = s, 0, False
        while i < e:
            p = self.next_match(i, a, e)
            if p < 0:
                i = a + self.next_t(e - a)
                break
            was = bool(self.ms[p])
            self.ms[clean:p] = False
            self.ms[p] = True
            if was:
                met = True
                n += int(self.ms[p:e].sum())
                self.rewalks.append((True, p - i0))
                break
            n += 1
            i = p + self.match_len(p)
            a = i
            clean = p + 1
        if not met:
            self.ms[clean:e] = False
            if self.ent[k] is not None:
                self.rewalks.append((False, e - i0))
            self.ex[k] = (i, a)
        self.ent[k] = (i0, a0)
        self.cnt[k] = n

    def forward(self, st, k):
        """The state past segment k entered with st, where the segment has
        no hit at or past st[0]: the literal run goes on."""
        i, a = st
        _, e = self.span(k)
        return (a + self.next_t(e - a), a) if i < e else st

    def scan(self):
        """(entry of each segment, a segment to re-walk, the lane's exit
        as the walks stand)."""
        st, tg, redo = (0, 0), [], False
        for k in range(self.K):
            tg.append(st)
            if self.last[k] >= 0:
                redo = redo or self.ent[k] != st
                if st[0] <= self.last[k]:
                    st = self.ex[k]
                    continue
            st = self.forward(st, k)
        return tg, redo, st

    def settle(self):
        """(re-walk rounds, walked serially)."""
        for k in range(self.K):
            if self.last[k] >= 0:
                s, _ = self.span(k)
                self.seg_walk(k, s, s)
        rounds = 0
        while True:
            tg, redo, self.exit = self.scan()
            if not redo:
                return rounds, False
            if rounds == ROUND_CAP:
                break
            rounds += 1
            for k in range(self.K):
                if self.last[k] >= 0 and self.ent[k] != tg[k]:
                    self.seg_walk(k, *tg[k])
        st = (0, 0)
        for k in range(self.K):
            if self.last[k] >= 0:
                if self.ent[k] != st:
                    self.seg_walk(k, *st)
                st = self.ex[k]
            else:
                st = self.forward(st, k)
        self.exit = st
        return rounds, True

    def write(self):
        """The records below MAX_SEQS, nseq and anchor."""
        total = sum(self.cnt)
        base = np.concatenate([[0], np.cumsum(self.cnt)[:-1]])
        rec = np.zeros((3, MAX_SEQS), np.int32)
        anchor = self.exit[1]
        for k in range(self.K):
            if self.last[k] < 0:
                continue
            idx = int(base[k])
            i, a = self.ent[k]
            _, e = self.span(k)
            while i < e and idx < MAX_SEQS:
                p = self.next_match(i, a, e)
                if p < 0:
                    break
                m = self.match_len(p)
                rec[:, idx] = p - a, m, p - int(self.cand[p])
                idx += 1
                i = a = p + m
                if idx == MAX_SEQS:
                    anchor = i
        return rec, min(total, MAX_SEQS), anchor, total


def model_lanes(data, cand, lcp, n_valid, K: int = SEGMENTS):
    """The kernel's function and counters on numpy lanes: (ll, ml, off
    (B, MAX_SEQS), nseq, anchor, stats dict as parse_stats() gives it,
    per-lane details)."""
    B, L = data.shape
    tset = skip_set(L)
    rec = np.zeros((3, B, MAX_SEQS), np.int32)
    nseq = np.zeros(B, np.int32)
    anchor = np.zeros(B, np.int32)
    stats = dict(lanes=0, segments=0, rounds_sum=0, rounds_max=0,
                 serial_lanes=0, truncated_lanes=0)
    lanes = []
    for b in range(B):
        nv = int(min(max(int(n_valid[b]), 0), L))
        if nv == 0:
            continue
        m = LaneModel(data[b], cand[b], lcp[b], nv, tset, K)
        rounds, serial = m.settle()
        rec[:, b], nseq[b], anchor[b], total = m.write()
        stats["lanes"] += 1
        stats["segments"] += m.K
        if serial:
            stats["serial_lanes"] += 1
        else:
            stats["rounds_sum"] += rounds
            stats["rounds_max"] = max(stats["rounds_max"], rounds)
        stats["truncated_lanes"] += total > MAX_SEQS
        lanes.append(dict(lane=b, rounds=rounds, serial=serial,
                          total=total, counts=list(m.cnt),
                          rewalks=m.rewalks))
    return rec[0], rec[1], rec[2], nseq, anchor, stats, lanes


# --- inputs ------------------------------------------------------------------

def with_candidates(data, nv):
    """(data, cand, lcp, n_valid) as numpy arrays, cand and lcp from
    find_candidates on the CPU."""
    cand, lcp = find_candidates(torch.from_numpy(data),
                                torch.from_numpy(nv))
    return data, cand.numpy(), lcp.numpy(), nv


def lanes_of(blocks, width=None):
    """Zero-padded lanes of `blocks` (bytes) and their lengths."""
    L = width or max(1024, 1 << (max(map(len, blocks)) - 1).bit_length())
    data = np.zeros((len(blocks), L), np.uint8)
    nv = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        nv[i] = len(b)
    return data, nv


def spanning_lanes(seed: int = 3, L: int = 1 << 15):
    """Lanes whose matches and literal runs span several segments: a
    random unit repeated (one long match over most of the lane), text with
    far copies of earlier stretches, random stretches between repeats (runs
    whose skip has grown), and a lane of random bytes (no match at all)."""
    rng = np.random.default_rng(seed)
    rnd = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta"]
    text = lambda n: b" ".join(words[j] for j in
                               rng.integers(0, 6, n // 5))[:n]
    unit = rnd(3000)
    a = unit * (L // 3000 + 1)
    t = text(6000)
    b = t + rnd(1500) + t[1000:5000] + rnd(9000) + t + text(4000) + t
    c = b"".join(rnd(int(rng.integers(500, 4000))) + text(
        int(rng.integers(200, 3000))) for _ in range(12))
    d = rnd(20000) + text(8000) + unit * 2
    return lanes_of([a[:L], b[:L], c[:L], d[:L], rnd(L)], L)


def cap_lane(seed: int = 7, L: int = 1 << 18):
    """A 256 KiB lane of random 5-byte words from a 64-word vocabulary:
    more than MAX_SEQS records."""
    rng = np.random.default_rng(seed)
    vocab = rng.integers(0, 256, (64, 5), dtype=np.uint8)
    words = vocab[rng.integers(0, 64, L // 5 + 1)].reshape(-1)[:L]
    return lanes_of([words.tobytes()], L)


def serial_lanes(seed: int = 5, L: int = 1 << 15):
    """Lanes whose segments never resynchronise, with their own candidates
    (any 0 <= cand < i and lcp <= n_valid - i is the kernel's input): a hit
    at every position with lcp 5 and offset 1, so a walk takes every fifth
    position from its entry, and a segment of 512 positions moves the
    phase of the next by 3; each round settles one segment, so past
    ROUND_CAP the lane is walked serially. The second lane has a stretch of
    ten segments with no hit (forwarded in closed form), the third takes
    lcp 6 and stops 1,000 bytes short of its width."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (3, L), dtype=np.uint8)
    nv = np.array([L, L, L - 1000], np.int32)
    pos = np.arange(L)[None, :]
    lcp = np.where(pos >= 1, [[5], [5], [6]], 0)
    lcp[1, 10 * 512:20 * 512] = 0
    lcp = np.minimum(lcp, np.maximum(nv[:, None] - pos, 0))
    lcp = np.where(lcp >= MIN_MATCH, lcp, 0).astype(np.int32)
    cand = np.where(lcp > 0, pos - 1, -1).astype(np.int32)
    return data, cand, lcp, nv


def random_lanes(seed: int):
    from test_torch_kernels_cuda import random_blocks

    return random_blocks(seed)


LANE_SETS = {"random31": lambda: with_candidates(*random_lanes(31)),
             "random32": lambda: with_candidates(*random_lanes(32)),
             "spanning": lambda: with_candidates(*spanning_lanes()),
             "cap": lambda: with_candidates(*cap_lane()),
             "serial": serial_lanes}


def plain(data, cand, lcp, nv):
    return [t.numpy() for t in parse_lanes_plain(
        *(torch.from_numpy(x) for x in (data, cand, lcp, nv)))]


_CACHE = {}


def lane_set(name: str):
    if name not in _CACHE:
        _CACHE[name] = LANE_SETS[name]()
    return _CACHE[name]


# --- tests -------------------------------------------------------------------

@pytest.mark.parametrize("K", [SEGMENTS, 4])
@pytest.mark.parametrize("name", ["random31", "random32", "spanning"])
def test_model_matches_plain(name, K):
    args = lane_set(name)
    want = plain(*args)
    ll, ml, off, nseq, anchor, stats, lanes = model_lanes(*args, K=K)
    for got, exp in zip((ll, ml, off, nseq, anchor), want):
        assert np.array_equal(got, exp)
    assert stats["lanes"] == int((args[3] > 0).sum())
    assert stats["truncated_lanes"] == 0
    assert all(r["rounds"] <= ROUND_CAP for r in lanes)


def test_model_spans_segments():
    """The spanning lanes take matches across segment edges and re-walk
    once; the random stretches, longer than ROUND_CAP segments, and the
    segments a long match passes over forward their entry in closed form,
    so no lane is walked serially, at 64 segments or at 4."""
    args = lane_set("spanning")
    _, ml, _, nseq, _, stats, lanes = model_lanes(*args)
    G, K = segments(int(args[3][0]))
    assert K == SEGMENTS and int(ml[0].max()) > 2 * G
    assert [r["rounds"] for r in lanes] == [1, 1, 1, 1, 0]
    assert stats["serial_lanes"] == 0 and nseq[-1] == 0
    assert model_lanes(*args, K=4)[5]["serial_lanes"] == 0


@pytest.mark.parametrize("K", [SEGMENTS, 4])
def test_model_serial_lanes(K):
    """Segments that never resynchronise: past ROUND_CAP rounds every lane
    is walked serially at 64 segments (the records still the plain
    walk's); at 4 segments the rounds settle them."""
    args = lane_set("serial")
    want = plain(*args)
    ll, ml, off, nseq, anchor, stats, lanes = model_lanes(*args, K=K)
    for got, exp in zip((ll, ml, off, nseq, anchor), want):
        assert np.array_equal(got, exp)
    assert int(nseq.min()) > 5000
    if K == SEGMENTS:
        assert stats["serial_lanes"] == 3
    else:
        assert stats["serial_lanes"] == 0 and stats["rounds_max"] == 3


def test_model_cap_lane():
    """More than MAX_SEQS records: the first MAX_SEQS kept, the anchor
    where the serial walk stops."""
    args = lane_set("cap")
    want = plain(*args)
    ll, ml, off, nseq, anchor, stats, lanes = model_lanes(*args)
    for got, exp in zip((ll, ml, off, nseq, anchor), want):
        assert np.array_equal(got, exp)
    assert int(nseq[0]) == MAX_SEQS and lanes[0]["total"] > MAX_SEQS
    assert stats["truncated_lanes"] == 1
    assert int(anchor[0]) < int(args[3][0])


def test_skip_words_follow_the_rule():
    for L in (1024, 4096, 1 << 17, 1 << 18):
        t = np.nonzero(skip_set(L))[0]
        assert t[0] == 0 and t[-1] >= L
        assert np.array_equal(np.diff(t), 1 + (t[:-1] >> 8))
        # the words the kernel requires (zt_parse_lanes checks ntw)
        assert len(skip_words(L)) == (L + (L >> 8) + 1) // 32 + 2


def test_segments_cover_the_lane():
    for nv in (1, 511, 512, 513, 8192, 100000, 131072, 1 << 18):
        for K in (1, 4, 32):
            G, k = segments(nv, K)
            assert G % 32 == 0 and G >= SEG_MIN and k <= K
            assert (k - 1) * G < nv <= k * G


# --- the device-encode corpus ------------------------------------------------

def corpus_lanes():
    """chip_smoke.py's device-encode lanes: make_corpus(8, seed=5), one
    128 KiB block a lane."""
    from chip_smoke import make_corpus

    return with_candidates(*lanes_of(make_corpus(8, seed=5)))


def report(args, K: int) -> str:
    _, _, _, nseq, _, stats, lanes = model_lanes(*args, K=K)
    r = np.array([x["rounds"] for x in lanes if not x["serial"]])
    walks = [w for x in lanes for w in x["rewalks"]]
    met = np.array([n for ok, n in walks if ok])
    worst = max(max(x["counts"]) for x in lanes)
    return (f"K {K} (G {segments(int(args[3].max()), K)[0]}): "
            f"{stats['lanes']} lanes, {int(nseq.sum())} records; re-walk "
            f"rounds a lane mean {r.mean():.4f}, max {int(r.max())}; serial "
            f"lanes {stats['serial_lanes']}; re-walks {len(walks)}, met the "
            f"old chain {len(met)}; positions until they met mean "
            f"{met.mean() if len(met) else 0:.1f}, p99 "
            f"{np.percentile(met, 99) if len(met) else 0:.0f}, max "
            f"{met.max() if len(met) else 0}; most records in a segment "
            f"{worst}")


if __name__ == "__main__":
    ks = [int(a) for a in sys.argv[1:]] or [SEGMENTS]
    args = corpus_lanes()
    for K in ks:
        print(report(args, K), flush=True)
