"""A numpy model of the Huffman kernel's segmented walk (csrc/huffman.cu).

The CUDA kernel cannot run here, so its schedule runs here as a model, step
for step, and is held to huffman_lanes_plain's bytes and ok flags, which are
held in turn to the reference's XLA form (zstd_tpu.ops.huffman.
decode_huffman_lanes):

  - a lane whose table has 1 <= nb <= max_bits on all 2^max_bits entries
    (max_bits >= 1) and whose init_pos lies in [0, 8 * row width] is
    decoded as a linked list of bit positions: p -> p - nb(LUT[bits
    [p, p + max_bits)]) from p0 = init_pos - max_bits;
  - (-max_bits, p0] is cut into K <= 32 segments of at least 64 bits;
    segment 0 starts at p0, segment k at its top; each walks until it leaves
    its segment; then in rounds every segment whose start differs from the
    exit of the segment above re-walks from that exit, until none does;
  - the lane is ok iff the settled chain holds exactly nsym symbols and
    ends exactly at -max_bits; then each segment writes its symbols at the
    prefix sum of the counts before it. Any other live lane is walked
    serially with the plain loop for exactly nsym symbols.

The GPU tests (tests/test_torch_kernels_cuda.py) run the kernel on these
inputs and hold its counters to the model's serial lanes and rounds. Run
as a script it prints, for the first frames of chip_smoke.py's main-path
corpus, the lanes' re-walk rounds and how many symbols a walk started at a
segment's top takes to land on the true chain:

    PYTHONPATH=. python tests/test_torch_huffman_schedule.py [frames]
"""

import sys

import numpy as np
import pytest
import torch

from zstd_tpu_torch.ops.huffman import huffman_lanes_plain

SEG_MIN = 64
WARPS = 32


def _bits(row, init_pos: int, mb: int):
    """bits[x + mb] = bit x of the row for x in [-mb, init_pos + 32): zeros
    below bit 0 and at or past the row's width."""
    top = max(init_pos + 32, 0)
    b = np.unpackbits(row, bitorder="little")[:top].astype(np.int64)
    out = np.zeros(top + mb, np.int64)
    out[mb:mb + len(b)] = b
    return out


def _next(row, init_pos: int, lut, mb: int):
    """(next position, symbol) at every position p in [-mb + 1, p0], as
    arrays indexed by p + mb."""
    p0 = init_pos - mb
    bits = _bits(row, init_pos, mb)
    n = p0 + mb
    state = np.zeros(n, np.int64)
    for t in range(mb):
        state |= bits[1 + t:1 + t + n] << t   # positions -mb + 1 .. p0
    e = lut[state]
    pos = np.arange(-mb + 1, p0 + 1)
    return (np.concatenate([[0], pos - (e >> 8)]),
            np.concatenate([[0], e & 0xFF]))


def _walk(nxt, mb: int, p: int, lo: int):
    """Positions the walk visits from p while p > lo, and its exit."""
    seen = []
    while p > lo:
        seen.append(p)
        p = int(nxt[p + mb])
    return seen, p


def segments(init_pos: int, mb: int):
    """[(hi, lo)] of the kernel's segments: (lo, hi] each."""
    p0 = init_pos - mb
    K = max(1, min(WARPS, init_pos // SEG_MIN))
    seg = (init_pos + K - 1) // K
    return [(p0 - k * seg, -mb if k == K - 1 else p0 - (k + 1) * seg)
            for k in range(K)]


def warp_lane(row, init_pos: int, lut, mb: int):
    """The segmented walk of one lane: (symbols of the settled chain, exit
    of the chain, re-walk rounds)."""
    nxt, sym = _next(row, init_pos, lut, mb)
    segs = segments(init_pos, mb)
    starts = [hi for hi, _ in segs]
    walks = [_walk(nxt, mb, s, lo) for s, (_, lo) in zip(starts, segs)]
    rounds = 0
    while True:
        exits = [w[1] for w in walks]
        redo = [k for k in range(1, len(segs)) if starts[k] != exits[k - 1]]
        if not redo:
            break
        rounds += 1
        for k in redo:   # all read the exits of the round before
            starts[k] = exits[k - 1]
            walks[k] = _walk(nxt, mb, starts[k], segs[k][1])
    chain = [p for w in walks for p in w[0]]
    return sym[np.asarray(chain, np.int64) + mb], walks[-1][1], rounds


def serial_lane(row, init_pos: int, lut, mb: int, n: int):
    """The plain loop: exactly n symbols; (symbols, ok)."""
    bits = np.unpackbits(row, bitorder="little")

    def read(p: int, k: int) -> int:
        v = 0
        for t in range(k):
            x = p - k + t
            if 0 <= x < len(bits):
                v |= int(bits[x]) << t
        return v if p > 0 else 0

    mask = (1 << mb) - 1
    p = init_pos
    ok = p >= 0
    state = read(p, mb)
    p -= mb
    out = np.zeros(n, np.uint8)
    for j in range(n):
        e = int(lut[state & 2047])
        ok = ok and p > -mb
        nb = min((e >> 8) & 0xFF, 32)
        b = read(p, nb)
        p -= nb
        state = ((state << nb) & mask) | b
        out[j] = e & 0xFF
    return out, ok and p == -mb


def model_lanes(streams, init_pos, tid, nsym, dst_frame, dst_off, tables,
                maxbits, lit, frame_ok):
    """The kernel's function, lane by lane, in place on numpy `lit` and
    `frame_ok`; returns {lane: re-walk rounds} of the lanes the warp walk
    decoded and the list of lanes walked serially."""
    n_frames, lit_w = lit.shape
    ls = streams.shape[1]
    rounds, serial = {}, []
    for b in range(streams.shape[0]):
        n = int(nsym[b])
        if n <= 0:
            continue
        t = min(max(int(tid[b]), 0), tables.shape[0] - 1)
        mb = min(max(int(maxbits[t]), 0), 11)
        lut = tables[t].astype(np.int64)
        nb = (lut[:1 << mb] >> 8) & 0xFF
        p = int(init_pos[b])
        f = min(max(int(dst_frame[b]), 0), n_frames - 1)
        off = int(dst_off[b])
        syms = None
        if mb >= 1 and (nb >= 1).all() and (nb <= mb).all() \
                and 0 <= p <= 8 * ls:
            syms, end, r = warp_lane(streams[b], p, lut & 0xFFFF, mb)
            if len(syms) == n and end == -mb:
                rounds[b] = r
            else:
                syms = None
        ok = True
        if syms is None:
            serial.append(b)
            syms, ok = serial_lane(streams[b], p, lut, mb, n)
        d = off + np.arange(n)
        keep = (d >= 0) & (d < lit_w)
        lit[f, d[keep]] = syms[keep]
        if not ok:
            frame_ok[f] = False
    return rounds, serial


def sync_symbols(row, init_pos: int, lut, mb: int):
    """For each segment but the first: the symbols a walk from its top
    takes to land on a position of the true chain from p0."""
    nxt, _ = _next(row, init_pos, lut, mb)
    chain, _ = _walk(nxt, mb, init_pos - mb, -mb)
    on = set(chain)
    out = []
    for hi, lo in segments(init_pos, mb)[1:]:
        p, k = hi, 0
        while p > -mb and p not in on:
            p = int(nxt[p + mb])
            k += 1
        out.append(k)
    return out


# --- inputs ------------------------------------------------------------------

LANE_KEYS = ("huff_streams", "huff_pos", "huff_tid", "huff_nsym",
             "huff_dst_frame", "huff_dst_off", "huff_tables", "huff_maxbits")


def main_lanes(frames: int):
    """The Huffman lanes of the first `frames` frames of chip_smoke.py's
    main-path corpus (FASTEST), as numpy arrays, with the staged literal
    rows."""
    from chip_smoke import make_corpus
    from zstd_tpu_torch.common.config import CompressionLevel
    from zstd_tpu_torch.encoding.frame_enc import compress_to_vec
    from zstd_tpu_torch.models.batch_decoder import BatchDecoder

    payloads = make_corpus(1 + (frames - 1) // 8)[:frames]
    dec = BatchDecoder(device="cpu")
    batch = dec.prepare([bytes(compress_to_vec(p, CompressionLevel.FASTEST))
                         for p in payloads])
    d = dec.stage(batch)
    arrs = {k: d[k].numpy().copy() for k in LANE_KEYS}
    return arrs, d["lit_base"].numpy().copy()


def _encode(lut, mb: int, picks):
    """A stream whose decode under `lut` gives the entries `picks` (LUT
    indices) in order: (stream bytes, init_pos)."""
    nbs = [int(lut[i]) >> 8 & 0xFF for i in picks]
    total = sum(nbs)
    bits = np.zeros(total + 8, np.uint8)
    top = total
    for i, nb in zip(picks, nbs):
        code = int(i) >> (mb - nb)
        top -= nb
        for t in range(nb):
            bits[top + t] = code >> t & 1
    return np.packbits(bits, bitorder="little"), total


def variant(arrs, lit, kind: str, seed: int = 0):
    """A copy of the main lanes with one kind of lane changed, each lane
    given its own literal row (one lane a frame) for the XLA comparison."""
    a = {k: v.copy() for k, v in arrs.items()}
    live = np.nonzero(a["huff_nsym"] > 0)[0]
    rng = np.random.default_rng(seed)
    b = int(live[len(live) // 2])
    t = int(a["huff_tid"][b])
    mb = int(a["huff_maxbits"][t])
    if kind == "flipped_byte":
        a["huff_streams"][b, int(a["huff_pos"][b]) // 16] ^= 0x5A
    elif kind == "init_neg":
        a["huff_pos"][b] = -1
    elif kind == "nsym_plus":
        a["huff_nsym"][b] += 1
    elif kind == "nsym_minus":
        a["huff_nsym"][b] -= 1
    elif kind in ("nb_zero", "nb_over"):
        row = a["huff_tables"][t].copy()
        if kind == "nb_zero":   # the entry of the lane's first state
            p0 = int(a["huff_pos"][b]) - mb
            i = int(_bits(a["huff_streams"][b], p0 + mb, mb)[
                p0 + mb + np.arange(mb)] @ (1 << np.arange(mb)))
            row[i] &= 0xFF
        else:                   # the table read at one bit less
            mb -= 1
        a["huff_tables"] = np.concatenate([a["huff_tables"], row[None]])
        a["huff_maxbits"] = np.append(a["huff_maxbits"], np.int32(mb))
        a["huff_tid"][b] = len(a["huff_maxbits"]) - 1
    elif kind == "short_lanes":
        # a one-symbol lane and lanes of 2-300 symbols (fewer than 32
        # segments), encoded with the batch's own tables
        ls = a["huff_streams"].shape[1]
        for k, lane in enumerate(live[:8]):
            t = int(a["huff_tid"][lane])
            mb = int(a["huff_maxbits"][t])
            m = 1 if k == 0 else int(rng.integers(2, 300))
            stream, pos = _encode(a["huff_tables"][t], mb,
                                  rng.integers(0, 1 << mb, m))
            a["huff_streams"][lane] = 0
            a["huff_streams"][lane, :min(len(stream), ls)] = stream[:ls]
            a["huff_pos"][lane] = pos
            a["huff_nsym"][lane] = m
    else:
        assert kind == "main", kind
    # one literal row per lane, at offset 0
    width = int(a["huff_nsym"].max()) + 8
    a["huff_dst_frame"] = np.arange(len(a["huff_nsym"]), dtype=np.int32)
    a["huff_dst_off"] = np.zeros_like(a["huff_dst_off"])
    return a, np.zeros((len(a["huff_nsym"]), width), np.uint8), b


def run_plain(a, lit):
    t = {k: torch.from_numpy(v) for k, v in a.items()
         if k != "huff_tables"}
    tables = torch.from_numpy(a["huff_tables"].astype(np.int32))
    out = torch.from_numpy(lit.copy())
    ok = torch.ones(lit.shape[0], dtype=torch.bool)
    huffman_lanes_plain(t["huff_streams"], t["huff_pos"], t["huff_tid"],
                        t["huff_nsym"], t["huff_dst_frame"],
                        t["huff_dst_off"], tables, t["huff_maxbits"], out, ok)
    return out.numpy(), ok.numpy()


def run_model(a, lit):
    out = lit.copy()
    ok = np.ones(lit.shape[0], bool)
    rounds, serial = model_lanes(
        a["huff_streams"], a["huff_pos"], a["huff_tid"], a["huff_nsym"],
        a["huff_dst_frame"], a["huff_dst_off"],
        a["huff_tables"].astype(np.int32), a["huff_maxbits"], out, ok)
    return out, ok, rounds, serial


def run_xla(a):
    """decode_huffman_lanes on the live lanes: (literals, ok) by lane (jax
    is imported here: the GPU tests use this module's inputs without it)."""
    import jax.numpy as jnp

    from zstd_tpu.ops.huffman import decode_huffman_lanes

    live = np.nonzero(a["huff_nsym"] > 0)[0]
    lits, ok = decode_huffman_lanes(
        *[jnp.asarray(a[k][live]) for k in ("huff_streams", "huff_pos",
                                            "huff_tid")],
        jnp.asarray(a["huff_tables"]), jnp.asarray(a["huff_maxbits"]),
        jnp.asarray(a["huff_nsym"][live]), int(a["huff_nsym"].max()))
    return live, np.asarray(lits), np.asarray(ok)


@pytest.fixture(scope="module")
def main2():
    return main_lanes(2)


KINDS = ["main", "flipped_byte", "init_neg", "nsym_plus", "nsym_minus",
         "nb_zero", "nb_over", "short_lanes"]
# does the changed lane take the serial path (None: either), and is it ok
SERIAL = {"main": False, "flipped_byte": None, "init_neg": True,
          "nsym_plus": True, "nsym_minus": True, "nb_zero": True,
          "nb_over": True, "short_lanes": False}
OK = {"main": True, "flipped_byte": None, "init_neg": False,
      "nsym_plus": False, "nsym_minus": False, "nb_zero": False,
      "nb_over": False, "short_lanes": True}


@pytest.mark.parametrize("kind", KINDS)
def test_model_matches_plain_and_xla(main2, kind):
    a, lit, b = variant(*main2, kind)
    want, want_ok = run_plain(a, lit)
    got, ok, rounds, serial = run_model(a, lit)
    assert np.array_equal(got, want)
    assert np.array_equal(ok, want_ok)
    live, lits, xok = run_xla(a)
    for k, lane in enumerate(live):
        n = int(a["huff_nsym"][lane])
        assert np.array_equal(want[lane, :n], lits[k, :n]), lane
        assert bool(want_ok[lane]) == bool(xok[k]), lane
    # which lanes take the serial path
    if SERIAL[kind] is not None:
        assert serial == ([b] if SERIAL[kind] else [])
    else:   # a flipped byte may or may not break the lane's chain
        assert serial in ([], [b]) and (b in serial) == (not ok[b])
    if OK[kind] is not None:
        assert ok.all() == OK[kind]
    assert len(rounds) + len(serial) == len(live) > 4
    assert max(rounds.values()) <= WARPS


def test_short_lanes_have_fewer_segments(main2):
    a, lit, _ = variant(*main2, "short_lanes")
    live = np.nonzero(a["huff_nsym"] > 0)[0][:8]
    assert int(a["huff_nsym"][live[0]]) == 1
    ks = [len(segments(int(a["huff_pos"][b]),
                       int(a["huff_maxbits"][a["huff_tid"][b]])))
          for b in live]
    assert ks[0] == 1 and max(ks) < WARPS


def test_segments_cover_the_lane():
    for init_pos, mb in [(0, 11), (11, 11), (63, 8), (64, 1), (2047, 11),
                         (2048, 11), (65000, 11), (65536, 10)]:
        segs = segments(init_pos, mb)
        assert segs[0][0] == init_pos - mb and segs[-1][1] == -mb
        assert all(lo == nxt_hi for (_, lo), (nxt_hi, _) in
                   zip(segs, segs[1:]))
        assert len(segs) <= WARPS
        if len(segs) > 1:
            assert min(hi - lo for hi, lo in segs) >= mb


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    arrs, lit = main_lanes(n)
    out = lit.copy()
    ok = np.ones(lit.shape[0], bool)
    live = np.nonzero(arrs["huff_nsym"] > 0)[0]
    rounds, serial = model_lanes(*[arrs[k] for k in LANE_KEYS[:6]],
                                 arrs["huff_tables"].astype(np.int32),
                                 arrs["huff_maxbits"], out, ok)
    sync = []
    for b in live:
        t = int(arrs["huff_tid"][b])
        sync += sync_symbols(arrs["huff_streams"][b], int(arrs["huff_pos"][b]),
                             arrs["huff_tables"][t].astype(np.int64),
                             int(arrs["huff_maxbits"][t]))
    r = np.asarray(list(rounds.values()))
    nsym = arrs["huff_nsym"][live]
    print(f"{n} main-path frames: {len(live)} Huffman lanes, "
          f"{int(nsym.sum())} symbols ({nsym.mean():.1f} a lane, max "
          f"{int(nsym.max())}, min {int(nsym.min())}); serial lanes "
          f"{len(serial)}; re-walk rounds a lane mean {r.mean():.4f}, max "
          f"{int(r.max())}; {len(sync)} segments below the first: symbols "
          f"to reach the true chain mean {np.mean(sync):.2f}, p99 "
          f"{np.percentile(sync, 99):.0f}, max {max(sync)}; all ok "
          f"{bool(ok.all())}")
