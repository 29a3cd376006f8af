"""Device match finding for the Fastest encode level.

Port of zstd_tpu/ops/match_finder.py. The work splits as in the reference:

  plain torch (vectorised, batched over block lanes; XLA in the reference):
    1. hash every 5-byte window (multiplicative hash, HASH_BITS buckets)
    2. candidate[i] = most recent previous position with the same hash —
       the "previous equal element" problem, solved with one sort of the
       composite key (hash, position) per lane
    3. lcp8[i] = length of the common prefix of data[i:] / data[cand:]
       capped at 8 (two 4-byte windows + XOR + trailing equal bytes)

  CUDA kernel (csrc/parse.cu, a cluster of two CTAs per lane, a warp a
  segment; a Pallas kernel in the reference, `_parse_kernel`):
    4. greedy parse: walk positions left to right; take a match when
       lcp >= MIN_MATCH (extending 8-capped matches byte-equal up to the
       valid end in whole 128-byte steps), else advance with the
       reference's literal-run skip acceleration. Emits (ll, ml, offset)
       records per lane. The kernel walks up to SEGMENTS segments of a
       lane at once and re-walks each from the exit of the one above until
       they agree (a walk is in step with another once both take a match
       at the same position; a segment with no hit left forwards its
       entry in closed form); `parse_stats()` reads its counters of the
       last call.

`parse_lanes` launches the kernel for CUDA tensors and runs
`parse_lanes_plain` (a serial walk of each lane on host copies: the parse
is serial by nature) for CPU tensors. The reference's POS_CHUNK chunking
and 128-lane row loads are TPU layout and do not change the result, so
they are not carried over. Padding past n_valid and the batch width change
no result either: lcp is capped at n_valid - pos and the extension stops at
n_valid.

The parse semantics are the reference's own (not a byte-for-byte clone of
the host matcher): output streams are validated by round trip, libzstd
interop and compressed size.
"""

import numpy as np
import torch

from zstd_tpu_torch.common.trace import scope
from zstd_tpu_torch.ops import _kernels

MIN_MATCH = 5
HASH_BITS = 16
_PRIME = 2654435761
_PRIME5 = 0x9E3779B1
MAX_SEQS = 32768     # emitted records cap per lane
EXTEND_STEP = 128    # bytes compared per extension step
EXTEND_CAP = 1 << 20  # no extension step starts at or past this length
M32 = 0xFFFFFFFF
# the kernel's constants (csrc/parse.cu), for its schedule model
SEGMENTS = 64         # segments (a warp each) a lane, at most
SEG_MIN = 512         # least positions a segment
ROUND_CAP = 8         # re-walk rounds before a lane is walked in order


def find_candidates(data, n_valid):
    """data (B, L) uint8, n_valid (B,) int32 -> (cand (B, L) int32,
    lcp8 (B, L) int32).

    cand[i] = latest j < i with hash5(j) == hash5(i) (-1 if none);
    lcp8[i] = common-prefix length of data[i:]/data[cand[i]:], capped at 8
    and at n_valid - i; both -1/0 beyond n_valid - MIN_MATCH."""
    B, L = data.shape
    dev = data.device
    bp = torch.cat([data.long(), torch.zeros((B, 8), dtype=torch.int64,
                                             device=dev)], dim=1)
    w4 = (bp[:, :L] | (bp[:, 1:L + 1] << 8) | (bp[:, 2:L + 2] << 16)
          | (bp[:, 3:L + 3] << 24))
    b5 = bp[:, 4:L + 4]
    # u32 products: int64 multiplication wraps, the low 32 bits are exact
    h = ((w4 * _PRIME) & M32) ^ ((b5 * _PRIME5) & M32)
    h = h >> (32 - HASH_BITS)                                   # (B, L)

    pos = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    nv = n_valid.long()[:, None]
    valid = pos <= nv - MIN_MATCH
    key = torch.where(valid, h, 1 << HASH_BITS)                # invalid last

    # previous same-hash position: sort by (hash, position), then look at
    # the neighbour (the reference's stable argsort)
    order = torch.sort((key << 32) | pos, dim=1).values & M32
    key_s = key.gather(1, order)
    prev_pos = torch.cat([torch.full((B, 1), -1, dtype=torch.int64,
                                     device=dev), order[:, :-1]], dim=1)
    same = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                      key_s[:, 1:] == key_s[:, :-1]], dim=1)
    cand_sorted = torch.where(same, prev_pos, -1)
    cand = torch.empty_like(cand_sorted).scatter_(1, order, cand_sorted)
    cand = torch.where(valid, cand, -1)

    # lcp capped at 8 via two 4-byte windows at i and cand
    w4b = (bp[:, 4:L + 4] | (bp[:, 5:L + 5] << 8) | (bp[:, 6:L + 6] << 16)
           | (bp[:, 7:L + 7] << 24))
    safe = cand.clamp(min=0)
    x0 = w4 ^ w4.gather(1, safe)
    x1 = w4b ^ w4b.gather(1, safe)

    def tz_bytes(x):
        """Equal low bytes of x == 0 per byte, up to 4."""
        return (((x & 0xFF) == 0).long() + ((x & 0xFFFF) == 0).long()
                + ((x & 0xFFFFFF) == 0).long() + (x == 0).long())

    lcp = torch.where(x0 == 0, 4 + tz_bytes(x1), tz_bytes(x0))
    lcp = torch.where(cand >= 0, lcp, 0)
    # matches may not run past the valid end
    lcp = torch.minimum(lcp, (nv - pos).clamp(min=0))
    return cand.to(torch.int32), lcp.to(torch.int32)


def _parse_lane(d: bytes, cand: list, lcp: list, nv: int):
    """One lane's greedy parse (the reference's `_parse_kernel` walk)."""
    ll, ml, off = [], [], []
    i = anchor = 0
    while i < nv and len(ll) < MAX_SEQS:
        lc, cd = lcp[i], cand[i]
        if lc >= MIN_MATCH and cd >= 0:
            o = i - cd
            m = lc
            go = m == 8  # only an 8-capped match may extend
            while go:
                p = i + m
                lim = min(nv - p, EXTEND_STEP)
                adv = lim
                if lim > 0:
                    a, b = d[p:p + lim], d[p - o:p - o + lim]
                    if a != b:
                        adv = next(j for j in range(lim) if a[j] != b[j])
                m += adv
                go = adv >= EXTEND_STEP and m < EXTEND_CAP
            ll.append(i - anchor)
            ml.append(m)
            off.append(o)
            i += m
            anchor = i
        else:
            # literal-run acceleration a la the reference skip_matching
            i += 1 + ((i - anchor) >> 8)
    return ll, ml, off, anchor


def _check(data, cand, lcp, n_valid):
    dev = data.device
    _kernels.require(data, "data", torch.uint8, 2, dev)
    B, L = data.shape
    for name, t in (("cand", cand), ("lcp", lcp)):
        _kernels.require(t, name, torch.int32, 2, dev)
        if tuple(t.shape) != (B, L):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {(B, L)}")
    _kernels.require(n_valid, "n_valid", torch.int32, 1, dev)
    if n_valid.shape[0] != B:
        raise ValueError(f"n_valid: {n_valid.shape[0]} lanes, expected {B}")


def parse_lanes_plain(data, cand, lcp, n_valid):
    """Plain version of the parse kernel: each lane walked serially on host
    copies. Returns (ll, ml, off) (B, MAX_SEQS) int32 (zero past nseq),
    nseq (B,) int32 and anchor (B,) int32 on data's device."""
    _check(data, cand, lcp, n_valid)
    B, L = data.shape
    data_h = data.cpu().numpy()
    cand_h = cand.cpu().numpy()
    lcp_h = lcp.cpu().numpy()
    nv_h = n_valid.cpu().numpy().clip(0, L)
    rec = np.zeros((3, B, MAX_SEQS), np.int32)
    meta = np.zeros((2, B), np.int32)
    for b in range(B):
        nv = int(nv_h[b])
        ll, ml, off, anchor = _parse_lane(
            data_h[b, :nv].tobytes(), cand_h[b, :nv].tolist(),
            lcp_h[b, :nv].tolist(), nv)
        n = len(ll)
        rec[:, b, :n] = (ll, ml, off)
        meta[:, b] = n, anchor
    dev = data.device
    ll, ml, off = (torch.from_numpy(rec[k]).to(dev) for k in range(3))
    nseq, anchor = (torch.from_numpy(meta[k]).to(dev) for k in range(2))
    return ll, ml, off, nseq, anchor


def skip_words(L: int) -> np.ndarray:
    """The skip set T of the literal-run rule (t_0 = 0, t_k+1 = t_k + 1 +
    (t_k >> 8): the offsets from anchor a literal run visits) as a bitmap
    of uint32 words, through the first t >= L, with a word to spare."""
    n = (L + (L >> 8) + 1) // 32 + 2
    bits = np.zeros(32 * n, np.uint8)
    t = 0
    while t < 32 * n:
        bits[t] = 1
        t += 1 + (t >> 8)
    return np.packbits(bits, bitorder="little").view("<u4")


_SKIP = {}


def _skip_tensor(L: int, device):
    """skip_words(L) on `device`, made once per width and device."""
    key = (L, str(device))
    if key not in _SKIP:
        _SKIP[key] = torch.from_numpy(
            skip_words(L).view(np.int32).copy()).to(device)
    return _SKIP[key]


def parse_buffers(data):
    """The parse kernel's outputs (ll, ml, off, nseq, anchor), its skip-set
    bitmap, scratch (extended match lengths by position, then the bitmaps
    of a lane too wide for shared memory) and counters, for CUDA lanes
    `data` (B, L)."""
    B, L = data.shape
    dev = data.device
    out = tuple(torch.zeros((B, MAX_SEQS), dtype=torch.int32, device=dev)
                for _ in range(3)) + tuple(
        torch.empty((B,), dtype=torch.int32, device=dev) for _ in range(2))
    scratch = torch.empty((B, L + 2 * ((L + 31) // 32)), dtype=torch.int32,
                          device=dev)
    stats = torch.zeros((len(STAT_KEYS),), dtype=torch.int64, device=dev)
    return out, _skip_tensor(L, dev), scratch, stats


def parse_lanes(data, cand, lcp, n_valid):
    """Greedy-parse B block lanes from their candidates: the CUDA kernel for
    CUDA tensors, parse_lanes_plain for CPU tensors. data (B, L) uint8,
    cand / lcp (B, L) int32 from find_candidates, n_valid (B,) int32.
    Returns (ll, ml, off) (B, MAX_SEQS) int32 (zero past nseq), nseq (B,)
    int32, anchor (B,) int32 (literals from anchor to n_valid are the
    trailing run)."""
    if not _kernels.on_cuda(data):
        return parse_lanes_plain(data, cand, lcp, n_valid)
    _check(data, cand, lcp, n_valid)
    B, L = data.shape
    out, tb, scratch, stats = parse_buffers(data)
    _kernels.launch("parse", data, L, cand, lcp, n_valid, B, *out, tb,
                    tb.numel(), scratch, stats)
    parse_lanes.launches += 1
    parse_lanes.last_stats = stats
    return out


parse_lanes.launches = 0
parse_lanes.last_stats = None

STAT_KEYS = ("lanes", "segments", "rounds_sum", "rounds_max",
             "serial_lanes", "truncated_lanes")


def parse_stats(stats=None) -> dict:
    """The kernel's counters of the last CUDA call of parse_lanes (or of a
    `stats` tensor from parse_buffers; waits for the device): lanes with
    bytes, their segments, the re-walk rounds of the lanes settled without
    the serial walk (sum and max), lanes walked serially, and lanes with
    more than MAX_SEQS records."""
    s = parse_lanes.last_stats if stats is None else stats
    if s is None:
        return {}
    return dict(zip(STAT_KEYS, s.tolist()))


def parse_blocks(data, n_valid):
    """find_candidates then parse_lanes: the device match finder, each
    stage in its trace scope."""
    with scope("find_candidates"):
        cand, lcp = find_candidates(data, n_valid)
    with scope("parse"):
        return parse_lanes(data, cand, lcp, n_valid)


def parse_blocks_plain(data, n_valid):
    """find_candidates then parse_lanes_plain (the CPU twin)."""
    cand, lcp = find_candidates(data, n_valid)
    return parse_lanes_plain(data, cand, lcp, n_valid)
