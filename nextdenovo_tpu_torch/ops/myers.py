"""Banded bit-parallel Myers alignment (batched), PyTorch + CUDA.

Counterpart of nextdenovo_tpu/ops/myers.py.  Each 32-bit word holds 32 band
cells; one column update is the Myers 1999 bit-vector recurrence in Hyyro's
banded (sliding-window) form:

    X  = Eq | VN
    D0 = (((X & VP) + VP) ^ VP) | X        (multiword add)
    HN = VP & D0;  HP = VN | ~(VP | D0)
    Xs = D0 >> 1
    VN = Xs & HP;  VP = HN | ~(Xs | HP)

Geometry: callers arrange m >= n (pairs are swapped; ops are transposed
back).  At text column j (1-based) the window covers query rows
i = j - off + r for band bits r in [0, W).  Rows i <= 0 are masked to
Eq=VP=VN=0 (the D(0,j)=j wall); rows i > m run over sentinel padding.

Traceback stores two planes per column — DV = ~(D0 ^ Eq) ("diagonal move
valid", diag-first tie order) and VP — and walks back with integer band
positions: each column consumes a whole UP-run via the highest non-up bit
at or below the current position, then one DIAG/LEFT.  Per column it emits
one event byte (min(k,63)<<2 | move); the host expands events to op strings
(native.expand_events).

Bit-vectors are int32 tensors holding the 32-bit patterns; the layout is
(words, batch) with the batch innermost.

Three functions are hand-written CUDA kernels, each with a plain PyTorch
version beside it that the wrapper uses for CPU tensors only:

  myers_fwd      replaces the lax.scan body of nextdenovo_tpu/ops/myers.py
                 myers_fwd (csrc/myers.cu).
  myers_tb       replaces the lax.scan body of myers_tb (csrc/myers.cu).
  build_streams  replaces the jitted _build_streams: the per-column streams
                 and initial windows from one flat array of the pairs
                 (kernel myers_streams, csrc/streams.cu).

The forward pass and the traceback are one dependent chain per pair and
column, so what bounds a launch depends on how many pairs it carries.  Up
to ~2500 pairs the card's warp
schedulers hold at most one warp each: the launch takes columns x the time of
one column on a lone warp, the same for 640 pairs as for 1280.  The kernels
shorten that column: eight lanes of a warp share a pair (a band word
each), the multiword add resolves its carries across the lanes with two
ballots and one integer add, the match windows are read by one funnel shift
instead of being shifted every column, and nothing on the chain waits for
device memory (the forward pass loads its per-column streams a chunk of 32
columns ahead; the traceback streams the planes through a shared-memory ring
with cp.async, 24 columns ahead of the walk).  Above that the bound becomes
the integer operations executed and then the planes' bytes (8*nw per pair and
column, written once and read once): a block stages whole columns in shared
memory and moves them as aligned rows, for which myers_fwd pads the planes'
rows, and myers_align sizes its sub-batches (max_plane_bytes) so that a
launch is as large as its callers' batches allow.  Neither kernel computes or
moves a plane row above a pair's own last column (myers_fwd_defined).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import _build
from ..device import check_tensor, resolve_device, row_pitch

UP, LEFT, DIAG = 1, 2, 0        # op encoding shared with ops.align
EV_FAIL = 255                   # event byte: band exit / up-run overflow
EV_IDLE = 254                   # event byte: pair not walking this column

_M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# plain multiword helpers: x is (NW, B) int64 holding values in [0, 2^32);
# bit r of the band = word r//32, bit r%32 (LSB = lowest band row)


def _to_u(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _lsr1(x, zrow):
    """band >> 1: bit r+1 -> r; bit 0 of word w+1 -> bit 31 of word w (zrow:
    a (1, B) row of zeros above the top word)."""
    return (x >> 1) | ((torch.cat([x[1:], zrow]) & 1) << 31)


def _lsl1_words(x):
    """band << 1 over the word axis -2 (x (..., NW, B)): bit r -> r+1; bit
    31 of word w -> bit 0 of word w+1."""
    dn = torch.zeros_like(x)
    dn[..., 1:, :] = x[..., :-1, :]
    return ((x << 1) & _M32) | (dn >> 31)


def _add(x, y, sh):
    """multiword x + y over the word axis (sh = arange(NW)[:, None]): each
    word's sum, then the carries into all words at once by look-ahead, as
    the kernel takes them: with G (bit w: word w overflowed) and P (bit w:
    its sum is all ones), the carries are ((G << 1) + P) ^ P.  Equal to the
    carry rippling up word by word."""
    s = x + y
    lo = s & _M32
    G = ((s >> 32) << sh).sum(dim=0)
    P = ((lo == _M32).to(torch.int64) << sh).sum(dim=0)
    C = ((G << 1) + P) ^ P
    return (lo + ((C >> sh) & 1)) & _M32


def _row_mask(lo_bit: torch.Tensor, nw: int) -> torch.Tensor:
    """(..., NW, B): bits r >= lo_bit set (lo_bit (..., B) int64)."""
    base = torch.arange(nw, device=lo_bit.device, dtype=torch.int64)[:, None] * 32
    sh = torch.clamp(lo_bit.unsqueeze(-2) - base, 0, 32)
    shifted = torch.full_like(sh, _M32) << torch.clamp(sh, max=31)
    return torch.where(sh >= 32, torch.zeros_like(sh), shifted & _M32)


# ---------------------------------------------------------------------------
# forward

# columns whose match words the plain forward pass forms at once
EQ_COLUMNS = 256


def _char_streams(win0, qtop, nw: int):
    """The bits that enter each character's match window, as words: entry c
    < 4 holds the initial window (bits 0..W-1, from win0[c]) and then bit
    W + t = (qtop[t] == c), the character injected after column t + 1;
    entry 4, all zeros, serves every other text character.  Column j's
    window of c is bits [j - 1, j - 1 + W) of entry c, as shifting the
    windows down one row a column would leave it.  Returns (words (5 * NS,
    B) int64 in [0, 2^32), NS)."""
    n_steps, B = qtop.shape
    dev = qtop.device
    nq = n_steps // 32 + 2
    ns = nw + nq
    S = torch.zeros((5, ns, B), dtype=torch.int64, device=dev)
    S[:4, :nw] = _to_u(win0)
    qt = torch.full((nq * 32, B), -1, dtype=torch.int64, device=dev)
    qt[:n_steps] = qtop
    chars = torch.arange(4, device=dev, dtype=torch.int64)[:, None, None]
    bits = (qt[None] == chars).to(torch.int64).reshape(4, nq, 32, B)
    shift = torch.arange(32, device=dev, dtype=torch.int64)[:, None]
    S[:4, nw:] = (bits << shift).sum(dim=2)
    return S.reshape(5 * ns, B), ns


def _match_words(S, ns: int, tch, c0: int, c1: int, nw: int):
    """Eq of columns c0 + 1 .. c1 before the row mask: (c1 - c0, NW, B)
    int64, the window of each column's text character (none for a
    character outside 0..3), each word read by a funnel shift of two stream
    words."""
    dev = tch.device
    B = tch.shape[1]
    s = torch.arange(c0, c1, device=dev, dtype=torch.int64)
    tc = tch[c0:c1].to(torch.int64)
    tsel = torch.where((tc >= 0) & (tc < 4), tc, 4)
    word = (s >> 5)[:, None] + torch.arange(nw, device=dev,
                                            dtype=torch.int64)[None, :]
    at = (tsel[:, None, :] * ns + word[:, :, None]).reshape(-1, B)
    lo = torch.gather(S, 0, at).reshape(c1 - c0, nw, B)
    hi = torch.gather(S, 0, at + 1).reshape(c1 - c0, nw, B)
    sh = (s & 31)[:, None, None]
    return (lo >> sh) | ((hi & ((1 << sh) - 1)) << (32 - sh))


def myers_fwd_plain(win0, qtop, tch, nvec, off, *, nw: int):
    """Plain PyTorch forward pass (any device); see myers_fwd.

    The column loop keeps only the recurrence: the match words come from
    _match_words and the row masks (which clear bits only in the columns j
    <= max(off)) are applied to them, EQ_COLUMNS columns at a time; a
    column's D0 goes straight into the planes, whose DV = ~(D0 ^ Eq) and
    the score's bits are taken from them after each chunk."""
    dev = qtop.device
    n_steps, B = qtop.shape
    i64 = torch.int64
    sh = torch.arange(nw, device=dev, dtype=i64)[:, None]
    off64 = off.to(i64)
    VP = _row_mask(off64, nw)
    VN = torch.zeros((nw, B), dtype=i64, device=dev)
    zrow = torch.zeros((1, B), dtype=i64, device=dev)
    act = myers_fwd_defined(nvec, n_steps)
    # columns every pair takes, and the last column whose masks clear a bit
    n_all = int(nvec.min()) if B else 0
    max_off = int(off64.max()) if B else 0
    off_w = (off64 >> 5)[None, None, :]
    d0word = torch.empty((n_steps, B), dtype=i64, device=dev)
    pl = torch.empty((n_steps, 2, nw, B), dtype=i64, device=dev)
    S, ns = _char_streams(win0, qtop, nw)
    for c0 in range(0, n_steps, EQ_COLUMNS):
        c1 = min(c0 + EQ_COLUMNS, n_steps)
        eq = _match_words(S, ns, tch, c0, c1, nw)
        if c0 < max_off:
            # row r: bits of rows i <= 0 of column r + 1 cleared
            r = torch.arange(c0, c1 + 1, device=dev, dtype=i64)[:, None]
            masks = _row_mask(torch.clamp(off64[None, :] - r, min=0), nw)
            k = min(c1, max_off) - c0
            eq[:k] &= masks[:k]
        for j in range(c0 + 1, c1 + 1):
            X = eq[j - 1 - c0] | VN
            D0 = torch.bitwise_or(_add(X & VP, VP, sh) ^ VP, X,
                                  out=pl[j - 1, 0])
            HN = VP & D0
            HP = VN | ((VP | D0) ^ _M32)
            Xs = _lsr1(D0, zrow)
            VNn = Xs & HP
            VPn = torch.bitwise_or(HN, (Xs | HP) ^ _M32, out=pl[j - 1, 1])
            if j <= max_off:
                VNn &= masks[j - c0]
                VPn &= masks[j - c0]
            if j <= n_all:
                VP, VN = VPn, VNn
            else:
                VP = torch.where(act[j - 1], VPn, VP)
                VN = torch.where(act[j - 1], VNn, VN)
        D0c = pl[c0:c1, 0]
        d0word[c0:c1] = torch.gather(
            D0c, 1, off_w.expand(c1 - c0, 1, B))[:, 0]
        D0c ^= eq
        D0c ^= _M32
    d0bit = (d0word >> (off64 & 31)) & 1
    score = torch.where(act, 1 - d0bit, 0).sum(dim=0)
    final = torch.stack([_to_i32(VP), _to_i32(VN)], dim=0)
    # the planes' words lie in [0, 2^32): each one's low 32 bits (the first
    # int32 of its 8 bytes, little-endian as CPUs and GPUs are) are its
    # int32 bit pattern, _to_i32's value, taken in one copy
    planes = pl.view(torch.int32)[..., 0::2].contiguous()
    return score.to(torch.int32), planes, final


def myers_fwd_defined(nvec: torch.Tensor, n_steps: int) -> torch.Tensor:
    """(n_steps, B) bool: the plane rows the forward pass defines — a pair's
    columns j <= nv (row j - 1).  The traceback never reads a row above a
    pair's own last column and the kernel leaves those rows unspecified (the
    plain version writes them)."""
    cols = torch.arange(n_steps, device=nvec.device, dtype=torch.int64)
    return cols[:, None] < nvec.to(torch.int64)[None, :]


def myers_fwd(win0: torch.Tensor, qtop: torch.Tensor, tch: torch.Tensor,
              nvec: torch.Tensor, off: torch.Tensor, *, nw: int):
    """Forward pass.

    win0: (4, NW, B) int32 initial per-character match windows (column 1)
    qtop: (n_max, B) int32 incoming band-bottom query chars per column
    tch:  (n_max, B) int32 text chars per column (4 = past end)
    nvec: (B,) int32 per-pair text lengths
    off:  (B,) int32 per-pair band offset (band bit r <-> i = j - off + r)
    Returns (score (B,) int32 = D(n,n)-track, planes (n_max, 2, NW, B)
    int32 [DV, VP], final (2, NW, B) int32 [VP, VN]).

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    which defines the plane rows myers_fwd_defined marks and no others and
    returns `planes` as the narrow view of a buffer with padded rows."""
    if qtop.device.type == "cpu":
        return myers_fwd_plain(win0, qtop, tch, nvec, off, nw=nw)
    n_steps, B = qtop.shape
    for name, t, shape in (("win0", win0, (4, nw, B)), ("qtop", qtop, (n_steps, B)),
                           ("tch", tch, (n_steps, B)), ("nvec", nvec, (B,)),
                           ("off", off, (B,))):
        check_tensor(name, t, shape, torch.int32, qtop.device)
    if nw != 8:
        raise ValueError(f"the myers_fwd kernel is built for nw = 8, got {nw}")
    dev = qtop.device
    score = torch.empty(B, dtype=torch.int32, device=dev)
    # plane rows are padded to whole 128-byte lines, so the kernels move
    # them 16 bytes a thread whatever B is; callers get the narrow view
    pitch = (B + 31) // 32 * 32
    planes = torch.empty((n_steps, 2, nw, pitch), dtype=torch.int32, device=dev)
    final = torch.empty((2, nw, B), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        rc = lib.ndt_myers_fwd(
            win0.data_ptr(), qtop.data_ptr(), tch.data_ptr(), nvec.data_ptr(),
            off.data_ptr(), score.data_ptr(), planes.data_ptr(),
            final.data_ptr(), n_steps, B, pitch, nw,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("myers_fwd", rc)
    _build.count_launch("myers_fwd", dev)
    return score, planes[..., :B], final


def tail_walk(score: np.ndarray, final: np.ndarray, m: np.ndarray,
              n: np.ndarray, off: np.ndarray) -> np.ndarray:
    """D(m,n) = D(n,n) + vertical deltas of the final column over rows
    n+1..m (final VP/VN are in window_{n+1} coords: bit r <-> i=n+1-off+r).
    Host numpy: final is small ((2, NW, B) uint32)."""
    nw = final.shape[1]
    VP, VN = final[0], final[1]
    d = np.asarray(m - n)
    off = np.asarray(off)
    out = np.asarray(score).copy()
    bitpos = np.arange(32, dtype=np.uint32)
    for w in range(nw):
        lo = w * 32
        # bits r in [off, off+d): within word w -> [off-lo, off-lo+d)
        a = np.clip(off - lo, 0, 32)
        b = np.clip(off - lo + d, 0, 32)
        selm = (bitpos[None, :] >= a[:, None]) & (bitpos[None, :] < b[:, None])
        vp = ((VP[w][:, None].astype(np.uint64) >> bitpos) & 1)
        vn = ((VN[w][:, None].astype(np.uint64) >> bitpos) & 1)
        out += (vp * selm).sum(1).astype(np.int64).astype(np.int32)
        out -= (vn * selm).sum(1).astype(np.int64).astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# traceback


def myers_tb_plain(planes, mvec, nvec, off, *, nw: int):
    """Plain PyTorch traceback (any device); see myers_tb.

    The walk's loop keeps only what depends on the walk: the bits that are
    not up-moves come from the planes EQ_COLUMNS columns at a time, a walk
    starts only at a column some pair ends on, and the landing bit f comes
    with its DV bit as the largest of each word's 2 * (its highest masked
    bit, read from the float64 exponent: exact below 2^53) + that bit's DV
    bit.  A walking pair has pos >= 0, so f <= pos wherever f exists."""
    dev = planes.device
    n_max = planes.shape[0]
    B = mvec.shape[0]
    i64 = torch.int64
    m64, n64, off64 = (x.to(i64) for x in (mvec, nvec, off))
    pos = torch.zeros(B, dtype=i64, device=dev)
    icur = torch.zeros(B, dtype=i64, device=dev)
    alive = torch.zeros(B, dtype=torch.bool, device=dev)
    # walking: alive and not failed
    act = torch.zeros(B, dtype=torch.bool, device=dev)
    ev_all = torch.empty((n_max, B), dtype=i64, device=dev)
    base = torch.arange(nw, device=dev, dtype=i64)[:, None] * 32
    full = torch.full((), _M32, dtype=i64, device=dev)
    idle = torch.full((B,), EV_IDLE, dtype=i64, device=dev)
    ends = set(n64.tolist())
    for c1 in range(n_max, 0, -EQ_COLUMNS):
        c0 = max(c1 - EQ_COLUMNS, 0)
        DVc = _to_u(planes[c0:c1, 0])
        # not an up-move at cell bit r: diag-valid, or no bit r - 1 in the
        # stored VP plane (window_{j+1} coords)
        notU = DVc | (_lsl1_words(_to_u(planes[c0:c1, 1])) ^ _M32)
        for j in range(c1, c0, -1):
            if j in ends:
                start = n64 == j
                pos = torch.where(start, m64 - n64 + off64, pos)
                icur = torch.where(start, m64, icur)
                alive = alive | start
                act = act | start
            # landing bit f = highest bit <= pos that is not an up-move
            M = notU[j - 1 - c0] & (full >> (31 - torch.clamp(pos - base,
                                                               -1, 31)))
            bit = torch.frexp(M.to(torch.float64)).exponent - 1
            dvb = (DVc[j - 1 - c0] >> torch.clamp(bit, min=0)) & 1
            fm = torch.where(M != 0, ((base + bit) << 1) | dvb, -2) \
                .max(dim=0).values
            f = fm >> 1
            k = pos - f
            i_land = icur - k
            md = (fm & 1) * (i_land > 0)
            emit = act & (f >= 0) & (k <= 63)
            ev_all[n_max - j] = torch.where(
                emit, (k << 2) | torch.where(md != 0, DIAG, LEFT),
                torch.where(act, EV_FAIL, idle))
            pos = torch.where(emit, f + 1 - md, pos)
            icur = torch.where(emit, i_land - md, icur)
            act = emit
    ok = act & (icur >= 0)
    return ev_all.to(torch.uint8), icur.to(torch.int32), ok


def myers_tb(planes: torch.Tensor, mvec: torch.Tensor, nvec: torch.Tensor,
             off: torch.Tensor, *, nw: int):
    """Walk back from (m, n) over the stored (DV, VP) planes.

    A pair walks from its own last column n down to column 1.  Per column
    the whole UP-run is consumed, then one DIAG/LEFT.  Emits one event byte
    per (pair, column): min(k,63)<<2 | move.  Returns (events (n_max, B)
    uint8 in scan order (j = n_max..1), i_final (B,) int32, ok (B,) bool).

    CPU tensors run the plain version; CUDA tensors launch the kernel, which
    takes `planes` as myers_fwd returns them (rows 16-byte aligned)."""
    if planes.device.type == "cpu":
        return myers_tb_plain(planes, mvec, nvec, off, nw=nw)
    n_max = planes.shape[0]
    B = mvec.shape[0]
    dev = planes.device
    pitch = row_pitch("planes", planes, (n_max, 2, nw, B), torch.int32, dev)
    for name, t in (("mvec", mvec), ("nvec", nvec), ("off", off)):
        check_tensor(name, t, (B,), torch.int32, dev)
    if nw != 8:
        raise ValueError(f"the myers_tb kernel is built for nw = 8, got {nw}")
    evs = torch.empty((n_max, B), dtype=torch.uint8, device=dev)
    i_f = torch.empty(B, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.uint8, device=dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        rc = lib.ndt_myers_tb(
            planes.data_ptr(), mvec.data_ptr(), nvec.data_ptr(),
            off.data_ptr(), evs.data_ptr(), i_f.data_ptr(), ok.data_ptr(),
            n_max, B, pitch, nw,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("myers_tb", rc)
    _build.count_launch("myers_tb", dev)
    return evs, i_f, ok.to(torch.bool)


def expand_events(evs: np.ndarray, i_final: int, n: int,
                  n_max: int) -> np.ndarray:
    """Events (scan order j=n_max..1) -> op string start->end for one pair.
    The walk visits columns n..1 (rows n_max-n .. n_max-1 of evs); each
    event is k ups then one diag/left, in END->START order; i_final extra
    ups precede everything (column 0)."""
    rows = evs[n_max - n : n_max]
    k = (rows >> 2).astype(np.int64)
    mv = (rows & 3).astype(np.int64)
    # walk order: [k ups, move] per visited column
    reps = np.empty(2 * len(rows), np.int64)
    vals = np.empty(2 * len(rows), np.int64)
    reps[0::2] = k
    reps[1::2] = 1
    vals[0::2] = UP
    vals[1::2] = mv
    ops_rev = np.repeat(vals, reps)
    ops = ops_rev[::-1]
    if i_final > 0:
        ops = np.concatenate([np.full(i_final, UP, np.int64), ops])
    return ops.astype(np.int8)


# ---------------------------------------------------------------------------
# host wrapper


def _build_streams(qpad: torch.Tensor, tpad: torch.Tensor, off: torch.Tensor,
                   *, nw: int):
    """Stream construction from sentinel-padded int8 char matrices, as the
    reference's jitted _build_streams does it: per-column text chars,
    incoming band-bottom query chars, and the initial per-character match
    windows (bit r <-> q[r - off_b]).  The plain part of build_streams.
    Returns (qtop (n_pad, B) int32, tch (n_pad, B) int32, win (4, NW, B)
    int32 bit patterns)."""
    dev = qpad.device
    B, qw = qpad.shape
    n_pad = tpad.shape[1]
    W = 32 * nw
    off64 = off.to(torch.int64)
    tch = tpad.T.to(torch.int32).contiguous()
    # column j injects q[j + W - off_b - 1]
    idx = (torch.arange(1, n_pad + 1, device=dev, dtype=torch.int64)[:, None]
           + (W - 1) - off64[None, :])
    qT = qpad.T.to(torch.int32)
    qtop = torch.gather(qT, 0, torch.clamp(idx, 0, qw - 1)).contiguous()
    r = torch.arange(W, device=dev, dtype=torch.int64)
    k = r[None, :] - off64[:, None]
    chars = torch.where(
        (k >= 0) & (k < qw),
        torch.gather(qpad.to(torch.int64), 1, torch.clamp(k, 0, qw - 1)), 4)
    bitv = (torch.ones((), dtype=torch.int64, device=dev) << (r & 31)
            ).reshape(1, nw, 32)
    cm = chars.reshape(B, nw, 32)
    win = torch.stack([
        _to_i32(torch.where(cm == c, bitv, 0).sum(dim=2).T)
        for c in range(4)]).contiguous()
    return qtop, tch, win


def flat_pairs(qs, ts):
    """The queries, then the texts, in one flat uint8 array, and where each
    begins: (flat, starts (2, B) int64, row 0 the queries', row 1 the
    texts')."""
    B = len(qs)
    lens = np.array([len(x) for x in qs] + [len(x) for x in ts], np.int64)
    flat = np.concatenate([np.asarray(x, np.uint8) for x in qs + ts]) \
        if B else np.zeros(0, np.uint8)
    starts = (np.cumsum(lens) - lens).reshape(2, B)
    return flat, starts


def upload_pairs(qs, ts, m, n, off, dev):
    """The swapped pairs and their (m, n, off) on dev in one copy: a buffer
    of the starts (int64), (m, n, off) (int32) and flat_pairs' characters,
    cut into views.  Returns (flat (uint8), starts (2, B) int64, m, n, off
    (B,) int32)."""
    B = len(qs)
    flat, starts = flat_pairs(qs, ts)
    meta = np.stack([m, n, off]).astype(np.int32)
    buf = np.concatenate([starts.view(np.uint8).ravel(),
                          meta.view(np.uint8).ravel(), flat])
    buf = torch.from_numpy(buf).to(dev)
    m_d, n_d, off_d = buf[16 * B : 28 * B].view(torch.int32).view(3, B) \
        .unbind(0)
    return (buf[28 * B :], buf[: 16 * B].view(torch.int64).view(2, B), m_d,
            n_d, off_d)


def _pad_rows(flat, start, length, width: int):
    """(B, width) int8 rows of `flat` (uint8): row b holds flat[start_b :
    start_b + length_b], then the sentinel 4."""
    dev = flat.device
    src = torch.cat([flat.view(torch.int8),
                     torch.full((1,), 4, dtype=torch.int8, device=dev)])
    col = torch.arange(width, device=dev, dtype=torch.int64)[None, :]
    inside = col < length.to(torch.int64)[:, None]
    return src[torch.where(inside, start[:, None] + col, flat.shape[0])]


def build_streams_plain(qflat, tflat, qstart, tstart, m, n, off, *,
                        nw: int, n_pad=None):
    """Plain version of build_streams (any device): the pads _myers_batch
    once filled row by row — qpad (B, max(m) + W + 2) and tpad (B, n_pad),
    int8, the sentinel 4 past each row's end — made from the flat arrays,
    then _build_streams on them."""
    B = m.shape[0]
    if n_pad is None:
        n_pad = max(int(n.max()), 1) if B else 1
    qw = (int(m.max()) if B else 0) + 32 * nw + 2
    qpad = _pad_rows(qflat, qstart, m, qw)
    tpad = _pad_rows(tflat, tstart, n, n_pad)
    return _build_streams(qpad, tpad, off, nw=nw)


def build_streams(qflat: torch.Tensor, tflat: torch.Tensor,
                  qstart: torch.Tensor, tstart: torch.Tensor,
                  m: torch.Tensor, n: torch.Tensor, off: torch.Tensor, *,
                  nw: int, n_pad=None):
    """The Myers pair's input streams from the pairs as they come: qflat,
    tflat (uint8, any length) hold the (already swapped, m >= n) queries
    and texts, pair b's at qstart[b] / tstart[b] ((B,) int64), m, n, off
    (B,) int32.  n_pad (the columns, max(n.max(), 1)) read from n when not
    given.  Returns (qtop (n_pad, B) int32, tch (n_pad, B) int32, win (4,
    NW, B) int32 bit patterns), what _build_streams returns for the pads of
    the same pairs.

    CPU tensors run the plain version; CUDA tensors launch the myers_streams
    kernel once (csrc/streams.cu)."""
    if qflat.device.type == "cpu":
        return build_streams_plain(qflat, tflat, qstart, tstart, m, n, off,
                                   nw=nw, n_pad=n_pad)
    dev = qflat.device
    B = m.shape[0]
    check_tensor("qflat", qflat, (qflat.shape[0],), torch.uint8, dev)
    check_tensor("tflat", tflat, (tflat.shape[0],), torch.uint8, dev)
    for name, t, dt in (("qstart", qstart, torch.int64),
                        ("tstart", tstart, torch.int64),
                        ("m", m, torch.int32), ("n", n, torch.int32),
                        ("off", off, torch.int32)):
        check_tensor(name, t, (B,), dt, dev)
    if nw != 8:
        raise ValueError(f"the myers_streams kernel is built for nw = 8, "
                         f"got {nw}")
    if n_pad is None:
        n_pad = max(int(n.max()), 1) if B else 1
    qtop = torch.empty((n_pad, B), dtype=torch.int32, device=dev)
    tch = torch.empty((n_pad, B), dtype=torch.int32, device=dev)
    win = torch.empty((4, nw, B), dtype=torch.int32, device=dev)
    if B:
        lib = _build.kernels()
        with torch.cuda.device(dev):
            rc = lib.ndt_myers_streams(
                qflat.data_ptr(), tflat.data_ptr(), qstart.data_ptr(),
                tstart.data_ptr(), m.data_ptr(), n.data_ptr(), off.data_ptr(),
                qtop.data_ptr(), tch.data_ptr(), win.data_ptr(), B, n_pad,
                nw, torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch("myers_streams", rc)
        _build.count_launch("myers_streams", dev)
    return qtop, tch, win


def myers_align(queries: List[np.ndarray], targets: List[np.ndarray],
                nw: int = 8, max_plane_bytes: int = 1 << 32, device=None):
    """Batched banded global alignment; returns list of dicts
    {dist, reached, ok, ops} matching ops.align.band_align.  Pairs are
    swapped internally so m >= n (ops transposed back); the band is
    centered per pair on the (0,0)->(m,n) chord via a per-pair offset.
    Long batches are processed in sub-batches bounding the traceback-plane
    memory (8*nw bytes per pair-column).  The bound is the card's: a pair-
    column gets cheaper with every doubling of a launch up to the 5120 pairs
    of 12288 columns measured on an H100 (planes of 3.75 GiB)."""
    dev = resolve_device(device)
    if len(queries) == 0:
        return []
    if len(queries) > 64:
        n_pad_est = ((max(max(len(q) for q in queries),
                          max(len(t) for t in targets)) + 1023)
                     // 1024) * 1024
        per_pair = n_pad_est * 8 * nw
        b_sub = max(64, int(max_plane_bytes // max(per_pair, 1)) // 64 * 64)
        if len(queries) > b_sub:
            out = []
            for s in range(0, len(queries), b_sub):
                out.extend(_myers_batch(queries[s : s + b_sub],
                                        targets[s : s + b_sub], nw, dev))
            return out
    return _myers_batch(queries, targets, nw, dev)


def _myers_batch(queries, targets, nw: int, dev: torch.device):
    """Forward + traceback + event expansion for one sub-batch."""
    from ..native import expand_events as _native_expand
    from ..utils import span as _tspan

    W = 32 * nw
    B = len(queries)
    # the host side is split into spans: the swap, the copies in and the
    # streams' build, the launches, the copies out, the expansion
    with _tspan("kernel/myers_prep", pairs=B):
        swapped = []
        qs, ts = [], []
        for q, t in zip(queries, targets):
            if len(q) >= len(t):
                qs.append(np.asarray(q, np.uint8))
                ts.append(np.asarray(t, np.uint8))
                swapped.append(False)
            else:
                qs.append(np.asarray(t, np.uint8))
                ts.append(np.asarray(q, np.uint8))
                swapped.append(True)
        m = np.array([len(q) for q in qs], np.int32)
        n = np.array([len(t) for t in ts], np.int32)
        off = np.clip((W - (m - n)) // 2, 16, W - 16).astype(np.int32)
        feasible = ((m - n) < (W - off - 2)) & (n >= 1)
        n_pad = max(int(n.max()), 1)
        # the per-column streams and initial windows are built on the device
        # from one flat array of the characters
        flat_d, starts_d, m_d, n_d, off_d = upload_pairs(qs, ts, m, n, off,
                                                         dev)
        qtop, tch, win0 = build_streams(flat_d, flat_d, starts_d[0],
                                        starts_d[1], m_d, n_d, off_d, nw=nw,
                                        n_pad=n_pad)
    # one launch of each kernel; the span records the launch's shape
    with _tspan("kernel/myers_batch", pairs=B, columns=n_pad):
        score, planes, final = myers_fwd(win0, qtop, tch, n_d, off_d, nw=nw)
        evs, i_f, ok = myers_tb(planes, m_d, n_d, off_d, nw=nw)
        del planes
    with _tspan("kernel/myers_out", pairs=B):
        score = score.cpu().numpy()
        final = final.cpu().numpy().view(np.uint32)
        evs = evs.cpu().numpy()
        i_f = i_f.cpu().numpy()
        okv = ok.cpu().numpy()

    with _tspan("kernel/myers_expand", pairs=B):
        dist = tail_walk(score, final, m, n, off)
        okv = okv & feasible
        sw = np.asarray(swapped, bool)
        # native single-pass expansion (swap applied in C)
        flat, offs = _native_expand(evs, n, i_f, okv, sw)
        flat = flat.view(np.int8)
        res = []
        for b in range(B):
            if okv[b]:
                res.append(dict(dist=int(dist[b]), reached=True, ok=True,
                                ops=flat[offs[b] : offs[b + 1]]))
            else:
                res.append(dict(dist=int(dist[b]), reached=False, ok=False,
                                ops=np.zeros(0, np.int8)))
    return res
