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

Two functions are hand-written CUDA kernels (csrc/myers.cu), each with a
plain PyTorch version beside it that the wrapper uses for CPU tensors only:

  myers_fwd  replaces the lax.scan body of nextdenovo_tpu/ops/myers.py
             myers_fwd.
  myers_tb   replaces the lax.scan body of myers_tb.

Both are one dependent chain per pair and column, so what bounds a launch
depends on how many pairs it carries.  Up to ~2500 pairs the card's warp
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


def _lsr1(x):
    """band >> 1: bit r+1 -> r; bit 0 of word w+1 -> bit 31 of word w."""
    up = torch.zeros_like(x)
    up[:-1] = x[1:]
    return (x >> 1) | ((up & 1) << 31)


def _lsl1(x):
    """band << 1: bit r -> r+1; bit 31 of word w -> bit 0 of word w+1."""
    dn = torch.zeros_like(x)
    dn[1:] = x[:-1]
    return ((x << 1) & _M32) | (dn >> 31)


def _add(x, y):
    """multiword x + y, the carry rippling up the word axis."""
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[0])
    for k in range(x.shape[0]):
        s = x[k] + y[k] + carry
        out[k] = s & _M32
        carry = s >> 32
    return out


def _row_mask(lo_bit: torch.Tensor, nw: int) -> torch.Tensor:
    """(NW, B): bits r >= lo_bit set (lo_bit (B,) int64)."""
    base = torch.arange(nw, device=lo_bit.device, dtype=torch.int64)[:, None] * 32
    sh = torch.clamp(lo_bit[None, :] - base, 0, 32)
    shifted = torch.full_like(sh, _M32) << torch.clamp(sh, max=31)
    return torch.where(sh >= 32, torch.zeros_like(sh), shifted & _M32)


# ---------------------------------------------------------------------------
# forward


def myers_fwd_plain(win0, qtop, tch, nvec, off, *, nw: int):
    """Plain PyTorch forward pass (any device); see myers_fwd."""
    dev = qtop.device
    n_steps, B = qtop.shape
    rows = torch.arange(nw, device=dev, dtype=torch.int64)[:, None]
    off64 = off.to(torch.int64)
    nvec64 = nvec.to(torch.int64)
    off_w = (off64 >> 5)[None, :]
    off_b = off64 & 31
    VP = _row_mask(off64, nw)
    VN = torch.zeros((nw, B), dtype=torch.int64, device=dev)
    w = [_to_u(win0[c]) for c in range(4)]
    score = torch.zeros(B, dtype=torch.int64, device=dev)
    planes = torch.empty((n_steps, 2, nw, B), dtype=torch.int32, device=dev)
    lastrow = rows == nw - 1
    top = torch.full((), 1 << 31, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(1, n_steps + 1):
        tj = tch[j - 1].to(torch.int64)[None, :]
        qt = qtop[j - 1].to(torch.int64)[None, :]
        Eq = torch.where(tj == 0, w[0], zero)
        for c in (1, 2, 3):
            Eq = Eq | torch.where(tj == c, w[c], zero)
        Eq = Eq & _row_mask(torch.clamp(off64 - j + 1, min=0), nw)
        X = Eq | VN
        D0 = (_add(X & VP, VP) ^ VP) | X
        HN = VP & D0
        HP = VN | ((VP | D0) ^ _M32)
        Xs = _lsr1(D0)
        nmask = _row_mask(torch.clamp(off64 - j, min=0), nw)
        VNn = Xs & HP & nmask
        VPn = (HN | ((Xs | HP) ^ _M32)) & nmask
        act = j <= nvec64
        d0word = torch.where(rows == off_w, D0, zero).sum(dim=0)
        d0bit = (d0word >> off_b) & 1
        score = score + torch.where(act, 1 - d0bit, zero)
        VP = torch.where(act[None, :], VPn, VP)
        VN = torch.where(act[None, :], VNn, VN)
        planes[j - 1, 0] = _to_i32((D0 ^ Eq) ^ _M32)
        planes[j - 1, 1] = _to_i32(VPn)
        # advance the 4 char windows to column j+1: shift down one row,
        # inject the incoming band-bottom char
        for c in range(4):
            inj = torch.where(lastrow & (qt == c), top, zero)
            w[c] = _lsr1(w[c]) | inj
    final = torch.stack([_to_i32(VP), _to_i32(VN)], dim=0)
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
    """Plain PyTorch traceback (any device); see myers_tb."""
    dev = planes.device
    n_max = planes.shape[0]
    B = mvec.shape[0]
    m64, n64, off64 = (x.to(torch.int64) for x in (mvec, nvec, off))
    pos = torch.zeros(B, dtype=torch.int64, device=dev)
    icur = torch.zeros(B, dtype=torch.int64, device=dev)
    alive = torch.zeros(B, dtype=torch.bool, device=dev)
    failed = torch.zeros(B, dtype=torch.bool, device=dev)
    evs = torch.empty((n_max, B), dtype=torch.uint8, device=dev)
    rows = torch.arange(nw, device=dev, dtype=torch.int64)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    full = torch.full((), _M32, dtype=torch.int64, device=dev)
    for j in range(n_max, 0, -1):
        DV = _to_u(planes[j - 1, 0])
        VPp = _to_u(planes[j - 1, 1])
        start = n64 == j
        pos = torch.where(start, m64 - n64 + off64, pos)
        icur = torch.where(start, m64, icur)
        alive = alive | start
        act = alive & ~failed
        # up-move bits in cell coords: up at cell bit r iff not diag-valid
        # and the stored VP plane (window_{j+1} coords) has bit r-1
        U = (DV ^ _M32) & _lsl1(VPp)
        # landing bit f = highest bit <= pos with U=0
        lo_word = (pos >> 5)[None, :]
        part = full >> torch.clamp(31 - (pos & 31), 0, 31)[None, :]
        mask_le = torch.where(rows < lo_word, full,
                              torch.where(rows == lo_word, part, zero))
        M = (U ^ _M32) & mask_le
        nz = M != 0
        hw = torch.where(nz, rows, -1).max(dim=0).values
        wsel = torch.where(nz & (rows == hw[None, :]), M, zero).sum(dim=0)
        v = wsel
        fbit = torch.zeros_like(pos)
        for kk in (16, 8, 4, 2, 1):
            t = (v >> kk) != 0
            fbit = fbit + torch.where(t, kk, 0)
            v = torch.where(t, v >> kk, v)
        f = hw * 32 + fbit
        k = pos - f
        exists = hw >= 0
        f_ok = (f >= 0) & (f < 32 * nw)
        fw = torch.clamp(f >> 5, 0, nw - 1)
        dvw = torch.gather(DV, 0, fw[None, :])[0]
        dvbit = f_ok & (((dvw >> (f & 31)) & 1) != 0)
        i_land = icur - k
        move_diag = dvbit & ~(i_land <= 0)
        bad = act & (~exists | (k > 63) | (k < 0))
        failed = failed | bad
        emit_ok = act & ~bad
        move = torch.where(move_diag, DIAG, LEFT)
        ev_ok = (torch.clamp(k, max=63) << 2) | move
        ev = torch.where(emit_ok, ev_ok & 0xFF,
                         torch.where(act, EV_FAIL, EV_IDLE))
        evs[n_max - j] = ev.to(torch.uint8)
        pos = torch.where(emit_ok, torch.where(move_diag, f, f + 1), pos)
        icur = torch.where(emit_ok,
                           torch.where(move_diag, i_land - 1, i_land), icur)
    ok = alive & ~failed & (icur >= 0)
    return evs, icur.to(torch.int32), ok


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
    """Device-side stream construction from sentinel-padded int8 char
    matrices: per-column text chars, incoming band-bottom query chars, and
    the initial per-character match windows (bit r <-> q[r - off_b]).
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
    # the host side is split into spans: the pads and copies in, the
    # launches, the copies out, the expansion
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
        # sentinel-padded char matrices (int8 keeps the host->device copy
        # small); the per-column streams and initial windows are built on
        # device
        qp_w = int(m.max()) + W + 2
        qpad = np.full((B, qp_w), 4, np.int8)
        tpad = np.full((B, n_pad), 4, np.int8)
        for b in range(B):
            qpad[b, : m[b]] = qs[b]
            tpad[b, : n[b]] = ts[b]

        m_d = torch.from_numpy(m).to(dev)
        n_d = torch.from_numpy(n).to(dev)
        off_d = torch.from_numpy(off).to(dev)
        qtop, tch, win0 = _build_streams(
            torch.from_numpy(qpad).to(dev), torch.from_numpy(tpad).to(dev),
            off_d, nw=nw)
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
