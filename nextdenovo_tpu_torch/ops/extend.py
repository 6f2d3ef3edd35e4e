"""Batched affine-gap (ksw2-class) extension DP, PyTorch + CUDA.

Counterpart of nextdenovo_tpu/ops/extend.py.  Semantics are Gotoh
affine-gap extension alignment:

  H(i,j) = max(H(i-1,j-1) + s(q_i, t_j), E(i,j), F(i,j))
  E(i,j) = max(H(i,j-1) - (gapo+gape), E(i,j-1) - gape)   # gap in query
  F(i,j) = max(H(i-1,j) - (gapo+gape), F(i-1,j) - gape)   # gap in target
  H(0,0) = 0;  H(i,0)/H(0,j) = leading-gap penalties

banded to 128 cells per anti-diagonal a = i + j on the fixed schedule
lo(a) = (a + 1) // 2 - 64 (cell i = lo(a) + lane, j = a - i), i.e. diagonals
j - i within about [-126, +128] of the main one (ksw2's static band).  Like
ksw2_extz both the best extension endpoint (max H over the band) and the
global score at (m, n) are reported; there is no zdrop early exit — callers
drop low-score pairs afterwards.

Best-endpoint tracking is per lane: each lane keeps its best H and the
earliest anti-diagonal where it occurred (strict `>` update); the planes
are reduced once on the host: max over lanes, then the earliest
anti-diagonal, then the lowest lane — the (a, lane) scan order of a scalar
implementation.

One function is a hand-written CUDA kernel (csrc/extend.cu) with its plain
PyTorch version beside it, which the wrapper uses for CPU tensors only:

  ext_fwd   replaces the Pallas kernel _ext_kernel.  One block of 128
            threads per pair, one thread per band lane; H/E/F of the last
            anti-diagonal in double-buffered shared memory, everything
            else in registers; one barrier per anti-diagonal.  Bound by
            operations on this card; a block stops at its pair's last
            anti-diagonal m + n.

Scores are int32; -inf is NINF = -(1 << 28), which leaves room for the gap
penalties subtracted from it along a band edge.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import _build
from ..device import check_tensor, resolve_device

NINF = -(1 << 28)
HALF = 64                 # band: i in [(a+1)//2 - HALF, (a+1)//2 - HALF + 127]
LANES = 128
# pairs of one launch hold at most this many sequence bytes on the device
EXT_BUDGET = 1 << 28


def ext_fwd_plain(qbuf, tbuf, mn, match: int = 2, mism: int = 4,
                  gapo: int = 4, gape: int = 2):
    """Plain PyTorch forward pass (any device); see ext_fwd."""
    dev = qbuf.device
    B, M = qbuf.shape
    N = tbuf.shape[1]
    i32 = torch.int32
    m = mn[:, 0:1].to(i32)
    n = mn[:, 1:2].to(i32)
    q64 = qbuf.to(torch.int64)
    t64 = tbuf.to(torch.int64)
    lane = torch.arange(LANES, device=dev, dtype=i32)[None, :]
    full = torch.full((B, LANES), NINF, dtype=i32, device=dev)
    ninf_col = torch.full((B, 1), NINF, dtype=i32, device=dev)
    h1, h2, ev, fv = full, full, full, full
    best, endv = full, full
    besta = torch.zeros((B, LANES), dtype=i32, device=dev)
    goe = gapo + gape
    a_end = int((m + n).max().item()) if B else -1
    for a in range(a_end + 1):
        i_v = (a + 1) // 2 - HALF + lane
        j_v = a - i_v
        if a % 2 == 0:      # above/F: lane - 1; left/E: same lane
            h_up = torch.cat([ninf_col, h1[:, :-1]], dim=1)
            f_up = torch.cat([ninf_col, fv[:, :-1]], dim=1)
            h_left, e_left = h1, ev
        else:               # left/E: lane + 1; above/F: same lane
            h_left = torch.cat([h1[:, 1:], ninf_col], dim=1)
            e_left = torch.cat([ev[:, 1:], ninf_col], dim=1)
            h_up, f_up = h1, fv
        e_new = torch.maximum(h_left - goe, e_left - gape)
        f_new = torch.maximum(h_up - goe, f_up - gape)
        qc = torch.gather(q64, 1, torch.clamp(i_v - 1, 0, M - 1)
                          .to(torch.int64).expand(B, LANES))
        tc = torch.gather(t64, 1, torch.clamp(j_v - 1, 0, N - 1)
                          .to(torch.int64).expand(B, LANES))
        sub = torch.where(qc == tc, match, -mism).to(i32)
        i0 = i_v == 0
        j0 = j_v == 0
        diag = torch.where(i0 | j0, NINF, h2 + sub)
        e_new = torch.where(j0, NINF, e_new)
        f_new = torch.where(i0, NINF, f_new)
        h_new = torch.maximum(diag, torch.maximum(e_new, f_new))
        h_new = torch.where(i0 & j0, 0, h_new)
        invalid = (i_v < 0) | (i_v > m) | (j_v < 0) | (j_v > n)
        h_new = torch.where(invalid, NINF, h_new).to(i32)
        e_new = torch.where(invalid, NINF, e_new).to(i32)
        f_new = torch.where(invalid, NINF, f_new).to(i32)
        upd = h_new > best
        best = torch.where(upd, h_new, best)
        besta = torch.where(upd, a, besta).to(i32)
        endv = torch.where((i_v == m) & (j_v == n), h_new, endv)
        h2, h1, ev, fv = h1, h_new, e_new, f_new
    return torch.stack([best, besta, endv], dim=1)


def ext_fwd(qbuf: torch.Tensor, tbuf: torch.Tensor, mn: torch.Tensor,
            match: int = 2, mism: int = 4, gapo: int = 4, gape: int = 2):
    """Score-only affine extension over B pairs.

    qbuf: (B, M) uint8 — query codes, q[i-1] at column i-1 (M >= max m)
    tbuf: (B, N) uint8 — target codes, t[j-1] at column j-1 (N >= max n)
    mn:   (B, 2) int32 — (m, n) per pair
    Returns planes (B, 3, 128) int32: per band lane the best H, the
    earliest anti-diagonal holding it, and H at (m, n) (NINF in every lane
    that does not hold that cell).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if qbuf.device.type == "cpu":
        return ext_fwd_plain(qbuf, tbuf, mn, match, mism, gapo, gape)
    dev = qbuf.device
    B, M = qbuf.shape
    N = tbuf.shape[1]
    check_tensor("qbuf", qbuf, (B, M), torch.uint8, dev)
    check_tensor("tbuf", tbuf, (B, N), torch.uint8, dev)
    check_tensor("mn", mn, (B, 2), torch.int32, dev)
    planes = torch.empty((B, 3, LANES), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        rc = lib.ndt_ext_fwd(
            qbuf.data_ptr(), tbuf.data_ptr(), mn.data_ptr(),
            planes.data_ptr(), B, M, N, match, mism, gapo, gape,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("ext_fwd", rc)
    _build.count_launch("ext_fwd", dev)
    return planes


# ----------------------------------------------------------------------------
# host-level wrappers


def pad_for_extend(seqs, width: int) -> np.ndarray:
    """(B, width) uint8 with s[x] at column x; the tail is never read for a
    cell inside the pair's matrix."""
    out = np.zeros((len(seqs), max(1, width)), np.uint8)
    for b, s in enumerate(seqs):
        out[b, : len(s)] = s
    return out


def affine_extend_fwd(queries: List[np.ndarray], targets: List[np.ndarray],
                      match: int = 2, mism: int = 4, gapo: int = 4,
                      gape: int = 2, device=None) -> np.ndarray:
    """The (B, 3, 128) int32 planes [best H, its anti-diagonal, H at (m, n)]
    of every pair, as a numpy array.  Pairs go to the device in sub-batches
    of at most EXT_BUDGET sequence bytes (per-pair results are
    independent)."""
    dev = resolve_device(device)
    B0 = len(queries)
    out = np.zeros((B0, 3, LANES), np.int32)
    s0 = 0
    while s0 < B0:
        s1, width = s0, 0
        while s1 < B0:
            w = max(width, len(queries[s1]) + len(targets[s1]), 2)
            if s1 > s0 and (s1 + 1 - s0) * w > EXT_BUDGET:
                break
            width = w
            s1 += 1
        qs, ts = queries[s0:s1], targets[s0:s1]
        m = np.array([len(q) for q in qs], np.int32)
        n = np.array([len(t) for t in ts], np.int32)
        qbuf = pad_for_extend(qs, int(m.max()))
        tbuf = pad_for_extend(ts, int(n.max()))
        planes = ext_fwd(torch.from_numpy(qbuf).to(dev),
                         torch.from_numpy(tbuf).to(dev),
                         torch.from_numpy(np.stack([m, n], axis=1)).to(dev),
                         match, mism, gapo, gape)
        out[s0:s1] = planes.cpu().numpy()
        s0 = s1
    return out


def affine_extend(queries: List[np.ndarray], targets: List[np.ndarray],
                  match: int = 2, mism: int = 4, gapo: int = 4,
                  gape: int = 2, device=None):
    """ksw2_extz-equivalent batched extension alignment.

    Returns a list of dicts per pair:
      score     best extension score (max H over the banded matrix)
      qe, te    1-based end coordinates of the best extension
      score_end global score at (m, n) (NINF if outside the band)
      reached   whether (m, n) was inside the band

    device=None means the GPU (raises without one); "cpu" runs the plain
    PyTorch version."""
    from ..utils import span as _tspan
    if len(queries) == 0:
        resolve_device(device)
        return []
    cells = sum(len(q) + len(t) + 1 for q, t in zip(queries, targets)) * LANES
    with _tspan("kernel/affine_extend", pairs=len(queries), band_cells=cells):
        planes = affine_extend_fwd(queries, targets, match, mism, gapo, gape,
                                   device=device)
    bh, ba, endh = planes[:, 0], planes[:, 1], planes[:, 2]
    sc = bh.max(axis=1)
    # deterministic tie-break: earliest anti-diagonal, then lowest lane
    cand = bh == sc[:, None]
    a_min = np.where(cand, ba, np.iinfo(np.int32).max).min(axis=1)
    lane = np.argmax(cand & (ba == a_min[:, None]), axis=1)
    i = (a_min + 1) // 2 - HALF + lane
    sc_end = endh.max(axis=1)
    return [dict(score=int(sc[b]), qe=int(i[b]), te=int(a_min[b] - i[b]),
                 score_end=int(sc_end[b]), reached=bool(sc_end[b] > NINF))
            for b in range(len(queries))]
