"""Batched banded global alignment (edit distance + traceback), PyTorch +
CUDA.

Counterpart of nextdenovo_tpu/ops/align.py.  `band_align` runs two tiers:
the bit-parallel banded Myers aligner first (ops/myers.py), then, for the
pairs that left its band, an anti-diagonal wavefront DP with an adaptive
band of W = 256 cells:

  * cells (i, j) on anti-diagonal a = i + j depend only on wavefronts a-1 /
    a-2, so a whole band of cells is computed per step;
  * the band start `lo` (lowest row index i in the band) is planned once
    per PACK = 16 anti-diagonals: it moves toward the half of the band
    holding the current minimum by clip(argmin - W/2, 0, 16) single steps,
    and is clamped so the final cell (m, n) is always reached;
  * traceback decisions (2 bits/cell: 0=diag, 1=up/consume-q, 2=left/
    consume-t; ties DIAG > UP > LEFT) are packed 16 anti-diagonals per
    int32 word, tb[pair][word][cell]; `lo` is stored per anti-diagonal.

Unit costs are edit distance (mismatch=1, gap=1).  `band_align_native`
is the native host aligner for callers that name it; band_align never
routes to it.

`band_align(R=1)` runs the narrow tier instead: a band of W = 128 cells on
a FIXED in-word cadence lo(s) = base + (s + 1) // 2 shared by every pair,
re-centred once per 16-step word by shifting the wavefronts by
delta = clip(argmin - 64, -8, 8) lanes (clamped so that (m, n) stays
reachable); only the word's base is stored, and the traceback applies the
matching lane correction at each word boundary.  Word-boundary adaptation
makes this tier slightly inexact on short pairs.

Four functions are hand-written CUDA kernels (csrc/wave.cu,
csrc/wave_fast.cu), each with a plain PyTorch version beside it that the
wrapper uses for CPU tensors only:

  wave_fwd  replaces the Pallas kernel _fwd_kernel (R = 2) of
            nextdenovo_tpu/ops/align.py.  One warp per pair, lane l holding
            band cells 8l .. 8l+7 in registers; the band shifts by 0 or 1 a
            step, so one shuffle a step brings the cell across a lane edge,
            and no block barrier is needed.  Every lane plans the band from
            a lane-then-shuffle argmin; words that touch no matrix edge run
            with the shift fixed at compile time; codes are staged a word
            ahead as bytes in shared memory.  Bound by operations on this
            card (8 int32 operations for each of the 256 cells of an
            anti-diagonal, ahead of the 64 B of decisions it must write); a
            warp stops at its own pair's last word and writes lo past it as
            0, so the wrapper allocates no zeroed buffer.
  wave_tb   replaces the Pallas kernel _tb_kernel (R = 2).  One warp per
            pair walks back from (m, n), all 32 lanes redundantly; the word
            rows (1 KB of decisions + 64 B of lo) stream ahead of the walk
            through a cp.async ring of 8 words in shared memory, so a step
            waits on one shared load, not on device memory; the next lane
            is picked among three formed while that load is in flight.
            Bound by the walk (one op a step, each waiting on the last, at
            one warp's issue rate), not by bytes.  Exact as wave_tb_plain
            on any tb/lo, band exits included; it reads no word above
            (m + n) // 16 and writes every byte of ops.

  wave_fast_fwd  replaces the Pallas kernel _fwd_kernel_fast (R = 1).
            One warp per pair, lane l holding band cells 4l .. 4l+3 of the
            last two wavefronts in registers; under the fixed cadence the
            neighbours are static (UP lane - 1 on even steps, LEFT lane + 1
            on odd ones), so one shuffle a step brings the cell across a
            lane edge, and no block barrier is needed.  Every lane plans
            the re-centring from a lane-then-warp argmin and shifts both
            wavefronts through a guarded shared buffer; a word's codes are
            staged a word ahead as bytes in shared memory; words that touch
            no matrix edge run without the edge tests.  Bound by
            operations, like wave_fwd at half the cells; a warp stops at its
            own pair's last word and writes base past it as 0, so the
            wrapper allocates no zeroed buffer.
  wave_fast_tb   replaces the Pallas kernel _tb_onehot_kernel (R = 1).
            The reference's one-hot lane vector is a serial walk: one warp
            per pair steps (word, step, lane) back from (m, n), all 32 lanes
            redundantly, as wave_tb does; the 512 B word rows and their
            bases stream ahead of the walk through a cp.async ring in
            shared memory.  The lane moves are static under the fixed
            cadence, so a step is one shared load and a pick among three
            addresses, and OP_NONE sentinel words beside each ring row stop
            a walk that steps out of the band without a bound test.  Bound
            by the walk, not by bytes; it writes every byte of ops.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import _build
from ..device import check_tensor, resolve_device
from .myers import _to_i32, myers_align

INF = 1 << 28
LANES = 128
PACK = 16           # anti-diagonal steps packed per tb int32 word
BAND_W = 256        # band cells per pair (the reference's R = 2 tier)
FAST_W = 128        # band cells per pair of the fixed-cadence R = 1 tier
T_FRONT = 24        # front sentinel pad of the R = 1 reversed-target buffer

OP_DIAG, OP_UP, OP_LEFT, OP_NONE = 0, 1, 2, 3


# ----------------------------------------------------------------------------
# forward


def wave_fwd_defined(mn: torch.Tensor, n_words: int) -> torch.Tensor:
    """(B, n_words) bool: the traceback words the forward pass defines — a
    pair's words up to the one holding its last anti-diagonal m + n.  Words
    past it are never read by the traceback and are left unspecified by the
    kernel (the plain version zeroes them)."""
    end = (mn[:, 0] + mn[:, 1]).to(torch.int64)
    last = torch.clamp(end // PACK, max=n_words - 1)
    words = torch.arange(n_words, device=mn.device, dtype=torch.int64)
    return words[None, :] <= last[:, None]


def _lowest_argmin(v, widx, W):
    """(min value, lowest index holding it) along dim 1."""
    best_v = v.min(dim=1).values
    best_w = torch.where(v == best_v[:, None], widx, W).min(dim=1).values
    return best_v, best_w


def wave_fwd_plain(qpad, rtpad, mn, n_words: int):
    """Plain PyTorch forward pass (any device); see wave_fwd."""
    dev = qpad.device
    B, QP = qpad.shape
    TP = rtpad.shape[1]
    W = BAND_W
    a_max = n_words * PACK
    m = mn[:, 0].to(torch.int64)
    n = mn[:, 1].to(torch.int64)
    end = m + n
    last_word = torch.clamp(end // PACK, max=n_words - 1)
    q64 = qpad.to(torch.int64)
    rt64 = rtpad.to(torch.int64)
    widx = torch.arange(W, device=dev, dtype=torch.int64)[None, :]
    v1 = torch.full((B, W), INF, dtype=torch.int64, device=dev)
    v2 = v1.clone()
    lo_m1 = torch.zeros(B, dtype=torch.int64, device=dev)
    lo_m2 = torch.zeros(B, dtype=torch.int64, device=dev)
    tb = torch.zeros((B, n_words, W), dtype=torch.int32, device=dev)
    lo_out = torch.zeros((B, a_max), dtype=torch.int32, device=dev)
    dist = torch.full((B,), INF, dtype=torch.int64, device=dev)
    reached = torch.zeros(B, dtype=torch.bool, device=dev)
    guard = torch.full((B, 1), INF, dtype=torch.int64, device=dev)
    n_run = int(last_word.max().item()) + 1 if B else 0
    for word in range(n_run):
        live = word <= last_word
        # per-word band plan: shift budget from the wavefront argmin
        # (lowest index on ties), per-step geometric clamps applied exactly
        best_v, best_w = _lowest_argmin(v1, widx, W)
        s_total = torch.clamp(best_w - W // 2, 0, PACK)
        s_total = torch.where(best_v >= INF, 0, s_total)
        bits = torch.zeros((B, W), dtype=torch.int64, device=dev)
        for s in range(PACK):
            a = word * PACK + s
            s_ad = (s_total > s).to(torch.int64)
            lo_a = torch.clamp(torch.maximum(lo_m1 + s_ad, a - n), min=0)
            lo_a = torch.minimum(torch.minimum(lo_a, m), lo_m1 + 1)
            s1 = (lo_a - lo_m1)[:, None]
            s2 = (lo_a - lo_m2)[:, None]
            lo_out[:, a] = torch.where(live, lo_a, 0).to(torch.int32)
            # predecessors: diag at w + s2 - 1 of wavefront a-2; up at
            # w + s1 - 1 and left at w + s1 of wavefront a-1; cells outside
            # the band read INF (the guard columns)
            v1p = torch.cat([guard, v1, guard], dim=1)
            v2p = torch.cat([guard, v2, guard], dim=1)
            ok1 = (s1 >= 0) & (s1 <= 1)
            ok2 = (s2 >= 0) & (s2 <= 2)
            diag = torch.where(
                ok2, torch.gather(v2p, 1, torch.clamp(widx + s2, 0, W + 1)), INF)
            up = torch.where(
                ok1, torch.gather(v1p, 1, torch.clamp(widx + s1, 0, W + 1)), INF)
            left = torch.where(
                ok1, torch.gather(v1p, 1, torch.clamp(widx + s1 + 1, 0, W + 1)),
                INF)
            i_v = lo_a[:, None] + widx
            j_v = a - i_v
            qc = torch.gather(q64, 1, torch.clamp(i_v, 0, QP - 1))
            tc = torch.gather(rt64, 1,
                              torch.clamp(n[:, None] - j_v + 1, 0, TP - 1))
            cd = diag + (qc != tc).to(torch.int64)
            cu = up + 1
            cl = left + 1
            vnew = torch.minimum(cd, torch.minimum(cu, cl))
            op = torch.where(vnew == cd, OP_DIAG,
                             torch.where(vnew == cu, OP_UP, OP_LEFT))
            vnew = torch.where(i_v == 0, j_v, vnew)
            op = torch.where(i_v == 0, OP_LEFT, op)
            vnew = torch.where(j_v == 0, i_v, vnew)
            op = torch.where(j_v == 0, OP_UP, op)
            invalid = (i_v < 0) | (i_v > m[:, None]) | (j_v < 0) | \
                (j_v > n[:, None])
            vnew = torch.where(invalid, INF, vnew)
            bits = bits | (op << (2 * s))
            at_end = end == a
            w_t = m - lo_a
            hit = torch.where(
                (w_t >= 0) & (w_t < W),
                torch.gather(vnew, 1, torch.clamp(w_t, 0, W - 1)[:, None])[:, 0],
                INF)
            dist = torch.where(at_end, hit, dist)
            reached = reached | at_end
            v2, v1 = v1, vnew
            lo_m2, lo_m1 = lo_m1, lo_a
        tb[:, word] = torch.where(live[:, None], _to_i32(bits), 0)
    stats = torch.stack([dist, reached.to(torch.int64)], dim=1).to(torch.int32)
    return tb, lo_out, stats


def wave_fwd(qpad: torch.Tensor, rtpad: torch.Tensor, mn: torch.Tensor,
             n_words: int):
    """Forward banded DP over B pairs.

    qpad:  (B, QP) int32 — query codes, sentinel 4 at [0], padded tail
    rtpad: (B, TP) int32 — reversed target codes, same scheme
    mn:    (B, 2) int32 — (m, n) per pair; n_words * 16 > max(m + n)
    Returns (tb (B, n_words, 256) int32 packed decisions, lo (B, n_words*16)
    int32 band start per anti-diagonal, stats (B, 2) int32 [dist, reached]).
    tb/lo are defined up to each pair's last anti-diagonal
    (wave_fwd_defined).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if qpad.device.type == "cpu":
        return wave_fwd_plain(qpad, rtpad, mn, n_words)
    dev = qpad.device
    B, QP = qpad.shape
    TP = rtpad.shape[1]
    check_tensor("qpad", qpad, (B, QP), torch.int32, dev)
    check_tensor("rtpad", rtpad, (B, TP), torch.int32, dev)
    check_tensor("mn", mn, (B, 2), torch.int32, dev)
    a_max = n_words * PACK
    tb = torch.empty((B, n_words, BAND_W), dtype=torch.int32, device=dev)
    lo = torch.empty((B, a_max), dtype=torch.int32, device=dev)
    stats = torch.empty((B, 2), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        rc = lib.ndt_wave_fwd(
            qpad.data_ptr(), rtpad.data_ptr(), mn.data_ptr(), tb.data_ptr(),
            lo.data_ptr(), stats.data_ptr(), B, QP, TP, n_words, a_max,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("wave_fwd", rc)
    _build.count_launch("wave_fwd", dev)
    return tb, lo, stats


# ----------------------------------------------------------------------------
# traceback


def wave_tb_plain(tb, lo, mn):
    """Plain PyTorch traceback (any device); see wave_tb."""
    dev = tb.device
    B, n_words, W = tb.shape
    a_max = lo.shape[1]
    i = mn[:, 0].to(torch.int64)
    a = (mn[:, 0] + mn[:, 1]).to(torch.int64)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    ops = torch.full((B, a_max), OP_NONE, dtype=torch.uint8, device=dev)
    rows = torch.arange(B, device=dev)
    lo64 = lo.to(torch.int64)
    while True:
        act = alive & (a > 0)
        if not bool(act.any()):
            break
        ac = torch.clamp(a, 0, a_max - 1)
        lo_a = torch.gather(lo64, 1, ac[:, None])[:, 0]
        w = i - lo_a
        inband = (w >= 0) & (w < W)
        lane = torch.clamp(w, 0, W - 1)
        word = tb[rows, ac // PACK, lane].to(torch.int64) & 0xFFFFFFFF
        op = (word >> (2 * (ac % PACK))) & 3
        old = torch.gather(ops, 1, ac[:, None])[:, 0]
        new = torch.where(inband, op, OP_NONE).to(torch.uint8)
        ops.scatter_(1, ac[:, None], torch.where(act, new, old)[:, None])
        i = torch.where(act & (op != OP_LEFT), i - 1, i)
        a = torch.where(act, torch.where(op == OP_DIAG, a - 2, a - 1), a)
        alive = torch.where(act, inband, alive)
    ok = alive & (a == 0) & (i == 0)
    return ops, ok


def wave_tb(tb: torch.Tensor, lo: torch.Tensor, mn: torch.Tensor):
    """Walk the packed decisions back from (m, n) per pair.

    Returns (ops (B, a_max) uint8: the op taken at anti-diagonal a in slot
    a, OP_NONE elsewhere — read low -> high it is the alignment start ->
    end; ok (B,) bool: the walk stayed in the band and ended at (0, 0)).
    Needs m + n < n_words * 16, as wave_fwd does; reads no tb/lo row above
    a pair's last anti-diagonal.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if tb.device.type == "cpu":
        return wave_tb_plain(tb, lo, mn)
    dev = tb.device
    B, n_words, W = tb.shape
    a_max = lo.shape[1]
    check_tensor("tb", tb, (B, n_words, BAND_W), torch.int32, dev)
    check_tensor("lo", lo, (B, n_words * PACK), torch.int32, dev)
    check_tensor("mn", mn, (B, 2), torch.int32, dev)
    ops = torch.empty((B, a_max), dtype=torch.uint8, device=dev)
    ok = torch.empty(B, dtype=torch.uint8, device=dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        rc = lib.ndt_wave_tb(
            tb.data_ptr(), lo.data_ptr(), mn.data_ptr(), ops.data_ptr(),
            ok.data_ptr(), B, n_words, a_max,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("wave_tb", rc)
    _build.count_launch("wave_tb", dev)
    return ops, ok.to(torch.bool)


# ----------------------------------------------------------------------------
# fixed-cadence tier (R = 1): forward


def _shift_lanes(v, delta, widx, W):
    """out[:, l] = v[:, l + delta] where that lane exists, else INF."""
    src = widx + delta[:, None]
    ok = (src >= 0) & (src < W)
    return torch.where(ok, torch.gather(v, 1, torch.clamp(src, 0, W - 1)), INF)


def wave_fast_fwd_plain(qpad, rtpad, mn, n_words: int):
    """Plain PyTorch forward pass of the R = 1 tier (any device); see
    wave_fast_fwd."""
    dev = qpad.device
    B, QP = qpad.shape
    TP = rtpad.shape[1]
    W = FAST_W
    m = mn[:, 0].to(torch.int64)
    n = mn[:, 1].to(torch.int64)
    end = m + n
    last_word = torch.clamp(end // PACK, max=n_words - 1)
    q64 = qpad.to(torch.int64)
    rt64 = rtpad.to(torch.int64)
    widx = torch.arange(W, device=dev, dtype=torch.int64)[None, :]
    inf_col = torch.full((B, 1), INF, dtype=torch.int64, device=dev)
    v1 = torch.full((B, W), INF, dtype=torch.int64, device=dev)
    v2 = v1.clone()
    lo_prev = torch.zeros(B, dtype=torch.int64, device=dev)
    dist = torch.full((B,), INF, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    tb = torch.zeros((B, n_words, W), dtype=torch.int32, device=dev)
    base = torch.zeros((B, n_words), dtype=torch.int32, device=dev)
    n_run = int(last_word.max().item()) + 1 if B else 0
    for word in range(n_run):
        a0 = word * PACK
        live = word <= last_word
        # per-word re-centring: lowest-lane argmin, then the three clamps
        rmin, rarg = _lowest_argmin(v1, widx, W)
        delta = torch.clamp(rarg - W // 2, -8, 8)
        delta = torch.where(rmin >= INF, 0, delta)
        delta = torch.maximum(delta, (a0 + PACK - 1) - n - (lo_prev + 8))
        delta = torch.minimum(delta, m - (lo_prev + 8))
        delta = torch.maximum(delta, -lo_prev)
        delta = torch.where(done, 0, delta)
        lo_base = lo_prev + delta
        a_cur = _shift_lanes(v1, delta, widx, W)
        b_cur = _shift_lanes(v2, delta, widx, W)
        bits = torch.zeros((B, W), dtype=torch.int64, device=dev)
        for s in range(PACK):
            a = a0 + s
            i_v = lo_base[:, None] + (s + 1) // 2 + widx
            j_v = a - i_v
            qc = torch.gather(q64, 1, torch.clamp(i_v, 0, QP - 1))
            tc = torch.gather(
                rt64, 1, torch.clamp(T_FRONT + n[:, None] - j_v, 0, TP - 1))
            if s % 2 == 0:      # up reads lane - 1, left the same lane
                up = torch.cat([inf_col, a_cur[:, :-1]], dim=1)
                left = a_cur
            else:               # up reads the same lane, left lane + 1
                up = a_cur
                left = torch.cat([a_cur[:, 1:], inf_col], dim=1)
            cd = b_cur + (qc != tc).to(torch.int64)
            cu = up + 1
            cl = left + 1
            vnew = torch.minimum(cd, torch.minimum(cu, cl))
            op = torch.where(vnew == cd, OP_DIAG,
                             torch.where(vnew == cu, OP_UP, OP_LEFT))
            vnew = torch.where(i_v == 0, j_v, vnew)
            op = torch.where(i_v == 0, OP_LEFT, op)
            vnew = torch.where(j_v == 0, i_v, vnew)
            op = torch.where(j_v == 0, OP_UP, op)
            invalid = (i_v < 0) | (i_v > m[:, None]) | (j_v < 0) | \
                (j_v > n[:, None])
            vnew = torch.where(invalid, INF, vnew)
            vnew = torch.where(done[:, None], a_cur, vnew)
            bits = bits | (op << (2 * s))
            at_end = (i_v == m[:, None]) & (j_v == n[:, None])
            hit = torch.where(at_end, vnew, INF).min(dim=1).values
            dist = torch.minimum(dist, hit)
            done = dist < INF
            b_cur, a_cur = a_cur, vnew
        v1 = torch.where(live[:, None], a_cur, v1)
        v2 = torch.where(live[:, None], b_cur, v2)
        lo_prev = torch.where(live, lo_base + 8, lo_prev)
        tb[:, word] = torch.where(live[:, None], _to_i32(bits), 0)
        base[:, word] = torch.where(live, lo_base, 0).to(torch.int32)
    stats = torch.stack([dist, done.to(torch.int64)], dim=1).to(torch.int32)
    return tb, base, stats


def wave_fast_fwd(qpad: torch.Tensor, rtpad: torch.Tensor, mn: torch.Tensor,
                  n_words: int):
    """Forward pass of the fixed-cadence R = 1 tier over B pairs.

    qpad:  (B, QP) int32 — query codes, sentinel 4 at [0], padded tail
    rtpad: (B, TP) int32 — reversed target codes behind T_FRONT sentinels
    mn:    (B, 2) int32 — (m, n) per pair; n_words * 16 > max(m + n)
    Returns (tb (B, n_words, 128) int32 packed decisions, base (B, n_words)
    int32 band start at each word's first step, stats (B, 2) int32 [dist,
    done]).  tb/base are defined up to each pair's last anti-diagonal
    (wave_fwd_defined).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if qpad.device.type == "cpu":
        return wave_fast_fwd_plain(qpad, rtpad, mn, n_words)
    dev = qpad.device
    B, QP = qpad.shape
    TP = rtpad.shape[1]
    check_tensor("qpad", qpad, (B, QP), torch.int32, dev)
    check_tensor("rtpad", rtpad, (B, TP), torch.int32, dev)
    check_tensor("mn", mn, (B, 2), torch.int32, dev)
    tb = torch.empty((B, n_words, FAST_W), dtype=torch.int32, device=dev)
    base = torch.empty((B, n_words), dtype=torch.int32, device=dev)
    stats = torch.empty((B, 2), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        rc = lib.ndt_wave_fast_fwd(
            qpad.data_ptr(), rtpad.data_ptr(), mn.data_ptr(), tb.data_ptr(),
            base.data_ptr(), stats.data_ptr(), B, QP, TP, n_words,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("wave_fast_fwd", rc)
    _build.count_launch("wave_fast_fwd", dev)
    return tb, base, stats


# ----------------------------------------------------------------------------
# fixed-cadence tier (R = 1): traceback


def wave_fast_tb_plain(tb, base, mn):
    """Plain PyTorch traceback of the R = 1 tier (any device); see
    wave_fast_tb."""
    dev = tb.device
    B, n_words, W = tb.shape
    a_max = n_words * PACK
    m = mn[:, 0].to(torch.int64)
    end = (mn[:, 0] + mn[:, 1]).to(torch.int64)
    base64 = base.to(torch.int64)
    rows = torch.arange(B, device=dev)
    ops = torch.full((B, a_max), OP_NONE, dtype=torch.uint8, device=dev)
    lane = torch.zeros(B, dtype=torch.int64, device=dev)
    alive = torch.zeros(B, dtype=torch.bool, device=dev)
    pend = torch.zeros(B, dtype=torch.bool, device=dev)
    t_top = int(end.max().item()) if B else 0
    for t in range(min(t_top, a_max - 1), 0, -1):
        w, s = t // PACK, t % PACK
        start = end == t
        if bool(start.any()):
            l0 = m - base64[:, w] - (s + 1) // 2
            lane = torch.where(start, l0, lane)
            alive = torch.where(start, (l0 >= 0) & (l0 < W), alive)
        if s == PACK - 1 and w + 1 < n_words:
            # word boundary: the forward pass may have re-centred the band
            corr = torch.clamp(base64[:, w + 1] - base64[:, w] - 8,
                               -W + 1, W - 1)
            moved = alive & ~start
            lane = torch.where(moved, lane + corr, lane)
            alive = alive & (~moved | ((lane >= 0) & (lane < W)))
        if not bool(alive.any()):
            if bool((end < t).all()):
                break
            continue
        act = alive & ~pend
        lc = torch.clamp(lane, 0, W - 1)
        word = tb[rows, w, lc].to(torch.int64) & 0xFFFFFFFF
        op = (word >> (2 * s)) & 3
        ops[:, t] = torch.where(act, op, ops[:, t].to(torch.int64)
                                ).to(torch.uint8)
        was_pend = alive & pend
        pend = act & (op == OP_DIAG)
        if s % 2 == 0:
            lane = torch.where(act & (op == OP_UP), lane - 1, lane)
        else:
            lane = torch.where(act & (op == OP_LEFT), lane + 1, lane)
        alive = alive & (was_pend | ((op != OP_NONE) & (lane >= 0)
                                     & (lane < W)))
    # a pair of two empty sequences starts (and stays) on anti-diagonal 0
    l0 = m - base64[:, 0]
    lane = torch.where(end == 0, l0, lane)
    alive = torch.where(end == 0, (l0 >= 0) & (l0 < W), alive)
    ok = alive & (lane == -base64[:, 0])
    return ops, ok


def wave_fast_tb(tb: torch.Tensor, base: torch.Tensor, mn: torch.Tensor):
    """Walk the R = 1 tier's packed decisions back from (m, n) per pair.

    Predecessors under the fixed cadence: DIAG is the same lane two steps
    back; UP is lane - 1 on even steps and the same lane on odd ones; LEFT
    is the same lane on even steps and lane + 1 on odd ones.  Crossing into
    word w from word w + 1 the lane moves by base[w+1] - base[w] - 8.  The
    walk stops at anti-diagonal 0; a lane that leaves the band ends it.

    Precondition (as wave_fast_fwd's): m + n < n_words * 16.  No word above
    (m + n) // 16 is read, so rows wave_fast_fwd leaves undefined there do
    not matter (wave_fwd_defined); a pair outside the precondition gets no
    op and ok = False.

    Returns (ops (B, n_words * 16) uint8: the op taken at anti-diagonal a in
    slot a, OP_NONE elsewhere; ok (B,) bool: the walk ended on cell (0, 0),
    lane -base[0]).  The kernel writes every byte of ops.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if tb.device.type == "cpu":
        return wave_fast_tb_plain(tb, base, mn)
    dev = tb.device
    B, n_words, W = tb.shape
    a_max = n_words * PACK
    check_tensor("tb", tb, (B, n_words, FAST_W), torch.int32, dev)
    check_tensor("base", base, (B, n_words), torch.int32, dev)
    check_tensor("mn", mn, (B, 2), torch.int32, dev)
    ops = torch.empty((B, a_max), dtype=torch.uint8, device=dev)
    ok = torch.empty(B, dtype=torch.uint8, device=dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        rc = lib.ndt_wave_fast_tb(
            tb.data_ptr(), base.data_ptr(), mn.data_ptr(), ops.data_ptr(),
            ok.data_ptr(), B, n_words, a_max,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("wave_fast_tb", rc)
    _build.count_launch("wave_fast_tb", dev)
    return ops, ok.to(torch.bool)


# ----------------------------------------------------------------------------
# host-level wrappers


def pad_for_align(seqs, max_len: int, W: int, front: int = 1) -> np.ndarray:
    """(B, QP) int32: `front` sentinels, then the sequence (buf[front-1+i] =
    s[i-1] style addressing), tail sentinel 5; QP is 128-aligned with >=
    W + 3*128 slack for the windowed loads."""
    B = len(seqs)
    QP = front + max_len + W + 3 * LANES
    QP = ((QP + LANES - 1) // LANES) * LANES
    out = np.full((B, QP), 5, dtype=np.int32)
    out[:, :front] = 4
    for b, s in enumerate(seqs):
        out[b, front : front + len(s)] = s
    return out


_B2C = np.frombuffer(b"ACGT", np.uint8)


def band_align_native(queries, targets, hq: bool = False):
    """The native O(ND) host aligner (native nd_band_align, the semantics of
    the reference's align.c, incl. the align_hq preset for HiFi).  Same
    results format as band_align; band_align never routes here, callers
    name it explicitly."""
    from ..native import band_align_cpu

    res = []
    for q, t in zip(queries, targets):
        qstr = _B2C[np.asarray(q, np.uint8) & 3].tobytes().decode()
        tstr = _B2C[np.asarray(t, np.uint8) & 3].tobytes().decode()
        d, qa, ta = band_align_cpu(qstr, tstr, hq=hq)
        if len(qa) <= 2 and (len(q) > 2 or len(t) > 2):
            res.append(dict(dist=INF, reached=False, ok=False,
                            ops=np.zeros(0, np.int8)))
            continue
        a = np.frombuffer(qa.encode(), np.uint8)
        b = np.frombuffer(ta.encode(), np.uint8)
        ops = np.where(b == ord("-"), OP_UP,
                       np.where(a == ord("-"), OP_LEFT, OP_DIAG)).astype(np.int8)
        res.append(dict(dist=int(np.sum(a != b)), reached=True, ok=True,
                        ops=ops))
    return res


def band_align(queries: List[np.ndarray], targets: List[np.ndarray],
               R: int | None = None, hq: bool = False, device=None):
    """Globally align each (query, target) code-array pair.

    Returns list of dicts {dist, reached, ok, ops}; ops is an int array of
    OP_DIAG/OP_UP/OP_LEFT in alignment-column order (start -> end).

    R=None: bit-parallel banded Myers first (256-cell band), then the
    adaptive wide-band wavefront kernels for pairs whose Myers walk missed
    the band.  R=2: the wide-band wavefront kernels alone.  R=1: the
    fixed-cadence narrow-band kernels alone.  `hq` is accepted for
    signature parity and ignored by every device tier.

    device=None means the GPU (raises without one); "cpu" runs the plain
    PyTorch versions."""
    from ..utils import span as _tspan
    dev = resolve_device(device)
    cells = sum(len(q) + len(t) for q, t in zip(queries, targets)) * 64
    with _tspan("kernel/band_align", pairs=len(queries), band_cells=cells):
        if R is None:
            with _tspan("kernel/myers_tier", pairs=len(queries)):
                res = myers_align(queries, targets, nw=8, device=dev)
            bad = [i for i, r in enumerate(res)
                   if not (r["ok"] and r["reached"])]
            if bad:
                with _tspan("kernel/band_retry", pairs=len(bad)):
                    retry = _band_align_R([queries[i] for i in bad],
                                          [targets[i] for i in bad], 2, dev)
                for i, r in zip(bad, retry):
                    res[i] = r
            return res
        return _band_align_R(queries, targets, R, dev)


def _band_align_R(queries, targets, R: int, dev: torch.device):
    if R not in (1, 2):
        raise ValueError(f"band_align: R must be 1, 2 or None, got {R!r}")
    B0 = len(queries)
    if B0 == 0:
        return []
    # bound the traceback buffer: tb is B * a_max * 64 bytes.  Split into
    # length-sorted sub-batches so each launch's tb stays under the budget;
    # per-pair results are independent, so reassembly by original index is
    # exact.
    TB_BUDGET = 1 << 30
    if B0 > 8:
        mn_est = [len(q) + len(t) + 1 for q, t in zip(queries, targets)]
        order = sorted(range(B0), key=lambda i: mn_est[i])
        groups, cur, cur_max = [], [], 0
        for i in order:
            nm = max(cur_max, mn_est[i])
            if cur and (len(cur) + 1) * nm * 64 > TB_BUDGET:
                groups.append(cur)
                cur, cur_max = [i], mn_est[i]
            else:
                cur.append(i)
                cur_max = nm
        if cur:
            groups.append(cur)
        if len(groups) > 1:
            res = [None] * B0
            for g in groups:
                sub = _band_align_R([queries[i] for i in g],
                                    [targets[i] for i in g], R, dev)
                for i, r in zip(g, sub):
                    res[i] = r
            return res
    m = np.array([len(q) for q in queries], np.int32)
    n = np.array([len(t) for t in targets], np.int32)
    a_sz = int((m + n).max()) + 1
    n_words = (a_sz + PACK - 1) // PACK
    W = R * LANES
    qpad = pad_for_align(queries, int(m.max()), W)
    rtpad = pad_for_align([np.asarray(t)[::-1] for t in targets],
                          int(n.max()), W, front=T_FRONT if R == 1 else 1)
    mn = torch.from_numpy(np.stack([m, n], axis=1)).to(dev)
    fwd, tbk = (wave_fast_fwd, wave_fast_tb) if R == 1 else (wave_fwd, wave_tb)
    tb, lo, stats = fwd(torch.from_numpy(qpad).to(dev),
                        torch.from_numpy(rtpad).to(dev), mn, n_words)
    ops, ok = tbk(tb, lo, mn)
    del tb
    ops_full = ops.cpu().numpy().view(np.int8)
    okv = ok.cpu().numpy()
    stats = stats.cpu().numpy()
    res = []
    for b in range(B0):
        o = ops_full[b]
        o = o[o != OP_NONE]
        res.append(dict(dist=int(stats[b, 0]), reached=bool(stats[b, 1]),
                        ok=bool(okv[b]), ops=o))
    return res
