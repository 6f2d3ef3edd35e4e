"""Batched tag-MSA link extraction (the consensus hot loop, vectorized).
PyTorch/CUDA port: a copy of nextdenovo_tpu/correct/tagmsa.py (numpy and
the port's native library; off the pipeline's path, as in the reference).

The reference's correction spends its time in two loops over every
alignment column (SURVEY hot loops 3/4): get_align_tags
(reference/lib/nextcorrect.c:1485-1536) converting alignments to
(t_pos, delta, q_base) tag streams, and update_msa (:212-253) find-or-
inserting each tag's (pp, ppp) second-order context into per-node link
lists.  The JAX package's profile of its 5 Mb run on a TPU host put these
at ~47% of the correction stage (SCALE_r02.json); nothing of that was
measured for this port.

This module replaces the find-or-insert with a sort: every column becomes
one packed link key

    khi = node(21b t_pos | 12b delta | 3b base) << 17
          | pp(2b t_pos-rel | 12b delta | 3b base)
    klo = ppp(2b rel | 12b delta | 3b base)

computed with vectorized numpy over all columns of all supports at once,
then lexsorted and run-length counted.  Ordering the unique table by
(node, first-encounter) makes the native consumer (nd_correct_links)
build EXACTLY the entry lists update_msa would have built, so the two
paths produce bit-identical consensus output (asserted in tests).

Per-support gating replicates nd_correct's preprocessing: the 250-column
gap cap, the trim to the first/last run of 8 exact matches
(get_align_shift, nextcorrect.c:102-154), the min_len_aln floor, and the
sequential max_cov_aln coverage budget.

The column math is plain elementwise/scan arithmetic under numpy (per-seed
calls on the host).  The pipeline's correction does not call this module:
it runs native.correct_seed, to which this path is bit-identical.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

DELTA_BITS = 12
DELTA_MAX = (1 << DELTA_BITS) - 1
TPOS_BITS = 21
GAP_CAP = 250      # align.c:542 gap cap, mirrored in nd_correct's rebuild
HEAD_REL = 3


def _pack_ctx(rel, delta, base):
    return (rel << 15) | (delta << 3) | base


def _support_links(seed: np.ndarray, sup: np.ndarray, t_start: int,
                   ops: np.ndarray, min_len_aln: int):
    """One support's trimmed-window link keys.

    Returns (ok, t_span, first, last, khi, klo) — ok False when the
    support is dropped
    (gap cap, no 8-match anchor, min_len_aln) exactly as nd_correct drops
    it; raises OverflowError when a delta exceeds the 12-bit pack budget
    (caller falls back to the reference path for the whole seed)."""
    ops = np.asarray(ops, np.uint8)
    n = len(ops)
    if n == 0:
        return False, 0, 0, 0, None, None
    q_consume = ops != 2
    t_consume = ops != 1
    idx = np.arange(n, dtype=np.int64)
    # gap cap: longest run of non-diagonal columns
    diag_idx = np.where(ops == 0, idx, -1)
    last_diag = np.maximum.accumulate(diag_idx)
    gap_run = idx - last_diag
    if len(gap_run) and int(gap_run.max()) > GAP_CAP:
        return False, 0, 0, 0, None, None
    qi = np.cumsum(q_consume) - 1
    ti = t_start + np.cumsum(t_consume) - 1
    if int(qi[-1]) + 1 != len(sup):
        return False, 0, 0, 0, None, None
    qbase = np.where(q_consume, sup[np.maximum(qi, 0)], 4).astype(np.int64)
    match = (ops == 0) & (qbase == seed[np.clip(ti, 0, len(seed) - 1)])
    # first/last run of 8 exact matches (get_align_shift)
    cm = np.concatenate([[0], np.cumsum(match)])
    win8 = (cm[8:] - cm[:-8]) == 8 if n >= 8 else np.zeros(0, bool)
    if not len(win8) or not win8.any():
        return False, 0, 0, 0, None, None
    starts = np.nonzero(win8)[0]
    first = int(starts[0])
    last = int(starts[-1]) + 7
    if last - first + 1 < min_len_aln:
        return False, 0, 0, 0, None, None

    w = slice(first, last + 1)
    tc = t_consume[w]
    tp = ti[w]
    base = qbase[w]
    m = last - first + 1
    widx = np.arange(m, dtype=np.int64)
    ltc = np.maximum.accumulate(np.where(tc, widx, -1))
    delta = widx - ltc - (ltc < 0)
    if int(delta.max()) > DELTA_MAX:
        raise OverflowError("delta exceeds pack budget")
    t_span = int(tc.sum())

    node = (tp << 15) | (delta << 3) | base
    # pp / ppp: previous 1 / 2 tags of this support (head outside)
    pp_rel = np.empty(m, np.int64)
    pp_ctx = np.empty(m, np.int64)
    pp_rel[1:] = tp[1:] - tp[:-1]
    pp_ctx[1:] = _pack_ctx(pp_rel[1:], delta[:-1], base[:-1])
    pp_ctx[0] = _pack_ctx(HEAD_REL, 0, 0)
    ppp_ctx = np.empty(m, np.int64)
    if m > 2:
        ppp_ctx[2:] = _pack_ctx(tp[2:] - tp[:-2], delta[:-2], base[:-2])
    ppp_ctx[: min(2, m)] = _pack_ctx(HEAD_REL, 0, 0)
    khi = (node << 17) | pp_ctx
    klo = ppp_ctx.astype(np.int32)
    return True, t_span, first, last, khi, klo


def extract_links(seed: np.ndarray, sup_seqs: List[np.ndarray],
                  t_starts: List[int], ops_list: List[np.ndarray],
                  min_len_aln: int, max_cov_aln: int
                  ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]]:
    """All-supports link table for one seed.

    Returns (accept uint8 (n_sup,), first int32, last int32, link_hi
    int64, link_lo int32, link_cnt int32) with the unique links ordered
    by (node,
    first-encounter), or None when a delta overflows the pack budget
    (caller uses the reference path).  The seed-self support
    (nextcorrect.c:2279-2282) is included implicitly as the first tag
    stream, matching nd_correct."""
    seed = np.asarray(seed, np.int64) & 3
    L = len(seed)
    parts_hi: List[np.ndarray] = []
    parts_lo: List[np.ndarray] = []
    # seed self: every position, delta 0, base = seed base
    tp = np.arange(L, dtype=np.int64)
    node = (tp << 15) | seed[tp]     # delta 0
    pp_ctx = np.empty(L, np.int64)
    pp_ctx[1:] = _pack_ctx(1, 0, seed[:-1])
    pp_ctx[0] = _pack_ctx(HEAD_REL, 0, 0)
    ppp_ctx = np.empty(L, np.int64)
    if L > 2:
        ppp_ctx[2:] = _pack_ctx(2, 0, seed[:-2])
    ppp_ctx[: min(2, L)] = _pack_ctx(HEAD_REL, 0, 0)
    parts_hi.append((node << 17) | pp_ctx)
    parts_lo.append(ppp_ctx.astype(np.int32))

    accept = np.zeros(len(sup_seqs), np.uint8)
    firsts = np.zeros(len(sup_seqs), np.int32)
    lasts = np.zeros(len(sup_seqs), np.int32)
    total_cov = 0
    for s, (sup, t0, ops) in enumerate(zip(sup_seqs, t_starts, ops_list)):
        if total_cov // L > max_cov_aln:
            break
        try:
            ok, t_span, first, last, khi, klo = _support_links(
                seed, np.asarray(sup, np.int64) & 3, int(t0), ops,
                min_len_aln)
        except OverflowError:
            return None
        if not ok:
            continue
        accept[s] = 1
        firsts[s] = first
        lasts[s] = last
        total_cov += t_span
        parts_hi.append(khi)
        parts_lo.append(klo)

    hi = np.concatenate(parts_hi)
    lo = np.concatenate(parts_lo)
    order = np.lexsort((lo, hi))          # stable: ties keep flat order
    hi_s, lo_s = hi[order], lo[order]
    newk = np.ones(len(hi_s), bool)
    newk[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    starts = np.nonzero(newk)[0]
    cnt = np.diff(np.concatenate([starts, [len(hi_s)]])).astype(np.int32)
    first_flat = order[starts]            # first encounter (flat order)
    hi_u, lo_u = hi_s[starts], lo_s[starts]
    final = np.lexsort((first_flat, hi_u >> 17))
    return (accept, firsts, lasts, hi_u[final],
            lo_u[final].astype(np.int32), cnt[final])


def correct_seed_links(seed: np.ndarray, sup_seqs, t_starts, ops_list, *,
                       min_len_aln: int = 500, max_cov_aln: int = 130,
                       min_cov: int = 4, max_lq_length: int = 10000,
                       min_error_corrected_ratio: float = 0.8,
                       split: bool = False, read_type: int = 1,
                       keep_all: bool = False, fast: bool = False):
    """Drop-in replacement for native.correct_seed using the vectorized
    link-table path; falls back to the reference path when a delta exceeds
    the pack budget.  Returns (len, identity, seq str)."""
    import ctypes

    from .. import native

    seed = np.ascontiguousarray(seed, np.uint8)
    res = extract_links(seed, sup_seqs, t_starts, ops_list,
                        min_len_aln, max_cov_aln)
    if res is None:
        # delta overflow: reference path (needs t_ends = t_start + span - 1)
        t_ends = [int(t0) + int(np.sum(np.asarray(o) != 1)) - 1
                  for t0, o in zip(t_starts, ops_list)]
        return native.correct_seed(
            seed, sup_seqs, t_starts, t_ends, ops_list,
            min_len_aln=min_len_aln, max_cov_aln=max_cov_aln,
            min_cov=min_cov, max_lq_length=max_lq_length,
            min_error_corrected_ratio=min_error_corrected_ratio,
            split=split, read_type=read_type, keep_all=keep_all, fast=fast)
    accept, firsts, lasts, hi, lo, cnt = res
    L = native.lib()
    n = len(sup_seqs)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    keep = [np.ascontiguousarray(s_, np.uint8) for s_ in sup_seqs]
    okeep = [np.ascontiguousarray(o, np.uint8) for o in ops_list]
    sup_arr = (u8p * max(n, 1))(*[a.ctypes.data_as(u8p) for a in keep])
    ops_arr = (u8p * max(n, 1))(*[a.ctypes.data_as(u8p) for a in okeep])
    sup_lens = (ctypes.c_int32 * max(n, 1))(*[len(a) for a in keep])
    ts = (ctypes.c_int32 * max(n, 1))(*[int(x) for x in t_starts])
    ops_lens = (ctypes.c_int32 * max(n, 1))(*[len(o) for o in okeep])
    hi = np.ascontiguousarray(hi, np.int64)
    lo = np.ascontiguousarray(lo, np.int32)
    cnt = np.ascontiguousarray(cnt, np.int32)
    accept = np.ascontiguousarray(accept, np.uint8)
    firsts = np.ascontiguousarray(firsts, np.int32)
    lasts = np.ascontiguousarray(lasts, np.int32)
    r = L.nd_correct_links(
        seed.ctypes.data_as(u8p), len(seed), n, sup_arr, sup_lens, ts,
        ops_arr, ops_lens, accept.ctypes.data_as(u8p),
        firsts.ctypes.data_as(i32p), lasts.ctypes.data_as(i32p),
        hi.ctypes.data_as(i64p), lo.ctypes.data_as(i32p),
        cnt.ctypes.data_as(i32p), len(hi),
        min_cov, max_lq_length, min_error_corrected_ratio,
        1 if split else 0, read_type, 1 if keep_all else 0,
        1 if fast else 0)
    c = r.contents
    out = (int(c.len), float(c.identity), c.seq.decode() if c.seq else "")
    L.nd_free_cns(r)
    return out
