"""cns-read overlap stage (minimap2-nd --step 2 equivalent), PyTorch + CUDA.

Counterpart of nextdenovo_tpu/overlap/cns.py.  Pipeline: minimizer
candidates (diagonal voting, engine.py) -> banded re-alignment on the
device for precise endpoints + identity (replacing the
re-align pass of map.c:988-1090 / alnpos refinement :919-987) -> dovetail /
containment classification and per-read stats accumulation (filter_ovl,
lib/ovl.c:449-563) -> mode-10-style records + per-read blacklist info
(out_bl fields, ovl.c:339-361) for the string graph.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..device import resolve_device
from ..io.seqstore import SeqStore
from ..ops.align import band_align
from ..ops.extend import affine_extend
from .engine import build_index, find_overlaps
from .records import OvlBlock

EDGEBACKLEN = 10   # lib/ovl.h:12


# Long realign pairs chunk into ~REALN_CORE-column pieces aligned
# independently and recombined (identity summed, endpoints refined from
# the terminal chunks): bounds the aligner's per-launch memory (same
# design as correct/driver.py CORR_CHUNK_T and the polish windows).
# Interior chunk boundaries are forced global-alignment ends and add a
# few edits of slop each (<0.5% of identity per boundary), which the
# loose min_ide gate and the graph's RATIO-based tests absorb.
REALN_CORE = 12288


def _realign_chunks(lq: int, lt: int):
    """Proportional exact partition of (q, t) spans into chunk slices."""
    nch = max(1, -(-max(lq, lt) // REALN_CORE))
    out = []
    for c in range(nch):
        out.append((lq * c // nch, lq * (c + 1) // nch,
                    lt * c // nch, lt * (c + 1) // nch))
    return out


def realign_overlaps(store: SeqStore, cand: OvlBlock, ext: int = 64,
                     batch: int = 384, device=None,
                     min_ide: float = 0.05, align_fn=None) -> OvlBlock:
    """Refine candidate overlap endpoints + identity with the banded aligner.

    Each candidate's clipped segments (grown by `ext` toward the read ends)
    are globally aligned (long pairs in chunks, see REALN_CORE); terminal
    gap runs are trimmed off to recover the true start/end, and identity =
    matches / columns (x10000) fills the mode-10 `ide` field.

    device=None means the GPU (raises without one); "cpu" runs the
    aligner's plain PyTorch versions.
    """
    dev = resolve_device(device)
    n = len(cand)
    recs = {k: [] for k in
            ("qname", "rev", "qs", "qe", "tname", "ts", "te", "match", "ide")}
    for s0 in range(0, n, batch):
        sl = slice(s0, min(n, s0 + batch))
        qs_l, ts_l = [], []
        flat_q, flat_t, owner = [], [], []   # chunk rows -> candidate row
        nch_of = []
        for i in range(sl.start, sl.stop):
            q, t = int(cand.qname[i]), int(cand.tname[i])
            rev = int(cand.rev[i])
            ql, tl = int(store.length[q]), int(store.length[t])
            qs = max(0, int(cand.qs[i]) - ext)
            qe = min(ql, int(cand.qe[i]) + ext)
            ts = max(0, int(cand.ts[i]) - ext)
            te = min(tl, int(cand.te[i]) + ext)
            qseq = store.subseq(q, qs, qe)
            tseq = store.subseq(t, ts, te, rc=bool(rev))
            qs_l.append((qs, qe))
            ts_l.append((ts, te))
            ch = _realign_chunks(len(qseq), len(tseq))
            nch_of.append(len(ch))
            for (a, b, c, d) in ch:
                flat_q.append(qseq[a:b].astype(np.int8))
                flat_t.append(tseq[c:d].astype(np.int8))
                owner.append(i - sl.start)
        if not flat_q:
            continue
        res_flat = (align_fn(flat_q, flat_t) if align_fn is not None
                    else band_align(flat_q, flat_t, device=dev))
        # regroup chunk results per candidate
        grouped = [[] for _ in range(sl.stop - sl.start)]
        for o, r in zip(owner, res_flat):
            grouped[o].append(r)
        for j in range(sl.stop - sl.start):
            i = sl.start + j
            chunks = grouped[j]
            if not chunks or not all(r["reached"] and r["ok"]
                                     for r in chunks):
                continue
            if len(chunks) == 1:
                r = chunks[0]
            else:
                r = dict(dist=sum(c["dist"] for c in chunks),
                         ops=np.concatenate([c["ops"] for c in chunks]))
            ops = r["ops"]
            # trim terminal gap runs to refine endpoints
            lead = 0
            while lead < len(ops) and ops[lead] != 0:
                lead += 1
            tail = 0
            while tail < len(ops) - lead and ops[len(ops) - 1 - tail] != 0:
                tail += 1
            core = ops[lead : len(ops) - tail]
            if len(core) == 0:
                continue
            q_lead = int(np.sum(ops[:lead] == 1))
            t_lead = lead - q_lead
            q_tail = int(np.sum(ops[len(ops) - tail :] == 1))
            t_tail = tail - q_tail
            n_q = int(np.sum(core != 2))
            n_t = int(np.sum(core != 1))
            dist_core = r["dist"] - lead - tail
            matches_lb = len(core) - dist_core  # columns - edits (lower bound)
            ide = max(0.0, min(1.0, matches_lb / max(1, len(core))))
            if ide < min_ide:
                continue
            (qs, qe) = qs_l[j]
            (ts, te) = ts_l[j]
            rev = int(cand.rev[i])
            new_qs = qs + q_lead
            new_qe = new_qs + n_q
            if rev:
                # t segment was rc'd: leading columns consume the rc prefix =
                # the fwd suffix
                new_te = te - t_lead
                new_ts = new_te - n_t
            else:
                new_ts = ts + t_lead
                new_te = new_ts + n_t
            recs["qname"].append(int(cand.qname[i]))
            recs["rev"].append(rev)
            recs["qs"].append(new_qs)
            recs["qe"].append(new_qe)
            recs["tname"].append(int(cand.tname[i]))
            recs["ts"].append(new_ts)
            recs["te"].append(new_te)
            recs["match"].append(matches_lb)
            recs["ide"].append(int(ide * 10000))
    return OvlBlock.from_arrays(**recs)


def extend_overlap_ends(store: SeqStore, ovl: OvlBlock, max_ext: int = 1024,
                        min_hang: int = 32, min_score: int = 8,
                        device=None) -> OvlBlock:
    """Greedy end-extension of refined overlaps toward the read ends.

    The device equivalent of the reference's greedy extension tier
    (`extend_fwd`/`extend_rev` lib/align.c:254-427 and `nd_extend_ends`
    minimap2/map.c:919-987): where both reads still have unaligned hang on
    the same overlap side, the two tails are run through the ksw2-extz
    extension kernel (ops/extend.py) and the endpoints advanced to the
    best-scoring extension point.  The drop-factor cutoff of the scalar
    walker maps to score maximisation here: extension past the point where
    errors outweigh matches can only lower the score, so the best endpoint
    IS the drop-limited greedy frontier.

    Only records with hang > `min_hang` on a side are re-examined (smaller
    hangs are already within the realign `ext` margin); tails are capped at
    `max_ext` bases.  Returns a new OvlBlock with extended qs/qe/ts/te and
    `match` grown by the extension-score lower bound (score/2 with the
    default match=2 scoring).
    """
    dev = resolve_device(device)
    n = len(ovl)
    if n == 0:
        return ovl
    cols = {k: np.array(getattr(ovl, k)).copy() for k in
            ("qname", "rev", "qs", "qe", "tname", "ts", "te", "match", "ide")}
    lens = np.asarray(store.length)
    # side=0: extend right (past qe / Te); side=1: extend left (before
    # qs / Ts), with both tails reversed so the kernel extends leftwards.
    tasks: List[Tuple[int, int]] = []
    qs_l: List[np.ndarray] = []
    ts_l: List[np.ndarray] = []
    for i in range(n):
        q, t = int(cols["qname"][i]), int(cols["tname"][i])
        rev = int(cols["rev"][i])
        ql, tl = int(lens[q]), int(lens[t])
        qs, qe = int(cols["qs"][i]), int(cols["qe"][i])
        # T = t in alignment orientation; overlap spans [Ts, Te) of T
        if rev:
            Ts, Te = tl - int(cols["te"][i]), tl - int(cols["ts"][i])
        else:
            Ts, Te = int(cols["ts"][i]), int(cols["te"][i])
        rh_q, rh_t = ql - qe, tl - Te
        if min(rh_q, rh_t) > min_hang:
            e = min(max_ext, rh_q, rh_t)
            qtail = store.subseq(q, qe, qe + e)
            if rev:  # T[Te:Te+e] = rc(t)[Te:Te+e] = rc(t[tl-Te-e : tl-Te])
                ttail = store.subseq(t, tl - Te - e, tl - Te, rc=True)
            else:
                ttail = store.subseq(t, Te, Te + e)
            tasks.append((i, 0))
            qs_l.append(qtail.astype(np.int8))
            ts_l.append(ttail.astype(np.int8))
        if min(qs, Ts) > min_hang:
            e = min(max_ext, qs, Ts)
            qhead = store.subseq(q, qs - e, qs)[::-1]
            if rev:  # T[Ts-e:Ts] = rc(t[tl-Ts : tl-Ts+e])
                thead = store.subseq(t, tl - Ts, tl - Ts + e, rc=True)[::-1]
            else:
                thead = store.subseq(t, Ts - e, Ts)[::-1]
            tasks.append((i, 1))
            qs_l.append(np.ascontiguousarray(qhead).astype(np.int8))
            ts_l.append(np.ascontiguousarray(thead).astype(np.int8))
    if not tasks:
        return ovl
    res = affine_extend(qs_l, ts_l, device=dev)
    for (i, side), r in zip(tasks, res):
        if r["score"] < min_score:
            continue
        dq, dt = int(r["qe"]), int(r["te"])
        if dq <= 0 or dt <= 0:
            continue
        rev = int(cols["rev"][i])
        if side == 0:
            cols["qe"][i] += dq
            if rev:
                cols["ts"][i] -= dt
            else:
                cols["te"][i] += dt
        else:
            cols["qs"][i] -= dq
            if rev:
                cols["te"][i] += dt
            else:
                cols["ts"][i] -= dt
        cols["match"][i] += r["score"] // 2
    return OvlBlock.from_arrays(**cols)


@dataclass
class CnsInfo:
    """Vectorized per-read accumulation (lib/ovl.h:60-107 ovlinfo_aln):
    st (n_reads, 9) int32 [con, lc, rc, lim, rim, llm, rlm, alnl_s, alnl_e],
    touched bool (n_reads,), alns (m, 3) int32 covered-interval triples
    (rid, s, e) with EDGEBACKLEN already applied, lens int32 (n_reads,)."""
    st: np.ndarray
    touched: np.ndarray
    alns: np.ndarray
    lens: np.ndarray


def filter_cns_overlaps(ovl: OvlBlock, lens: np.ndarray, maxhan1: int = 5000,
                        maxhan2: int = 500):
    """filter_ovl (lib/ovl.c:449-563): containment counting, dovetail
    classification, per-end depth/quality stats.  Native-backed (the accept
    loop is sequential per-read state).  Returns (kept OvlBlock, CnsInfo)."""
    from .. import native

    n = len(ovl)
    lens32 = np.asarray(lens, np.int32)
    order = np.argsort(-np.asarray(ovl.match, np.int64), kind="stable")
    srt = ovl.take(order)
    recs9 = np.stack([np.asarray(srt.data[k], np.int32)
                      for k in ("qname", "rev", "qs", "qe", "tname", "ts",
                                "te", "match", "ide")], axis=1) \
        if n else np.zeros((0, 9), np.int32)
    keep, st, touched, alns = native.cns_filter(recs9, lens32, maxhan1,
                                                maxhan2)
    kept = srt.take(np.nonzero(keep)[0]) if keep.any() \
        else OvlBlock.empty(True)
    return kept, CnsInfo(st=st, touched=touched, alns=alns, lens=lens32)


def bl_info_for_graph(info: CnsInfo, min_con_count: int = 2,
                      max_hang_len: int = 500, drop_chimera: bool = True):
    """init_os (ng/main.c:13-79): turn per-read stats into graph ReadInfo
    inputs; multi-interval (chimeric) cns reads are dropped.  Vectorized
    over the CnsInfo arrays."""
    st, lens = info.st, np.asarray(info.lens, np.int64)
    n_reads = len(lens)
    # ---- merged covered intervals per read ----
    a = info.alns
    n_ivs = np.zeros(n_reads, np.int64)
    last_s = np.zeros(n_reads, np.int64)
    last_e = np.zeros(n_reads, np.int64)
    has_iv = np.zeros(n_reads, bool)
    if len(a):
        rid = a[:, 0].astype(np.int64)
        s = a[:, 1].astype(np.int64)
        e = a[:, 2].astype(np.int64)
        o = np.lexsort((e, s, rid))
        rid, s, e = rid[o], s[o], e[o]
        first = np.ones(len(rid), bool)
        first[1:] = rid[1:] != rid[:-1]
        # per-rid running max of e (rid-major packing keeps resets implicit)
        packed = (rid << 33) | (e + (1 << 31))
        cm = np.maximum.accumulate(packed)
        prev_e = np.concatenate([[np.int64(-(1 << 31))],
                                 (cm[:-1] & ((1 << 33) - 1)) - (1 << 31)])
        new_run = first | (s > prev_e)
        n_ivs = np.bincount(rid[new_run], minlength=n_reads)
        # last merged run per read: its start s, and the rid-final cummax e
        idx = np.arange(len(rid))
        run_idx = np.maximum.accumulate(np.where(new_run, idx, -1))
        last = np.zeros(len(rid), bool)
        last[:-1] = first[1:]
        last[-1] = True
        rl = rid[last]
        last_s[rl] = s[run_idx[last]] - EDGEBACKLEN
        last_e[rl] = ((cm[last] & ((1 << 33) - 1)) - (1 << 31)) + EDGEBACKLEN
        has_iv[rl] = True
    # ---- per-read gating (init_os + refilt_con_read) ----
    con = st[:, 0].astype(np.int64).copy()
    sel = info.touched & (con < min_con_count)
    if drop_chimera:
        sel &= n_ivs <= 1
    s_arr = np.where(has_iv, last_s, 0)
    e_arr = np.where(has_iv, last_e, lens)
    # refilt_con_read (ng/main.c:37-43)
    ls, le_ = st[:, 7].astype(np.int64), st[:, 8].astype(np.int64)
    refilt = sel & (ls < s_arr + max_hang_len) & \
        (le_ > e_arr - max_hang_len) & (le_ > ls)
    con = con + refilt
    sel &= con < min_con_count
    le_out = np.maximum(0, s_arr)
    re_out = np.maximum(0, lens - np.minimum(e_arr, lens))
    out = {}
    for r in np.nonzero(sel)[0]:
        out[int(r)] = dict(
            con=int(con[r]), le=int(le_out[r]), re=int(re_out[r]),
            lim=int(st[r, 3]), rim=int(st[r, 4]), llm=int(st[r, 5]),
            rlm=int(st[r, 6]), lc=int(st[r, 1]), rc=int(st[r, 2]))
    return out


def cns_overlap_stage(store: SeqStore, rids: np.ndarray, k: int = 17,
                      w: int = 17, maxhan1: int = 5000, maxhan2: int = 500,
                      min_span: int = 2000, min_cnt: int = 3,
                      max_occ: int = 16, extend_ends: bool = True,
                      device=None, return_info: bool = False):
    """Full step-2 stage: candidates -> realign -> [end-extend] -> filter.
    Returns (mode-10 OvlBlock, bl_info dict for the graph)[, CnsInfo].
    device=None means the GPU (raises without one)."""
    dev = resolve_device(device)
    idx = build_index(store, rids, k=k, w=w, max_occ=max(64, max_occ * 4),
                      device=dev)
    # every read is a query: the pair-once gate keeps each ava pair a
    # single record, like the reference's pairwise cns_files(i,j) jobs
    # with --dual=yes (nextDenovo:356-366) whose stream the dovetail
    # filter consumes once per pair
    qmask = np.zeros(len(store), bool)
    qmask[np.asarray(rids)] = True
    cand = find_overlaps(store, rids, idx, k=k, w=w, max_occ=max_occ,
                         min_cnt=min_cnt, min_span=min_span,
                         query_mask=qmask, device=dev)
    idx = None           # release the index's device memory before realign
    ovl = realign_overlaps(store, cand, device=dev)
    if extend_ends:
        ovl = extend_overlap_ends(store, ovl, device=dev)
    kept, info = filter_cns_overlaps(ovl, np.asarray(store.length),
                                     maxhan1=maxhan1, maxhan2=maxhan2)
    bl = bl_info_for_graph(info)
    if return_info:
        return kept, bl, info
    return kept, bl
