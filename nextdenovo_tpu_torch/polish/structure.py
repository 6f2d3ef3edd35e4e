"""Structural-error machinery for contig polishing.

Counterpart of nextdenovo_tpu/polish/structure.py: the equivalent of the
reference's SA-tag / gap-cluster subsystem in
lib/ctg_cns.c:
  - split-read indel candidates         (check_indel :2463-2493)
  - spanning-depth bins                 (update_ref_d/ds :3315-3329,
                                         cal_rreads_w :3225, cal_ref_d :3298)
  - gap clustering + robust median      (update_gap_cluster :2552-2613,
                                         cal_gap_cluster_median :2513)
  - gap-spanning pseudo-read extraction (generate_gapseqs :2898-2996)
  - low-depth region scan               (update_ld_regs :2696-2746,
                                         update_ld_regs_with_refqv :2753-2795)
  - unsupported split points            (update_split_p :2999-3052)

The reference discovers split reads from BAM SA tags; here a read that maps
to the same contig in >=2 fragments plays that role directly (no SAM/BAM
round-trip).  All of this is host-side control logic operating on mapping
coordinates; the base-level work (re-aligning pseudo-reads into the window
MSA) rides the same device alignment path as every other support read.

Coordinates: mapping records carry forward-read qs/qe plus a rev flag;
"oriented" read coordinates below run along the contig direction
(d = qlen - qe .. qlen - qs when rev).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# constants from lib/ctg_cns.h:26-38 and ctg_cns.c:2459-2460
INS_WIN_STEP = 10
INS_WIN_DIV = 20
INS_WIN_MIN_SIZE = 500
INS_MIN_DEPTH_RATIO = 0.1
INS_MIN_DEPTH_RATIO_REFQV = 0.3
CLUSTER_MIN_DEPTH_RATIO = 0.2
TEM_CLIP_RATIO = 0.1
MAX_GAP_LEN = 30000
ENDING_FLANK = 1000            # update_split_p local
LQSEQ_MAX_CAN_COUNT = 60


@dataclass
class Gap:
    """One split-read indel candidate (the reference's gap_ record)."""
    gs: int                    # contig gap interval
    ge: int
    read: int                  # read id (into the mapping store)
    rev: int
    qlen: int
    f1: dict                   # upstream fragment mapping record
    f2: dict                   # downstream fragment
    score: int = 0
    # filled by gap_regions(): oriented read coords spanning the region
    ds: int = -1
    de: int = -1
    valid: bool = False


@dataclass
class GapCluster:
    gaps: List[Gap] = field(default_factory=list)
    median: int = 0
    rs: int = 0                # selected contig region [rs, re]
    re: int = 0
    dead: bool = False


def _oriented(rec: dict) -> tuple:
    """Oriented (contig-direction) read interval of a mapping record."""
    if rec["rev"]:
        return rec["qlen"] - rec["qe"], rec["qlen"] - rec["qs"]
    return rec["qs"], rec["qe"]


def detect_gaps(recs: List[dict]) -> List[Gap]:
    """Split-read indel candidates, check_indel semantics
    (ctg_cns.c:2463-2493): both fragments near the read ends (clips <
    TEM_CLIP_RATIO * qlen), consistent ordering on contig and read, both
    jumps < MAX_GAP_LEN; keep the minimum-score fragment pair per read."""
    by_read: Dict[tuple, List[dict]] = {}
    for r in recs:
        by_read.setdefault((r["qname"], r["rev"]), []).append(r)
    gaps = []
    for (rid, rev), frags in by_read.items():
        if len(frags) < 2:
            continue
        qlen = frags[0]["qlen"]
        mclen = int(qlen * TEM_CLIP_RATIO)
        frags.sort(key=lambda f: f["ts"])
        best: Optional[Gap] = None
        for i in range(len(frags)):
            for j in range(i + 1, len(frags)):
                f1, f2 = frags[i], frags[j]
                d1s, d1e = _oriented(f1)
                d2s, d2e = _oriented(f2)
                if not (f2["te"] > f1["te"] and d2e > d1e):
                    continue
                if not (d1s < mclen and d2e > qlen - mclen):
                    continue
                if abs(f2["ts"] - f1["te"]) >= MAX_GAP_LEN:
                    continue
                if abs(d2s - d1e) >= MAX_GAP_LEN or f1["ts"] == f2["ts"]:
                    continue
                score = d1s + qlen - d2e + abs(f2["ts"] - f1["te"]) \
                    + abs(d2s - d1e)
                if best is None or score < best.score:
                    gs, ge = sorted((f1["te"], f2["ts"]))
                    best = Gap(gs=gs, ge=ge, read=rid, rev=rev, qlen=qlen,
                               f1=f1, f2=f2, score=score)
        if best is not None:
            gaps.append(best)
    return gaps


def spanning_width(spans: np.ndarray) -> int:
    """rreads_w (cal_rreads_w, ctg_cns.c:3225-3248): median span length /
    INS_WIN_DIV, floored at INS_WIN_MIN_SIZE."""
    if len(spans) == 0:
        return INS_WIN_MIN_SIZE
    lens = np.sort(spans[:, 1] - spans[:, 0])
    w = (int(lens[len(lens) // 2]) + 1) // INS_WIN_DIV
    return max(w, INS_WIN_MIN_SIZE)


def spanning_depth(ctg_len: int, spans: np.ndarray, w: int) -> np.ndarray:
    """Depth of well-anchored alignments per INS_WIN_STEP bin
    (update_ref_d, ctg_cns.c:3315-3323): an alignment contributes only to
    bins at least w inside its span, and only if it is >= 3w long."""
    nbins = max(1, ctg_len // INS_WIN_STEP)
    diff = np.zeros(nbins + 1, np.int64)
    for s, e in np.asarray(spans, np.int64):
        if e - s + 1 < 3 * w:
            continue
        b0 = (s + w) // INS_WIN_STEP
        b1 = (e - 2 * w) // INS_WIN_STEP
        if b1 >= b0 and b0 < nbins:
            diff[b0] += 1
            diff[min(b1 + 1, nbins)] -= 1
    ds = np.cumsum(diff[:-1])
    return np.minimum(ds, np.iinfo(np.uint16).max).astype(np.uint16)


def median_depth(ds: np.ndarray) -> int:
    """cal_ref_d (ctg_cns.c:3298-3313): median of the bins, ignoring a
    length-scaled clip at each end plus leading/trailing zeros; falls back
    to an iterative trimmed mean for long low-coverage windows."""
    l = len(ds)
    if l == 0:
        return 0
    ign5 = 10000 if l > 20000 else (100 if l > 200 else 20)
    i = min(ign5, l - 1)
    while i < l - 1 and ds[i] == 0:
        i += 1
    j = l - 1
    while j > i and ds[j] == 0:
        j -= 1
    t = ds[i : j + 1]
    if len(t) == 0:
        return 0
    low = int((t < 4).sum())
    if l > 50000 and low / len(t) > 0.2:
        # cal_ref_d_ave: mean of nonzero bins below 3x running mean
        h, mean = 0, 150
        while mean > h / 3:
            h = mean * 3
            sub = t[::10]
            sub = sub[(sub > 0) & (sub < h)]
            if len(sub) == 0:
                return 0
            mean = int(sub.mean())
        return mean
    return int(np.partition(t, len(t) // 2)[len(t) // 2])


def _cluster_median(members: List[Gap]) -> int:
    """Robust cluster median (cal_gap_cluster_median, ctg_cns.c:2513-2551):
    smallest window (growing by 10 up to 100) whose densest center holds
    >= max(3, n/6) gap midpoints; else the plain median midpoint."""
    mids = sorted((g.gs + g.ge) // 2 for g in members)
    n = len(mids)
    offset = 10
    while offset <= 100:
        best_c, best_m, best_diff = 0, 0, 1 << 62
        prev = -1
        for m in mids:
            if m == prev:
                continue
            prev = m
            lo, hi = m - offset, m + offset
            cnt, diff = 0, 0
            for m2 in mids:
                if lo <= m2 <= hi and m2 != m:
                    cnt += 1
                    diff += abs(m2 - m)
            if cnt > best_c or (cnt == best_c and diff < best_diff):
                best_c, best_m, best_diff = cnt, m, diff
        if best_c >= max(3, n // 6):
            return best_m
        offset += 10
    return mids[n // 2]


def cluster_gaps(gaps: List[Gap], ds: np.ndarray, d: int,
                 ref_s: int = 0) -> List[GapCluster]:
    """update_gap_cluster (ctg_cns.c:2552-2613): overlapping gap intervals
    in low-spanning-depth territory (bin depth < d/2) form a cluster; keep
    clusters with > d * CLUSTER_MIN_DEPTH_RATIO members whose local depth
    is below the member count."""
    if d < 10 or not gaps:
        return []
    md = int(d * CLUSTER_MIN_DEPTH_RATIO)
    gaps = sorted(gaps, key=lambda g: (g.gs, g.ge))
    nbins = len(ds)

    def bin_depth(p):
        b = (p - ref_s) // INS_WIN_STEP
        return int(ds[min(max(b, 0), nbins - 1)]) if nbins else 0

    clusters = []
    i = 0
    n = len(gaps)
    while i < n - md:
        p = (gaps[i].gs + gaps[i].ge) // 2
        if p - ref_s < 0 or bin_depth(p) >= d // 2:
            i += 1
            continue
        e = gaps[i].ge
        members = [gaps[i]]
        t = 1
        j = i + 1
        while j < n and gaps[j].gs <= e:
            if bin_depth((gaps[j].gs + gaps[j].ge) // 2) < d // 2:
                t += 1
                e = max(e, gaps[j].ge)
                if len(members) < LQSEQ_MAX_CAN_COUNT * 2:
                    members.append(gaps[j])
            j += 1
        i = j
        if len(members) > md and bin_depth(p) < t:
            clusters.append(GapCluster(gaps=members))
    for clu in clusters:
        clu.median = _cluster_median(clu.gaps)
    return clusters


def _read_pos_at(frag: dict, ctg_pos: int) -> int:
    """Oriented read coordinate of a contig position inside a fragment, by
    linear interpolation (the exact base is recovered by re-alignment
    downstream; the reference walks align tags here, ctg_cns.c:2948-2965)."""
    ds, de = _oriented(frag)
    span = max(1, frag["te"] - frag["ts"])
    f = (de - ds) / span
    return int(ds + (ctg_pos - frag["ts"]) * f)


def gap_regions(clusters: List[GapCluster]) -> None:
    """Pick each cluster's contig region and member read intervals
    (generate_gapseqs, ctg_cns.c:2898-2996 simplified): grow a window
    around the median until at least half of the members span it with
    their two fragments, then record oriented read coords per member."""
    for clu in clusters:
        members = clu.gaps
        # the reference grows from 10 bp because its gapseqs are spliced in
        # at exact tag positions; we re-align the pseudo-reads, so start at
        # a window wide enough for the banded aligner to anchor (>=400 bp)
        best_cnt, best = 0, (clu.median - 200, clu.median + 200)
        offset, prev_cnt = 200, -1
        while offset < 30000:
            s, e = clu.median - offset, clu.median + offset
            cnt = 0
            for g in members:
                if g.f1["ts"] < s < g.f1["te"] and \
                        g.f2["ts"] < e < g.f2["te"] and \
                        s < g.f2["ts"] and e > g.f1["te"]:
                    cnt += 1
            if cnt > best_cnt:
                best_cnt, best = cnt, (s, e)
            if cnt >= max(1, len(members) // 2) or cnt < prev_cnt:
                break
            prev_cnt = cnt
            offset += 10
        clu.rs, clu.re = best
        nvalid = 0
        for g in members:
            if not (g.f1["ts"] <= clu.rs <= g.f1["te"] and
                    g.f2["ts"] <= clu.re <= g.f2["te"]):
                continue
            g.ds = _read_pos_at(g.f1, clu.rs)
            g.de = _read_pos_at(g.f2, clu.re)
            if g.de > g.ds + 10:
                g.valid = True
                nvalid += 1
        if nvalid == 0:
            clu.dead = True
    # merge clusters closer than 500 bp: keep the better-supported one
    # (ctg_cns.c:2977-2985)
    for a, b in zip(clusters, clusters[1:]):
        if a.dead or b.dead:
            continue
        if a.re + 500 >= b.rs:
            na = sum(g.valid for g in a.gaps)
            nb = sum(g.valid for g in b.gaps)
            (a if nb > na else b).dead = True


def gap_pseudo_seqs(clusters: List[GapCluster], get_read) -> List[dict]:
    """Extract the gap-spanning read subsequences (the reference's gapseq
    pseudo-reads fed back into the MSA via update_align_tags).  get_read
    (rid, start, end, rc) -> codes.  Returns dicts with contig interval
    [ts, te) and the oriented read codes."""
    out = []
    for clu in clusters:
        if clu.dead:
            continue
        for g in clu.gaps:
            if not g.valid:
                continue
            ds, de = max(0, g.ds), min(g.qlen, g.de)
            if g.rev:
                seq = get_read(g.read, g.qlen - de, g.qlen - ds, True)
            else:
                seq = get_read(g.read, ds, de, False)
            if len(seq):
                out.append(dict(ts=clu.rs, te=clu.re, seq=seq,
                                read=g.read))
    return out


def low_depth_regions(ds: np.ndarray, w: int, d: int) -> List[tuple]:
    """update_ld_regs (ctg_cns.c:2696-2746): maximal runs of bins at depth
    <= d * INS_MIN_DEPTH_RATIO, expanded while depth <= 2x that, merged when
    closer than INS_WIN_DIV/2 * w bases."""
    l = len(ds)
    md = int(d * INS_MIN_DEPTH_RATIO)
    md2 = md * 2
    regs: List[list] = []
    i = 0
    while i < l:
        if ds[i] <= md:
            s = i
            while s > 1 and ds[s] <= md2:
                s -= 1
            e = i
            while e < l and ds[e] <= md2:
                e += 1
            rs = s * INS_WIN_STEP if s > 1 else 0
            re = (e - 1) * INS_WIN_STEP + w
            if regs and rs <= regs[-1][1] + INS_WIN_DIV // 2 * w:
                regs[-1][1] = max(regs[-1][1], re)
            else:
                regs.append([rs, re])
            i = e
        i += 1
    return [tuple(r) for r in regs]


def refqv_regions(ds: np.ndarray, qv: List[dict], w: int, d: int,
                  s_t: int, e_t: int, ide_ratio: float = 0.8,
                  ort_t: int = 800, irt_t: int = 800) -> List[tuple]:
    """update_ld_regs_with_refqv (ctg_cns.c:2753-2795): contig nodes whose
    join quality is poor on all three measures AND that sit near a
    depth dip become point break candidates."""
    if not qv:
        return []
    ides = sorted(q["ide"] for q in qv)
    ref_ide = ides[len(ides) // 2]
    if ref_ide == 0:
        return []
    ide_t = ref_ide * ide_ratio
    d_t = d * INS_MIN_DEPTH_RATIO_REFQV
    ww = w * INS_WIN_DIV
    nbins = len(ds)
    out = []
    for q in qv:
        p = q["p"]
        if not (s_t <= p < e_t):
            continue
        if not (q["ide"] < ide_t and q["ort"] < ort_t and q["irt"] < irt_t):
            continue
        b0 = max(0, (p - 2 * ww - s_t) // INS_WIN_STEP)
        b1 = min(nbins - 1, (p + 2 * ww - s_t) // INS_WIN_STEP)
        if b1 >= b0 and (ds[b0 : b1 + 1] <= d_t).any():
            out.append((p - s_t, p + 1 - s_t))
    return out


def merge_regions(regs: List[tuple], w: int) -> List[tuple]:
    """Sort + coalesce regions closer than INS_WIN_DIV/2 * w
    (ctg_cns.c:2776-2785)."""
    regs = sorted(regs)
    out: List[list] = []
    for s, e in regs:
        if out and s < out[-1][1] + INS_WIN_DIV // 2 * w:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(r) for r in out]


def split_points(ld_regs: List[tuple], clusters: List[GapCluster],
                 qv: List[dict], ctg_len: int) -> List[tuple]:
    """update_split_p (ctg_cns.c:2999-3052): low-depth regions away from
    the contig ends and not explained by any gap cluster become split
    regions (merged when < 10 kb apart); each is then narrowed to the
    worst-quality contig node inside it when that node's summed quality is
    < 2900."""
    regions = [(c.rs, c.re) for c in clusters if not c.dead]
    splits: List[list] = []
    for rs, re in ld_regs:
        if rs < ENDING_FLANK or re + ENDING_FLANK > ctg_len:
            continue
        explained = any(not (cr_e < rs or cr_s > re)
                        for cr_s, cr_e in regions)
        if explained:
            continue
        if splits and rs <= splits[-1][1] + 10000:
            splits[-1][1] = max(splits[-1][1], re)
        else:
            splits.append([rs, re])
    out = []
    for rs, re in splits:
        best_sco, best_p = 0, None
        for q in qv or []:
            if rs <= q["p"] <= re:
                sco = q["ide"] + q["ort"] + q["irt"]
                if best_sco == 0 or sco < best_sco:
                    best_sco, best_p = sco, q["p"]
        if best_p is not None and best_sco < 2900:
            out.append((best_p, best_p))
        else:
            out.append((rs, re))
    return out


def analyze_contig(ctg_len: int, recs: List[dict], qv: List[dict],
                   get_read, min_reads: int = 150,
                   min_split_depth: int = 15) -> dict:
    """Run the full structural pass for one contig: returns
    dict(pseudo=[{ts,te,seq,read}], splits=[(s,e)], depth=int).
    Gating mirrors ctg_cns_core (ctg_cns.c:3557, :3581): too few mapped
    reads disables the machinery; splits need median depth > 15."""
    if len(recs) < min_reads:
        return dict(pseudo=[], splits=[], depth=0, clusters=[])
    spans = np.array([[r["ts"], r["te"]] for r in recs], np.int64)
    w = spanning_width(spans)
    ds = spanning_depth(ctg_len, spans, w)
    d = median_depth(ds)
    gaps = detect_gaps(recs)
    clusters = cluster_gaps(gaps, ds, d)
    gap_regions(clusters)
    pseudo = gap_pseudo_seqs(clusters, get_read)
    ld = low_depth_regions(ds, w, d)
    ld += refqv_regions(ds, qv or [], w, d, 0, ctg_len)
    ld = merge_regions(ld, w)
    splits = split_points(ld, clusters, qv or [], ctg_len) \
        if d > min_split_depth else []
    return dict(pseudo=pseudo, splits=splits, depth=d, clusters=clusters)
