"""Contig polishing (ctg_align + ctg_cns equivalent), PyTorch + CUDA.

Counterpart of nextdenovo_tpu/polish/driver.py.

The reference maps seed reads back to contigs with minimap2 --step 3, sorts
BAMs, and re-consensuses 5 Mb windows with the same tag-MSA machinery as
correction plus SV detection (lib/ctg_cns.c:3399-3623
ctg_cns_core; window stitching link_consensus :3121-3223).

Device-native redesign: no SAM/BAM round-trip at all —
  1. coarse mapping via the minimizer engine (contigs indexed, reads queried);
  2. per window: read segments are clipped by coordinate interpolation,
     aligned to the window with the banded device aligner, and fed
     to the native tag-MSA consensus (nd_correct) with the window as seed;
  3. windows overlap by STITCH bases and are spliced on an exact suffix
     match, mirroring the reference's 50-base stitch (ctg_cns.c:3620).
  4. structural pass (polish/structure.py): split-read gap clusters feed
     gap-spanning pseudo-reads into the window MSA (generate_gapseqs
     equivalent), and unsupported low-depth regions split the contig
     (update_split_p equivalent), refined by the per-node qv tags carried
     on the contig headers.
"""
from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from ..device import resolve_device
from ..io.seqstore import SeqStore
from ..native import correct_seed
from ..ops.align import band_align
from ..overlap.engine import build_index, find_overlaps
from .structure import analyze_contig

log = logging.getLogger(__name__)

STITCH = 50          # ctg_cns.c:3620-3621
# Window-EDGE trim before stitching: consensus quality degrades in the
# outermost bases of each window (interpolated read clipping, alignment
# endpoint slop, thinner effective coverage), and with 25 kb windows the
# seams are dense enough to matter — measured 2e-2 per-base error in
# 300 bp seam bands vs ~0 in the interior before this fix
# (tests/test_polish_seams.py).  Consecutive windows overlap by
# 2*EDGE + STITCH so the spliced sequence always comes from window
# INTERIORS; the trimmed overlap is exactly STITCH bases.
EDGE = 200
# extra window overlap beyond 2*EDGE + STITCH: consensus length drifts by
# up to ~1% of the window (indel corrections), so the stitch key's
# expected offset in the next trimmed window must sit safely inside the
# search range rather than straddling 0
SLACK = 500
# read-vs-window alignment chunking (see polish_contig): pairs longer
# than CHUNK_T split into ~PIECE-sized independently-aligned supports
CHUNK_T = 6000
PIECE = 5000
_TR = bytes.maketrans(b"ACGT", bytes([0, 1, 2, 3]))


def _interp_read_interval(rec, ws, we):
    """Clip a mapping record to window [ws, we) on the contig; return the
    corresponding read interval by linear interpolation (exact base-level
    clipping happens via re-alignment)."""
    ts, te = rec["ts"], rec["te"]
    qs, qe = rec["qs"], rec["qe"]
    if te <= ws or ts >= we:
        return None
    f = (qe - qs) / max(1, te - ts)
    cs, ce = max(ts, ws), min(te, we)
    if rec["rev"]:
        rqs = qs + int((te - ce) * f)
        rqe = qe - int((cs - ts) * f)
    else:
        rqs = qs + int((cs - ts) * f)
        rqe = qe - int((te - ce) * f)
    return cs, ce, max(0, rqs - 32), rqe + 32


def _window_jobs(ctg: np.ndarray, recs: List[dict], reads: SeqStore,
                 window: int, r0: int, r1: int,
                 pseudo: Optional[List[dict]]):
    """Build every window's support segments for the region [r0, r1).

    Returns a list of (ws, we, segs, tss, tes) — the exact per-window
    construction polish_contig historically did inline; factored out so the
    alignments of ALL windows can run as one batch (fewer, larger device
    launches) and so a multi-device polish can shard the same pair list
    without duplicating this logic."""
    jobs = []
    ws = r0
    while ws < r1:
        we = min(r1, ws + window)
        tss, tes, segs = [], [], []
        for rec in recs:
            iv = _interp_read_interval(rec, ws, we)
            if iv is None:
                continue
            cs, ce, _, _ = iv
            if ce - cs < 200:
                continue
            # Long read-vs-window pairs are split into ~PIECE-sized chunks
            # aligned independently: each chunk is its own MSA support (the
            # consensus does not care that several segments share a read),
            # indel drift per chunk stays far inside the Myers band (25 kb
            # pairs at ~10% error routinely exited the 256-cell band and
            # fell to the slow adaptive retry tier — the dominant polish
            # cost), and chunk boundaries are STAGGERED per read so any
            # boundary alignment slop never piles onto one column.
            if ce - cs <= CHUNK_T:
                pieces = [(cs, ce)]
            else:
                st = (int(rec["qname"]) % 5) * (PIECE // 5)
                bounds = [cs]
                p = cs + st + PIECE if st else cs + PIECE
                while p < ce - PIECE // 2:
                    bounds.append(p)
                    p += PIECE
                bounds.append(ce)
                pieces = list(zip(bounds[:-1], bounds[1:]))
            for (p0, p1) in pieces:
                piv = _interp_read_interval(rec, p0, p1)
                if piv is None:
                    continue
                pcs, pce, prqs, prqe = piv
                if pce - pcs < 200:
                    continue
                seg = reads.subseq(rec["qname"], prqs, prqe,
                                   rc=bool(rec["rev"]))
                if len(seg) < 100:
                    continue
                segs.append(seg.astype(np.int8))
                tss.append(pcs - ws)
                tes.append(pce - ws - 1)
        for p in pseudo or ():
            ts, te = p["ts"], p["te"]
            if te <= ws or ts >= we or te <= ts:
                continue
            f = len(p["seq"]) / max(1, te - ts)
            cs, ce = max(ts, ws), min(te, we)
            if ce - cs < 100:
                continue
            ss = max(0, int((cs - ts) * f) - 32)
            se = min(len(p["seq"]), len(p["seq"]) - int((te - ce) * f) + 32)
            seg = np.asarray(p["seq"][ss:se], np.int8)
            if len(seg) < 50:
                continue
            segs.append(seg)
            tss.append(cs - ws)
            tes.append(ce - ws - 1)
        jobs.append((ws, we, segs, tss, tes))
        ws = we - (2 * EDGE + STITCH + SLACK) if we < r1 else r1
    return jobs


def polish_contig(ctg: np.ndarray, recs: List[dict], reads: SeqStore,
                  window: int = 25000, min_cov: int = 3, read_type: int = 1,
                  pseudo: Optional[List[dict]] = None, region=None,
                  device=None, return_seams: bool = False,
                  align_fn=None) -> np.ndarray:
    """Re-consensus one contig (or the `region` slice of it) from its
    mapped reads, plus any gap-spanning pseudo-read segments.

    All windows' support alignments run as ONE batched align_fn call
    (default: band_align on `device`; None means the GPU), then windows are
    consensused and stitched in order.  align_fn(segs, targets) ->
    band_align-shaped dicts lets a multi-device polish inject its own
    aligner without changing any per-window logic.

    return_seams: also return the output coordinates of every window
    stitch (for seam-error validation, tests/test_polish_seams.py)."""
    n = len(ctg)
    r0, r1 = region if region is not None else (0, n)
    if align_fn is None:
        dev = resolve_device(device)
        align_fn = lambda s, t: band_align(s, t, device=dev)
    jobs = _window_jobs(ctg, recs, reads, window, r0, r1, pseudo)
    flat_segs, flat_tgts = [], []
    for (ws, we, segs, tss, tes) in jobs:
        flat_segs.extend(segs)
        flat_tgts.extend(ctg[ws + a : ws + b + 1].astype(np.int8)
                         for a, b in zip(tss, tes))
    flat_res = align_fn(flat_segs, flat_tgts) if flat_segs else []
    out = ""
    seams: List[int] = []
    ri = 0
    for (ws, we, segs, tss, tes) in jobs:
        wseq = ctg[ws:we]
        res = flat_res[ri : ri + len(segs)]
        ri += len(segs)
        if segs:
            sup_ok, ts_ok, te_ok, ops_ok = [], [], [], []
            for seg, a, b, r in zip(segs, tss, tes, res):
                if r["reached"] and r["ok"]:
                    sup_ok.append(seg.astype(np.uint8))
                    ts_ok.append(a)
                    te_ok.append(b)
                    ops_ok.append(r["ops"].astype(np.uint8))
            ln, ide, seq = correct_seed(
                wseq, sup_ok, ts_ok, te_ok, ops_ok, min_len_aln=100,
                max_cov_aln=100, min_cov=min_cov, max_lq_length=2000,
                min_error_corrected_ratio=0.0, split=False,
                read_type=read_type, keep_all=True)
            wcons = seq.upper() if ln > (we - ws) * 0.5 else _codes_str(wseq)
            # low-depth window edges: the consensus chain only spans covered
            # columns; splice draft sequence for uncovered heads/tails (the
            # reference's ld-region handling, ctg_cns.c:2696-2795)
            if ln > (we - ws) * 0.5:
                wstr = _codes_str(wseq)
                wcons = _splice_uncovered(wstr, wcons)
        else:
            wcons = _codes_str(wseq)
        # trim edge-degraded consensus (interior-only stitching, see EDGE)
        head_trim = EDGE if ws > r0 else 0
        tail_trim = EDGE if we < r1 else 0
        if head_trim or tail_trim:
            wcons = wcons[head_trim : len(wcons) - tail_trim
                          if tail_trim else len(wcons)]
        # stitch on an exact STITCH-mer (link_consensus analogue)
        if not out:
            out = wcons
        else:
            seams.append(len(out))
            key = out[-STITCH:]
            pos = wcons.find(key, 0, max(len(wcons) // 4,
                                         2 * (SLACK + 2 * EDGE)))
            if pos >= 0:
                out = out + wcons[pos + STITCH:]
            else:
                out = out + wcons  # stitch miss: keep both (rare)
    arr = np.frombuffer(out.encode().translate(_TR), np.uint8)
    if return_seams:
        return arr, seams
    return arr


def _splice_uncovered(draft: str, cons: str, k: int = 40) -> str:
    """Re-attach draft head/tail that the consensus chain did not reach,
    anchored on exact k-mer matches."""
    if len(cons) < 2 * k:
        return cons
    head = cons[:k]
    pos = draft.find(head, 0, max(len(draft) // 2, 4 * k))
    if pos > 0:
        cons = draft[:pos] + cons
    tail = cons[-k:]
    pos = draft.rfind(tail, min(len(draft) // 2, len(draft) - 4 * k))
    if 0 <= pos and pos + k < len(draft):
        cons = cons + draft[pos + k:]
    return cons


def _codes_str(codes: np.ndarray) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[np.asarray(codes, np.uint8) & 3
                                            ].tobytes().decode()


def map_polish_reads(contigs: List[np.ndarray], reads: SeqStore,
                     k: int = 15, w: int = 10,
                     shard: Optional[tuple] = None, device=None):
    """ctg_align equivalent: map every read onto the draft contigs via the
    minimizer engine (contigs indexed, reads queried).  Returns an OvlBlock.

    shard=(n_hosts, host_id): query only every n_hosts-th read (round-robin)
    — the multi-host launcher's job-matrix split of the reference's
    ctg_align stage (nextDenovo:368-415).  device=None means the GPU."""
    dev = resolve_device(device)
    joint = SeqStore.from_codes(contigs + [reads.get(i)
                                           for i in range(len(reads))])
    n_ctg = len(contigs)
    rid_reads = np.arange(n_ctg, n_ctg + len(reads))
    if shard is not None:
        n_hosts, host_id = shard
        rid_reads = rid_reads[host_id::n_hosts]
    idx = build_index(joint, np.arange(n_ctg), k=k, w=w, max_occ=256,
                      device=dev)
    # top_k=4: keep secondary chains so reads spanning a misjoin map in >=2
    # fragments — the split-read (SA-tag) evidence polish/structure.py
    # consumes (lib/ctg_cns.c:2158 set_satags)
    return find_overlaps(joint, rid_reads, idx, k=k, w=w, max_occ=8,
                         min_cnt=4, min_span=500, top_k=4, device=dev)


def collect_per_ctg(ovl, n_ctg: int, reads: SeqStore) -> List[List[dict]]:
    """Group mapping records per contig (record order preserved)."""
    per_ctg: List[List[dict]] = [[] for _ in range(n_ctg)]
    for i in range(len(ovl)):
        t = int(ovl.tname[i])
        if 0 <= t < n_ctg:
            rid = int(ovl.qname[i]) - n_ctg
            per_ctg[t].append(dict(
                qname=rid, rev=int(ovl.rev[i]),
                qs=int(ovl.qs[i]), qe=int(ovl.qe[i]),
                ts=int(ovl.ts[i]), te=int(ovl.te[i]),
                qlen=int(reads.length[rid])))
    return per_ctg


MAX_PATCH_GAP = 30000      # MAX_GAP_LEN, ctg_cns.h via check_indel


def apply_gap_patches(ctg: np.ndarray, recs: List[dict], clusters,
                      reads: SeqStore, read_type: int = 1,
                      device=None, align_fn=None):
    """Local reassembly of split-read gap clusters.

    The reference repairs draft indels by splicing gap-spanning read
    subsequences into the window MSA at exact tag positions
    (generate_gapseqs + update_align_tags, lib/ctg_cns.c:
    2837-2998).  Our window MSA aligns supports with a banded aligner, so
    indels beyond the band (~250 bp) cannot be expressed that way; instead
    each well-supported cluster is repaired EXPLICITLY: the members'
    gap-spanning subsequences are consensused (median-length member as
    backbone, corrected by the rest) and the result spliced over the
    cluster's contig region.  Subsequent window re-consensus then sees a
    draft the reads span and polishes the patch like any other sequence.

    Returns (patched ctg, shifted recs, map_pos, patched_cluster_set):
    map_pos translates original contig coords to patched coords; clusters
    with <3 alignable members are left for the pseudo-read path.
    """
    live = [c for c in clusters if not getattr(c, "dead", True)]
    patches = []
    patched_ids = set()
    for clu in live:
        seqs = []
        for gp in clu.gaps:
            if not gp.valid:
                continue
            ds, de = max(0, gp.ds), min(gp.qlen, gp.de)
            if de - ds < 100:
                continue
            if gp.rev:
                seq = reads.subseq(gp.read, gp.qlen - de, gp.qlen - ds,
                                   rc=True)
            else:
                seq = reads.subseq(gp.read, ds, de)
            if len(seq) >= 100:
                seqs.append(np.asarray(seq, np.int8))
        if len(seqs) < 3:
            continue
        order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
        bb = seqs[order[len(order) // 2]]
        sups = [seqs[i] for i in order if seqs[i] is not bb][:40]
        if align_fn is not None:
            res = align_fn(sups, [bb] * len(sups))
        else:
            res = band_align(sups, [bb] * len(sups), device=device)
        ok_s, ts_l, te_l, ops_l = [], [], [], []
        for s, r in zip(sups, res):
            if r["reached"] and r["ok"]:
                ok_s.append(s.astype(np.uint8))
                ts_l.append(0)
                te_l.append(len(bb) - 1)
                ops_l.append(r["ops"].astype(np.uint8))
        if len(ok_s) >= 2:
            ln, _ide, seq = correct_seed(
                bb.astype(np.uint8), ok_s, ts_l, te_l, ops_l,
                min_len_aln=100, max_cov_aln=60, min_cov=2,
                max_lq_length=2000, min_error_corrected_ratio=0.0,
                split=False, read_type=read_type, keep_all=True)
            patch = np.frombuffer(seq.upper().encode().translate(_TR),
                                  np.uint8) if ln > len(bb) * 0.5 else bb
        else:
            patch = bb
        rs, re_ = int(clu.rs), int(clu.re)
        L0 = re_ - rs
        if not (0 <= rs < re_ <= len(ctg)) or len(patch) < L0 // 5 or \
                len(patch) > L0 + MAX_PATCH_GAP:
            continue
        patches.append((rs, re_, patch))
        patched_ids.add(id(clu))
    if not patches:
        return ctg, recs, (lambda p: p), patched_ids, {}

    patches.sort(key=lambda p: p[0])

    def map_pos(p: int) -> int:
        """Original -> patched coords.  Endpoints INSIDE a patched region
        clamp to the nearest patch border: mapping records computed against
        the unpatched draft, a border-crossing endpoint has no meaningful
        interior position (stretch-interpolating it misregisters the
        support segment and corrupts the window MSA around the patch)."""
        shift = 0
        for rs, re_, patch in patches:
            if p >= re_:
                shift += len(patch) - (re_ - rs)
            elif p > rs:
                near_end = (p - rs) > (re_ - p)
                return shift + rs + (len(patch) if near_end else 0)
        return p + shift

    parts, prev = [], 0
    patch_map = {}
    for rs, re_, patch in patches:
        parts.append(ctg[prev:rs])
        parts.append(patch)
        patch_map[(rs, re_)] = (map_pos(rs), len(patch))
        prev = re_
    parts.append(ctg[prev:])
    new_ctg = np.concatenate(parts)
    new_recs = [dict(r, ts=map_pos(r["ts"]), te=map_pos(r["te"]))
                for r in recs]
    log.info("gap patches: %d applied (%s)", len(patches),
             ", ".join(f"[{rs}:{re_})->{len(p)}bp"
                       for rs, re_, p in patches))
    return new_ctg, new_recs, map_pos, patched_ids, patch_map


def warn_fragmented(per_ctg: List[List[dict]], ctg_lens: List[int],
                    read_type: int) -> float:
    """HiFi fragment-mapping warning (lib/ctg_cns.c:
    3598-3617): when more than 10% of HiFi mappings are fragments (the
    alignment covers <90% of the read while away from a contig end), warn
    that the draft should be polished with other reads first or mapping
    made more error-tolerant.  Returns the fragment fraction."""
    if read_type != 3:
        return 0.0
    total = frag = 0
    for recs, L in zip(per_ctg, ctg_lens):
        for r in recs:
            total += 1
            if (r["qe"] - r["qs"]) < 0.9 * r["qlen"] and \
                    r["ts"] > 500 and r["te"] + 500 < L:
                frag += 1
    fra = frag / (total + 1)
    if fra > 0.1:
        log.warning(
            "Too many (%.3f%%) fragment mappings: please polish the genome "
            "with other reads first, or relax the mapping parameters to "
            "tolerate more errors; continuing anyway",
            100.0 * frag / (total + 1))
    return fra


def polish_one(ctg: np.ndarray, recs: List[dict], reads: SeqStore,
               qv: List[dict], read_type: int = 1, min_cov: int = 3,
               window: int = 25000, split: bool = True,
               struct_min_reads: int = 150,
               device=None, align_fn=None) -> List[np.ndarray]:
    """Polish one contig -> its polished pieces (>1 when the structural
    pass splits an unsupported join, ctg_cns `-sp`).  device=None means the
    GPU (raises without one) unless align_fn is given."""
    if align_fn is None:
        device = resolve_device(device)
    ana = analyze_contig(
        len(ctg), recs, qv,
        lambda rid, s, e, rc: reads.subseq(rid, s, e, rc=rc),
        min_reads=struct_min_reads)
    # repair well-supported gap clusters by local reassembly; weakly
    # supported ones fall back to the pseudo-read MSA path
    ctg, recs, map_pos, patched, patch_map = apply_gap_patches(
        ctg, recs, ana.get("clusters", []), reads, read_type=read_type,
        device=device, align_fn=align_fn)
    # cluster-member reads become pseudo supports over their (re-mapped)
    # patch interval, so the window MSA refines the spliced patch like any
    # covered sequence; unpatched clusters keep their original role
    pseudo = []
    for p in ana["pseudo"]:
        key = (p["ts"], p["te"])
        if key in patch_map:
            new_rs, new_len = patch_map[key]
            pseudo.append(dict(p, ts=new_rs, te=new_rs + new_len))
        else:
            pseudo.append(dict(p, ts=map_pos(p["ts"]),
                               te=map_pos(p["te"])))
    splits = [(map_pos(s), map_pos(e)) for s, e in ana["splits"]] \
        if split else []
    cuts = sorted((s + e) // 2 for s, e in splits)
    bounds = [0] + [c for c in cuts if 0 < c < len(ctg)] + [len(ctg)]
    pieces = []
    for a, b in zip(bounds, bounds[1:]):
        if b - a < 1:
            continue
        pieces.append(polish_contig(
            ctg, recs, reads, window=window, min_cov=min_cov,
            read_type=read_type, pseudo=pseudo, region=(a, b),
            device=device, align_fn=align_fn))
    return pieces


def run_polish(contigs: List[np.ndarray], reads: SeqStore,
               k: int = 15, w: int = 10, read_type: int = 1,
               min_cov: int = 3, window: int = 25000,
               node_qv: Optional[List[List[dict]]] = None,
               split: bool = True, struct_min_reads: int = 150,
               device=None, ovl=None,
               contig_ids=None, align_fn=None) -> List[np.ndarray]:
    """Polish every contig with the read set.  Returns polished contigs
    (possibly more than the input when `split` breaks unsupported joins,
    the reference's ctg_cns `-sp` behaviour).

    ovl: precomputed mapping block (map_polish_reads), e.g. gathered from
    sharded multi-host mapping.  contig_ids: polish only these contigs
    (multi-host contig shard); output order follows contig_ids."""
    dev = resolve_device(device)
    if not contigs:
        return []
    if ovl is None:
        ovl = map_polish_reads(contigs, reads, k=k, w=w, device=dev)
    per_ctg = collect_per_ctg(ovl, len(contigs), reads)
    warn_fragmented(per_ctg, [len(c) for c in contigs], read_type)
    out = []
    ids = range(len(contigs)) if contig_ids is None else contig_ids
    for ci in ids:
        ctg = contigs[ci]
        recs = per_ctg[ci]
        qv = node_qv[ci] if node_qv and ci < len(node_qv) else []
        pieces = polish_one(ctg, recs, reads, qv, read_type=read_type,
                            min_cov=min_cov, window=window, split=split,
                            struct_min_reads=struct_min_reads,
                            device=dev, align_fn=align_fn)
        out.extend(pieces)
        log.info("polish: contig %d %d -> %s bp (%d reads, %d splits)",
                 ci, len(ctg), "+".join(str(len(p)) for p in pieces),
                 len(recs), len(pieces) - 1)
    return out
