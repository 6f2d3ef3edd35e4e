"""All-vs-all overlap engine: minimizer index + diagonal-vote chaining
(PyTorch).

Counterpart of nextdenovo_tpu/overlap/engine.py.  Design:

  * the index is a hash-sorted flat table queried with vectorized binary
    search (on the card within a bucket of a directory of hash starts)
    instead of a bucketed hash table;
  * candidate overlaps come from diagonal-band voting over anchors (sorted
    once, then reduced per segment) rather than an O(n * lookback) chain
    DP — endpoints are anchor extents within the winning diagonal corridor.
    Precise endpoints/identity are recovered downstream by the banded
    aligner.

The device program of one query batch (_match_block, _vote_emit) is three
hand-written CUDA kernels (csrc/engine.cu) with two stable torch.sort
lexsorts between them:

  engine_anchor   replaces _match_block's lookup and expansion: a lower
                  bound within the hash's bucket of a directory of the index
                  (anchor_directory, made once a find_overlaps call), up to
                  max_occ occurrences, the gates, the taken anchors
                  compacted; one launch, each block's offset the totals of
                  the blocks before it (no cumsum);
  vote_corridor   replaces _vote_emit's vote: per (query, target, strand)
                  group the bin counts (counted once into a tile in shared
                  memory), top_k corridors and each anchor's corridor, one
                  warp a group;
  chain_emit      replaces _vote_emit's chain scoring and emission: per
                  group the corridor segments' link scores, extents and
                  suppression, and the emit flag, one warp a group walking
                  it once.

_vote_emit finds the groups' starts once, on the device with no host sync
(group_starts), and hands both kernels the same: the second sort permutes
anchors only inside a (query, target, strand) group.  A _match_block call
syncs with the host twice (engine_anchor's anchor count, the emitted
records' count).

Arrays are sized by their content: minimizer and anchor lists are compacted
(padding entries never take part in any segment of valid anchors, so the
emitted records are the same), while the per-launch caps on minimizers
(`cap`) and emitted records (`cap_out`) keep their truncate-the-first-N
semantics and overflow counts.
"""
from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..device import check_tensor, resolve_device
from ..io.seqstore import SeqStore
from ..ops.segment import (segment_argmax, segment_max, segment_min,
                           segment_starts, segment_sum)
from ..ops.sketch import sketch, sketch_wide
from .records import OvlBlock

I32MAX = 2**31 - 1

REC_FIELDS = ("qname", "rev", "qs", "qe", "tname", "ts", "te", "match")


STRAND_BIT = 30          # index pos field: bit 30 = strand (pos < 2^20
POS_MASK = (1 << 30) - 1  # always — reads cap at 1 Mb)


class MiniIndex(NamedTuple):
    h: torch.Tensor       # int64 sorted hashes in [0, 2^32)
    rid: torch.Tensor     # int32 global read id
    pos: torch.Tensor     # int32 k-mer start (fwd coords) | strand << 30
    n: int                # valid entries
    lens: torch.Tensor    # int32 (n_reads,) read length lookup

    def unpack(self):
        """(pos, strand) numpy views for host consumers/partitioners."""
        p = self.pos.cpu().numpy()
        return p & POS_MASK, p >> STRAND_BIT


def _build_index(h, rid, pos, strand, lens, max_occ: int, device) -> MiniIndex:
    """Host-side (numpy) hash-sort + high-frequency filter: a one-off
    O(n log n) sort in the unsigned order of the hashes.  The resulting
    arrays live on `device` and are consumed by _match_block."""
    h = np.asarray(h, np.uint32)
    rid = np.asarray(rid, np.int32)
    pos = np.asarray(pos, np.int32)
    strand = np.asarray(strand, np.int32)
    order = np.argsort(h, kind="stable")
    h, rid, pos, strand = h[order], rid[order], pos[order], strand[order]
    # high-frequency filter (minimap2 -f analogue): drop hashes with more
    # than max_occ entries entirely
    starts = np.ones(len(h), bool)
    if len(h) > 1:
        starts[1:] = h[1:] != h[:-1]
    seg = np.cumsum(starts) - 1
    cnt = np.bincount(seg, minlength=seg[-1] + 1 if len(seg) else 0)[seg] \
        if len(seg) else np.zeros(0, np.int64)
    keep = (cnt <= max_occ) & (rid >= 0)
    h = np.where(keep, h, np.uint32(0xFFFFFFFF))
    order2 = np.argsort(h, kind="stable")
    h, rid, pos, strand = h[order2], rid[order2], pos[order2], strand[order2]
    posst = pos | (strand.astype(np.int32) << STRAND_BIT)
    if len(h) == 0:
        # one sentinel row keeps the table non-empty for the lookups
        h = np.full(1, 0xFFFFFFFF, np.uint32)
        rid = np.full(1, -1, np.int32)
        posst = np.zeros(1, np.int32)
    return MiniIndex(torch.from_numpy(h.astype(np.int64)).to(device),
                     torch.from_numpy(rid).to(device),
                     torch.from_numpy(posst).to(device),
                     int(keep.sum()),
                     torch.from_numpy(np.asarray(lens, np.int32)).to(device))


# Hard cap on sketch-row buffer length.  Reads longer than this are split
# into halo-chunked rows, so no sketch batch is wider than CHUNK_LP.
CHUNK_LP = 16384


def _chunk_rows(rids, lens, k: int, w: int, hpc: bool = False):
    """Split reads into sketch rows of buffer length <= CHUNK_LP.

    Each row OWNS a base range of its read and carries halos: a left halo
    of w-1 bases (every window that can select an owned position starts at
    most w-1 before it) and a right halo of w+k-2 bases (those windows'
    k-mers are complete).  With the sketcher's own_lo/own_hi gate, the
    union of owned minimizers over chunks is exactly the full-read
    minimizer set.  HPC rows (runs compress) use the reference's inflated
    original-coord halos, 16x + 64: a run longer than that slack next to a
    chunk edge can lose or move minimizers, as in the reference.

    Returns a list of rows (rid, g0, own_lo, own_hi, buf_len) with
    own_lo/own_hi buffer-local and g0 the buffer's original-coord start.
    """
    if hpc:
        halo_l = (w - 1) * 16 + 64
        halo_r = (w + k - 1) * 16 + 64
    else:
        halo_l = w - 1
        halo_r = w + k - 2
    own_len = CHUNK_LP - halo_l - halo_r
    assert own_len > 0
    rows = []
    for r in rids:
        L = int(lens[r])
        if L <= CHUNK_LP:
            rows.append((int(r), 0, 0, L, L))
            continue
        o = 0
        while o < L:
            o1 = min(o + own_len, L)
            g0 = max(0, o - halo_l)
            g1 = min(L, o1 + halo_r)
            rows.append((int(r), g0, o - g0, o1 - g0, g1 - g0))
            o = o1
    return rows


def sketch_inputs(store: SeqStore, rows):
    """A batch of chunk rows as the sketchers take it: codes (len(rows), L)
    int8, lengths, own_lo, own_hi (len(rows),) int32, in numpy."""
    L = max(max(r[4] for r in rows), 1)
    # int8 keeps the host->device copy 4x smaller (base codes are 0..4);
    # the sketchers mask to 2 bits on device
    codes = np.zeros((len(rows), L), np.int8)
    blens = np.zeros(len(rows), np.int32)
    olo = np.zeros(len(rows), np.int32)
    ohi = np.zeros(len(rows), np.int32)
    for i, (r, g0, lo, hi, bl) in enumerate(rows):
        c = store.get(int(r))[g0 : g0 + bl]
        codes[i, : len(c)] = c
        blens[i] = len(c)
        olo[i], ohi[i] = lo, hi
    return codes, blens, olo, ohi


def _sketch_rows(store: SeqStore, rows, k: int, w: int, cap: int, device,
                 hpc: bool = False):
    """Sketch a batch of chunk rows as one (len(rows), L) launch.  k > 31
    or hpc routes to the long-kmer/HPC sketcher (the HiFi -k51 -w51 path).
    Returned positions are BUFFER-local; callers add each row's g0."""
    codes, blens, olo, ohi = sketch_inputs(store, rows)
    to = lambda a: torch.from_numpy(a).to(device)
    if k > 31 or hpc:
        return sketch_wide(to(codes), to(blens), k=k, w=w, cap=cap, hpc=hpc,
                           own_lo=to(olo), own_hi=to(ohi))
    return sketch(to(codes), to(blens), k=k, w=w, cap=cap,
                  own_lo=to(olo), own_hi=to(ohi))


def build_index(store: SeqStore, rids: np.ndarray, k: int, w: int,
                max_occ: int = 64, batch_rows: int = 32, hpc: bool = False,
                device=None) -> MiniIndex:
    """Sketch reads `rids` of `store` and build a queryable index on
    `device` (None = the GPU).  hpc: sketch the homopolymer-compressed
    reads (positions stay in original coordinates); find_overlaps never
    compresses its queries, as in the reference.

    Reads are batched in length order so each sketch batch carries rows of
    similar length, and long reads are halo-chunked (_chunk_rows).  Index
    entry order is irrelevant — _build_index re-sorts by hash."""
    from ..utils import span as _tspan
    dev = resolve_device(device)
    lens = np.asarray(store.length, np.int64)
    parts = []
    rids = np.asarray(rids)
    rids = rids[np.argsort(lens[rids], kind="stable")] if len(rids) else rids
    rows = _chunk_rows(rids, lens, k, w, hpc=hpc)
    rows_lp = batch_rows * CHUNK_LP
    cap_mini = 2 * rows_lp // max(1, w) + 1024
    for s in range(0, len(rows), batch_rows):
        sub = rows[s : s + batch_rows]
        with _tspan("engine/index_sketch", rows=len(sub)):
            m = _sketch_rows(store, sub, k, w, cap_mini, dev, hpc=hpc)
        if m.n_all > m.n:
            raise RuntimeError(
                f"sketch cap overflow building index: selected "
                f"{m.n_all} minimizers > cap {m.n}; raise cap_mini")
        row_rid = np.array([rr[0] for rr in sub], np.int64)
        row_g0 = np.array([rr[1] for rr in sub], np.int32)
        mr = m.rid.cpu().numpy()
        parts.append((row_rid[mr].astype(np.int32),
                      (m.pos.cpu().numpy() + row_g0[mr]).astype(np.int32),
                      m.hash.cpu().numpy().astype(np.uint32),
                      m.strand.cpu().numpy().astype(np.int8)))
    rid = np.concatenate([p[0] for p in parts]) if parts else np.zeros(0, np.int32)
    pos = np.concatenate([p[1] for p in parts]) if parts else np.zeros(0, np.int32)
    h = np.concatenate([p[2] for p in parts]) if parts else np.zeros(0, np.uint32)
    st = np.concatenate([p[3] for p in parts]) if parts else np.zeros(0, np.int32)
    return _build_index(h, rid, pos, st, lens, max_occ=max_occ, device=dev)


# ---------------------------------------------------------------------------
# The device program: three hand-written CUDA kernels (csrc/engine.cu), each
# with its plain PyTorch version beside it, which the wrapper takes for CPU
# tensors only.  The plain versions reduce segments on segment ids
# (ops/segment.py); the kernels give the same tensors exactly.

MAX_TOP_K = 8             # corridors a group the vote kernel keeps
VOTE_TILE = 256           # runs of a group the vote kernel's tile holds
ANCHOR_THREADS = 256      # minimizers a block of engine_anchor_kernel
DIR_BUCKET = 8            # index entries a directory bucket averages, at most
DIR_BITS_MAX = 24         # directory bits at most (2^24 + 1 starts, 64 MB)


def engine_anchor_plain(qm_rid, qm_pos, qm_hash, qm_strand, q_rid_base,
                        q_pos_base, qmask, idx_h, idx_rid, idx_pos,
                        max_occ: int):
    """Plain version of engine_anchor (any device)."""
    lo = torch.searchsorted(idx_h, qm_hash, right=False)
    hi = torch.searchsorted(idx_h, qm_hash, right=True)
    cnt = torch.clamp(hi - lo, max=max_occ)
    q_grid = q_rid_base[qm_rid]
    qpos = qm_pos + q_pos_base[qm_rid]
    # anchor expansion: (M, max_occ)
    occ = torch.arange(max_occ, device=qm_hash.device,
                       dtype=torch.int64)[None, :]
    take = occ < cnt[:, None]
    aidx = torch.clamp(lo[:, None] + occ, max=idx_h.shape[0] - 1)
    t_rid = idx_rid[aidx].to(torch.int64)
    t_posst = idx_pos[aidx].to(torch.int64)
    take = take & (t_rid != q_grid[:, None]) & (t_rid >= 0)
    # pair-once gate (see qmask in _match_block's docstring)
    take = take & ~((qmask[torch.clamp(t_rid, min=0)] > 0)
                    & (t_rid < q_grid[:, None]))
    # the taken anchors only, in flat (minimizer, occurrence) order
    sel = torch.nonzero(take.reshape(-1))[:, 0]
    row = sel // max_occ
    posst = t_posst.reshape(-1)[sel]
    return (q_grid[row], t_rid.reshape(-1)[sel], posst & POS_MASK,
            (qm_strand[row] ^ (posst >> STRAND_BIT)) & 1, qpos[row])


def directory_bits(H: int) -> int:
    """b of engine_anchor's bucket directory for an index of H entries: the
    least b with H <= DIR_BUCKET * 2^b (buckets of at most ~8 entries on
    average), at most DIR_BITS_MAX."""
    return min(max(-(-H // DIR_BUCKET) - 1, 0).bit_length(), DIR_BITS_MAX)


def anchor_directory(idx_h):
    """engine_anchor's bucket directory of the sorted index hashes idx_h:
    (2^b + 1,) int32 on idx_h's device, b = directory_bits(H), entry i the
    first index entry of hash >= i << (32 - b).  One torch.searchsorted of
    the buckets' bounds, no host sync; find_overlaps makes it once."""
    b = directory_bits(idx_h.shape[0])
    step = 1 << (32 - b)
    bounds = torch.arange(0, ((1 << b) + 1) * step, step, dtype=torch.int64,
                          device=idx_h.device)
    return torch.searchsorted(idx_h, bounds, out_int32=True)


def _anchor_stat(M: int, dev):
    """engine_anchor's block totals on dev and its block count nb: (nb + 2,)
    int64, the kernel's, with A at nb once it has run."""
    nb = -(-M // ANCHOR_THREADS)
    return torch.empty(nb + 2, dtype=torch.int64, device=dev), nb


def _anchor_launch(lib, ins, stat, out, M, H, stride, shift, max_occ,
                   stream):
    """One launch of engine_anchor_kernel on the current device: ins are the
    eleven inputs' data pointers (the directory last), out the (5, stride)
    output's (stride >= A)."""
    rc = lib.ndt_engine_anchor(*ins, stat.data_ptr(), out, M, H, stride,
                               shift, max_occ, stream)
    _build.check_launch("engine_anchor", rc)


def engine_anchor(qm_rid, qm_pos, qm_hash, qm_strand, q_rid_base,
                  q_pos_base, qmask, idx_h, idx_rid, idx_pos, max_occ: int,
                  bucket=None):
    """A query batch's anchors against the index.

    qm_rid, qm_pos, qm_hash, qm_strand: (M,) int64 minimizers (rid = the
    batch row); q_rid_base, q_pos_base: (R,) int64 per row; qmask: (N,)
    int8; idx_h (H,) int64 sorted, idx_rid / idx_pos (H,) int32; bucket:
    anchor_directory(idx_h), made here when not given.  Per minimizer the
    first max_occ index entries of its hash, less self hits, filter rows and
    the pair-once gate.  Returns (qr, t_rid, t_pos, rel, qpos), (A,) int64
    each, in flat (minimizer, occurrence) order.

    CPU tensors run the plain version; CUDA tensors launch the kernel once
    (into rows of M * max_occ, the bound of A), then read the anchor count
    A: one host sync."""
    H = idx_h.shape[0]
    if bucket is not None:
        check_tensor("bucket", bucket, ((1 << directory_bits(H)) + 1,),
                     torch.int32, idx_h.device)
    if qm_hash.device.type == "cpu":
        return engine_anchor_plain(qm_rid, qm_pos, qm_hash, qm_strand,
                                   q_rid_base, q_pos_base, qmask, idx_h,
                                   idx_rid, idx_pos, max_occ)
    dev = qm_hash.device
    M, R, N = qm_rid.shape[0], q_rid_base.shape[0], qmask.shape[0]
    i64 = torch.int64
    for name, t, n, dt in (
            ("qm_rid", qm_rid, M, i64), ("qm_pos", qm_pos, M, i64),
            ("qm_hash", qm_hash, M, i64), ("qm_strand", qm_strand, M, i64),
            ("q_rid_base", q_rid_base, R, i64),
            ("q_pos_base", q_pos_base, R, i64),
            ("qmask", qmask, N, torch.int8), ("idx_h", idx_h, H, i64),
            ("idx_rid", idx_rid, H, torch.int32),
            ("idx_pos", idx_pos, H, torch.int32)):
        check_tensor(name, t, (n,), dt, dev)
    if H > I32MAX:
        raise ValueError(f"engine_anchor: an index of {H} entries (at most "
                         f"{I32MAX})")
    lib = _build.kernels()
    if bucket is None:
        bucket = anchor_directory(idx_h)
    shift = 32 - directory_bits(H)
    stat, nb = _anchor_stat(M, dev)
    ins = [t.data_ptr() for t in (qm_rid, qm_pos, qm_hash, qm_strand,
                                  q_rid_base, q_pos_base, qmask, idx_h,
                                  idx_rid, idx_pos, bucket)]
    cap = M * max(max_occ, 0)
    out = torch.empty((5, cap), dtype=i64, device=dev)
    A = 0
    if M:
        with torch.cuda.device(dev):
            _anchor_launch(lib, ins, stat, out.data_ptr(), M, H, cap, shift,
                           max_occ, torch.cuda.current_stream(dev).cuda_stream)
        _build.count_launch("engine_anchor", dev)
        A = int(stat[nb])
    return out[:, :A].unbind(0)


def group_starts(key_q, key_t):
    """(A + 1,) int64 on key_q's device: the index where each run of equal
    (key_q, key_t) begins, in order, then A in every slot past the last
    run's.  No host sync: a start flag compacted into a buffer of fixed
    size (nonzero_static), five launches."""
    A = key_q.shape[0]
    start = torch.ones(A, dtype=torch.bool, device=key_q.device)
    if A > 1:
        torch.logical_or(key_q[1:] != key_q[:-1], key_t[1:] != key_t[:-1],
                         out=start[1:])
    return torch.nonzero_static(start, size=A + 1, fill_value=A)[:, 0]


def vote_corridor_plain(key_q, key_t, key_b, diag, qpos, *, diag_shift: int,
                        top_k: int):
    """Plain version of vote_corridor (any device)."""
    A = key_q.shape[0]
    dbin = key_b >> 10
    g_starts = segment_starts(key_q) | segment_starts(key_t)
    b_starts = g_starts | segment_starts(dbin)
    bin_cnt = segment_sum(torch.ones(A, dtype=torch.int64,
                                     device=key_q.device), b_starts)
    width = 1 << diag_shift
    # top-K corridor selection: iteratively take the best-voted remaining
    # diagonal bin per group, assign each anchor to the nearest selected
    # corridor within +-width, then blank out the selected bin (+-2 bins)
    # before the next round.  Secondary corridors (i > 0) are kept only
    # when their bin vote is >= half the primary's.
    corr = torch.full_like(key_q, top_k)
    bestd = torch.full_like(key_q, 1 << 30)
    cur = bin_cnt
    prim_cnt = None
    for i in range(top_k):
        bc, bb = segment_argmax(cur, dbin, g_starts)
        if i == 0:
            prim_cnt = bc
        center_i = (bb - (1 << 20)) * width + width // 2
        di = torch.abs(diag - center_i)
        ok = (bc * 2 >= prim_cnt) & (bc > 0)
        better = ok & (di <= width) & (di < bestd)
        corr = torch.where(better, i, corr)
        bestd = torch.where(better, di, bestd)
        if i + 1 < top_k:
            cur = torch.where(torch.abs(dbin - bb) <= 2, -1, cur)
    return (key_t * (top_k + 1) + corr,
            torch.where(corr < top_k, qpos, I32MAX))


def vote_corridor(key_q, key_t, key_b, diag, qpos, *, diag_shift: int,
                  top_k: int, gstart=None):
    """Corridor vote over anchors in the first sort's order (key_q, key_t,
    key_b; (A,) int64 each, with each anchor's diag and qpos): per (key_q,
    key_t) group the top_k best-voted diagonal bins, and each anchor's
    nearest kept corridor (top_k = none).  Returns (key_t2, qp2_key), the
    second sort's keys: key_t * (top_k + 1) + corridor, and qpos where the
    anchor has a corridor, else I32MAX.

    CPU tensors run the plain version; CUDA tensors launch the kernel, one
    warp a group, over gstart (group_starts(key_q, key_t), made here when
    not given)."""
    if key_q.device.type == "cpu":
        return vote_corridor_plain(key_q, key_t, key_b, diag, qpos,
                                   diag_shift=diag_shift, top_k=top_k)
    dev = key_q.device
    A = key_q.shape[0]
    if not 1 <= top_k <= MAX_TOP_K:
        raise ValueError(f"vote_corridor: top_k {top_k} outside 1.."
                         f"{MAX_TOP_K}")
    for name, t in (("key_q", key_q), ("key_t", key_t), ("key_b", key_b),
                    ("diag", diag), ("qpos", qpos)):
        check_tensor(name, t, (A,), torch.int64, dev)
    lib = _build.kernels()
    gstart = _kernel_starts(gstart, A, dev,
                            lambda: group_starts(key_q, key_t))
    key_t2 = torch.empty_like(key_t)
    qp2_key = torch.empty_like(qpos)
    if A:
        _vote_launch(lib, key_t, key_b, diag, qpos, gstart, key_t2, qp2_key,
                     A, diag_shift, top_k)
        _build.count_launch("vote_corridor", dev)
    return key_t2, qp2_key


def _kernel_starts(gstart, A: int, dev, make):
    """A kernel's group starts: gstart checked, or make() where it is None.
    A stays under 2^31 (the kernels count groups in int)."""
    if A > I32MAX:
        raise ValueError(f"engine: {A} anchors in one launch (at most "
                         f"{I32MAX})")
    if gstart is None:
        return make()
    check_tensor("gstart", gstart, (A + 1,), torch.int64, dev)
    return gstart


def _vote_launch(lib, key_t, key_b, diag, qpos, gstart, key_t2, qp2_key, G,
                 diag_shift, top_k):
    """One launch of vote_corridor_kernel on key_t's device over the groups
    gstart[:G + 1] bounds (G = A: a warp leaves at a start equal to A)."""
    dev = key_t.device
    with torch.cuda.device(dev):
        rc = lib.ndt_vote_corridor(
            key_t.data_ptr(), key_b.data_ptr(), diag.data_ptr(),
            qpos.data_ptr(), gstart.data_ptr(), key_t2.data_ptr(),
            qp2_key.data_ptr(), G, diag_shift, top_k,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("vote_corridor", rc)


def chain_emit_plain(kq2, kt2, qp2, tp2, *, k: int, top_k: int,
                     min_cnt: int, min_span: int):
    """Plain version of chain_emit (any device)."""
    dev = kq2.device
    KC = top_k + 1
    # chain score per corridor: corridor anchors in exact qpos order, each
    # consecutive link scored alpha = min(dq, dt, k) minus the gap penalty
    # beta = 0.01*k*|dd| + 0.5*log2(|dd|); non-colinear links contribute 0.
    near2 = qp2 != I32MAX
    g2 = segment_starts(kq2) | segment_starts(kt2)
    key_tq = kt2 // KC        # original (t_rid*2 + rel) key
    corr2 = kt2 - key_tq * KC
    dq = qp2 - torch.cat([qp2[:1], qp2[:-1]])
    dt = tp2 - torch.cat([tp2[:1], tp2[:-1]])
    prev_near = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev),
                           near2[:-1]])
    link_ok = near2 & prev_near & ~g2 & (dq > 0) & (dt > 0)
    dd = torch.abs(dq - dt).to(torch.float32)
    alpha = torch.clamp(torch.minimum(dq, dt), max=k).to(torch.float32)
    beta = 0.01 * k * dd + 0.5 * torch.log2(dd + 1.0)
    link_sc = torch.where(link_ok, torch.clamp(alpha - beta, min=0.0), 0.0)
    # per-link scores quantize to 1/8 BEFORE the segmented sum, so the sum
    # is an integer one and independent of reduction order
    link_q = torch.round(link_sc * 8.0).to(torch.int64)
    chain_sc = segment_sum(link_q, g2) // 8 + k

    # per-corridor extents and vote counts (segments of g2 are homogeneous
    # in corridor id, so every element carries its corridor's values)
    inf = 1 << 30
    cnt2 = segment_sum(near2.to(torch.int64), g2)
    qs = segment_min(torch.where(near2, qp2, inf), g2)
    qe = segment_max(torch.where(near2, qp2, -inf), g2) + k
    ts = segment_min(torch.where(near2, tp2, inf), g2)
    te = segment_max(torch.where(near2, tp2, -inf), g2) + k

    # secondary suppression by primary query-span overlap (mask level 0.5):
    # broadcast the primary corridor's query extent over the (q, t) group
    gg = segment_starts(kq2) | segment_starts(key_tq)
    is0 = near2 & (corr2 == 0)
    qs0 = segment_max(torch.where(is0, qs, -inf), gg)
    qe0 = segment_max(torch.where(is0, qe, -inf), gg)
    oq = torch.minimum(qe, qe0) - torch.maximum(qs, qs0)
    sec_ok = (corr2 == 0) | (oq * 2 < qe - qs)

    # one record per corridor segment, at its last anchor
    g2_ends = torch.cat([g2[1:], torch.ones((1,), dtype=torch.bool,
                                            device=dev)])
    span = torch.minimum(qe - qs, te - ts)
    emit = (g2_ends & near2 & sec_ok & (cnt2 >= min_cnt)
            & (span >= min_span))
    rec = torch.stack([kq2, key_tq & 1, qs, qe, key_tq >> 1, ts, te,
                       torch.minimum(chain_sc, span)])
    return emit, torch.where(emit, rec, 0)


def chain_emit(kq2, kt2, qp2, tp2, *, k: int, top_k: int, min_cnt: int,
               min_span: int, gstart=None):
    """Chain score, extents, secondary suppression and emission over
    anchors in the second sort's order (key_q, key_t2, qp2_key, t_pos;
    (A,) int64 each).  Returns (emit, rec): (A,) bool, set at the last
    anchor of each corridor segment that makes a record, and (8, A) int64,
    that record's REC_FIELDS in that column and zeros elsewhere.

    CPU tensors run the plain version; CUDA tensors launch the kernel, one
    warp a (key_q, t_rid * 2 + rel) group, over gstart: the starts of those
    groups, made here when not given.  The second sort permutes anchors only
    inside a (key_q, key_t) group, so the first sort's group_starts are
    these groups' starts too, and _vote_emit hands both kernels the same."""
    kw = dict(k=k, top_k=top_k, min_cnt=min_cnt, min_span=min_span)
    if kq2.device.type == "cpu":
        return chain_emit_plain(kq2, kt2, qp2, tp2, **kw)
    dev = kq2.device
    A = kq2.shape[0]
    if not 1 <= top_k <= MAX_TOP_K:
        raise ValueError(f"chain_emit: top_k {top_k} outside 1..{MAX_TOP_K}")
    for name, t in (("kq2", kq2), ("kt2", kt2), ("qp2", qp2), ("tp2", tp2)):
        check_tensor(name, t, (A,), torch.int64, dev)
    lib = _build.kernels()
    gstart = _kernel_starts(gstart, A, dev,
                            lambda: group_starts(kq2, kt2 // (top_k + 1)))
    emit = torch.empty(A, dtype=torch.bool, device=dev)
    rec = torch.empty((8, A), dtype=torch.int64, device=dev)
    if A:
        _chain_launch(lib, kq2, kt2, qp2, tp2, gstart, emit, rec, A, **kw)
        _build.count_launch("chain_emit", dev)
    return emit, rec


def _chain_launch(lib, kq2, kt2, qp2, tp2, gstart, emit, rec, G, *, k: int,
                  top_k: int, min_cnt: int, min_span: int):
    """One launch of chain_emit_kernel on kq2's device over the groups
    gstart[:G + 1] bounds."""
    dev = kq2.device
    with torch.cuda.device(dev):
        rc = lib.ndt_chain_emit(
            kq2.data_ptr(), kt2.data_ptr(), qp2.data_ptr(), tp2.data_ptr(),
            gstart.data_ptr(), emit.data_ptr(), rec.data_ptr(), kq2.shape[0],
            G, k, top_k, min_cnt, min_span,
            # the plain version's 0.01 * k as PyTorch casts it
            float(np.float32(0.01 * k)),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("chain_emit", rc)


def _match_block(qm_rid, qm_pos, qm_hash, qm_strand, q_rid_base, q_pos_base,
                 qmask, idx: MiniIndex, k: int, max_occ: int,
                 diag_shift: int, min_cnt: int, min_span: int, cap_out: int,
                 top_k: int = 1, bucket=None):
    """Anchors + diagonal voting for one sketched query batch.

    qm_*: flat minimizer tensors (M,), rid = local row ids.
    qmask: (n_reads,) int8 — 1 marks reads that are (globally) part of the
    query set.  When two query reads overlap each other, BOTH would find
    the pair (each against the index), and downstream seed-keyed
    symmetrization would then count the one true overlap TWICE per seed.
    This gate drops an anchor to a target that is itself a query with a
    SMALLER rid, so each query-query pair is emitted exactly once (by its
    min-rid side), independent of host sharding.  All-zeros disables the
    gate.
    q_rid_base: (rows,) mapping local row -> global rid.  Several rows may
    map to the same global rid (halo chunks of one long read): grouping is
    by GLOBAL rid, so anchors from all chunks of a read vote together.
    q_pos_base: (rows,) original-coord start of each row's buffer, added
    to qm_pos so positions/diagonals are in whole-read coords.
    top_k: emit up to this many diagonal corridors per (query, target,
    strand) group: corridor i+1 is the best remaining bin outside
    already-selected corridors, kept when its vote count is >= half the
    primary's and its query span does not overlap the primary's by more
    than 50%.
    bucket: anchor_directory(idx.h), made by engine_anchor when not given.
    Returns (records dict of (n_out,) int64 tensors, n_out, overflow)
    """
    anchors = engine_anchor(qm_rid, qm_pos, qm_hash, qm_strand, q_rid_base,
                            q_pos_base, qmask, idx.h, idx.rid, idx.pos,
                            max_occ, bucket=bucket)
    return _vote_emit(
        *anchors, k=k, diag_shift=diag_shift, min_cnt=min_cnt,
        min_span=min_span, cap_out=cap_out, top_k=top_k)


def _stable_lexsort(keys):
    """Permutation sorting by keys[0] (major) .. keys[-1] (minor): one
    stable single-key pass per key, minor -> major."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for kcol in reversed(keys):
        order = torch.sort(kcol[perm], stable=True).indices
        perm = perm[order]
    return perm


def _vote_inputs(qr, t_rid, t_pos, rel, qpos, *, diag_shift: int):
    """vote_corridor's inputs: (key_q, key_t, key_b, diag, qpos) in the
    first sort's order, lexicographic (key_q, key_t, key_b) with ties in
    the anchors' order, and t_pos in that order."""
    diag = torch.where(rel == 0, qpos - t_pos, qpos + t_pos)
    dbin = (diag >> diag_shift) + (1 << 20)
    key_t = t_rid * 2 + rel
    key_b = dbin * (1 << 10) + torch.clamp(qpos >> 8, max=(1 << 10) - 1)
    perm = _stable_lexsort([qr, key_t, key_b])
    return tuple(x[perm] for x in (qr, key_t, key_b, diag, qpos, t_pos))


def _chain_inputs(key_q, key_t2, qp2_key, t_pos):
    """chain_emit's inputs: the four keys in the second sort's order.  Its
    4 keys (t_pos breaks qpos ties) make the emitted records a pure
    function of the anchor SET, independent of anchor order."""
    perm2 = _stable_lexsort([key_q, key_t2, qp2_key, t_pos])
    return tuple(x[perm2] for x in (key_q, key_t2, qp2_key, t_pos))


def _vote_emit(qr, t_rid, t_pos, rel, qpos, *, k: int, diag_shift: int,
               min_cnt: int, min_span: int, cap_out: int, top_k: int):
    """Diagonal-corridor voting + chain scoring + emission over flat anchor
    tensors (A,) (every anchor is a taken one): vote_corridor after the
    first sort, chain_emit after the second, then the first cap_out
    records in order."""
    if qr.shape[0] == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=qr.device)
        return {kk: empty for kk in REC_FIELDS}, 0, 0
    key_q, key_t, key_b, diag, qpos, t_pos = _vote_inputs(
        qr, t_rid, t_pos, rel, qpos, diag_shift=diag_shift)
    # one set of (key_q, key_t) group starts for both kernels
    gstart = group_starts(key_q, key_t)
    key_t2, qp2_key = vote_corridor(key_q, key_t, key_b, diag, qpos,
                                    diag_shift=diag_shift, top_k=top_k,
                                    gstart=gstart)
    emit, rec = chain_emit(*_chain_inputs(key_q, key_t2, qp2_key, t_pos),
                           k=k, top_k=top_k, min_cnt=min_cnt,
                           min_span=min_span, gstart=gstart)
    hits = torch.nonzero(emit)[:, 0]
    n_emit = int(hits.shape[0])
    hc = hits[:cap_out]           # the first cap_out in order; rest dropped
    n_out = int(hc.shape[0])
    return dict(zip(REC_FIELDS, rec[:, hc])), n_out, n_emit - n_out


def find_overlaps(store: SeqStore, query_rids, idx: MiniIndex, k: int, w: int,
                  max_occ: int = 16, diag_bin: int = 256, min_cnt: int = 4,
                  min_span: int = 500, batch_rows: int = 16,
                  top_k: int = 1, query_mask=None, device=None) -> OvlBlock:
    """Overlap query reads against the index; returns an OvlBlock (PAF-like
    fwd-coordinate records with a rev flag, step-1 semantics).

    top_k > 1 emits up to that many chains per (query, target, strand).

    query_mask: optional (n_reads,) bool marking the GLOBAL query set.  When
    given, a pair of two query reads is emitted exactly once, by its
    lower-rid side (see _match_block).

    device=None means the GPU; it must be where `idx` lives."""
    from ..utils import span as _tspan
    dev = resolve_device(device)
    lens = np.asarray(store.length, np.int64)
    diag_shift = int(np.log2(diag_bin))
    out = []
    query_rids = np.asarray(query_rids)
    # batch queries in length order; output is canonicalized by a stable
    # qname sort below, so record order is independent of batching order
    if len(query_rids):
        query_rids = query_rids[np.argsort(lens[query_rids], kind="stable")]
    # Batch packing is CANONICAL PER READ: a read's chunks share a batch
    # with other reads only when they all fit; a read with more chunks than
    # fit starts fresh batches and splits at fixed multiples of batch_rows.
    # Emitted records are therefore a function of the read alone —
    # independent of how queries are partitioned across batches.
    batches = []
    cur = []
    for r in query_rids:
        rrows = _chunk_rows([r], lens, k, w)
        if len(cur) + len(rrows) <= batch_rows:
            cur.extend(rrows)
        else:
            if cur:
                batches.append(cur)
            while len(rrows) > batch_rows:
                batches.append(rrows[:batch_rows])
                rrows = rrows[batch_rows:]
            cur = rrows
        if len(cur) == batch_rows:
            batches.append(cur)
            cur = []
    if cur:
        batches.append(cur)
    rows_lp = batch_rows * CHUNK_LP
    qmask_arr = np.zeros(len(lens), np.int8)
    if query_mask is not None:
        qmask_arr[np.asarray(query_mask, bool)[: len(lens)]] = 1
    qmask_dev = torch.from_numpy(qmask_arr).to(dev)
    cap_out = 256 * batch_rows + 256
    bucket = anchor_directory(idx.h)      # engine_anchor's, once a call

    for sub in batches:
        with _tspan("engine/host_fill", rows=len(sub)):
            m = _sketch_rows(store, sub, k, w,
                             2 * rows_lp // max(1, w) + 1024, dev)
        base = torch.tensor([rr[0] for rr in sub], dtype=torch.int64,
                            device=dev)
        pbase = torch.tensor([rr[1] for rr in sub], dtype=torch.int64,
                             device=dev)
        with _tspan("engine/match", rows=len(sub)):
            rec, n, overflow = _match_block(
                m.rid, m.pos, m.hash, m.strand, base, pbase, qmask_dev, idx,
                k=k, max_occ=max_occ, diag_shift=diag_shift, min_cnt=min_cnt,
                min_span=min_span, cap_out=cap_out, top_k=top_k,
                bucket=bucket)
            if overflow > 0:
                # rare: too many candidate groups; record the loss loudly
                logging.getLogger(__name__).warning(
                    "overlap emit overflow: %d records dropped", overflow)
            if n:
                packed = torch.stack([rec[kk] for kk in REC_FIELDS]
                                     ).to(torch.int32).cpu().numpy()
                out.append(OvlBlock({kk: packed[fi]
                                     for fi, kk in enumerate(REC_FIELDS)}))
    res = OvlBlock.concat_all(out)
    if len(res):
        res = res.take(np.argsort(np.asarray(res.qname), kind="stable"))
    return res
