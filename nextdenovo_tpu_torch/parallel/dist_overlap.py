"""Overlap engine step of the mesh path (PyTorch/CUDA port of
nextdenovo_tpu/parallel/dist_overlap.py).

The reference program, per shard of an n-shard mesh:

  * the minimizer index is sharded by hash range (shard d holds hashes
    whose top bits are d);
  * each shard sketches its block of query rows and routes every minimizer
    to the shard that owns its hash (all_to_all);
  * the owner looks the minimizers up in its index block and routes each
    anchor BACK to its query's home shard, (qid - qid0) // B_local (a
    second all_to_all);
  * diagonal voting, chain scoring and emission run per home shard through
    the single-device engine's code (overlap/engine._vote_emit).

Here each card of the mesh runs its shards on a host thread of its own
(parallel/mesh.Mesh.for_each_card), and the two all_to_all copy the buckets
between cards at the joins.  The buckets hold compacted rows, so what moves
is the real minimizers and anchors, never the reference's padded caps (at
1 Mb / 30x with use_mesh = 8 those pad ~10 M minimizers to 24 M slots a
shard, and their anchors to 780 M slots).  Every cap keeps its meaning: a
bucket takes the first `cap` selected rows in the reference's order and
counts the rest as drops, so the records, their order per shard and the
overflow count equal the JAX package's, whichever card finishes first: the
counts are summed in shard order after each join.

On the card the routing is mesh.bucketize (route_count and route_scatter
around one host sync a bucketing, each bucket written once at its kept
size) and the lookup the single-device
engine's engine_anchor kernel, one launch every LOOKUP_ROWS received
minimizers, each minimizer a query row of its own, against the shard's
block of the index with its bucket directory (index_shards, made once a
mesh_overlaps call).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..io.seqstore import SeqStore
from ..ops.sketch import sketch
from ..overlap.engine import (POS_MASK, REC_FIELDS, STRAND_BIT, _vote_emit,
                              anchor_directory, build_index, engine_anchor)
from ..overlap.records import OvlBlock
from ..utils import span
from .mesh import (Mesh, _np, all_to_all, bucket_drops, bucketize,
                   partition_index, psum, replicate, shard_rows)

# positions of one sketch launch (rows x the batch's longest row): the
# sketch is row-local, so a shard's rows are sketched in batches whose
# concatenation is the shard's (row, position)-ordered minimizer list
SKETCH_POSITIONS = 1 << 22
# received minimizers looked up at once ((rows, max_occ) candidates)
LOOKUP_ROWS = 1 << 20
# anchors handed to one _vote_emit call: a home shard's anchors are split
# at query boundaries (the emission is a per-query function, emitted in
# ascending query order)
VOTE_ANCHORS = 1 << 24


def _sketch_shard(codes: torch.Tensor, lens: np.ndarray, k: int, w: int):
    """Minimizers of one shard's rows in (row, position) order, all of them
    (the caller applies cap_mini).  Returns (rid, pos, hash, strand)."""
    parts = []
    B = codes.shape[0]
    r0 = 0
    while r0 < B:
        r1, top = r0 + 1, max(int(lens[r0]), 1)
        while r1 < B and (r1 - r0 + 1) * max(top, int(lens[r1])) \
                <= SKETCH_POSITIONS:
            top = max(top, int(lens[r1]))
            r1 += 1
        lt = torch.from_numpy(lens[r0:r1].astype(np.int32)).to(codes.device)
        # a column slice of the shard's buffer: the kernels take its row
        # pitch, no copy
        m = sketch(codes[r0:r1, :top], lt, k=k, w=w, cap=(r1 - r0) * top)
        parts.append((m.rid + r0, m.pos, m.hash, m.strand))
        r0 = r1
    return tuple(torch.cat([p[i] for p in parts]) for i in range(4))


class IndexShard(NamedTuple):
    """One shard's block of the hash-partitioned index, on its card, as
    engine_anchor reads it: the hashes (sorted, int64), the rids (int32),
    position | strand << STRAND_BIT (int32; positions stay under 2^30:
    reads cap at 1 Mb) and the bucket directory of the hashes."""
    h: torch.Tensor
    rid: torch.Tensor
    posst: torch.Tensor
    bucket: torch.Tensor

    def unpacked(self):
        """(h, rid, pos, strand), int64 each: the plain lookup's arrays."""
        p = self.posst.to(torch.int64)
        return self.h, self.rid.to(torch.int64), p & POS_MASK, p >> STRAND_BIT


class ShardedIndex(NamedTuple):
    """index_shards' result: a shard's IndexShard at its number, and one
    past the largest rid of the index (the length engine_anchor's qmask
    needs)."""
    shards: List[IndexShard]
    rid_end: int


def index_shards(mesh: Mesh, idx_h, idx_rid, idx_pos, idx_strand
                 ) -> ShardedIndex:
    """The (n_shards * H,) index arrays of distributed_overlap_step, cut
    into the shards' blocks on their cards, with what engine_anchor reads
    made once: mesh_overlaps makes it before the autocap's first try, so a
    retry does not make it again."""
    posst = _np(idx_pos).astype(np.int32) \
        | (_np(idx_strand).astype(np.int32) << STRAND_BIT)
    rids = shard_rows(mesh, _np(idx_rid).astype(np.int32))
    shards = [IndexShard(h, rid, ps, anchor_directory(h)) for h, rid, ps in
              zip(shard_rows(mesh, idx_h, torch.int64), rids,
                  shard_rows(mesh, posst))]
    rid_end = max((int(r.max()) + 1 for r in rids if r.numel()), default=0)
    return ShardedIndex(shards, rid_end)


def anchor_mask(qm, rid_end: int, dev) -> torch.Tensor:
    """engine_anchor's qmask (int8) for a lookup with the pair-once mask qm
    (None: no gate, zeros): qm > 0, read as the plain lookup reads it at
    clamp(t_rid, 0, len(qm) - 1), so past its end its last entry, for every
    rid below rid_end."""
    n = max(rid_end, 1)
    if qm is None:
        return torch.zeros(n, dtype=torch.int8, device=dev)
    m = (qm > 0).to(torch.int8)
    if m.shape[0] < n:
        m = torch.cat([m, m[-1:].expand(n - m.shape[0])])
    return m.contiguous()


def _lookup(recv, ix: IndexShard, qm, amask, max_occ: int):
    """Anchors of the minimizers a shard received, in the reference's flat
    (minimizer, occurrence) order, taken ones only, as _vote_emit takes
    them: (qid, t_rid, t_pos, rel, qpos).  The first max_occ entries of each
    hash, less pad rows (rid < 0), self hits and the pair-once gate of qm
    (None: off).

    CPU tensors run the plain version; CUDA tensors launch engine_anchor
    (csrc/engine.cu) once every LOOKUP_ROWS minimizers, with its qmask amask
    (anchor_mask of qm)."""
    if ix.h.device.type == "cpu":
        return _lookup_plain(recv, *ix.unpacked(), qm, max_occ)
    return _lookup_anchor(recv, ix, amask, max_occ)


def _lookup_anchor(recv, ix: IndexShard, amask, max_occ: int):
    """The lookup through engine_anchor (on any device; on the CPU its plain
    version): each received minimizer a query row of its own (qm_rid = its
    number, q_rid_base = its qid, q_pos_base = 0)."""
    h_r, pos_r, str_r, qid_r = recv
    out = []
    for a in range(0, h_r.shape[0], LOOKUP_ROWS):
        h, pos, st, qid = (x[a : a + LOOKUP_ROWS]
                           for x in (h_r, pos_r, str_r, qid_r))
        rows = torch.arange(h.shape[0], device=h.device, dtype=torch.int64)
        got = engine_anchor(rows, pos, h, st, qid, torch.zeros_like(rows),
                            amask, ix.h, ix.rid, ix.posst, max_occ,
                            bucket=ix.bucket)
        # the anchors are views of rows of M * max_occ: with chunks to
        # follow, copy them out (and let go of the views) before the next
        # launch, so that one such buffer is held at a time
        if a + LOOKUP_ROWS < h_r.shape[0]:
            got = tuple(x.clone() for x in got)
        out.append(got)
    if not out:
        e = torch.zeros(0, dtype=torch.int64, device=ix.h.device)
        return (e,) * 5
    return tuple(torch.cat([o[i] for o in out]) for i in range(5))


def _lookup_plain(recv, ih, irid, ipos, istr, qm, max_occ: int):
    """Plain version of _lookup (any device): two torch.searchsorted and an
    (M, max_occ) expansion per LOOKUP_ROWS minimizers."""
    h_r, pos_r, str_r, qid_r = recv
    H = ih.shape[0]
    occ = torch.arange(max_occ, device=ih.device)[None, :]
    out = []
    for a in range(0, h_r.shape[0], LOOKUP_ROWS):
        h, pos, st, qid = (x[a : a + LOOKUP_ROWS]
                           for x in (h_r, pos_r, str_r, qid_r))
        lo = torch.searchsorted(ih, h, right=False)
        hi = torch.searchsorted(ih, h, right=True)
        cnt = torch.clamp(hi - lo, max=max_occ)
        take = occ < cnt[:, None]
        aidx = torch.clamp(lo[:, None] + occ, max=H - 1)
        t_rid = irid[aidx]
        take = take & (t_rid >= 0) & (t_rid != qid[:, None])
        if qm is not None:
            # pair-once gate (engine._match_block parity)
            tq = qm[torch.clamp(t_rid, 0, qm.shape[0] - 1)]
            take = take & ~((tq > 0) & (t_rid < qid[:, None]))
        sel = torch.nonzero(take.reshape(-1))[:, 0]
        row = sel // max_occ
        out.append((qid[row], t_rid.reshape(-1)[sel],
                    ipos[aidx].reshape(-1)[sel],
                    (istr[aidx].reshape(-1)[sel] ^ st[row]) & 1, pos[row]))
    if not out:
        e = torch.zeros(0, dtype=torch.int64, device=ih.device)
        return (e,) * 5
    return tuple(torch.cat([o[i] for o in out]) for i in range(5))


def _vote_emit_home(anchors, *, k, diag_shift, min_cnt, min_span, cap_out,
                    top_k):
    """_vote_emit over a home shard's anchors in query-id slices of at most
    VOTE_ANCHORS anchors (one slice when they fit).  Records come out in
    ascending query order either way, so the concatenation is the single
    call's output, the first cap_out records of it kept.  Returns (records
    dict, n_out, emission overflow)."""
    qid = anchors[0]
    kw = dict(k=k, diag_shift=diag_shift, min_cnt=min_cnt,
              min_span=min_span, top_k=top_k)
    if qid.shape[0] <= VOTE_ANCHORS:
        return _vote_emit(*anchors, cap_out=cap_out, **kw)
    uq, cnt = torch.unique(qid, return_counts=True)
    cum = torch.cumsum(cnt, 0).cpu().numpy()
    uq = uq.cpu().numpy()
    cuts, base = [0], 0
    for i in range(len(cum)):
        if cum[i] - base > VOTE_ANCHORS and i > cuts[-1]:
            cuts.append(i)
            base = cum[i - 1]
    cuts.append(len(uq))
    recs, n_out, n_emit = [], 0, 0
    for a, b in zip(cuts[:-1], cuts[1:]):
        sel = torch.nonzero((qid >= int(uq[a])) & (qid <= int(uq[b - 1])))[:, 0]
        rec, n, over = _vote_emit(*(x[sel] for x in anchors),
                                  cap_out=cap_out - n_out, **kw)
        recs.append(rec)
        n_out += n
        n_emit += n + over
    rec = {f: torch.cat([r[f] for r in recs]) for f in REC_FIELDS}
    return rec, n_out, n_emit - n_out


def distributed_overlap_step(codes, lens, rid_base, idx_h, idx_rid, idx_pos,
                             idx_strand, qmask=None, *, k: int, w: int,
                             cap_mini: int, max_occ: int, diag_shift: int,
                             cap_out: int, mesh: Mesh, min_cnt: int = 4, min_span: int = 500,
                             top_k: int = 1, qid0: int = 0, index=None):
    """One overlap step over the mesh's shards.

    codes:    (n_shards*B, L) integer base codes, shard s owning rows
              [s*B, (s+1)*B) (data-parallel queries)
    lens:     (n_shards*B,) row lengths
    rid_base: (n_shards*B,) global rid per row; global rid r must live on
              shard (r - qid0) // B (block distribution) for the anchor
              route-back to find its home shard.  qid0 is the rid of row 0
              (nonzero when queries sit in a joint id space after other
              reads, e.g. the polish read->contig mapping).
    idx_*:    (n_shards*H,) index arrays sharded by hash range (shard d
              holds the entries with hash >> (32 - log2(n_shards)) == d,
              sorted; partition_index builds them)
    qmask:    optional (n_reads,) int8, 1 marks reads of the global query
              set: the pair-once gate of engine._match_block.  None
              disables it (mapping workloads with disjoint id spaces).
    index:    index_shards of the idx_* arrays, made here when not given
    Returns (records, n_ovl, n_over): records[s] is shard s's dict of
    compacted record tensors (REC_FIELDS), in the reference's order;
    n_ovl the records over all shards; n_over the rows dropped anywhere
    (sketch cap, routing buckets, rows routed out of the mesh, emission
    cap), 0 when nothing was lost."""
    n = mesh.n_shards
    shift_bits = 32 - max(1, (n - 1).bit_length()) if n > 1 else 32
    codes = shard_rows(mesh, codes)
    lens_np = _np(lens).astype(np.int64).reshape(n, -1)
    rid_base = shard_rows(mesh, rid_base, torch.int64)
    if index is None:
        index = index_shards(mesh, idx_h, idx_rid, idx_pos, idx_strand)
    # an all-zeros qmask disables the gate
    qm = replicate(mesh, qmask) if qmask is not None \
        and bool((_np(qmask) > 0).any()) else None
    amask = {dev: anchor_mask(None if qm is None else qm[dev],
                              index.rid_end, dev)
             for dev in dict.fromkeys(mesh.devices) if dev.type == "cuda"}
    B_local = codes[0].shape[0]

    # ---- sketch each source shard, route minimizers to index shards ------
    cap_route = cap_mini // max(1, n) * 2

    def sketch_route(dev, shards):
        out = []
        for s in shards:
            rid, pos, h, strand = _sketch_shard(codes[s], lens_np[s], k, w)
            # sketch-cap overflow counts: the reference keeps the first
            # cap_mini minimizers in (row, position) order
            over = max(int(rid.shape[0]) - cap_mini, 0)
            rid, pos, h, strand = (x[:cap_mini] for x in (rid, pos, h, strand))
            qid = rid_base[s][rid]
            owner = ((h >> shift_bits) % n if n > 1
                     else torch.zeros_like(h))
            buckets, counts = bucketize((h, pos, strand, qid), owner, None,
                                        n, cap_route)
            out.append((buckets, over + bucket_drops(counts, cap_route)))
        return out

    sent = mesh.for_each_card("mesh/sketch_route", sketch_route)
    n_over = psum(o for _, o in sent)
    recv = all_to_all(mesh, [b for b, _ in sent])
    sent = None

    # ---- lookup in each index shard, route anchors back home -------------
    # the reference's route-back bucket: (n * cap_route rows received,
    # padded) x max_occ / n * 2 slots
    cap_back = cap_route * max_occ * 2

    def lookup_route(dev, shards):
        out = []
        for d in shards:
            got = tuple(torch.cat([b[i] for b in recv[d]]) for i in range(4))
            recv[d] = None
            anchors = _lookup(got, index.shards[d],
                              None if qm is None else qm[dev],
                              amask.get(dev), max_occ)
            if n == 1:
                out.append(([anchors], 0))
                continue
            dest = torch.div(anchors[0] - qid0, B_local, rounding_mode="floor")
            # anchors routed out of the mesh are drops, not silent losses
            buckets, counts = bucketize(anchors, dest, None, n, cap_back)
            out.append((buckets, bucket_drops(counts, cap_back)))
        return out

    back = mesh.for_each_card("mesh/lookup_route", lookup_route)
    n_over += psum(o for _, o in back)
    home = all_to_all(mesh, [b for b, _ in back])
    back = None

    # ---- voting, chaining and emission on each home shard ----------------
    def vote_emit(dev, shards):
        out = []
        for q in shards:
            anchors = tuple(torch.cat([b[i] for b in home[q]])
                            for i in range(5))
            home[q] = None
            out.append(_vote_emit_home(
                anchors, k=k, diag_shift=diag_shift, min_cnt=min_cnt,
                min_span=min_span, cap_out=cap_out, top_k=top_k))
        return out

    done = mesh.for_each_card("mesh/vote_emit", vote_emit)
    n_over += psum(over for _, _, over in done)
    return [rec for rec, _, _ in done], psum(n for _, n, _ in done), n_over


def distributed_overlap_autocap(codes, lens, rid_base, idx_h, idx_rid,
                                idx_pos, idx_strand, qmask=None, *,
                                cap_mini: int, cap_out: int,
                                max_retries: int = 3, **kw):
    """Overflow-safe wrapper: runs distributed_overlap_step and, when the
    overflow count reports dropped rows anywhere (routing buckets, sketch
    cap, or emission cap), re-runs with doubled caps — detection and
    re-batching instead of silent truncation.

    Returns (outputs as distributed_overlap_step, final caps)."""
    for _ in range(max_retries + 1):
        out = distributed_overlap_step(
            codes, lens, rid_base, idx_h, idx_rid, idx_pos, idx_strand,
            qmask, cap_mini=cap_mini, cap_out=cap_out, **kw)
        n_over = out[-1]
        if n_over == 0:
            return out, (cap_mini, cap_out)
        cap_mini *= 2
        cap_out *= 2
    raise RuntimeError(
        f"distributed overlap still overflowing after {max_retries} cap "
        f"doublings ({n_over} rows dropped at cap_mini={cap_mini}, "
        f"cap_out={cap_out})")


def _pow2_rows(reads: SeqStore, n_shards: int):
    """Pack EVERY read as a data-parallel code row (block distribution:
    rid r on shard r // B_local, required by the anchor route-back).  The
    codes are int8 (base codes 0..4)."""
    rlens = np.asarray(reads.length, np.int64)
    L = max(2048, int(1 << int(np.ceil(np.log2(max(2, rlens.max()))))))
    B = ((len(reads) + n_shards - 1) // n_shards) * n_shards
    codes = np.zeros((B, L), np.int8)
    lens = np.zeros(B, np.int32)
    rid_base = np.arange(B, dtype=np.int32)
    for i in range(len(reads)):
        c = reads.get(i)[:L]
        codes[i, : len(c)] = c
        lens[i] = len(c)
    return codes, lens, rid_base, L, B


def mesh_overlaps(index_store: SeqStore, index_rids, queries: SeqStore,
                  qid0: int, mesh: Mesh, qmask, *, k, w, max_occ,
                  index_max_occ, min_cnt, min_span, top_k):
    """Every read of `queries` (rids qid0, qid0 + 1, ...) against the index
    of `index_rids` of `index_store`, hash-partitioned over the mesh, with
    the pair-once gate of qmask (None: no gate).  The set-up of the
    reference's mesh stages: build the index, partition it, pack the query
    rows, size the caps, run the autocap.  Returns its per-shard
    records."""
    n = mesh.n_shards
    with span("mesh/build_index", k=k, w=w) as sp:
        idx = build_index(index_store, index_rids, k=k, w=w,
                          max_occ=index_max_occ, device=mesh.device)
        ih, irid, ipos, istr = partition_index(idx, n)
        if sp is not None:
            # each card's share of the index: the entries of its shards
            per = (irid.reshape(n, -1) >= 0).sum(1)
            sp.attrs["card_entries"] = [
                int(per[r.start:r.stop].sum())
                for r in map(mesh.shards_of, range(len(mesh.devices)))]
        index = index_shards(mesh, ih, irid, ipos, istr)
    idx = None
    codes, lens, rid_base, L, B = _pow2_rows(queries, n)
    cap_mini = 2 * (B // n) * L // max(1, w) + 1024
    out, _caps = distributed_overlap_autocap(
        codes, lens, rid_base + qid0, ih, irid, ipos, istr, qmask, k=k, w=w,
        cap_mini=cap_mini, max_occ=max_occ, diag_shift=8,
        cap_out=max(4096, 512 * (B // n)), mesh=mesh, min_cnt=min_cnt,
        min_span=min_span, top_k=top_k, qid0=qid0, index=index)
    return out[0]


def records_block(records, qmask=None) -> OvlBlock:
    """Per-shard records of distributed_overlap_step -> one OvlBlock sorted
    by qname (stable), keeping only queries with qmask > 0 when given."""
    cols = {f: np.concatenate([r[f].cpu().numpy() for r in records])
            .astype(np.int32) for f in REC_FIELDS}
    if qmask is not None:
        keep = np.asarray(qmask)[cols["qname"]] > 0
        cols = {f: v[keep] for f, v in cols.items()}
    blk = OvlBlock.from_arrays(**cols)
    if len(blk):
        blk = blk.take(np.argsort(np.asarray(blk.qname), kind="stable"))
    return blk
