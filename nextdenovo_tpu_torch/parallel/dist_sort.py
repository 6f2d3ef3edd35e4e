"""Seed-keyed overlap sort of the mesh path (PyTorch/CUDA port of
nextdenovo_tpu/parallel/dist_sort.py).

Every shard symmetrizes its block of raw overlap records to the seed-keyed
orientation, routes each record to the shard owning its seed (seed %
n_shards, all_to_all), and sorts what it received by the total order
(seed asc, match desc, span asc, tname, ts, qs, rev).  A seed's records then
sit on one shard, and the per-seed coverage/chimera filter (native
nd_ovl_sort_filter) runs shard by shard.

Rows that tie on all seven keys (the same seed, match, span, target, ts, qs
and strand, differing only in te) keep the order in which their shard
received them: the JAX package's multi-operand sort keeps that order on
the CPU, and the port's sorts are stable passes (tests/test_torch_mesh.py
holds such a tie).  Each card of the mesh runs its shards on a host thread
of its own (parallel/mesh.Mesh.for_each_card).

On the card the route is one call, seed_route: the routing kernels of
csrc/route.cu with the raw records as their rows.  seed_route_count makes
both views' keys from one read of each record and counts them; the host
reads the totals (one sync); seed_route_scatter builds each kept view from
its record straight into its bucket, so the symmetrized views are never
written out.  The seven-key sort stays _stable_lexsort, seven stable
torch.sort passes.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..device import check_tensor
from ..overlap.engine import _stable_lexsort
from ..overlap.records import OvlBlock
from ..overlap.sort import SortResult, _filter_sorted_native, _rows_to_block
from .mesh import (ROUTE_SEED_TILE, Mesh, RouteLaunches, all_to_all,
                   bucketize_plain, check_route, psum, replicate, route_call,
                   shard_rows)


def seed_symmetrize_plain(rec, is_seed, lens, n_shards: int):
    """The seed-keyed views of a shard's raw records (rec (R, 8) int64:
    qname, rev, qs, qe, tname, ts, te, match, exclusive ends), as
    distributed_seed_sort_step routes them: the records whose two reads
    differ and whose spans are both at least 500, each seen from its query
    (rows 0..R-1) and from its target (rows R..2R-1), ends inclusive, kept
    where the seed side is a seed (is_seed (n_reads,) bool) and the span
    ends inside it (lens (n_reads,) int64; ids clamped into range).
    Returns (cols (8, 2R) int64, valid (2R,) bool, dest (2R,) int64 = the
    seed % n_shards, floor-mod).  Any device."""
    n_reads = lens.shape[0]
    q, rev, qs, qe = rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]
    t, ts, te, match = rec[:, 4], rec[:, 5], rec[:, 6], rec[:, 7]
    keep = (q != t) & (qe - qs >= 500) & (te - ts >= 500)
    sq = torch.clamp(q, 0, n_reads - 1)
    st_ = torch.clamp(t, 0, n_reads - 1)
    # the two symmetrized views (overlap.sort.symmetrize semantics, ends
    # made inclusive)
    v_q = keep & is_seed[sq] & (lens[sq] >= qe)
    v_t = keep & is_seed[st_] & (lens[st_] >= te)
    cols = torch.stack([torch.cat([a, b]) for a, b in (
        (q, t), (rev, rev), (qs, ts), (qe - 1, te - 1),
        (t, q), (ts, qs), (te - 1, qe - 1), (match, match))])
    return cols, torch.cat([v_q, v_t]), cols[0] % n_shards


def seed_route_plain(rec, is_seed, lens, n_shards: int, cap: int):
    """Plain version of seed_route (any device): the views, then
    bucketize_plain."""
    cols, valid, dest = seed_symmetrize_plain(rec, is_seed, lens, n_shards)
    return bucketize_plain(cols.unbind(0), dest, valid, n_shards, cap)


def seed_route(rec, is_seed, lens, n_shards: int, cap: int):
    """A shard's raw records routed by seed: the valid views of
    seed_symmetrize_plain bucketed as mesh.bucketize buckets them (bucket d
    the first `cap` valid views of seed % n_shards == d in view order, eight
    fields; counts (n_shards + 1,) int64 on the host).

    CPU tensors run the plain version; CUDA tensors launch
    seed_route_count, read its totals (one host sync), allocate each
    bucket at its kept size and launch seed_route_scatter (csrc/route.cu)."""
    if rec.device.type == "cpu":
        return seed_route_plain(rec, is_seed, lens, n_shards, cap)
    dev = rec.device
    R, n_reads = rec.shape[0], lens.shape[0]
    check_tensor("rec", rec, (R, 8), torch.int64, dev)
    if rec.data_ptr() % 16:
        raise ValueError("seed_route: rec must start on a 16-byte boundary "
                         "(the kernel reads a record 16 bytes at a time)")
    check_tensor("is_seed", is_seed, (n_reads,), torch.bool, dev)
    check_tensor("lens", lens, (n_reads,), torch.int64, dev)
    if n_reads < 1:
        raise ValueError("seed_route: no reads")
    check_route(2 * R, n_shards)
    if R == 0:
        empty = tuple(torch.empty(0, dtype=torch.int64, device=dev)
                      for _ in range(8))
        return [empty] * n_shards, np.zeros(n_shards + 1, np.int64)
    return route_call(dev, seed_route_launches(_build.kernels(), rec,
                                               is_seed, lens, n_shards, cap))


def seed_route_launches(lib, rec, is_seed, lens, n_shards: int,
                        cap: int) -> RouteLaunches:
    """seed_route's launches of seed_route_count and seed_route_scatter from
    `lib` (R > 0 records)."""
    R, n_reads = rec.shape[0], lens.shape[0]
    return RouteLaunches(
        "seed_route", 2 * R, 2 * -(-R // ROUTE_SEED_TILE), n_shards, cap, 8,
        lambda sc, ticket, stream: lib.ndt_seed_route_count(
            rec.data_ptr(), is_seed.data_ptr(), lens.data_ptr(), R, n_reads,
            n_shards, sc.keys, sc.blk, ticket, sc.counts.data_ptr(), stream),
        lambda sc, dst, stream: lib.ndt_seed_route_scatter(
            rec.data_ptr(), R, sc.keys, sc.blk, sc.counts.data_ptr(),
            n_shards, min(cap, 2 * R), dst, sc.table, stream))


def distributed_seed_sort_step(rec8, is_seed, lens, *, cap_route: int,
                               mesh: Mesh):
    """rec8: (n_shards*R, 8) raw records (qname, rev, qs, qe, tname, ts, te,
    match; exclusive ends), shard s owning rows [s*R, (s+1)*R); is_seed
    (n_reads,) bool and lens (n_reads,) read by every shard.  Returns
    (rows, n_tot, n_sent): rows[d] is shard d's (m_d, 8) int64 tensor of
    seed-keyed records in the host filter's total order, ends INCLUSIVE;
    n_tot the records the shards received, n_sent the records they routed
    (they differ when a bucket overflowed cap_route)."""
    n_shards = mesh.n_shards
    rec8 = shard_rows(mesh, rec8, torch.int64)
    is_seed = replicate(mesh, np.asarray(is_seed, bool))
    lens = replicate(mesh, np.asarray(lens, np.int64))

    def route(dev, shards):
        out = []
        for s in shards:
            buckets, counts = seed_route(rec8[s], is_seed[dev], lens[dev],
                                         n_shards, cap_route)
            # every valid view's seed % n_shards lies in the mesh
            out.append((buckets, int(counts.sum())))
        return out

    sent = mesh.for_each_card("mesh/sort_route", route)
    n_sent = psum(c for _, c in sent)
    recv = all_to_all(mesh, [b for b, _ in sent])
    sent = None

    def sort(dev, shards):
        out = []
        for d in shards:
            qn, rv, s_, e_, tn, ts2, te2, mt = (
                torch.cat([b[i] for b in recv[d]]) for i in range(8))
            recv[d] = None
            # total order shared with the host path: (qname, -match, span,
            # tname, ts, qs, rev)
            perm = _stable_lexsort([qn, -mt, e_ - s_, tn, ts2, s_, rv])
            out.append(torch.stack([qn, rv, s_, e_, tn, ts2, te2, mt],
                                   dim=1)[perm])
        return out

    rows = mesh.for_each_card("mesh/sort", sort)
    return rows, psum(len(r) for r in rows), n_sent


def distributed_sort_filter(raw: OvlBlock, is_seed: np.ndarray,
                            lens: np.ndarray, mesh: Mesh,
                            max_bin_cov: int = 40, max_flank_len: int = 300,
                            is_hq: bool = False) -> SortResult:
    """Full ovl_sort over the mesh: shuffle and sort on the device, then
    the native per-seed filter per shard on the host."""
    n, n_shards = len(raw), mesh.n_shards
    R = -(-max(n, 1) // n_shards)
    rec8 = np.full((R * n_shards, 8), 0, np.int32)
    for i, k in enumerate(("qname", "rev", "qs", "qe", "tname", "ts", "te",
                           "match")):
        rec8[:n, i] = np.asarray(raw.data[k], np.int32)
    # pad rows have q == t == 0: the keep gate drops them
    cap_route = 2 * (2 * R) // n_shards + 256
    rows, n_tot, n_sent = distributed_seed_sort_step(
        rec8, is_seed, np.asarray(lens, np.int32), cap_route=cap_route,
        mesh=mesh)
    if n_tot != n_sent:
        raise RuntimeError(
            f"distributed sort overflow: routed {n_tot} != sent {n_sent} "
            f"records (raise cap_route)")

    lens64 = np.asarray(lens, np.int64)
    shard_recs = [r.cpu().numpy().astype(np.int32) for r in rows]
    # min_seed_len must match the host path: min length over seeds PRESENT
    # in the symmetrized record set (global across shards)
    present = np.unique(np.concatenate([r[:, 0] for r in shard_recs]))
    min_seed_len = int(lens64[present].min()) if len(present) else 0

    def filter_(dev, shards):
        # the native filter releases the interpreter lock: the cards'
        # threads filter their shards at once, on the host
        return [_filter_sorted_native(
            shard_recs[s], lens64, min_seed_len, max_bin_cov, max_flank_len,
            is_hq) if len(shard_recs[s]) else None for s in shards]

    rows_parts, bl = [], {}
    for part in mesh.for_each_card("mesh/sort_filter", filter_):
        if part is not None:
            rows_parts.append(part[0])
            # shard by shard: bl.json lists the seeds in shard order
            bl.update(part[1])
    if not rows_parts:
        return SortResult(OvlBlock.empty(), {})
    out = np.concatenate(rows_parts)
    # canonical global order: shards interleave seeds (seed % n_shards), so
    # re-sort by seed id (stable keeps the within-seed filter order)
    out = out[np.argsort(out[:, 0], kind="stable")]
    return SortResult(_rows_to_block(out), bl)
