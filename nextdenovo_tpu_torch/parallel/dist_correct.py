"""Seed correction of the mesh path (PyTorch/CUDA port of
nextdenovo_tpu/parallel/dist_correct.py).

Seed jobs are owned by shard `seed % n_shards` (the owner key of the
distributed sort, parallel/dist_sort.py), and the results are filled in
that order.  Every (support, seed segment) pair of a job is aligned WHOLE
— the mesh path does not cut long pairs into pieces as
correct.driver.correct_seeds does (_chunk_sup_pairs), and passes no `hq` —
by distributed_band_align, and the native consensus runs per seed.

distributed_band_align deals the pairs to the shards round-robin, and each
card of the mesh runs ops.align.band_align on its shards' pairs, sorted by
length, on a host thread of its own (parallel/mesh.Mesh.for_each_card):
band_align's Myers tier (ops.myers.myers_align, csrc/myers.cu's myers_fwd
and myers_tb) stands for the reference's distributed_myers_step, and the
pairs that leave its band retry on the wide-band wavefront (band_align's
R = 2 tier, csrc/wave.cu's wave_fwd and wave_tb).  The reference pads
every pair of every shard into one (S*B, qw) Myers program; the Myers
program is row-local (a pair's result depends neither on the launch it
shares nor on the padding width), so here myers_align cuts the sorted
pairs into sub-batches whose traceback planes stay under its 4 GiB bound,
each padded alone.  Event expansion is the native expand_events (the
reference's `_expand_pair` in C).
"""
from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Dict, List

import numpy as np

from ..correct.driver import SeedJob, _consensus_entry, iter_seed_jobs
from ..io.seqstore import SeqStore
from ..ops.align import band_align
from ..utils import span
from .mesh import Mesh

# pairs aligned in one distributed_band_align call of distributed_correct:
# enough for the aligner's largest launches (~7k pairs of 8 kb under the
# 4 GiB plane bound), few enough that the consensus of one group overlaps
# the alignment of the next
GROUP_PAIRS = 1 << 15


def distributed_band_align(queries, targets, mesh: Mesh):
    """Banded alignment of arbitrary (query, target) pairs over the mesh.
    The pairs are dealt to the shards round-robin, pair i to shard i % n,
    as the reference deals them; each card aligns its shards' pairs in one
    band_align call on its device (the Myers tier, then the wide-band
    retry), in ascending order of their longer side, so that each Myers
    sub-batch pads to lengths close to its own.  Each pair's result is its
    own, whatever launch it shares.  Returns band_align-shaped dicts in
    input order."""
    n = mesh.n_shards

    def align(dev, shards):
        mine = [i for i in range(len(queries)) if i % n in shards]
        order = sorted(mine, key=lambda i: max(len(queries[i]),
                                              len(targets[i])))
        out = band_align([np.asarray(queries[i], np.int8) for i in order],
                         [np.asarray(targets[i], np.int8) for i in order],
                         device=dev)
        got = dict(zip(order, out))
        return [[(i, got[i]) for i in range(s, len(queries), n)]
                for s in shards]

    res = [None] * len(queries)
    for part in mesh.for_each_card("mesh/band_align", align):
        for i, r in part:
            res[i] = r
    return res


def group_pairs(store: SeqStore, group: List[SeedJob]):
    """The (support, seed segment) pairs of a group of seed jobs, in job
    order: ([(job index, support, segment start, segment end)], [segment
    codes])."""
    pairs, segs = [], []
    for gi, job in enumerate(group):
        seed_codes = store.get(job.seed)
        for (t, rev, ss, se, sqs, sqe) in job.sups:
            pairs.append((gi, store.subseq(t, sqs, sqe + 1, rc=bool(rev)),
                          ss, se))
            segs.append(seed_codes[ss : se + 1].astype(np.int8))
    return pairs, segs


def distributed_correct(store: SeqStore, sorted_blk, blacklist: Dict,
                        mesh: Mesh, read_type: int = 1,
                        min_len_seed: int = 1000, min_len_aln: int = 500,
                        min_cov_seed: int = 10, max_cov_aln: int = 130, min_cov: int = 4,
                        max_lq_length: int = 10000,
                        min_error_corrected_ratio: float = 0.8,
                        split: bool = False, fast: bool = False):
    """Correction over the mesh: returns {seed: (len, ide, seq)} for every
    seed job, filled shard by shard (the owner shard's jobs in job order).

    The jobs are taken in that order in groups of at least GROUP_PAIRS
    pairs; a group's pairs are aligned in one distributed_band_align call
    and its seeds' native consensus runs on a host thread pool (ctypes
    releases the GIL), one thread a core up to 8, while the next group
    aligns."""
    lens = np.asarray(store.length)
    jobs: List[SeedJob] = list(iter_seed_jobs(
        sorted_blk, blacklist, lens, min_len_seed=min_len_seed,
        min_len_aln=min_len_aln, min_cov_seed=min_cov_seed,
        max_cov_aln=max_cov_aln))
    # shard ownership: the key of the distributed sort
    owned = sorted(jobs, key=lambda j: j.seed % mesh.n_shards)
    kw = dict(min_len_aln=min_len_aln, max_cov_aln=max_cov_aln,
              min_cov=min_cov,
              min_error_corrected_ratio=min_error_corrected_ratio,
              split=split, read_type=read_type, fast=fast)
    futures = []

    def flush(group, ex):
        pairs, segs = group_pairs(store, group)
        with span("mesh/align_group", jobs=len(group), pairs=len(pairs)):
            res = distributed_band_align([p[1] for p in pairs], segs, mesh)
        per_job = [([], [], [], []) for _ in group]
        for (gi, sup, ss, se), r in zip(pairs, res):
            if r["reached"] and r["ok"]:
                for lst, v in zip(per_job[gi], (sup.astype(np.uint8), ss, se,
                                                r["ops"].astype(np.uint8))):
                    lst.append(v)
        for job, (sups, tss, tes, ops) in zip(group, per_job):
            futures.append((job.seed, ex.submit(
                _consensus_entry,
                (store.get(job.seed), sups, tss, tes, ops,
                 dict(kw, max_lq_length=min(max_lq_length,
                                            job.seed_len // 2 or 1))))))

    with cf.ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 4))) as ex:
        group, n_pairs = [], 0
        for job in owned:
            group.append(job)
            n_pairs += len(job.sups)
            if n_pairs >= GROUP_PAIRS:
                flush(group, ex)
                group, n_pairs = [], 0
        if group:
            flush(group, ex)
        with span("mesh/consensus_wait", seeds=len(futures)):
            return {seed: fut.result() for seed, fut in futures}
