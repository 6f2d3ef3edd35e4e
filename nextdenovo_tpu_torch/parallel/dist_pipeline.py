"""Pipeline stages of the mesh path (PyTorch/CUDA port of
nextdenovo_tpu/parallel/dist_pipeline.py).  `use_mesh = N` (N > 1, one
host) routes the heavy stages through the mesh layer, N shards over the
mesh's cards, one host thread a card (parallel/mesh.py):

  raw_align  -> distributed_overlap_step   (hash-sharded index,
                                            minimizer routing)
  sort_align -> distributed_sort_filter    (seed shuffle)
  seed_cns   -> distributed_correct        (whole pairs on the Myers tier,
                                            consensus per owning shard)
  cns_align  -> mesh candidates + distributed_band_align realignment
  ctg_align  -> distributed_map_polish_reads
  ctg_cns    -> polish with distributed_band_align

The overlap set-up that stages 01, 04 and 06 share (the reference's
_pow2_rows, the index partition, the caps) is dist_overlap.mesh_overlaps.
Every stage file equals the JAX package's mesh run's
(tests/test_torch_pipeline_mesh.py).  The mesh path is not the
single-device path: seed_cns aligns long (support, segment) pairs whole,
where correct.driver.correct_seeds cuts segments over CORR_CHUNK_T into
pieces, so corrected reads can differ between the two.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np

from ..io.seqstore import SeqStore
from ..overlap.records import OvlBlock
from .dist_overlap import mesh_overlaps, records_block
from .mesh import Mesh

log = logging.getLogger("nextdenovo_tpu_torch")


def mesh_raw_align(store: SeqStore, seed_mask: np.ndarray, mesh: Mesh, *,
                   k: int, w: int, max_occ: int = 16, min_cnt: int = 4,
                   min_span: int = 500, top_k: int = 4) -> OvlBlock:
    """raw_align over the mesh: every read is a data-parallel query row,
    the minimizer index is hash-partitioned across shards, and the record
    set is filtered to seed queries (the single-device stage queries the
    seeds only)."""
    qmask = np.asarray(seed_mask, np.int8)
    records = mesh_overlaps(store, np.arange(len(store)), store, 0, mesh,
                            qmask, k=k, w=w, max_occ=max_occ,
                            index_max_occ=64, min_cnt=min_cnt,
                            min_span=min_span, top_k=top_k)
    return records_block(records, qmask)


def mesh_correction(store: SeqStore, sorted_blk, blacklist: Dict,
                    mesh: Mesh, *, read_type: int = 1,
                    min_len_seed: int = 1000,
                    min_error_corrected_ratio: float = 0.8,
                    split: bool = False, fast: bool = False,
                    **kw) -> SeqStore:
    """seed_cns over the mesh: distributed_correct per seed, then
    run_correction's post-processing (piece naming, split at uncorrected
    runs, length and identity gates) in global job order."""
    from ..correct.driver import _TR, iter_seed_jobs, seed_pieces
    from .dist_correct import distributed_correct

    lens = np.asarray(store.length)
    jobs = list(iter_seed_jobs(
        sorted_blk, blacklist, lens, min_len_seed=min_len_seed,
        **{k: v for k, v in kw.items()
           if k in ("min_len_aln", "min_cov_seed", "max_cov_aln")}))
    results = distributed_correct(
        store, sorted_blk, blacklist, mesh, read_type=read_type, min_len_seed=min_len_seed,
        min_error_corrected_ratio=min_error_corrected_ratio, split=split,
        fast=fast,
        **{k: v for k, v in kw.items()
           if k in ("min_len_aln", "min_cov_seed", "max_cov_aln",
                    "min_cov", "max_lq_length")})
    out_seqs, out_names = [], []
    n_fail = 0
    for job in jobs:
        pieces, failed = seed_pieces(job.seed, *results[job.seed],
                                     min_len_seed, min_error_corrected_ratio,
                                     split)
        n_fail += failed
        for name, r in pieces:
            out_names.append(name)
            out_seqs.append(
                np.frombuffer(r.encode().translate(_TR), np.uint8))
    log.info("mesh correction: %d corrected sequences (%d failures)",
             len(out_seqs), n_fail)
    return SeqStore.from_codes(out_seqs, names=out_names)


def mesh_cns_align(cns_store: SeqStore, mesh: Mesh, *, k: int, w: int,
                   maxhan1: int, maxhan2: int, min_span: int,
                   min_cnt: int = 3, max_occ: int = 16):
    """cns_align over the mesh: all-vs-all candidates from the mesh overlap
    step (pair-once gated), realignment by distributed_band_align; end
    extension (on mesh.device) and the sequential dovetail filter run as
    on one device.
    Returns (OvlBlock, bl_info, CnsInfo) like
    cns_overlap_stage(return_info=True)."""
    from ..overlap.cns import (bl_info_for_graph, extend_overlap_ends,
                               filter_cns_overlaps, realign_overlaps)
    from .dist_correct import distributed_band_align

    records = mesh_overlaps(cns_store, np.arange(len(cns_store)), cns_store,
                            0, mesh, np.ones(len(cns_store), np.int8), k=k,
                            w=w, max_occ=max_occ,
                            index_max_occ=max(64, max_occ * 4),
                            min_cnt=min_cnt, min_span=min_span, top_k=1)
    cand = records_block(records)
    align_fn = lambda fq, ft: distributed_band_align(fq, ft, mesh)
    ovl = realign_overlaps(cns_store, cand, device=mesh.device,
                           align_fn=align_fn)
    ovl = extend_overlap_ends(cns_store, ovl, device=mesh.device)
    kept, info = filter_cns_overlaps(ovl, np.asarray(cns_store.length),
                                     maxhan1=maxhan1, maxhan2=maxhan2)
    return kept, bl_info_for_graph(info), info
