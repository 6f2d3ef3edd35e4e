"""Contig polish over the mesh (PyTorch/CUDA port of
nextdenovo_tpu/parallel/dist_polish.py).

  * ctg_align: the read->contig mapping runs the mesh overlap step
    (parallel/dist_overlap.py) with the contigs' minimizer index
    partitioned by hash range over the shards and the reads as
    data-parallel query rows after the contigs in one joint id space.
  * ctg_cns: every window's support alignment goes through
    distributed_band_align (parallel/dist_correct.py); the window consensus
    and stitching stay on the host, as in polish/driver.py, which takes the
    aligner as `align_fn`.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..io.seqstore import SeqStore
from ..polish.driver import run_polish
from .dist_correct import distributed_band_align
from .dist_overlap import mesh_overlaps, records_block
from .mesh import Mesh


def distributed_polish(contigs: List[np.ndarray], reads: SeqStore,
                       mesh: Mesh, *,
                       read_type: int = 1, min_cov: int = 3,
                       window: int = 25000,
                       node_qv: Optional[List[List[dict]]] = None,
                       split: bool = True, struct_min_reads: int = 150,
                       ovl=None, contig_ids=None) -> List[np.ndarray]:
    """run_polish with every support alignment run by
    distributed_band_align over `mesh` — the mesh form of ctg_cns."""
    align_fn = lambda segs, tgts: distributed_band_align(segs, tgts, mesh)
    return run_polish(contigs, reads, read_type=read_type, min_cov=min_cov,
                      window=window, node_qv=node_qv, split=split,
                      struct_min_reads=struct_min_reads, ovl=ovl,
                      contig_ids=contig_ids, align_fn=align_fn,
                      device=mesh.device)


def distributed_map_polish_reads(contigs: List[np.ndarray], reads: SeqStore,
                                 mesh: Mesh, k: int = 15, w: int = 10):
    """ctg_align over the mesh: the contigs' index hash-partitioned across
    the shards, the reads queried data-parallel through
    distributed_overlap_autocap.  Returns an OvlBlock whose records are
    sorted by qname (stable), as find_overlaps returns them."""
    n_ctg = len(contigs)
    # the reads are query rows after the contigs, in the joint id space of
    # the reference's (contigs + reads) store
    return records_block(mesh_overlaps(
        SeqStore.from_codes(list(contigs)), np.arange(n_ctg), reads, n_ctg,
        mesh, None, k=k, w=w, max_occ=8, index_max_occ=256, min_cnt=4,
        min_span=500, top_k=4))
