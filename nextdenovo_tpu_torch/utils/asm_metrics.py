"""Assembly-vs-truth quality metrics for simulated workloads.

The reference validates assemblies by mapping contigs back to a trusted
reference and counting QUAST-style misassembly breakpoints
(doc/TEST3.rst:141-157 reports contiguity + BUSCO/QUAST
checks on A. thaliana).  We have the exact truth genome for every
simulated run, so the same check reduces to exact unique-31-mer anchor
chaining: a misassembly is a contig position where the truth coordinates
of adjacent anchor blocks are inconsistent (jump/strand flip), exactly
QUAST's "extensive misassembly" (>=1 kb inconsistency) definition.

Also provides the dual-haplotype k-mer identity: on a heterozygous
simulation (io/simulate.py het_snp_rate) the consensus legitimately
resolves each SNP site to EITHER haplotype, so identity must be measured
against the union of both haplotypes' k-mer sets or ~31*rate/2 of
k-mers read as false errors (0.92 "identity" at het=0.005 on a perfect
assembly).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def pack_kmers(seq: np.ndarray, k: int = 31) -> np.ndarray:
    """All k-mers of a 2-bit coded sequence as uint64 (len(seq)-k+1)."""
    a = np.asarray(seq, np.uint64)
    if len(a) < k:
        return np.zeros(0, np.uint64)
    v = np.zeros(len(a) - k + 1, np.uint64)
    for j in range(k):
        v = (v << np.uint64(2)) | a[j : len(a) - k + 1 + j]
    return v


def second_haplotype(genome: np.ndarray, het_snp_rate: float,
                     seed: int) -> np.ndarray:
    """Reproduce io/simulate.simulate_reads's hap2 derivation exactly
    (same rng stream prefix: one random(glen) draw + one integers draw),
    so post-hoc metric tools can rebuild the diploid truth without
    re-simulating reads."""
    if het_snp_rate <= 0:
        return np.asarray(genome)
    rng = np.random.default_rng(seed)
    hap2 = np.asarray(genome).copy()
    snp = rng.random(len(hap2)) < het_snp_rate
    hap2[snp] = (hap2[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    return hap2


def kmer_identity(contigs: Sequence[np.ndarray],
                  genomes: Sequence[np.ndarray],
                  k: int = 31, stride: int = 7) -> float:
    """Fraction of sampled contig k-mers present in ANY truth genome
    (both strands).  Pass [hap1, hap2] for diploid simulations."""
    gk: set = set()
    for g in genomes:
        g = np.asarray(g)
        gk |= set(pack_kmers(g, k).tolist())
        gk |= set(pack_kmers((g ^ 3)[::-1], k).tolist())
    hit = tot = 0
    for c in contigs:
        ck = pack_kmers(np.asarray(c), k)[::stride]
        hit += int(np.fromiter((int(x) in gk for x in ck), bool,
                               len(ck)).sum()) if len(ck) else 0
        tot += len(ck)
    return hit / max(1, tot)


def _unique_anchor_table(genome: np.ndarray, k: int):
    """Sorted (kmer, truth_pos, strand) over k-mers that occur exactly
    once in the genome counting both strands (repeat copies drop out, so
    anchors never tie between repeat instances)."""
    g = np.asarray(genome)
    fv = pack_kmers(g, k)
    rv = pack_kmers((g ^ 3)[::-1], k)
    allv = np.concatenate([fv, rv])
    pos = np.concatenate([np.arange(len(fv), dtype=np.int64),
                          # rc k-mer at rc-index j starts at genome pos
                          # len(g)-k-j on the forward strand
                          (len(g) - k) - np.arange(len(rv), dtype=np.int64)])
    strand = np.concatenate([np.zeros(len(fv), np.int8),
                             np.ones(len(rv), np.int8)])
    order = np.argsort(allv, kind="stable")
    sv, sp, ss = allv[order], pos[order], strand[order]
    # unique = not equal to either neighbor
    uniq = np.ones(len(sv), bool)
    uniq[1:] &= sv[1:] != sv[:-1]
    uniq[:-1] &= sv[1:] != sv[:-1]
    return sv[uniq], sp[uniq], ss[uniq]


def misassembly_count(contigs: Sequence[np.ndarray], genome: np.ndarray,
                      k: int = 31, stride: int = 101, tol: int = 200,
                      min_block: int = 3, extensive: int = 1000) -> dict:
    """QUAST-style misassembly breakpoints by unique-k-mer anchor chaining.

    Per contig: sample every `stride`-th k-mer, keep those unique in the
    truth (either strand), and walk anchors in contig order.  Adjacent
    anchors are collinear when strand matches and the diagonal moves by
    <= tol (absorbs residual consensus indels).  Maximal collinear runs
    with >= min_block anchors form blocks; every junction between
    surviving blocks is a breakpoint, classified `extensive` (truth
    inconsistency >= `extensive` bp or a strand flip — QUAST's extensive
    misassembly) or `local` otherwise.

    Returns {"extensive": n, "local": n, "n_anchors": n, "n_blocks": n}.
    """
    ukm, upos, ustr = _unique_anchor_table(genome, k)
    n_ext = n_loc = n_anc = n_blk = 0
    for c in contigs:
        cv = pack_kmers(np.asarray(c), k)
        if not len(cv):
            continue
        cpos = np.arange(0, len(cv), stride, dtype=np.int64)
        cv = cv[::stride]
        idx = np.searchsorted(ukm, cv)
        idx = np.minimum(idx, len(ukm) - 1)
        hit = len(ukm) > 0
        hit = (ukm[idx] == cv) if hit else np.zeros(len(cv), bool)
        ap, gp, gs = cpos[hit], upos[idx[hit]], ustr[idx[hit]]
        n_anc += len(ap)
        if len(ap) < 2:
            n_blk += 1 if len(ap) else 0
            continue
        dc = np.diff(ap)
        dg = np.diff(gp)
        same = gs[1:] == gs[:-1]
        # expected truth step: +dc on '+' anchors, -dc on '-'
        exp = np.where(gs[:-1] == 0, dc, -dc)
        drift = np.abs(dg - exp)
        brk = (~same) | (drift > tol)
        # blocks = runs between breaks; drop blocks with < min_block anchors
        bounds = np.flatnonzero(brk)           # break after anchor bounds[i]
        starts = np.concatenate([[0], bounds + 1])
        ends = np.concatenate([bounds, [len(ap) - 1]])
        keep = (ends - starts + 1) >= min_block
        ks, ke = starts[keep], ends[keep]
        n_blk += len(ks)
        # re-examine junctions between surviving neighbours only
        for i in range(len(ks) - 1):
            a, b = ke[i], ks[i + 1]            # last anchor / first anchor
            if gs[a] != gs[b]:
                n_ext += 1
                continue
            step = ap[b] - ap[a]
            e = step if gs[a] == 0 else -step
            d = abs(int(gp[b] - gp[a]) - int(e))
            if d <= tol:
                continue                        # collinear after noise drop
            if d >= extensive:
                n_ext += 1
            else:
                n_loc += 1
    return {"extensive": int(n_ext), "local": int(n_loc),
            "n_anchors": int(n_anc), "n_blocks": int(n_blk)}
