"""Seed-correction driver (PyTorch/CUDA port).

Counterpart of nextdenovo_tpu/correct/driver.py: reads the seed-keyed
sorted overlap block, gathers oriented support subsequences, aligns
(seed-segment, support) pairs in length-sorted batches on the device's
banded aligner (ops/align.py), and hands alignment op strings to the native
consensus engine (native/, = nextcorrect.c semantics) on a host thread
pool.

Reference data flow: read_seq_data (nextcorrect.py:92-143) selects supports
per seed (min_len_aln, max_cov_aln*1.5 cap, dedup by read, min_cov_seed
gate); worker (:183-199) fetches subsequences and calls nextCorrect.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..io.seqstore import SeqStore
from ..native import correct_seed
from ..device import resolve_device
from ..ops import align as dev_align

log = logging.getLogger(__name__)

# Long (support, seed-segment) pairs are split into ~PIECE-sized chunks
# aligned independently (same design as the polish windows,
# polish/driver.py CHUNK_T/PIECE): each chunk is its own MSA support, the
# per-chunk indel drift stays far inside the Myers band, and the aligner's
# column count (hence its traceback-plane memory per pair) is bounded at
# ~CORR_CHUNK_T.  Chunk boundaries are staggered per support read so
# boundary slop never piles onto one column.
CORR_CHUNK_T = 12288
CORR_PIECE = 9216


def _chunk_sup_pairs(sup: np.ndarray, seg_ss: int, seg_se: int, t: int):
    """Split one oriented support/segment pair into staggered chunks.
    Returns [(sup_lo, sup_hi, ss, se)] with INCLUSIVE seed ends."""
    seg_len = seg_se - seg_ss + 1
    if seg_len <= CORR_CHUNK_T:
        return [(0, len(sup), seg_ss, seg_se)]
    st = (t % 5) * (CORR_PIECE // 5)
    bounds = [seg_ss]
    # stagger with a SHORT first chunk (st alone), never st + CORR_PIECE:
    # a long first chunk would exceed CORR_CHUNK_T
    p = seg_ss + (st if st else CORR_PIECE)
    while p < seg_se - CORR_PIECE // 2:
        bounds.append(p)
        p += CORR_PIECE
    bounds.append(seg_se + 1)
    f = len(sup) / max(1, seg_len)
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        # support-slice slop scales with chunk length: the fixed +-32 can
        # undershoot cumulative indel drift on raw reads over ~9 kb chunks
        slop = 32 + (b - a) // 32
        lo = max(0, int((a - seg_ss) * f) - slop)
        hi = min(len(sup), int((b - seg_ss) * f) + slop)
        if b - a >= 200 and hi - lo >= 100:
            out.append((lo, hi, a, b - 1))
    return out or [(0, len(sup), seg_ss, seg_se)]


@dataclass
class SeedJob:
    seed: int
    seed_len: int
    sups: List[Tuple[int, int, int, int, int, int]]  # (q, rev, ss, se, qs, qe) inclusive


def iter_seed_jobs(sorted_blk, blacklist: Dict[int, str], lens: np.ndarray,
                   min_len_seed: int = 1000, min_len_aln: int = 500,
                   min_cov_seed: int = 10, max_cov_aln: int = 130
                   ) -> Iterator[SeedJob]:
    """Group the sorted block per seed (read_seq_data semantics)."""
    q = np.asarray(sorted_blk.qname)
    if len(q) == 0:
        return
    seeds = np.unique(q)
    for si in range(len(seeds)):
        seed = int(seeds[si])
        if seed in blacklist:
            continue
        lo, hi = int(np.searchsorted(q, seed, "left")), int(np.searchsorted(q, seed, "right"))
        seed_len = int(lens[seed])
        if seed_len < min_len_seed:
            continue
        sups = []
        used = set()
        total = 0
        for i in range(lo, hi):
            t = int(sorted_blk.tname[i])
            if t == seed:
                continue  # self record
            ss, se = int(sorted_blk.qs[i]), int(sorted_blk.qe[i])
            if se - ss < min_len_aln:
                continue
            if total / seed_len > max_cov_aln * 1.5:
                break
            if t in used:
                continue
            used.add(t)
            sups.append((t, int(sorted_blk.rev[i]), ss, se,
                         int(sorted_blk.ts[i]), int(sorted_blk.te[i])))
            total += se - ss + 1
        if total / seed_len < min_cov_seed:
            continue
        yield SeedJob(seed, seed_len, sups)


def _consensus_entry(payload):
    """Top-level (picklable) consensus worker: runs one seed's native
    tag-MSA consensus from a prebuilt payload.  Used by both the thread
    pool and the spawn-process pool (see isolation note in correct_seeds)."""
    seed_codes, sups, tss, tes, ops, kw = payload
    return correct_seed(seed_codes, sups, tss, tes, ops, **kw)


def correct_seeds(store: SeqStore, jobs: List[SeedJob], read_type: int = 1,
                  min_len_aln: int = 500, max_cov_aln: int = 130,
                  min_cov: int = 4, max_lq_length: int = 10000,
                  min_error_corrected_ratio: float = 0.8, split: bool = False,
                  min_len_seed: int = 1000, align_batch: int = 384,
                  fast: bool = False, lookahead: int = 4,
                  cns_threads: int | None = None, device=None):
    """Run correction for the given jobs.  Yields (seed, len, ide, seq-str)
    in job order.

    Alignment pairs are pooled ACROSS seeds: a group of jobs is gathered
    until it holds >= align_batch*lookahead pairs, sorted by m+n (so each
    kernel batch carries similar lengths and minimal padding), and aligned
    in one band_align call.  The native consensus for each fully-aligned
    seed then runs on a host thread pool (ctypes releases the GIL),
    overlapping the next group's device alignment — the analogue of the
    reference's multiprocessing.Pool over seeds (nextcorrect.py:232-235)
    fused with its per-seed align loop.

    device=None means the GPU; "cpu" runs the aligner's plain versions."""
    import concurrent.futures as cf
    import os as _os

    dev = resolve_device(device)

    if cns_threads is None:
        # min(8, n_cpu): the feeder thread mostly blocks on the device, so
        # one consensus thread per core.  NDT_CNS_THREADS overrides (e.g.
        # =1 to serialize the native consensus when isolating
        # heap-corruption suspects at scale).
        cns_threads = int(_os.environ.get("NDT_CNS_THREADS", "0")) or \
            max(1, min(8, _os.cpu_count() or 4))
    # NDT_CNS_ISOLATE=1 runs the consensus in SPAWNED WORKER PROCESSES
    # instead of threads — a debugging/hardening mode.  Threads remain the
    # default: same heap, no pickle overhead.
    isolate = _os.environ.get("NDT_CNS_ISOLATE", "") not in ("", "0")
    if isolate:
        import multiprocessing as _mp
        ex = cf.ProcessPoolExecutor(
            max_workers=cns_threads, mp_context=_mp.get_context("spawn"))
    else:
        ex = cf.ThreadPoolExecutor(cns_threads)

    def _consensus(job, seed_codes, qs_list, spans, ops_all):
        sups, tss, tes, ops = [], [], [], []
        for i, o in enumerate(ops_all):
            if o is None:
                continue
            sups.append(qs_list[i].astype(np.uint8))
            tss.append(spans[i][0])
            tes.append(spans[i][1])
            ops.append(o)
        kw = dict(min_len_aln=min_len_aln,
                  max_cov_aln=max_cov_aln, min_cov=min_cov,
                  max_lq_length=min(max_lq_length, job.seed_len // 2 or 1),
                  min_error_corrected_ratio=min_error_corrected_ratio,
                  split=split, read_type=read_type, fast=fast)
        return seed_codes, sups, tss, tes, ops, kw

    pending: List[Tuple[int, "cf.Future"]] = []

    def _flush(group):
        # group: list of (job, seed_codes, qs_list, t_pairs, spans).  All
        # pairs go to ONE band_align call, length-sorted so the aligner's
        # internal sub-batches (ops/myers.py) carry similar lengths with
        # minimal padding.
        flat = []
        for gi, (_job, _sc, qs_list, t_pairs, _sp) in enumerate(group):
            for si in range(len(qs_list)):
                flat.append((len(qs_list[si]) + len(t_pairs[si]), gi, si))
        flat.sort(key=lambda x: (x[0], x[1], x[2]))
        ops_store = [[None] * len(g[2]) for g in group]
        res = dev_align.band_align(
            [group[gi][2][si] for _, gi, si in flat],
            [group[gi][3][si] for _, gi, si in flat],
            hq=read_type == 3, device=dev)
        for (_, gi, si), r in zip(flat, res):
            if r["reached"] and r["ok"]:
                ops_store[gi][si] = r["ops"].astype(np.uint8)
        for (job, sc, qs_list, _t, spans), ops_all in zip(group, ops_store):
            pending.append((job.seed,
                            ex.submit(_consensus_entry,
                                      _consensus(job, sc, qs_list, spans,
                                                 ops_all))))

    try:
        group, npairs = [], 0
        for job in jobs:
            seed_codes = store.get(job.seed)
            qs_list, t_pairs, spans = [], [], []
            for (t, rev, ss, se, sqs, sqe) in job.sups:
                sup = store.subseq(t, sqs, sqe + 1, rc=bool(rev))
                for (lo, hi, a, b) in _chunk_sup_pairs(sup, ss, se, t):
                    qs_list.append(sup[lo:hi].astype(np.int8))
                    t_pairs.append(seed_codes[a : b + 1].astype(np.int8))
                    spans.append((a, b))
            group.append((job, seed_codes, qs_list, t_pairs, spans))
            npairs += len(qs_list)
            if npairs >= align_batch * lookahead:
                _flush(group)
                group, npairs = [], 0
                # drain finished heads (keeps memory bounded, order stable)
                while pending and pending[0][1].done():
                    seed, fut = pending.pop(0)
                    ln, ide, seq = fut.result()
                    yield seed, ln, ide, seq
        if group:
            _flush(group)
        for seed, fut in pending:
            ln, ide, seq = fut.result()
            yield seed, ln, ide, seq
    finally:
        ex.shutdown(wait=True)


def seed_pieces(seed: int, ln: int, ide: float, seq: str, min_len_seed: int,
                min_error_corrected_ratio: float, split: bool):
    """A seed's consensus -> ([(name, sequence)], failed): nothing below
    min_len_seed or min_error_corrected_ratio (failed when the consensus
    gave up, ln == 3); with split the corrected (uppercase) runs of at
    least min_len_seed, named seed_1, seed_2, ... (nextcorrect.py:237-247);
    else the whole sequence upper-cased, named by the seed."""
    if ln < min_len_seed or ide < min_error_corrected_ratio:
        return [], int(ln == 3)
    if not split:
        return [(str(seed), seq.upper())], 0
    runs = []
    cur = []
    for c in seq:
        if c in "ACGT":
            cur.append(c)
        else:
            if cur:
                runs.append("".join(cur))
            cur = []
    if cur:
        runs.append("".join(cur))
    return [(f"{seed}_{i+1}", r) for i, r in enumerate(runs)
            if len(r) >= min_len_seed], 0


def run_correction(store: SeqStore, sorted_blk, blacklist: Dict[int, str],
                   read_type: int = 1, min_len_seed: int = 1000,
                   min_error_corrected_ratio: float = 0.8,
                   split: bool = False,   # reference -s default (store_true
                                          # False, lib/nextcorrect.py:294)
                   resume_path: str | None = None,
                   fast: bool = False, shard: Tuple[int, int] | None = None,
                   device=None, **kw):
    """Full correction pass -> (corrected SeqStore, names).

    shard=(n_hosts, host_id): process only every n_hosts-th seed job
    (round-robin).  device=None means the GPU (raises without one).

    split=True mirrors nextcorrect.py's `-s` behavior: corrected seeds are split
    at uncorrected (lowercase) regions (nextcorrect.py:237-247).
    resume_path: jsonl progress file — completed seeds are appended as they
    finish and skipped on re-run (the reference's truncate-and-continue,
    nextcorrect.py:156-181, without the truncation dance)."""
    import json
    import os

    dev = resolve_device(device)
    lens = np.asarray(store.length)
    jobs = list(iter_seed_jobs(sorted_blk, blacklist, lens,
                               min_len_seed=min_len_seed, **{
                                   k: v for k, v in kw.items()
                                   if k in ("min_len_aln", "min_cov_seed",
                                            "max_cov_aln")}))
    if shard is not None:
        n_hosts, host_id = shard
        jobs = jobs[host_id::n_hosts]
    done: Dict[int, list] = {}
    if resume_path and os.path.exists(resume_path):
        with open(resume_path) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                    done[int(rec["seed"])] = rec["pieces"]
                except Exception:
                    break  # partial last line: ignore (re-done below)
        if done:
            log.info("correction: resuming, %d seeds already done", len(done))
    jobs = [j for j in jobs if j.seed not in done]
    prog = open(resume_path, "a") if resume_path else None
    log.info("correction: %d seed jobs", len(jobs))
    out_seqs, out_names = [], []
    for pieces in done.values():
        for name, seq in pieces:
            out_names.append(name)
            out_seqs.append(np.frombuffer(seq.encode().translate(_TR), np.uint8))
    n_fail = 0
    for seed, ln, ide, seq in correct_seeds(
            store, jobs, read_type=read_type, device=dev,
            min_error_corrected_ratio=min_error_corrected_ratio,
            split=split, fast=fast,
            **{k: v for k, v in kw.items()
               if k in ("min_len_aln", "max_cov_aln", "min_cov",
                        "max_lq_length")}):
        pieces, failed = seed_pieces(seed, ln, ide, seq, min_len_seed,
                                     min_error_corrected_ratio, split)
        n_fail += failed
        for name, r in pieces:
            out_names.append(name)
            out_seqs.append(np.frombuffer(r.encode().translate(_TR), np.uint8))
        if prog is not None:
            prog.write(json.dumps(dict(seed=int(seed), pieces=pieces)) + "\n")
            prog.flush()
    if prog is not None:
        prog.close()
    log.info("correction: %d corrected sequences (%d failures)",
             len(out_seqs), n_fail)
    return SeqStore.from_codes(out_seqs, names=out_names)


_TR = bytes.maketrans(b"ACGT", bytes([0, 1, 2, 3]))
