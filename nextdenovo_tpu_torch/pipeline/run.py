"""Pipeline orchestrator (PyTorch/CUDA port): correct-then-assemble end to
end.

Counterpart of nextdenovo_tpu/pipeline/run.py: a single-controller driver
with per-stage durable checkpoints (`<workdir>/<stage>/` + `.done`
markers), resumable by re-running the same command.

Stages (task = all; task = correct stops after 03, input_type = corrected
skips 01-03):
  00.db         read stats, auto seed_cutoff, 2-bit read store + seeds
  01.raw_align  minimizer all-vs-all overlap of seeds
  02.sort_align seed-keyed sort + depth/chimera filter (host)
  03.seed_cns   device align + native consensus -> corrected reads
  04.cns_align  cns all-vs-all + realign + end extension + dovetail filter
  05.ctg_graph  string graph -> draft contigs (host)
  06.ctg_cns    reads mapped back to the contigs + window re-consensus

Multi-host runs (hosts=parallel.launcher.HostContext; `python -m
nextdenovo_tpu_torch launch`) shard stages 01, 03, 04 and 06 round-robin by
host and run 00, 02 and 05 on host 0.  use_mesh = N > 1 on one host runs
stages 01, 02, 03, 04 and 06 as the reference's mesh path, N shards over
the visible cards, one host thread a card (parallel/dist_pipeline.py).

Usage: python -m nextdenovo_tpu_torch run.cfg [--device cpu]
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time

import numpy as np

from .. import _build
from ..correct.driver import run_correction
from ..device import resolve_device
from ..graph.assemble import assemble
from ..io.fastx import read_fastx, write_fasta
from ..io.seqstore import SeqStore, stat_n50
from ..overlap.cns import cns_overlap_stage
from ..overlap.engine import build_index, find_overlaps
from ..overlap.records import OvlBlock
from ..overlap.sort import sort_filter_overlaps
from ..utils import get_tracer, span
from .config import Config, load_config

log = logging.getLogger("nextdenovo_tpu_torch")


def mesh_shards(cfg: Config, n_hosts: int = 1) -> int:
    """The shard count of the mesh path, 0 for the single-device path: the
    reference takes the mesh path for use_mesh > 1 on one host (use_mesh =
    1, and any use_mesh in a multi-host run, take the single-device
    path)."""
    n = int(getattr(cfg, "use_mesh", 0) or 0)
    return n if n > 1 and n_hosts <= 1 else 0


def check_ported(cfg: Config, n_hosts: int = 1) -> None:
    """Refuse, before any work, a configuration the reference cannot run:
    raw HiFi reads on the mesh path, whose stage 01 sketches at raw_k = 51
    while the mesh overlap step's sketch packs k <= 31 only (the JAX
    package fails there on an assertion)."""
    if mesh_shards(cfg, n_hosts) and cfg.read_type == "hifi" \
            and cfg.input_type != "corrected":
        raise NotImplementedError(
            "use_mesh > 1 with read_type = hifi: the mesh path's raw_align "
            "sketches at raw_k = 51 and its sketch packs k <= 31 only, as in "
            "the reference; run HiFi reads with use_mesh <= 1")


def retry(name: str, fn, n: int = 3):
    """Bounded stage rerun (the reference's `rerun = 3` loops,
    nextDenovo:652-661): a transient stage failure is retried up to n
    times before propagating."""
    for attempt in range(n + 1):
        try:
            return fn()
        except KeyboardInterrupt:
            raise
        except Exception:
            if attempt >= n:
                raise
            log.warning("%s failed (attempt %d/%d), rerunning",
                        name, attempt + 1, n, exc_info=True)


class Stage:
    def __init__(self, workdir: str, name: str):
        self.dir = os.path.join(workdir, name)
        os.makedirs(self.dir, exist_ok=True)

    def done(self) -> bool:
        return os.path.exists(os.path.join(self.dir, ".done"))

    def mark(self):
        with open(os.path.join(self.dir, ".done"), "w") as fh:
            fh.write(str(time.time()))
        self._launches()

    def wait(self, hs):
        """A host that does not mark this stage waits for the host that
        does (multi-host runs)."""
        if not self.done():
            hs.wait_done(self)
        self._launches()

    def _launches(self):
        # the kernels' launch counts so far in this process, as a
        # zero-length span: the difference between two stages' rows is
        # what this process launched in the later stage
        get_tracer().add("launches/" + os.path.basename(self.dir), 0.0,
                         **_build.LAUNCHES)

    def path(self, f):
        return os.path.join(self.dir, f)


def run_pipeline(cfg: Config, device=None, hosts=None, mesh_devices=None):
    """Run the configured task.  device=None means the GPU and raises when
    there is none; "cpu" runs the kernels' plain PyTorch versions.

    The mesh path (use_mesh = N > 1) spreads its N shards over
    mesh_devices when given (parallel.mesh.make_mesh; repeats make groups
    on one device), else over the one explicit `device`, else over the
    visible cards, up to N (CUDA_VISIBLE_DEVICES restricts them).

    hosts: optional parallel.launcher.HostContext — N identical host
    processes share the workdir; raw_align, seed_cns, the cns_align
    candidates and realignment, ctg_align and ctg_cns are round-robin
    sharded by host, the sequential stages run on host 0 while the others
    wait on the stage's `.done` marker."""
    from ..parallel.launcher import SingleHost

    hs = hosts if hosts is not None else SingleHost()
    multi = hs.n_hosts > 1
    check_ported(cfg, hs.n_hosts)
    dev = resolve_device(device)
    # use_mesh = N: the heavy stages run as the reference's mesh path, N
    # shards over the mesh's cards (parallel/dist_pipeline.py)
    mesh, n_mesh = None, mesh_shards(cfg, hs.n_hosts)
    if n_mesh:
        from ..parallel.mesh import make_mesh
        mesh = make_mesh(n_mesh, device, devices=mesh_devices)
        log.info("use_mesh=%d: mesh stages, %d shards on %d card(s) (%s), "
                 "one host thread a card", n_mesh, n_mesh,
                 len(mesh.devices), ", ".join(map(str, mesh.devices)))
    # rewrite=no: keep any previous run safe by moving the workdir to
    # .backup.vN before starting fresh (nextDenovo:577-585).  rewrite=yes
    # (default) reuses the workdir in place, which is also how resume works.
    if not cfg.rewrite and not multi and os.path.isdir(cfg.workdir) \
            and os.listdir(cfg.workdir):
        import shutil
        for i in range(100):
            bak = f"{cfg.workdir}.backup.v{i}"
            if not os.path.exists(bak):
                shutil.move(cfg.workdir, bak)
                log.warning("rewrite=no: backed up %s to %s",
                            cfg.workdir, bak)
                break
    os.makedirs(cfg.workdir, exist_ok=True)
    t_start = time.time()

    # ---- db_stat + db_split --------------------------------------------
    st = Stage(cfg.workdir, "00.db")
    if multi and not hs.is_main():
        st.wait(hs)
    if st.done():
        store = SeqStore.load(st.path("reads"))
        meta = json.load(open(st.path("meta.json")))
        cfg.seed_cutoff = meta["seed_cutoff"]
        cfg.sort_max_depth = meta["sort_max_depth"]
        cfg.cns_min_span = meta["cns_min_span"]
        cfg.maxhan1 = meta["maxhan1"]
        seed_mask = np.asarray(meta["seed_mask"], bool)
    else:
        seqs, names = [], []
        with open(cfg.input_fofn) as fh:
            files = [l.strip() for l in fh if l.strip()]
        for f in files:
            if not f.startswith("/"):
                f = os.path.join(os.path.dirname(cfg.input_fofn), f)
            for name, codes in read_fastx(f):
                if len(codes) >= cfg.read_cutoff:
                    seqs.append(codes)
                    names.append(name)
        store = SeqStore.from_codes(seqs, names=names)
        lens = np.asarray(store.length)
        cfg.derive(int(lens.sum()), lens)
        seed_mask = lens >= cfg.seed_cutoff
        log.info("db: %d reads, %d bases, seed_cutoff=%d (%d seeds), sort -k %d",
                 len(store), store.total_bases, cfg.seed_cutoff,
                 int(seed_mask.sum()), cfg.sort_max_depth)
        store.save(st.path("reads"))
        json.dump(dict(seed_cutoff=cfg.seed_cutoff,
                       sort_max_depth=cfg.sort_max_depth,
                       cns_min_span=cfg.cns_min_span, maxhan1=cfg.maxhan1,
                       seed_mask=seed_mask.tolist()),
                  open(st.path("meta.json"), "w"))
        st.mark()
    lens = np.asarray(store.length)
    rids = np.arange(len(store))

    if cfg.input_type == "corrected":
        cns_store = store
    else:
        cns_store = _correct_stages(cfg, dev, hs, store, seed_mask, lens,
                                    rids, mesh)

    if cfg.task == "correct":
        _dump_trace(cfg, hs, mesh)
        return dict(cns=cns_store)

    # ---- cns_align ------------------------------------------------------
    st = Stage(cfg.workdir, "04.cns_align")
    if not st.done() and multi:
        _cns_align_multi(cfg, dev, hs, st, cns_store)
    elif not st.done():
        cns_rids = np.arange(len(cns_store))
        with span("cns_align", reads=len(cns_store)):
            if mesh is not None:
                from ..parallel.dist_pipeline import mesh_cns_align
                cns_ovl, bl, cinfo = retry(
                    "cns_align(mesh)", lambda: mesh_cns_align(
                        cns_store, mesh, k=cfg.cns_k,
                        w=cfg.cns_w, maxhan1=cfg.maxhan1,
                        maxhan2=cfg.maxhan2, min_span=cfg.cns_min_span),
                    cfg.rerun)
            else:
                cns_ovl, bl, cinfo = retry(
                    "cns_align", lambda: cns_overlap_stage(
                        cns_store, cns_rids, k=cfg.cns_k, w=cfg.cns_w,
                        maxhan1=cfg.maxhan1, maxhan2=cfg.maxhan2,
                        min_span=cfg.cns_min_span, device=dev,
                        return_info=True),
                    cfg.rerun)
        cns_ovl.save(st.path("cns.filt.dovt.ovl"))
        json.dump(bl, open(st.path("cnsbl.json"), "w"))
        np.savez(st.path("cnsinfo.npz"), st=cinfo.st,
                 touched=cinfo.touched, alns=cinfo.alns, lens=cinfo.lens)
        st.mark()
    cns_ovl = OvlBlock.load(st.path("cns.filt.dovt.ovl"))
    bl = {int(k): v for k, v in json.load(open(st.path("cnsbl.json"))).items()}
    log.info("cns_align: %d dovetail records, %d graph reads",
             len(cns_ovl), len(bl))

    # ---- ctg_graph ------------------------------------------------------
    # graph building is host-0 work (single-process in the reference too,
    # ng/opt.c:10); draft contigs + per-node qv are persisted so every host
    # can join the sharded polish stage below (and for resume).
    st = Stage(cfg.workdir, "05.ctg_graph")
    if multi and not hs.is_main():
        st.wait(hs)
    if st.done():
        draft = SeqStore.load(st.path("draft"))
        seqs = [draft.get(i) for i in range(len(draft))]
        node_qv = None
        if os.path.exists(st.path("node_qv.json")):
            node_qv = json.load(open(st.path("node_qv.json")))
    else:
        read_lens = {i: int(cns_store.length[i])
                     for i in range(len(cns_store))}
        with span("ctg_graph", records=len(cns_ovl)):
            sg, seqs = assemble(cns_ovl, read_lens, bl_info=bl,
                                get_read=lambda r: cns_store.get(r),
                                min_ctg_len=cfg.min_ctg_len,
                                alt_ctg=cfg.alt_ctg, **cfg.graph_params)
        paths = getattr(sg, "last_paths", [None] * len(seqs))
        node_meta = getattr(sg, "last_node_meta", None)
        from ..graph.output import (write_ctg_fasta, write_ctg_gfa,
                                    write_ctg_paths, write_graphml)
        write_ctg_fasta(st.path("nd.asm.p.fasta"), sg, seqs, paths,
                        min_len=cfg.min_ctg_len, node_meta=node_meta)
        write_ctg_gfa(st.path("nd.asm.p.gfa"), sg, seqs, paths)
        write_graphml(st.path("nd.asm.p.graphml"), sg)
        write_ctg_paths(st.path("nd.asm.p.path"), sg, paths)
        node_qv = None
        if node_meta is not None:
            node_qv = [[dict(p=m["off"], ide=m["ide"], ort=m["ort"],
                             irt=m["irt"]) for m in meta]
                       for meta in node_meta]
            json.dump(node_qv, open(st.path("node_qv.json"), "w"),
                      default=int)
        SeqStore.from_codes(seqs).save(st.path("draft"))
        st.mark()

    # ---- ctg_align + ctg_cns (polish) -----------------------------------
    # Sharded across hosts like the reference's ctg_align/ctg_cns job
    # matrices (nextDenovo:368-467): the read->contig mapping is split by
    # read, the window re-consensus by contig; host 0 gathers.
    st = Stage(cfg.workdir, "06.ctg_cns")
    if not st.done():
        if cfg.polish and seqs:
            from ..polish.driver import (collect_per_ctg, map_polish_reads,
                                         polish_one, warn_fragmented)

            # reference maps the raw seed reads back to contigs
            # (ctg_align, nextDenovo:368-415); fall back to cns reads
            if cfg.input_type == "raw":
                seed_rids = np.nonzero(seed_mask)[0]
                map_store = SeqStore.from_codes([store.get(int(r))
                                                 for r in seed_rids])
            else:
                map_store = cns_store
            map_p = st.path(f"map.h{hs.host_id}" if multi else "map")
            if not os.path.exists(map_p + ".npz"):
                with span("ctg_align", contigs=len(seqs)):
                    if mesh is not None:
                        from ..parallel.dist_polish import \
                            distributed_map_polish_reads
                        part = distributed_map_polish_reads(
                            seqs, map_store, mesh)
                    else:
                        part = map_polish_reads(
                            seqs, map_store, device=dev,
                            shard=(hs.n_hosts, hs.host_id) if multi
                            else None)
                part.save(map_p)
            if multi:
                hs.barrier("polish_map")
                # stable qname sort == single-host emission order
                ovl = _merge_by_qname(
                    [st.path(f"map.h{k}") for k in range(hs.n_hosts)])
            else:
                ovl = OvlBlock.load(map_p)
            pieces_p = st.path(f"pieces.h{hs.host_id}" if multi
                               else "pieces")
            if not os.path.exists(pieces_p + ".npz"):
                per_ctg = collect_per_ctg(ovl, len(seqs), map_store)
                warn_fragmented(per_ctg, [len(s) for s in seqs],
                                cfg.read_type_code)
                keyed = []
                align_fn = None
                if mesh is not None:
                    from ..parallel.dist_correct import \
                        distributed_band_align
                    align_fn = (lambda a_, b_: distributed_band_align(
                        a_, b_, mesh))
                with span("ctg_cns", contigs=len(seqs)):
                    for ci in hs.shard(len(seqs)):
                        ci = int(ci)
                        qv = (node_qv[ci] if node_qv and ci < len(node_qv)
                              else [])
                        for j, p in enumerate(retry(
                                f"ctg_cns contig {ci}",
                                lambda: polish_one(
                                    seqs[ci], per_ctg[ci], map_store, qv,
                                    read_type=cfg.read_type_code,
                                    split=cfg.ctg_split, device=dev,
                                    align_fn=align_fn),
                                cfg.rerun)):
                            keyed.append((f"{ci:06d}.{j:03d}", p))
                        log.info("polish: contig %d done", ci)
                SeqStore.from_codes([p for _, p in keyed],
                                    names=[n for n, _ in keyed]
                                    ).save(pieces_p)
            hs.barrier("polish_cns")
            if hs.is_main():
                all_pieces = []
                for k in range(hs.n_hosts):
                    p = SeqStore.load(st.path(f"pieces.h{k}") if multi
                                      else pieces_p)
                    all_pieces += [(n, p.get(i))
                                   for i, n in enumerate(p.names)]
                all_pieces.sort(key=lambda x: x[0])
                seqs = [s for _, s in all_pieces
                        if len(s) >= cfg.min_ctg_len]
                seqs.sort(key=len, reverse=True)
        if hs.is_main():
            from ..graph.output import stat_table

            names = [f"ctg{i:06d}" for i in range(len(seqs))]
            write_fasta(st.path("nd.asm.fasta"), list(zip(names, seqs)))
            stats = stat_n50(np.array([len(s) for s in seqs])) if seqs else {}
            with open(st.path("nd.asm.stat"), "w") as fh:
                fh.write(stat_table(seqs, cfg.genome_size or None))
                fh.write("\n" + json.dumps(stats, indent=1, default=int))
            st.mark()
        else:
            st.wait(hs)
    seqs = [s for _, s in read_fastx(st.path("nd.asm.fasta"))]
    stats = stat_n50(np.array([len(s) for s in seqs])) if seqs else {}
    _dump_trace(cfg, hs, mesh)
    log.info("assembly: %d contigs, N50=%s, total=%s (%.1fs)",
             len(seqs), stats.get("N50", (0,))[0] if stats else 0,
             stats.get("total", 0), time.time() - t_start)
    return dict(cns=cns_store, contigs=seqs, stats=stats,
                fasta=st.path("nd.asm.fasta"))


def _correct_stages(cfg: Config, dev, hs, store: SeqStore, seed_mask, lens,
                    rids, mesh=None) -> SeqStore:
    """Stages 01-03: raw overlaps of the seeds, the seed-keyed sort and
    filter, and the correction itself.  Returns the corrected-read store.
    With several hosts each overlaps and corrects its share of the seeds
    into per-host parts, and host 0 merges them and sorts; with a mesh
    (parallel/mesh.Mesh) the three stages run the mesh path."""
    multi = hs.n_hosts > 1
    # ---- raw_align ------------------------------------------------------
    st = Stage(cfg.workdir, "01.raw_align")
    if not st.done():
        seed_rids = rids[seed_mask]
        mine = seed_rids[hs.shard(len(seed_rids))]
        part_p = st.path(f"raw.ovl.h{hs.host_id}" if multi else "raw.ovl")
        if mesh is not None and not os.path.exists(part_p + ".npz"):
            from ..parallel.dist_pipeline import mesh_raw_align
            with span("raw_align", reads=len(store), queries=len(mine)):
                blk = retry("raw_align(mesh)", lambda: mesh_raw_align(
                    store, seed_mask, mesh, k=cfg.raw_k,
                    w=cfg.raw_w), cfg.rerun)
            blk.save(part_p)
        if not os.path.exists(part_p + ".npz"):
            # intra-stage resume: queries run in fixed chunks, each durably
            # checkpointed — a crash mid-overlap redoes only the unfinished
            # chunk (the reference's per-job .done granularity)
            CHUNK_Q = 2000
            with span("raw_align", reads=len(store), queries=len(mine)):
                idx = None
                parts = []
                for j, q0 in enumerate(range(0, len(mine), CHUNK_Q)):
                    cp = part_p + f".c{j:04d}"
                    if os.path.exists(cp + ".npz"):
                        parts.append(OvlBlock.load(cp))
                        continue
                    if idx is None:
                        with span("raw_align/build_index", k=cfg.raw_k,
                                  w=cfg.raw_w):
                            idx = build_index(store, rids, k=cfg.raw_k,
                                              w=cfg.raw_w, max_occ=64,
                                              device=dev)
                    sub = mine[q0 : q0 + CHUNK_Q]
                    blk = retry(
                        f"raw_align chunk {j}",
                        lambda: find_overlaps(
                            store, sub, idx, k=cfg.raw_k, w=cfg.raw_w,
                            max_occ=16, min_cnt=4, min_span=500,
                            top_k=4, query_mask=seed_mask, device=dev),
                        cfg.rerun)
                    blk.save(cp)
                    parts.append(blk)
            raw_part = OvlBlock.concat_all(parts)
            raw_part.save(part_p)
            n_parts = len(parts)
            # release the minimizer index's device memory now: as a
            # function local it would otherwise stay resident for the
            # whole run
            idx = None
            parts = None
            for j in range(n_parts):
                try:
                    os.unlink(part_p + f".c{j:04d}.npz")
                except OSError:
                    pass
        if multi:
            hs.barrier("raw_align")
            if hs.is_main():
                # stable qname sort == single-host emission order
                # (find_overlaps iterates query rids ascending)
                _merge_by_qname([st.path(f"raw.ovl.h{k}")
                                 for k in range(hs.n_hosts)]
                                ).save(st.path("raw.ovl"))
                st.mark()
            else:
                st.wait(hs)
        else:
            st.mark()
    raw_ovl = OvlBlock.load(st.path("raw.ovl"))
    log.info("raw_align: %d overlap records", len(raw_ovl))

    # ---- sort_align -----------------------------------------------------
    st = Stage(cfg.workdir, "02.sort_align")
    if multi and not hs.is_main():
        st.wait(hs)
    if st.done():
        sorted_blk = OvlBlock.load(st.path("sorted.ovl"))
        blacklist = {int(k): v for k, v in
                     json.load(open(st.path("bl.json"))).items()}
    else:
        with span("sort_align", records=len(raw_ovl)):
            if mesh is not None:
                from ..parallel.dist_sort import distributed_sort_filter
                res = distributed_sort_filter(
                    raw_ovl, seed_mask, lens, mesh,
                    max_bin_cov=cfg.sort_max_depth,
                    is_hq=cfg.read_type == "hifi")
            else:
                res = sort_filter_overlaps(
                    raw_ovl, seed_mask, lens,
                    max_bin_cov=cfg.sort_max_depth)
        sorted_blk, blacklist = res.block, res.blacklist
        log.info("sort_align: %d records, %d blacklisted seeds",
                 len(sorted_blk), len(blacklist))
        sorted_blk.save(st.path("sorted.ovl"))
        json.dump(blacklist, open(st.path("bl.json"), "w"))
        st.mark()

    # ---- seed_cns -------------------------------------------------------
    st = Stage(cfg.workdir, "03.seed_cns")
    if not st.done():
        part_p = st.path(f"cns.h{hs.host_id}" if multi else "cns")
        if mesh is not None and not os.path.exists(part_p + ".npz"):
            from ..parallel.dist_pipeline import mesh_correction
            with span("seed_cns", records=len(sorted_blk)):
                cns_part = retry("seed_cns(mesh)", lambda: mesh_correction(
                    store, sorted_blk, blacklist, mesh, **correct_kw(cfg)),
                    cfg.rerun)
            cns_part.save(part_p)
        if not os.path.exists(part_p + ".npz"):
            with span("seed_cns", records=len(sorted_blk)):
                cns_part = retry("seed_cns", lambda: run_correction(
                    store, sorted_blk, blacklist,
                    resume_path=st.path(
                        f"cns.progress.h{hs.host_id}.jsonl" if multi
                        else "cns.progress.jsonl"),
                    shard=(hs.n_hosts, hs.host_id) if multi else None,
                    device=dev, **correct_kw(cfg)), cfg.rerun)
            cns_part.save(part_p)
        if multi:
            hs.barrier("seed_cns")
            if hs.is_main():
                _merge_cns([st.path(f"cns.h{k}") for k in range(hs.n_hosts)]
                           ).save(st.path("cns"))
                st.mark()
            else:
                st.wait(hs)
        else:
            st.mark()
    cns_store = SeqStore.load(st.path("cns"))
    if hs.is_main() and not os.path.exists(st.path("cns.fasta")):
        write_fasta(st.path("cns.fasta"),
                    [(n, cns_store.get(i))
                     for i, n in enumerate(cns_store.names)])
    log.info("seed_cns: %d corrected reads, %d bases",
             len(cns_store), cns_store.total_bases)

    return cns_store


def correct_kw(cfg: Config) -> dict:
    """Stage 03's options, as run_correction and mesh_correction take
    them."""
    return dict(read_type=cfg.read_type_code, min_len_seed=cfg.min_len_seed,
                min_error_corrected_ratio=cfg.min_error_corrected_ratio,
                split=cfg.split_corrected, fast=cfg.fast_correct,
                min_len_aln=cfg.min_len_aln, min_cov_seed=cfg.min_cov_seed,
                max_cov_aln=cfg.max_cov_aln, min_cov=cfg.min_cov_base,
                max_lq_length=cfg.max_lq_length)


def _merge_by_qname(paths) -> OvlBlock:
    """Per-host OvlBlock parts in one block, stably sorted by qname: each
    query belongs to one host, so this is the single-host emission order."""
    merged = OvlBlock.concat_all([OvlBlock.load(p) for p in paths])
    return merged.take(np.argsort(np.asarray(merged.qname), kind="stable"))


def _merge_cns(paths) -> SeqStore:
    """Per-host corrected-read parts in one store, in the single-host order
    of the (seed, piece) names ("123", "123_2")."""
    seqs, names = [], []
    for p in paths:
        part = SeqStore.load(p)
        seqs.extend(part.get(i) for i in range(len(part)))
        names.extend(part.names)

    def key(n):
        a, _, b = n.partition("_")
        return (int(a), int(b) if b else 0)

    order = sorted(range(len(names)), key=lambda i: key(names[i]))
    return SeqStore.from_codes([seqs[i] for i in order],
                               names=[names[i] for i in order])


def _cns_align_multi(cfg: Config, dev, hs, st: Stage,
                     cns_store: SeqStore) -> None:
    """Stage 04 on several hosts: each runs the candidates, realignment and
    end extension of its share of the corrected reads (the device-heavy
    part); host 0 merges the parts and runs the global per-read filter."""
    from ..overlap.cns import (bl_info_for_graph, extend_overlap_ends,
                               filter_cns_overlaps, realign_overlaps)
    cns_rids = np.arange(len(cns_store))
    mine = cns_rids[hs.shard(len(cns_rids))]
    part_p = st.path(f"cns.realn.h{hs.host_id}")
    if not os.path.exists(part_p + ".npz"):
        # the same calls as cns_overlap_stage, on this host's queries
        with span("cns_align", reads=len(cns_store), queries=len(mine)):
            cidx = build_index(cns_store, cns_rids, k=cfg.cns_k, w=cfg.cns_w,
                               max_occ=64, device=dev)
            cand = find_overlaps(cns_store, mine, cidx, k=cfg.cns_k,
                                 w=cfg.cns_w, max_occ=16, min_cnt=3,
                                 min_span=cfg.cns_min_span,
                                 query_mask=np.ones(len(cns_store), bool),
                                 device=dev)
            cidx = None          # release the index's device memory
            part = realign_overlaps(cns_store, cand, device=dev)
            part = extend_overlap_ends(cns_store, part, device=dev)
        part.save(part_p)
    hs.barrier("cns_align")
    if not hs.is_main():
        st.wait(hs)
        return
    merged = _merge_by_qname([st.path(f"cns.realn.h{k}")
                              for k in range(hs.n_hosts)])
    kept, info = filter_cns_overlaps(merged, np.asarray(cns_store.length),
                                     maxhan1=cfg.maxhan1, maxhan2=cfg.maxhan2)
    kept.save(st.path("cns.filt.dovt.ovl"))
    json.dump(bl_info_for_graph(info), open(st.path("cnsbl.json"), "w"))
    np.savez(st.path("cnsinfo.npz"), st=info.st, touched=info.touched,
             alns=info.alns, lens=info.lens)
    st.mark()


def _mesh_cards(mesh):
    """Each CUDA card of the mesh: its peak device memory since the
    process's last reset and the kernels it launched, logged and recorded
    as the span `mesh/cards`."""
    import torch
    cards = {}
    for dev in dict.fromkeys(mesh.devices):
        if dev.type == "cuda":
            i = torch.cuda.current_device() if dev.index is None \
                else dev.index
            cards[str(i)] = dict(
                name=torch.cuda.get_device_name(i),
                peak_mib=torch.cuda.max_memory_allocated(i) / 2**20,
                launches=dict(_build.CARD_LAUNCHES.get(i, {})))
    if cards:
        log.info("mesh cards: %s", json.dumps(cards))
        get_tracer().add("mesh/cards", 0.0, cards=cards)


def _dump_trace(cfg, hs, mesh=None):
    """Span dump: <workdir>/trace.jsonl (trace.h<k>.jsonl per host of a
    multi-host run: each host holds its own tracer), after a mesh run's
    `mesh/cards` span, plus the summary table in the log."""
    if mesh is not None:
        _mesh_cards(mesh)
    tracer = get_tracer()
    if tracer.enabled:
        name = (f"trace.h{hs.host_id}.jsonl" if hs.n_hosts > 1
                else "trace.jsonl")
        tracer.dump_jsonl(os.path.join(cfg.workdir, name))
        log.info("profile:\n%s", tracer.summary())


def main(argv=None):
    import argparse

    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s")
    p = argparse.ArgumentParser(prog="python -m nextdenovo_tpu_torch run")
    p.add_argument("cfg", help="run.cfg")
    p.add_argument("--device", default=None,
                   help="torch device; default: the GPU (cuda). 'cpu' runs "
                        "the plain PyTorch versions of the kernels")
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    cfg = load_config(a.cfg)
    out = run_pipeline(cfg, device=a.device)
    if "stats" in out:
        print(json.dumps(out["stats"], default=int))
    return 0


if __name__ == "__main__":
    sys.exit(main())
