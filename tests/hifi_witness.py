#!/usr/bin/env python3
"""Why corrected HiFi reads can be much shorter than their seeds: one seed's
correction, re-run by the port on the card and by the JAX package (the
reference) on the CPU on the same supports.

    python3 tests/hifi_witness.py card [out.npz]
        On a CUDA card, port only (imports nothing of JAX): runs the
        chip_smoke.py hifi_path input (1 Mb genome, 30x of 15 kb reads at
        0.4 %) through `task = correct`, takes the corrected read that kept
        the least of its seed among chip_smoke's 200-read identity sample,
        rebuilds that seed's job from the run's sorted overlaps and corrects
        it again on the card with the HiFi consensus (read-type code 3) and
        the ONT one (code 1).  Fails unless code 3 gives stage 03's read.
        Writes the seed, its supports and the card's results to out.npz
        (default chiprun_out/hifi_witness.npz).

    JAX_PLATFORMS=cpu python3 tests/hifi_witness.py reference [in.npz]
        On the CPU: corrects the same job with the JAX package's
        correct_seeds (interpret=True, its TPU path) and the port's
        (device="cpu") for codes 3 and 1, prints the lengths and fails
        unless both equal the card's, base for base.

The job is rebuilt in a store whose read ids are those of the run, since
the correction's chunking staggers on the support's id.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODES = (3, 1)          # the HiFi consensus, then the ONT one
KW = ("min_len_aln", "max_cov_aln", "min_cov", "max_lq_length",
      "min_error_corrected_ratio")


def card(out_path):
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from nextdenovo_tpu_torch.__main__ import main as cli_main
    from nextdenovo_tpu_torch.correct.driver import (correct_seeds,
                                                     iter_seed_jobs)
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    from nextdenovo_tpu_torch.io.simulate import simulate_genome, simulate_reads
    from nextdenovo_tpu_torch.overlap.records import OvlBlock
    from nextdenovo_tpu_torch.pipeline.config import load_config

    if not torch.cuda.is_available():
        print("hifi_witness: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.phase_build()
    workdir = tempfile.mkdtemp(prefix="hifi_witness_")
    g_size = cs.HIFI_GENOME_SIZE
    genome = simulate_genome(g_size, seed=3)
    sim = simulate_reads(genome, coverage=cs.HIFI_COVERAGE,
                         mean_len=cs.HIFI_MEAN_LEN,
                         error_rate=cs.HIFI_ERROR_RATE, seed=4, min_len=4000)
    cfg_p = cs._write_run(
        workdir, sim.reads,
        "[General]\ntask = correct\ninput_type = raw\n"
        "read_type = hifi\ninput_fofn = input.fofn\nworkdir = wd\n"
        f"[correct_option]\ngenome_size = {g_size}\n")
    t0 = time.time()
    if cli_main(["run", cfg_p]) != 0:
        raise RuntimeError("task = correct failed")
    cs.log(f"[witness] task = correct in {time.time() - t0:.1f}s")
    wd = os.path.join(workdir, "wd")
    cns = SeqStore.load(os.path.join(wd, "03.seed_cns", "cns"))
    _, kept, seeds = cs._check_identity("witness", dev, wd, cns, sim, genome,
                                        0.98, window=cs._anchor)
    seed = int(seeds[int(np.argmin(kept))])
    stage03 = cns.get([int(n) for n in cns.names].index(seed))

    cfg = load_config(cfg_p)
    meta = json.load(open(os.path.join(wd, "00.db", "meta.json")))
    cfg.seed_cutoff = meta["seed_cutoff"]
    reads = SeqStore.load(os.path.join(wd, "00.db", "reads"))
    blk = OvlBlock.load(os.path.join(wd, "02.sort_align", "sorted.ovl"))
    bl = {int(k): v for k, v in json.load(open(os.path.join(
        wd, "02.sort_align", "bl.json"))).items()}
    (job,) = [j for j in iter_seed_jobs(
        blk, bl, np.asarray(reads.length), min_len_seed=cfg.min_len_seed,
        min_len_aln=cfg.min_len_aln, min_cov_seed=cfg.min_cov_seed,
        max_cov_aln=cfg.max_cov_aln) if j.seed == seed]
    kw = dict(min_len_aln=cfg.min_len_aln, max_cov_aln=cfg.max_cov_aln,
              min_cov=cfg.min_cov_base, max_lq_length=cfg.max_lq_length,
              min_error_corrected_ratio=cfg.min_error_corrected_ratio)
    out = {}
    for code in CODES:
        ((_, ln, ide, seq),) = correct_seeds(reads, [job], read_type=code,
                                             device=dev, **kw)
        out[code] = (ln, ide, seq)
        cs.log(f"[witness] seed {seed} ({job.seed_len} bases, "
               f"{len(job.sups)} supports), code {code} on the card: {ln} "
               f"bases, identity {ide:.4f}")
    if out[3][0] != len(stage03):
        raise RuntimeError(f"code 3 gave {out[3][0]} bases, stage 03 wrote "
                           f"{len(stage03)}")

    ids = sorted({seed} | {int(s[0]) for s in job.sups})
    seqs = [reads.get(i).astype(np.uint8) for i in ids]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(
        out_path, seed=seed, seed_len=job.seed_len,
        sups=np.array(job.sups, np.int64), ids=np.array(ids, np.int64),
        lens=np.array([len(x) for x in seqs], np.int64),
        codes=np.concatenate(seqs), stage03=stage03.astype(np.uint8),
        kw=json.dumps(kw),
        card=json.dumps({c: [int(v[0]), float(v[1]), v[2]]
                         for c, v in out.items()}))
    cs.log(f"[witness] wrote {out_path} ({os.path.getsize(out_path)} bytes)")
    return 0


def _job_inputs(z):
    """(codes of every read id up to the largest used, the job's fields);
    ids the job does not use hold one base, as they are never read."""
    ids, lens = z["ids"], z["lens"]
    offs = np.concatenate([[0], np.cumsum(lens)])
    reads = [np.zeros(1, np.uint8) for _ in range(int(ids.max()) + 1)]
    for i, a, b in zip(ids, offs[:-1], offs[1:]):
        reads[int(i)] = z["codes"][a:b]
    sups = [tuple(int(v) for v in s) for s in z["sups"]]
    return reads, int(z["seed"]), int(z["seed_len"]), sups


def reference(in_path):
    from nextdenovo_tpu.correct import driver as jd
    from nextdenovo_tpu.io.seqstore import SeqStore as JStore
    from nextdenovo_tpu_torch import convert
    from nextdenovo_tpu_torch.correct import driver as td

    z = np.load(in_path)
    reads, seed, seed_len, sups = _job_inputs(z)
    kw = json.loads(str(z["kw"]))
    card_res = {int(c): v for c, v in json.loads(str(z["card"])).items()}
    js = JStore.from_codes(reads)
    ts = convert.seqstore_from_arrays(js.words, js.word_start, js.length,
                                      js.names)
    print(f"seed {seed}: {seed_len} bases, {len(sups)} supports; stage 03 "
          f"on the card wrote {len(z['stage03'])} bases")
    ok = True
    for code in CODES:
        res = {}
        t0 = time.time()
        ((_, *res["jax"]),) = jd.correct_seeds(
            js, [jd.SeedJob(seed, seed_len, sups)], read_type=code,
            interpret=True, **kw)
        t1 = time.time()
        ((_, *res["port"]),) = td.correct_seeds(
            ts, [td.SeedJob(seed, seed_len, sups)], read_type=code,
            device="cpu", **kw)
        t2 = time.time()
        ln_c, _, seq_c = card_res[code]
        for who, (ln, ide, seq) in res.items():
            same = ln == ln_c and seq == seq_c
            ok &= same
            print(f"code {code}: {who} {ln} bases, identity {ide:.4f}, "
                  f"{'equal to' if same else 'DIFFERS from'} the card's "
                  f"{ln_c}")
        print(f"code {code}: JAX interpret {t1 - t0:.1f}s, port on the CPU "
              f"{t2 - t1:.1f}s")
    return 0 if ok else 1


def main(argv):
    mode = argv[1] if len(argv) > 1 else ""
    path = argv[2] if len(argv) > 2 else os.path.join(
        ROOT, "chiprun_out", "hifi_witness.npz")
    if mode == "card":
        return card(path)
    if mode == "reference":
        return reference(path)
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv))
