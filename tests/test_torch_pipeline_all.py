"""The second slice as a whole: task = all (stages 00-06) through the
port's run_pipeline on the CPU against the JAX package's run_pipeline with
its TPU path on the CPU (interpret=True), from the same reads.  Tolerance:
exact equality of every stage file through nd.asm.fasta; the same for the
port's two-host run (`launch --hosts 2`).  (input_type = corrected,
task = assemble: tests/test_torch_pipeline_assemble.py.)"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from nextdenovo_tpu.pipeline.config import load_config as jload
from nextdenovo_tpu.pipeline.run import run_pipeline as jrun
from nextdenovo_tpu_torch.pipeline.config import load_config as tload
from nextdenovo_tpu_torch.pipeline import run as trun_mod
from nextdenovo_tpu_torch.pipeline.run import run_pipeline as trun

from torch_port_util import (GRAPH_SMALL, assert_same_npz, write_correct_cfg,
                             write_reads)

GLEN = 20_000


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe_all")
    write_reads(d, GLEN, 11, coverage=20, mean_len=2000, error_rate=0.10)
    jcfg = write_correct_cfg(d, "j", GLEN, "wd_j", task="all",
                             extra=GRAPH_SMALL)
    tcfg = write_correct_cfg(d, "t", GLEN, "wd_t", task="all",
                             extra=GRAPH_SMALL)
    ref = jrun(jload(jcfg), interpret=True)
    got = trun(tload(tcfg), device="cpu")
    return d, tcfg, ref, got


@pytest.mark.parametrize("rel", [
    "04.cns_align/cns.filt.dovt.ovl.npz", "04.cns_align/cnsinfo.npz",
    "05.ctg_graph/draft.npz", "06.ctg_cns/map.npz", "06.ctg_cns/pieces.npz"])
def test_stage_arrays_equal(runs, rel):
    d = runs[0]
    assert_same_npz(str(d / "wd_j" / rel), str(d / "wd_t" / rel), rel)
    z = np.load(str(d / "wd_t" / rel), allow_pickle=True)
    assert all(len(z[k]) > 0 for k in z.files), rel       # nothing is empty


@pytest.mark.parametrize("rel", [
    "04.cns_align/cnsbl.json", "05.ctg_graph/node_qv.json"])
def test_stage_json_equal(runs, rel):
    d = runs[0]
    a = json.load(open(d / "wd_j" / rel))
    assert a and a == json.load(open(d / "wd_t" / rel))


@pytest.mark.parametrize("rel", [
    "05.ctg_graph/nd.asm.p.fasta", "05.ctg_graph/nd.asm.p.path",
    "05.ctg_graph/nd.asm.p.gfa", "05.ctg_graph/nd.asm.p.graphml",
    "06.ctg_cns/nd.asm.fasta", "06.ctg_cns/nd.asm.stat"])
def test_stage_text_files_identical(runs, rel):
    d = runs[0]
    a = open(d / "wd_j" / rel).read()
    assert a and a == open(d / "wd_t" / rel).read()


def test_returned_assembly_equal(runs):
    d, _, ref, got = runs
    assert len(got["contigs"]) >= 1
    assert len(got["contigs"][0]) > 0.6 * GLEN
    assert len(ref["contigs"]) == len(got["contigs"])
    for a, b in zip(ref["contigs"], got["contigs"]):
        assert np.array_equal(a, b)
    assert json.dumps(ref["stats"], default=int) == \
        json.dumps(got["stats"], default=int)
    assert np.array_equal(ref["cns"].words, got["cns"].words)
    assert got["fasta"].endswith(os.path.join("06.ctg_cns", "nd.asm.fasta"))


def test_same_spans_recorded(runs):
    """Both drivers record the stage spans cns_align, ctg_graph, ctg_align
    and ctg_cns in their trace dump."""
    d = runs[0]
    for wd in ("wd_j", "wd_t"):
        names = {json.loads(l)["name"]
                 for l in open(d / wd / "trace.jsonl")}
        assert {"cns_align", "ctg_graph", "ctg_align", "ctg_cns"} <= names, wd
    names = {json.loads(l)["name"] for l in open(d / "wd_t" / "trace.jsonl")}
    assert {"launches/04.cns_align", "launches/06.ctg_cns"} <= names


def test_done_markers_and_resume_04_06(runs, monkeypatch):
    d, tcfg, _, got = runs
    for st in ("04.cns_align", "05.ctg_graph", "06.ctg_cns"):
        assert os.path.exists(d / "wd_t" / st / ".done")

    # a finished run resumes from its markers: no stage body runs again
    def boom(*a, **k):
        raise AssertionError("stage re-ran despite its .done marker")
    from nextdenovo_tpu_torch.polish import driver as pdrv
    for name in ("build_index", "find_overlaps", "sort_filter_overlaps",
                 "run_correction", "cns_overlap_stage", "assemble"):
        monkeypatch.setattr(trun_mod, name, boom)
    for name in ("map_polish_reads", "polish_one"):
        monkeypatch.setattr(pdrv, name, boom)
    again = trun(tload(tcfg), device="cpu")
    assert all(np.array_equal(a, b)
               for a, b in zip(again["contigs"], got["contigs"]))
    # dropping stage 06's marker and pieces redoes the consensus only: the
    # mapping file and every earlier stage are reused
    monkeypatch.undo()
    fasta = open(d / "wd_t" / "06.ctg_cns" / "nd.asm.fasta").read()
    os.unlink(d / "wd_t" / "06.ctg_cns" / ".done")
    os.unlink(d / "wd_t" / "06.ctg_cns" / "pieces.npz")
    os.unlink(d / "wd_t" / "06.ctg_cns" / "nd.asm.fasta")
    for name in ("build_index", "find_overlaps", "sort_filter_overlaps",
                 "run_correction", "cns_overlap_stage", "assemble"):
        monkeypatch.setattr(trun_mod, name, boom)
    monkeypatch.setattr(pdrv, "map_polish_reads", boom)
    trun(tload(tcfg), device="cpu")
    assert open(d / "wd_t" / "06.ctg_cns" / "nd.asm.fasta").read() == fasta


def test_two_hosts_equal_single_host(runs):
    """`launch --hosts 2 --submit local --device cpu`: two host processes
    share a new workdir on the same reads.  Every merged stage file equals
    the JAX package's single-host file, and each host wrote its parts."""
    d = runs[0]
    cfg = write_correct_cfg(d, "m", GLEN, "wd_m", task="all",
                            extra=GRAPH_SMALL)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "nextdenovo_tpu_torch", "launch", cfg,
         "--hosts", "2", "--submit", "local", "--device", "cpu"],
        cwd=str(d), env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    ref, got = d / "wd_j", d / "wd_m"
    for rel in ("01.raw_align/raw.ovl.npz", "02.sort_align/sorted.ovl.npz",
                "03.seed_cns/cns.npz", "04.cns_align/cns.filt.dovt.ovl.npz",
                "04.cns_align/cnsinfo.npz", "05.ctg_graph/draft.npz"):
        assert_same_npz(str(ref / rel), str(got / rel), rel)
    for rel in ("02.sort_align/bl.json", "03.seed_cns/cns.fasta",
                "04.cns_align/cnsbl.json", "05.ctg_graph/node_qv.json",
                "05.ctg_graph/nd.asm.p.fasta", "05.ctg_graph/nd.asm.p.path",
                "05.ctg_graph/nd.asm.p.gfa", "05.ctg_graph/nd.asm.p.graphml",
                "06.ctg_cns/nd.asm.fasta", "06.ctg_cns/nd.asm.stat"):
        a = open(ref / rel, "rb").read()
        assert a and a == open(got / rel, "rb").read(), rel
    for k in (0, 1):
        for rel in (f"01.raw_align/raw.ovl.h{k}.npz",
                    f"03.seed_cns/cns.h{k}.npz",
                    f"04.cns_align/cns.realn.h{k}.npz",
                    f"06.ctg_cns/map.h{k}.npz",
                    f"06.ctg_cns/pieces.h{k}.npz"):
            assert (got / rel).exists(), rel
        rows = {json.loads(l)["name"]: json.loads(l)
                for l in open(got / f"trace.h{k}.jsonl")}
        assert {"launches/03.seed_cns", "launches/06.ctg_cns"} <= set(rows)
        assert rows["seed_cns"]["records"] > 0            # each host corrected
    # the two hosts split the seeds' correction between them
    n = [len(np.load(str(got / f"03.seed_cns/cns.h{k}.npz"))["length"])
         for k in (0, 1)]
    assert min(n) > 0 and sum(n) == len(np.load(
        str(ref / "03.seed_cns/cns.npz"))["length"])
