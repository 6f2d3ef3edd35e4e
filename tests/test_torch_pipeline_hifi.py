"""read_type = hifi as a whole: task = all (stages 00-06) through the port's
run_pipeline on the CPU against the JAX package's run_pipeline with its TPU
path on the CPU (interpret=True), from the same reads.  Tolerance: exact
equality of every stage file through nd.asm.fasta.

HiFi changes, against the ONT run of tests/test_torch_pipeline_all.py: the
raw overlaps of stage 01 come from the k = 51, w = 51 long-kmer sketch, the
consensus of stage 03 takes the kmer/phasing path (read-type code 3), and
max_lq_length drops to 1000.  The size (16 kb genome, 12x of ~3 kb reads at
0.5 % error) is the smallest of those tried that still gives a contig; the
JAX side takes most of the file's time (its Myers tier compiles per shape).
"""
import json
import os

import numpy as np
import pytest

from nextdenovo_tpu.pipeline.config import load_config as jload
from nextdenovo_tpu.pipeline.run import run_pipeline as jrun
from nextdenovo_tpu_torch.pipeline.config import load_config as tload
from nextdenovo_tpu_torch.pipeline.run import run_pipeline as trun

from torch_port_util import (GRAPH_SMALL, assert_same_npz, write_correct_cfg,
                             write_reads)

GLEN = 16_000


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe_hifi")
    write_reads(d, GLEN, 11, coverage=12, mean_len=3000, error_rate=0.005)
    cfgs = {}
    for name in ("j", "t"):
        cfgs[name] = write_correct_cfg(d, name, GLEN, f"wd_{name}",
                                       task="all", extra=GRAPH_SMALL,
                                       read_type="hifi")
    jcfg, tcfg = jload(cfgs["j"]), tload(cfgs["t"])
    ref = jrun(jcfg, interpret=True)
    got = trun(tcfg, device="cpu")
    return d, (jcfg, tcfg), ref, got


def test_hifi_presets_derived(runs):
    _, cfgs, _, _ = runs
    for cfg in cfgs:
        assert cfg.read_type_code == 3
        assert cfg.raw_k == cfg.raw_w == 51
        assert cfg.max_lq_length == 1000


@pytest.mark.parametrize("rel", [
    "00.db/reads.npz",
    "01.raw_align/raw.ovl.npz", "02.sort_align/sorted.ovl.npz",
    "03.seed_cns/cns.npz",
    "04.cns_align/cns.filt.dovt.ovl.npz", "04.cns_align/cnsinfo.npz",
    "05.ctg_graph/draft.npz", "06.ctg_cns/map.npz", "06.ctg_cns/pieces.npz"])
def test_stage_arrays_equal(runs, rel):
    d = runs[0]
    assert_same_npz(str(d / "wd_j" / rel), str(d / "wd_t" / rel), rel)
    z = np.load(str(d / "wd_t" / rel), allow_pickle=True)
    assert all(len(z[k]) > 0 for k in z.files), rel       # nothing is empty


@pytest.mark.parametrize("rel", [
    "00.db/meta.json", "02.sort_align/bl.json", "04.cns_align/cnsbl.json",
    "05.ctg_graph/node_qv.json"])
def test_stage_json_equal(runs, rel):
    d = runs[0]
    a = json.load(open(d / "wd_j" / rel))
    assert a and a == json.load(open(d / "wd_t" / rel))


@pytest.mark.parametrize("rel", [
    "03.seed_cns/cns.fasta",
    "05.ctg_graph/nd.asm.p.fasta", "05.ctg_graph/nd.asm.p.path",
    "05.ctg_graph/nd.asm.p.gfa", "05.ctg_graph/nd.asm.p.graphml",
    "06.ctg_cns/nd.asm.fasta", "06.ctg_cns/nd.asm.stat"])
def test_stage_text_files_identical(runs, rel):
    d = runs[0]
    a = open(d / "wd_j" / rel).read()
    assert a and a == open(d / "wd_t" / rel).read()


def test_returned_assembly_equal(runs):
    d, _, ref, got = runs
    assert len(got["cns"]) > 0
    assert np.array_equal(ref["cns"].words, got["cns"].words)
    assert len(got["contigs"]) >= 1
    assert len(got["contigs"][0]) > 0.6 * GLEN
    assert len(ref["contigs"]) == len(got["contigs"])
    for a, b in zip(ref["contigs"], got["contigs"]):
        assert np.array_equal(a, b)
    assert json.dumps(ref["stats"], default=int) == \
        json.dumps(got["stats"], default=int)
    for st in ("00.db", "01.raw_align", "02.sort_align", "03.seed_cns",
               "04.cns_align", "05.ctg_graph", "06.ctg_cns"):
        assert os.path.exists(d / "wd_t" / st / ".done"), st
