"""The mesh path as a whole: task = all with use_mesh = 8 through the port's
run_pipeline on the CPU (8 shards on one device; then again with the shards
in two device groups, mesh_devices=[cpu, cpu], one host thread a group)
against the JAX package's run_pipeline with use_mesh = 8 on its virtual
8-device CPU mesh (tests/conftest.py, interpret=True), from the same reads.
Tolerance: exact equality of every stage file, 01 through nd.asm.fasta;
bl.json byte for byte (its seeds come in shard order)."""
import json
import os

import numpy as np
import pytest
import torch

from nextdenovo_tpu.pipeline.config import load_config as jload
from nextdenovo_tpu.pipeline.run import run_pipeline as jrun
from nextdenovo_tpu_torch.pipeline.config import load_config as tload
from nextdenovo_tpu_torch.pipeline.run import run_pipeline as trun
from nextdenovo_tpu_torch.utils import get_tracer

from torch_port_util import (GRAPH_SMALL, assert_same_npz, write_correct_cfg,
                             write_reads)

GLEN = 20_000
MESH = "use_mesh = 8\n"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe_mesh")
    write_reads(d, GLEN, 11, coverage=20, mean_len=2000, error_rate=0.10)
    jcfg = write_correct_cfg(d, "j", GLEN, "wd_j", task="all",
                             extra=GRAPH_SMALL + MESH)
    tcfg = write_correct_cfg(d, "t", GLEN, "wd_t", task="all",
                             extra=GRAPH_SMALL + MESH)
    ref = jrun(jload(jcfg), interpret=True)
    got = trun(tload(tcfg), device="cpu")
    return d, ref, got


@pytest.fixture(scope="module")
def grouped(runs):
    """The port's run again in the same directory, its 8 shards in two
    device groups on the CPU."""
    d = runs[0]
    tcfg = write_correct_cfg(d, "g", GLEN, "wd_g", task="all",
                             extra=GRAPH_SMALL + MESH)
    cpu = torch.device("cpu")
    get_tracer().reset()        # its trace.jsonl then holds its own spans
    trun(tload(tcfg), device="cpu", mesh_devices=[cpu, cpu])
    return d


ARRAYS = ["01.raw_align/raw.ovl.npz", "02.sort_align/sorted.ovl.npz",
          "03.seed_cns/cns.npz", "04.cns_align/cns.filt.dovt.ovl.npz",
          "04.cns_align/cnsinfo.npz", "05.ctg_graph/draft.npz",
          "06.ctg_cns/map.npz", "06.ctg_cns/pieces.npz"]
FILES = ["02.sort_align/bl.json", "03.seed_cns/cns.fasta",
         "04.cns_align/cnsbl.json", "05.ctg_graph/node_qv.json",
         "05.ctg_graph/nd.asm.p.fasta", "05.ctg_graph/nd.asm.p.path",
         "05.ctg_graph/nd.asm.p.gfa", "05.ctg_graph/nd.asm.p.graphml",
         "06.ctg_cns/nd.asm.fasta", "06.ctg_cns/nd.asm.stat"]


@pytest.mark.parametrize("rel", ARRAYS)
def test_stage_arrays_equal(runs, rel):
    d = runs[0]
    assert_same_npz(str(d / "wd_j" / rel), str(d / "wd_t" / rel), rel)
    z = np.load(str(d / "wd_t" / rel), allow_pickle=True)
    assert all(len(z[k]) > 0 for k in z.files), rel       # nothing is empty


@pytest.mark.parametrize("rel", FILES)
def test_stage_files_identical(runs, rel):
    d = runs[0]
    a = open(d / "wd_j" / rel, "rb").read()
    assert a and a == open(d / "wd_t" / rel, "rb").read()


@pytest.mark.parametrize("rel", ARRAYS)
def test_grouped_stage_arrays_equal(grouped, rel):
    assert_same_npz(str(grouped / "wd_j" / rel), str(grouped / "wd_g" / rel),
                    rel)


@pytest.mark.parametrize("rel", FILES)
def test_grouped_stage_files_identical(grouped, rel):
    a = open(grouped / "wd_j" / rel, "rb").read()
    assert a and a == open(grouped / "wd_g" / rel, "rb").read()


def test_grouped_spans_on_two_groups(grouped):
    """The grouped run's phases ran on both groups: each mesh phase's
    per-group spans name groups 0 and 1 and lie inside one of the phase's
    own spans."""
    rows = [json.loads(l) for l in open(grouped / "wd_g" / "trace.jsonl")]
    for phase in ("mesh/sketch_route", "mesh/lookup_route", "mesh/vote_emit",
                  "mesh/sort_route", "mesh/sort", "mesh/sort_filter",
                  "mesh/band_align"):
        outer = [r for r in rows if r["name"] == phase]
        inner = [r for r in rows if r["name"] == phase + "/card"]
        assert outer and all(r["cards"] == 2 for r in outer), phase
        assert {r["card"] for r in inner} == {"0:cpu", "1:cpu"}, phase
        assert len(inner) == 2 * len(outer), phase
        for r in inner:
            assert any(o["t0"] - 1e-3 <= r["t0"] and r["t0"] + r["wall"]
                       <= o["t0"] + o["wall"] + 1e-3 for o in outer), phase


def test_blacklist_in_shard_order(runs):
    """bl.json lists the blacklisted seeds shard by shard (seed % 8), as the
    JAX package's mesh sort fills it, not in ascending order."""
    d = runs[0]
    seeds = [int(k) for k in
             json.load(open(d / "wd_t" / "02.sort_align" / "bl.json"))]
    assert len(seeds) > 1
    assert [s % 8 for s in seeds] == sorted(s % 8 for s in seeds)


def test_returned_assembly_equal(runs):
    d, ref, got = runs
    assert len(got["contigs"]) >= 1
    assert len(got["contigs"][0]) > 0.6 * GLEN
    assert len(ref["contigs"]) == len(got["contigs"])
    for a, b in zip(ref["contigs"], got["contigs"]):
        assert np.array_equal(a, b)
    assert np.array_equal(ref["cns"].words, got["cns"].words)


def test_mesh_spans_recorded(runs):
    """The port's mesh stages ran: their spans are in the trace dump, and
    every stage left its .done marker."""
    d = runs[0]
    for st in ("00.db", "01.raw_align", "02.sort_align", "03.seed_cns",
               "04.cns_align", "05.ctg_graph", "06.ctg_cns"):
        assert os.path.exists(d / "wd_t" / st / ".done"), st
    names = {json.loads(l)["name"] for l in open(d / "wd_t" / "trace.jsonl")}
    assert {"mesh/sketch_route", "mesh/lookup_route", "mesh/vote_emit",
            "mesh/align_group", "mesh/consensus_wait"} <= names
