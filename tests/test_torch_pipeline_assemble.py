"""input_type = corrected, task = assemble (stages 00, 04-06) through the
port's run_pipeline on the CPU against the JAX package's run_pipeline with
its TPU path on the CPU (interpret=True), from the same reads.  Tolerance:
exact equality of the stage files and of nd.asm.fasta."""
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

GLEN = 20_000


@pytest.fixture(scope="module")
def corrected_runs(tmp_path_factory):
    """input_type = corrected, task = assemble: ~1 % error reads go
    straight to stage 04 and polish maps the same reads back.  The genome
    holds one duplicated 1.5 kb segment: reads that share only that copy
    keep unaligned tails on both sides, so stage 04 runs the affine-gap
    extender (on a repeat-free genome it has no tail pair to extend)."""
    d = tmp_path_factory.mktemp("pipe_asm")
    write_reads(d, GLEN, 51, repeat_len=1500, coverage=8, mean_len=3000,
           error_rate=0.01)
    out = {}
    for tag in ("j", "t"):
        p = write_correct_cfg(d, tag, GLEN, f"wd_{tag}", task="assemble",
                              extra=GRAPH_SMALL)
        text = open(p).read().replace("input_type = raw",
                                      "input_type = corrected")
        open(p, "w").write(text)
        out[tag] = p
    ref = jrun(jload(out["j"]), interpret=True)
    got = trun(tload(out["t"]), device="cpu")
    return d, ref, got


def test_corrected_input_assemble_equal(corrected_runs):
    d, ref, got = corrected_runs
    assert len(got["contigs"]) >= 1
    assert len(ref["contigs"]) == len(got["contigs"])
    for a, b in zip(ref["contigs"], got["contigs"]):
        assert np.array_equal(a, b)
    assert open(d / "wd_j" / "06.ctg_cns" / "nd.asm.fasta").read() == \
        open(d / "wd_t" / "06.ctg_cns" / "nd.asm.fasta").read()


@pytest.mark.parametrize("rel", [
    "04.cns_align/cns.filt.dovt.ovl.npz", "04.cns_align/cnsinfo.npz",
    "05.ctg_graph/draft.npz", "06.ctg_cns/map.npz", "06.ctg_cns/pieces.npz"])
def test_corrected_input_stage_arrays_equal(corrected_runs, rel):
    d = corrected_runs[0]
    assert_same_npz(str(d / "wd_j" / rel), str(d / "wd_t" / rel), rel)


def test_stage_04_ran_the_extender(corrected_runs):
    """Stage 04 handed tail pairs to the extender (the port records a span
    for each affine_extend call)."""
    d = corrected_runs[0]
    ext = [json.loads(l) for l in open(d / "wd_t" / "trace.jsonl")]
    ext = [e for e in ext if e["name"] == "kernel/affine_extend"]
    assert ext and ext[-1]["pairs"] > 0


def test_stages_01_03_skipped(corrected_runs):
    d = corrected_runs[0]
    for wd in ("wd_j", "wd_t"):
        assert not os.path.exists(d / wd / "01.raw_align")
        assert not os.path.exists(d / wd / "03.seed_cns")
        for st in ("00.db", "04.cns_align", "05.ctg_graph", "06.ctg_cns"):
            assert os.path.exists(d / wd / st / ".done")
