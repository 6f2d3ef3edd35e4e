"""Seed correction and contig polish of the mesh path
(nextdenovo_tpu_torch/parallel/dist_correct.py, dist_polish.py) with the 8
shards spread over k in {2, 4} device groups on the CPU (`devices=[cpu] *
k`, one host thread a group), against the JAX package's n = 8 mesh
functions on the virtual 8-device CPU mesh (tests/conftest.py), on the same
numpy inputs.  The inputs are small: on the CPU every group's aligner call
costs the plain aligner a step a column, and the groups' threads contend
for the interpreter.  Tolerance: exact equality."""
import numpy as np
import pytest
import torch

from nextdenovo_tpu.io.seqstore import SeqStore as JStore
from nextdenovo_tpu.io.simulate import (mutate_read, simulate_genome,
                                        simulate_reads)
from nextdenovo_tpu.parallel import dist_correct as jdc
from nextdenovo_tpu.parallel import dist_polish as jdp
from nextdenovo_tpu.parallel import mesh as jm
from nextdenovo_tpu.polish.driver import map_polish_reads as jmap
from nextdenovo_tpu_torch.io.seqstore import SeqStore as TStore
from nextdenovo_tpu_torch.overlap.engine import build_index, find_overlaps
from nextdenovo_tpu_torch.overlap.records import OvlBlock
from nextdenovo_tpu_torch.overlap.sort import sort_filter_overlaps
from nextdenovo_tpu_torch.parallel import dist_correct as tdc
from nextdenovo_tpu_torch.parallel import dist_polish as tdp
from nextdenovo_tpu_torch.parallel import mesh as tm

# one intra-op thread, as in every port test
import torch_port_util  # noqa: F401

GROUPS = (2, 4)
CORRECT_KW = dict(min_len_seed=1500, min_cov_seed=1, min_len_aln=300,
                  min_cov=2)


def _tmesh(k):
    return tm.make_mesh(8, devices=[torch.device("cpu")] * k)


@pytest.fixture(scope="module")
def jmesh():
    return jm.make_mesh(8)


@pytest.fixture(scope="module")
def one_seed(jmesh):
    """tests/test_torch_mesh.py's correction workload (a 12 kb genome at 8x
    of 2.5 kb reads) cut to the records of seed 8, whose longest pair is
    the shortest of the five jobs (12 supports of up to 2270 bases), and the
    JAX package's n = 8 correction of it."""
    g = simulate_genome(12_000, seed=61)
    sim = simulate_reads(g, coverage=8, mean_len=2500, error_rate=0.08,
                         seed=62, min_len=1500)
    store = TStore.from_codes(sim.reads)
    lens = np.asarray(store.length, np.int64)
    rids = np.arange(len(store))
    idx = build_index(store, rids, k=15, w=5, max_occ=64, device="cpu")
    raw = find_overlaps(store, rids, idx, k=15, w=5, max_occ=16, min_cnt=4,
                        min_span=500, top_k=1, device="cpu")
    srt = sort_filter_overlaps(raw, lens >= 2500, lens)
    sub = srt.block.take(np.nonzero(np.asarray(srt.block.qname) == 8)[0])
    ref = jdc.distributed_correct(JStore.from_codes(sim.reads), sub,
                                  srt.blacklist, jmesh, 8, **CORRECT_KW)
    return store, sub, srt.blacklist, ref


@pytest.mark.parametrize("k", GROUPS)
def test_correct_groups(one_seed, k):
    """The JAX package's {seed: (len, ide, seq)}."""
    store, sub, bl, ref = one_seed
    got = tdc.distributed_correct(store, sub, bl, _tmesh(k), **CORRECT_KW)
    assert list(ref) == [8] and got[8][0] > 1000
    assert list(ref.items()) == list(got.items())


@pytest.fixture(scope="module")
def short_draft(jmesh):
    """tests/test_torch_mesh.py's polish workload (an 8 kb genome at 12x,
    a draft at 2 % error) cut to the draft's first 1.5 kb (one window), the
    reads the JAX package maps to it, and its n = 8 polish."""
    g = simulate_genome(8_000, seed=91)
    sim = simulate_reads(g, coverage=12, mean_len=3000, error_rate=0.06,
                         seed=92, min_len=1500)
    draft = [mutate_read(g, 0.02, np.random.default_rng(93))[:1500]]
    js = JStore.from_codes(sim.reads)
    ovl = jmap(draft, js)
    ref = jdp.distributed_polish(draft, js, jmesh, 8, ovl=ovl, split=False,
                                 window=4000)
    return sim.reads, draft, ovl, ref


@pytest.mark.parametrize("k", GROUPS)
def test_polish_groups(short_draft, k):
    """The JAX package's polished pieces."""
    reads, draft, ovl, ref = short_draft
    got = tdp.distributed_polish(
        draft, TStore.from_codes(reads), _tmesh(k),
        ovl=OvlBlock({f: np.asarray(v) for f, v in ovl.data.items()}),
        split=False, window=4000)
    assert len(ovl) > 5 and len(got) == len(ref)
    assert sum(len(p) for p in got) > 1_200
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
