"""Stage 04 of the port (nextdenovo_tpu_torch/overlap/cns.py on the CPU)
against the JAX package's stage with its TPU path on the CPU
(interpret=True): one simulated corrected-read store goes to both sides
through convert.py.  Tolerance: exact equality of every OvlBlock field, the
`bl` dict and the four CnsInfo arrays."""
import numpy as np
import pytest

from nextdenovo_tpu.io.seqstore import SeqStore as JStore
from nextdenovo_tpu.io.simulate import simulate_genome, simulate_reads
from nextdenovo_tpu.overlap import cns as jc
from nextdenovo_tpu.overlap import engine as jeng
from nextdenovo_tpu.overlap.records import OvlBlock as JBlock
from nextdenovo_tpu_torch import convert
from nextdenovo_tpu_torch.overlap import cns as tc

FIELDS = ("qname", "rev", "qs", "qe", "tname", "ts", "te", "match", "ide")
K, W, MIN_SPAN = 17, 17, 300


def _cols(blk):
    return {k: np.asarray(blk.data[k]) for k in FIELDS if k in blk.data}


def _same_block(ref, got):
    assert len(ref) == len(got)
    a, b = _cols(ref), _cols(got)
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def _to_port(blk):
    return convert.ovlblock_from_arrays(_cols(blk))


def _same_info(ref, got):
    for k in ("st", "touched", "alns", "lens"):
        x, y = np.asarray(getattr(ref, k)), np.asarray(getattr(got, k))
        assert x.shape == y.shape and np.array_equal(x, y), k


@pytest.fixture(scope="module")
def world():
    """~1 % error reads of ~3 kb from both strands of a 15 kb genome, the
    candidates of the JAX engine, and their realignment on both sides."""
    g = simulate_genome(15_000, seed=31)
    sim = simulate_reads(g, coverage=7, mean_len=3000, error_rate=0.01,
                         seed=32)
    assert 0 < int(np.sum(sim.strand)) < len(sim.reads)     # both strands
    js = JStore.from_codes(sim.reads)
    ts = convert.seqstore_from_arrays(js.words, js.word_start, js.length,
                                      js.names)
    rids = np.arange(len(js))
    idx = jeng.build_index(js, rids, k=K, w=W, max_occ=64)
    cand = jeng.find_overlaps(js, rids, idx, k=K, w=W, max_occ=16, min_cnt=3,
                              min_span=MIN_SPAN,
                              query_mask=np.ones(len(js), bool))
    assert len(cand) > 20
    ref = jc.realign_overlaps(js, cand, interpret=True)
    got = tc.realign_overlaps(ts, _to_port(cand), device="cpu")
    return js, ts, cand, ref, got


def test_realign_overlaps_equal(world):
    js, ts, cand, ref, got = world
    assert len(ref) > 20
    _same_block(ref, got)


def test_realign_batch_size_changes_nothing(world):
    """`batch` fixes which pairs share a band_align call; per-pair results
    do not depend on it."""
    js, ts, cand, ref, got = world
    small = tc.realign_overlaps(ts, _to_port(cand), batch=len(cand) // 3 + 1,
                                device="cpu")
    _same_block(got, small)


def _pulled_in(blk, by=300):
    """The block with every long overlap cut back by `by` bases at both
    ends, so that both reads keep an unaligned hang on each side."""
    c = {k: v.copy() for k, v in _cols(blk).items()}
    long_ = (c["qe"] - c["qs"] > 4 * by) & (c["te"] - c["ts"] > 4 * by)
    for k, sign in (("qs", 1), ("qe", -1), ("ts", 1), ("te", -1)):
        c[k] = np.where(long_, c[k] + sign * by, c[k])
    return c


def test_extend_overlap_ends_equal(world):
    js, ts, cand, ref, got = world
    cut = _pulled_in(ref)
    jin = JBlock.from_arrays(**cut)
    tin = convert.ovlblock_from_arrays(cut)
    jout = jc.extend_overlap_ends(js, jin, interpret=True)
    tout = tc.extend_overlap_ends(ts, tin, device="cpu")
    _same_block(jout, tout)
    # at least one record extended on each side and on each strand
    o = _cols(tout)
    for rev in (0, 1):
        on = cut["rev"] == rev
        assert np.any(on & (o["qe"] > cut["qe"])), ("right", rev)
        assert np.any(on & (o["qs"] < cut["qs"])), ("left", rev)
    assert np.all(o["match"] >= cut["match"])
    # nothing to extend: the block comes back as it is
    none = tc.extend_overlap_ends(ts, tin, min_hang=10**6, device="cpu")
    _same_block(tin, none)


def test_filter_and_bl_info_equal(world):
    js, ts, cand, ref, got = world
    jk, jinfo = jc.filter_cns_overlaps(ref, np.asarray(js.length))
    tk, tinfo = tc.filter_cns_overlaps(got, np.asarray(ts.length))
    assert len(tk) > 0
    _same_block(jk, tk)
    _same_info(jinfo, tinfo)
    jbl, tbl = jc.bl_info_for_graph(jinfo), tc.bl_info_for_graph(tinfo)
    assert len(tbl) > 0 and jbl == tbl
    # the info carried across as arrays gives the same dict again
    again = convert.cnsinfo_from_arrays(jinfo.st, jinfo.touched, jinfo.alns,
                                        jinfo.lens)
    assert tc.bl_info_for_graph(again) == jbl


def test_cns_overlap_stage_equal(world):
    """The port's whole stage against the JAX package's.  The JAX side is
    put together from the steps cns_overlap_stage runs, on the candidates
    and the realignment the fixture already holds (the JAX package's own
    cns_overlap_stage would only compute them a second time; both whole
    stages run inside run_pipeline in tests/test_torch_pipeline_*.py)."""
    js, ts, cand, ref, got = world
    rids = np.arange(len(js))
    jk, jinfo = jc.filter_cns_overlaps(
        jc.extend_overlap_ends(js, ref, interpret=True),
        np.asarray(js.length))
    jbl = jc.bl_info_for_graph(jinfo)
    tk, tbl, tinfo = tc.cns_overlap_stage(
        ts, rids, k=K, w=W, min_span=MIN_SPAN, device="cpu",
        return_info=True)
    assert len(tk) > 0 and len(tbl) > 0
    _same_block(jk, tk)
    assert jbl == tbl
    _same_info(jinfo, tinfo)
    pair = tc.cns_overlap_stage(ts, rids, k=K, w=W, min_span=MIN_SPAN,
                                device="cpu")
    assert len(pair) == 2 and pair[1] == tbl


def test_realign_chunks_partition():
    for lq, lt in ((100, 90), (12288, 12000), (12289, 30000), (50000, 47000)):
        ch = tc._realign_chunks(lq, lt)
        assert ch == jc._realign_chunks(lq, lt)
        assert ch[0][0] == 0 and ch[0][2] == 0
        assert ch[-1][1] == lq and ch[-1][3] == lt
        assert max(b - a for a, b, _, _ in ch) <= tc.REALN_CORE + 1
