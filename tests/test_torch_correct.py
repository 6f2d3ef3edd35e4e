"""The port's seed-correction driver (nextdenovo_tpu_torch/correct/
driver.py, aligner on the CPU's plain versions) against the JAX package's
TPU path run on the CPU (Myers + Pallas interpret), from the same store,
sorted block and blacklist.  Tolerance: byte-identical corrected reads."""
import numpy as np
import pytest

from nextdenovo_tpu.correct import driver as jd
from nextdenovo_tpu.io.seqstore import SeqStore as JStore
from nextdenovo_tpu.io.simulate import simulate_genome, simulate_reads
from nextdenovo_tpu.overlap.records import OvlBlock as JBlock
from nextdenovo_tpu_torch import convert
from nextdenovo_tpu_torch.correct import driver as td
from nextdenovo_tpu_torch.overlap import engine as te
from nextdenovo_tpu_torch.overlap.sort import sort_filter_overlaps


@pytest.fixture(scope="module")
def world():
    """Stages 00-02 once (with the port, on the CPU); both packages then
    correct from the same sorted block."""
    g = simulate_genome(10_000, seed=21)
    sim = simulate_reads(g, coverage=28, mean_len=2000, error_rate=0.10,
                         seed=22)
    js = JStore.from_codes(sim.reads)
    ts = convert.seqstore_from_arrays(js.words, js.word_start, js.length,
                                      js.names)
    rids = np.arange(len(ts))
    lens = np.asarray(ts.length)
    seed_mask = lens >= 1500
    idx = te.build_index(ts, rids, k=15, w=5, max_occ=64, device="cpu")
    raw = te.find_overlaps(ts, rids[seed_mask], idx, k=15, w=5, max_occ=16,
                           min_cnt=4, min_span=500, top_k=4,
                           query_mask=seed_mask, device="cpu")
    res = sort_filter_overlaps(raw, seed_mask, lens, max_bin_cov=26)
    return js, ts, res.block, res.blacklist, lens


KW = dict(min_len_seed=1000, min_len_aln=500, min_cov_seed=10,
          max_cov_aln=130)


def test_iter_seed_jobs_equal(world):
    js, ts, blk, bl, lens = world
    jblk = JBlock({k: v for k, v in blk.data.items()})
    ref = list(jd.iter_seed_jobs(jblk, bl, lens, **KW))
    got = list(td.iter_seed_jobs(blk, bl, lens, **KW))
    assert len(ref) == len(got) > 0
    for a, b in zip(ref, got):
        assert (a.seed, a.seed_len, a.sups) == (b.seed, b.seed_len, b.sups)


@pytest.mark.parametrize("t", [0, 3])
def test_chunk_sup_pairs_equal(t):
    sup = np.zeros(30_000, np.uint8)
    assert jd._chunk_sup_pairs(sup, 100, 29_000, t) == \
        td._chunk_sup_pairs(sup, 100, 29_000, t)
    assert jd._chunk_sup_pairs(sup[:900], 5, 800, t) == \
        td._chunk_sup_pairs(sup[:900], 5, 800, t)


@pytest.fixture(scope="module")
def jax_align_memo():
    """The JAX package's band_align results by call: (hq, interpret and
    every pair's bytes) -> results.  Its Myers tier takes ~100 s on the CPU
    for this world; a repeated call with the same arguments (codes 1 and 2
    make the same one) is served from here, code 3 (hq=True) runs its own."""
    return {}


@pytest.mark.parametrize("read_type", [1, 2, 3])
def test_run_correction_store_identical(world, read_type, jax_align_memo,
                                        monkeypatch):
    """Read-type codes 1 (ONT), 2 (CLR) and 3 (HiFi: the kmer/phasing
    consensus, and hq=True to the aligner)."""
    from nextdenovo_tpu.ops import align as jalign
    band_align = jalign.band_align

    def memo_band_align(qs, ts_, interpret=False, hq=False):
        key = (hq, interpret, tuple(q.tobytes() for q in qs),
               tuple(t.tobytes() for t in ts_))
        if key not in jax_align_memo:
            jax_align_memo[key] = band_align(qs, ts_, interpret=interpret,
                                             hq=hq)
        return jax_align_memo[key]
    monkeypatch.setattr(jalign, "band_align", memo_band_align)
    js, ts, blk, bl, lens = world
    jblk = JBlock({k: v for k, v in blk.data.items()})
    ref = jd.run_correction(js, jblk, bl, read_type=read_type,
                            interpret=True, **KW)
    monkeypatch.undo()
    got = td.run_correction(ts, blk, bl, read_type=read_type, device="cpu",
                            **KW)
    assert len(got) > 0
    assert ref.names == got.names
    assert np.array_equal(ref.length, got.length)
    assert np.array_equal(ref.words, got.words)


def _hifi_consensus_inputs(case):
    """The inputs of tests/test_hifi_consensus.py: supports of a 3 kb truth
    at 0.4 % error, or of two alleles of a 2 kb truth that differ at one
    SNP, each aligned against the seed by the JAX package's native hq
    aligner."""
    from test_hifi_consensus import _mk_supports
    from nextdenovo_tpu.io.simulate import mutate_read
    if case == "truth":
        rng = np.random.default_rng(21)
        truth = rng.integers(0, 4, 3000).astype(np.uint8)
        seed = mutate_read(truth, 0.004, rng)
        return (seed,) + _mk_supports(truth, seed, 12, 0.004, rng, hq=True)
    rng = np.random.default_rng(22)
    truth = rng.integers(0, 4, 2000).astype(np.uint8)
    alt = truth.copy()
    alt[1000] = (alt[1000] + 2) % 4
    seed = truth.copy()
    a = _mk_supports(truth, seed, 8, 0.003, rng, hq=True)
    b = _mk_supports(alt, seed, 4, 0.003, rng, hq=True)
    return (seed,) + tuple(x + y for x, y in zip(a, b))


@pytest.mark.parametrize("read_type", [2, 3])
@pytest.mark.parametrize("case", ["truth", "het_site"])
def test_correct_seed_read_types_equal(case, read_type):
    """native.correct_seed with the CLR (2) and HiFi (3) codes gives the
    same (length, identity, sequence) in both packages."""
    from nextdenovo_tpu import native as jn
    from nextdenovo_tpu_torch import native as tn
    seed, sups, ts_, te_, ops = _hifi_consensus_inputs(case)
    kw = dict(min_len_aln=100, max_cov_aln=60, min_cov=3,
              max_lq_length=1000, read_type=read_type)
    ref = jn.correct_seed(seed, sups, ts_, te_, ops, **kw)
    got = tn.correct_seed(seed, sups, ts_, te_, ops, **kw)
    assert got[0] > 0.9 * len(seed)
    assert got == ref
