"""correct/tagmsa.py of the port: the vectorised link path
(`extract_links` + native `nd_correct_links`) against the port's reference
consensus path (`native.correct_seed`) and against the JAX package's
`extract_links` / `correct_seed_links`, on the same seeds, supports and op
streams, for read types 1 and 3 and with split and strict settings.
Tolerance: exact equality.

The two native entries treat a malformed op stream differently (a support
whose ops do not consume it exactly), so every op stream is checked to be
well formed before the consensus runs."""
import numpy as np
import pytest

from nextdenovo_tpu.correct import tagmsa as jtag
from nextdenovo_tpu.io.simulate import mutate_read, simulate_genome
from nextdenovo_tpu.ops import align as jalign
from nextdenovo_tpu_torch.correct import tagmsa as ttag
from nextdenovo_tpu_torch.native import correct_seed


def _make_case(rng, seed_len=6000, n_sup=25, err=0.12):
    """A seed, supports drawn from its true sequence, and their op streams
    against the seed (the JAX package's band_align on the CPU)."""
    seed_true = simulate_genome(seed_len, seed=int(rng.integers(1 << 30)))
    seed = mutate_read(seed_true, err, rng)
    sups, tss, tes = [], [], []
    for _ in range(n_sup):
        a = int(rng.integers(0, len(seed) // 3))
        b = int(rng.integers(a + len(seed) // 3, len(seed)))
        frag = mutate_read(seed_true[
            min(a, len(seed_true) - 1) : min(b, len(seed_true))], err, rng)
        sups.append(frag.astype(np.int8))
        tss.append(a)
        tes.append(min(b, len(seed)) - 1)
    segs = [seed[a : e + 1].astype(np.int8) for a, e in zip(tss, tes)]
    res = jalign.band_align(sups, segs)
    ok_s, ok_ts, ok_ops = [], [], []
    for s, a, r in zip(sups, tss, res):
        if r["reached"] and r["ok"]:
            ok_s.append(s.astype(np.uint8))
            ok_ts.append(a)
            ok_ops.append(r["ops"].astype(np.uint8))
    return seed.astype(np.uint8), ok_s, ok_ts, ok_ops


def _check_well_formed(seed, sups, tss, ops):
    for s, t0, o in zip(sups, tss, ops):
        o = np.asarray(o)
        assert set(np.unique(o).tolist()) <= {0, 1, 2}
        assert int(np.sum(o != 2)) == len(s)           # consumes the support
        assert 0 <= t0 and t0 + int(np.sum(o != 1)) <= len(seed)


def _compare(seed, sups, tss, ops, **kw):
    _check_well_formed(seed, sups, tss, ops)
    tes = [t0 + int(np.sum(np.asarray(o) != 1)) - 1
           for t0, o in zip(tss, ops)]
    links_t = ttag.extract_links(seed, sups, tss, ops, kw["min_len_aln"],
                                 kw["max_cov_aln"])
    links_j = jtag.extract_links(seed, sups, tss, ops, kw["min_len_aln"],
                                 kw["max_cov_aln"])
    assert links_t is not None and links_j is not None
    for a, b in zip(links_t, links_j):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ref = correct_seed(seed, sups, tss, tes, ops, **kw)
    got = ttag.correct_seed_links(seed, sups, tss, ops, **kw)
    assert got == ref, (got[:2], ref[:2])
    assert got == jtag.correct_seed_links(seed, sups, tss, ops, **kw)
    return got


@pytest.mark.parametrize("read_type,err", [(1, 0.12), (3, 0.02)])
def test_links_path_equals_correct_seed(read_type, err):
    rng = np.random.default_rng(7 + read_type)
    n_cases = 0
    for _ in range(2):
        seed, sups, tss, ops = _make_case(rng, err=err)
        if len(sups) < 5:
            continue
        got = _compare(seed, sups, tss, ops, min_len_aln=500,
                       max_cov_aln=130, min_cov=3, max_lq_length=3000,
                       min_error_corrected_ratio=0.0, split=False,
                       read_type=read_type, keep_all=True)
        assert got[0] > 0.5 * len(seed)
        n_cases += 1
    assert n_cases == 2


@pytest.mark.parametrize("read_type,err", [(1, 0.12), (3, 0.02)])
def test_links_path_split_and_strict(read_type, err):
    """The non-keep-all path (SSR trim, split at lq regions) as well."""
    rng = np.random.default_rng(42)
    seed, sups, tss, ops = _make_case(rng, seed_len=8000, n_sup=35, err=err)
    assert len(sups) >= 5
    _compare(seed, sups, tss, ops, min_len_aln=500, max_cov_aln=130,
             min_cov=4, max_lq_length=3000, min_error_corrected_ratio=0.8,
             split=True, read_type=read_type, keep_all=False)

