"""Stage 06 of the port (nextdenovo_tpu_torch/polish/ on the CPU) against
the JAX package's with its TPU path on the CPU (interpret=True): the same
draft contigs and the same reads go to both sides.  Tolerance: exact
equality of the mapping block, the per-contig records, the structural
analysis and the polished pieces."""
import numpy as np
import pytest

from nextdenovo_tpu.io.seqstore import SeqStore as JStore
from nextdenovo_tpu.io.simulate import mutate_read
from nextdenovo_tpu.polish import driver as jd
from nextdenovo_tpu.polish import structure as jst
from nextdenovo_tpu_torch import convert
from nextdenovo_tpu_torch.polish import driver as td
from nextdenovo_tpu_torch.polish import structure as tst


def _tiled_reads(src, rng, rlen=3_000, step=500, copies=7):
    """Overlapping reads giving ~20x spanning depth, both strands."""
    reads = []
    for pos in range(0, len(src) - rlen + 1, step):
        for c in range(copies):
            r = mutate_read(src[pos : pos + rlen], 0.02, rng)
            reads.append((r[::-1] ^ 3) if c % 2 else r)
    return reads


def _both_sides(draft, reads, min_reads):
    """Map, group, analyse and polish on both sides."""
    js = JStore.from_codes(reads)
    ts = convert.seqstore_from_arrays(js.words, js.word_start, js.length,
                                      js.names)
    out = {}
    for tag, drv, stc, store, kw in (
            ("j", jd, jst, js, dict(interpret=True)),
            ("t", td, tst, ts, dict(device="cpu"))):
        ovl = drv.map_polish_reads([draft], store,
                                   **({} if tag == "j" else kw))
        per_ctg = drv.collect_per_ctg(ovl, 1, store)
        ana = stc.analyze_contig(
            len(draft), per_ctg[0], [],
            lambda rid, s, e, rc, store=store: store.subseq(rid, s, e, rc=rc),
            min_reads=min_reads)
        pieces = drv.polish_one(draft, per_ctg[0], store, [], read_type=1,
                                struct_min_reads=min_reads, **kw)
        out[tag] = dict(ovl=ovl, per_ctg=per_ctg, ana=ana, pieces=pieces)
    return out, ts


@pytest.fixture(scope="module")
def planted():
    """A 9 kb draft with ~1 % planted errors and reads of the true
    sequence."""
    rng = np.random.default_rng(21)
    truth = rng.integers(0, 4, 9_000).astype(np.uint8)
    draft = mutate_read(truth, 0.01, rng)
    reads = _tiled_reads(truth, rng, step=750, copies=4)
    return truth, draft, _both_sides(draft, reads, 150)


@pytest.fixture(scope="module")
def chimeric():
    """A draft made of two unrelated halves, reads only within the halves:
    the junction is unsupported and the contig must be split."""
    rng = np.random.default_rng(11)
    half_a = rng.integers(0, 4, 9_000).astype(np.uint8)
    half_b = rng.integers(0, 4, 9_000).astype(np.uint8)
    draft = np.concatenate([half_a, half_b])
    reads = _tiled_reads(half_a, rng) + _tiled_reads(half_b, rng)
    return draft, _both_sides(draft, reads, 50)


def _same_ovl(a, b):
    assert len(a) == len(b) > 0
    assert sorted(a.data) == sorted(b.data)
    for k in a.data:
        assert np.array_equal(np.asarray(a.data[k]), np.asarray(b.data[k])), k


def _plain(x):
    """Nested analysis results as comparable plain data."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if hasattr(x, "__dict__"):
        return {k: _plain(v) for k, v in vars(x).items()}
    if isinstance(x, np.generic):
        return x.item()
    return x


@pytest.mark.parametrize("which", ["planted", "chimeric"])
def test_map_and_collect_equal(which, request):
    res = request.getfixturevalue(which)[-1][0]
    _same_ovl(res["j"]["ovl"], res["t"]["ovl"])
    assert res["j"]["per_ctg"] == res["t"]["per_ctg"]
    assert len(res["t"]["per_ctg"][0]) > 10
    assert {r["rev"] for r in res["t"]["per_ctg"][0]} == {0, 1}


@pytest.mark.parametrize("which", ["planted", "chimeric"])
def test_analyze_contig_equal(which, request):
    res = request.getfixturevalue(which)[-1][0]
    assert _plain(res["j"]["ana"]) == _plain(res["t"]["ana"])


@pytest.mark.parametrize("which", ["planted", "chimeric"])
def test_polish_one_pieces_equal(which, request):
    res = request.getfixturevalue(which)[-1][0]
    a, b = res["j"]["pieces"], res["t"]["pieces"]
    assert len(a) == len(b) >= 1
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_planted_errors_are_corrected(planted):
    """Share of the contig's 31-mers found in the true sequence."""
    truth, draft, (res, ts) = planted
    from nextdenovo_tpu_torch.utils.asm_metrics import kmer_identity
    (piece,) = res["t"]["pieces"]
    before = kmer_identity([draft], [truth], stride=1)
    after = kmer_identity([piece], [truth], stride=1)
    assert before < 0.8 and after > 0.97, (before, after)


def test_chimeric_contig_is_split(chimeric):
    draft, (res, ts) = chimeric
    assert res["t"]["ana"]["splits"]
    pieces = res["t"]["pieces"]
    assert len(pieces) > 1, [len(p) for p in pieces]
    assert all(4_000 < len(p) < 11_000 for p in pieces)


def test_run_polish_and_align_fn(planted):
    """run_polish maps and polishes in one call; align_fn replaces the
    default aligner without changing the result (split=False changes
    nothing where no split is due)."""
    truth, draft, (res, ts) = planted
    from nextdenovo_tpu_torch.ops.align import band_align
    calls = []

    def fn(a, b):
        calls.append(len(a))
        return band_align(a, b, device="cpu")

    out = td.run_polish([draft], ts, device="cpu", align_fn=fn, split=False)
    assert calls and len(out) == 1
    assert np.array_equal(out[0], res["t"]["pieces"][0])


def test_helpers_equal():
    rec = dict(qs=100, qe=2100, ts=5000, te=7050, rev=1, qname=3)
    for ws, we in ((0, 4000), (4000, 6000), (6500, 9000), (5000, 7050)):
        assert td._interp_read_interval(rec, ws, we) == \
            jd._interp_read_interval(rec, ws, we)
    d, c = "ACGT" * 60, "GTAC" * 3 + "ACGT" * 50
    assert td._splice_uncovered(d, c) == jd._splice_uncovered(d, c)
    assert (td.STITCH, td.EDGE, td.SLACK, td.CHUNK_T, td.PIECE) == \
        (jd.STITCH, jd.EDGE, jd.SLACK, jd.CHUNK_T, jd.PIECE)
    per = [[dict(qs=0, qe=500, ts=1000, te=1500, qlen=2000)]]
    assert td.warn_fragmented(per, [10_000], 3) == \
        jd.warn_fragmented(per, [10_000], 3) > 0.1
    assert td.warn_fragmented(per, [10_000], 1) == 0.0
