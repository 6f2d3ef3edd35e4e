"""The port's long-k sketch (nextdenovo_tpu_torch/ops/sketch.py:
kmer_pack_wide, sketch_wide) and the engine's HiFi route (overlap/engine.py:
_chunk_rows, build_index and find_overlaps at k = 51, w = 51) against the
JAX package's, on the same numpy inputs.  Tolerance: exact equality of every
field.

One sketch batch shape is shared by the sketch_wide cases: the JAX side
compiles once per (shape, k, w, ownership)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextdenovo_tpu.io.seqstore import SeqStore as JStore
from nextdenovo_tpu.io.simulate import (mutate_read, simulate_genome,
                                        simulate_reads)
from nextdenovo_tpu.ops import sketch as jsk
from nextdenovo_tpu.overlap import engine as je
from nextdenovo_tpu_torch import convert
from nextdenovo_tpu_torch.ops import sketch as tsk
from nextdenovo_tpu_torch.overlap import engine as te

J = jnp.asarray
T = torch.from_numpy


def _batch():
    """A ragged (5, 1024) int8 batch with homopolymer runs of 1-4 bases, a
    row with no repeated base, a row that holds one long run and a row of
    length 0."""
    rng = np.random.default_rng(5)
    lens = np.array([1024, 700, 0, 300, 640], np.int32)
    codes = np.zeros((5, 1024), np.int8)
    for i in (0, 1, 4):
        c = np.repeat(rng.integers(0, 4, 1024), rng.integers(1, 5, 1024))
        codes[i, : lens[i]] = c[: lens[i]]
    codes[3, :300] = np.tile([0, 1, 2, 3, 1, 3, 0, 2], 38)[:300]
    codes[4, 100:400] = 2                    # one long run inside the row
    return codes, lens


OWN_LO = np.array([0, 100, 0, 20, 50], np.int32)
OWN_HI = np.array([900, 600, 0, 280, 600], np.int32)


def _assert_same_minimizers(ref, got):
    n = int(ref.n)
    assert got.n == n and got.n_all == int(ref.n_all)
    for f in ("rid", "pos", "hash", "strand"):
        assert np.array_equal(np.asarray(getattr(ref, f))[:n].astype(np.int64),
                              getattr(got, f).numpy()), f


@pytest.mark.parametrize("k", [17, 33, 51, 63])
def test_kmer_pack_wide_equal(k):
    codes, _ = _batch()
    fl, rl = jsk.kmer_pack_wide(J(codes), k)
    tf, tr = tsk.kmer_pack_wide(T(codes), k)
    assert len(tf) == len(fl) == 4
    for ref, got in zip(fl + rl, tf + tr):
        assert np.array_equal(np.asarray(ref).astype(np.int64), got.numpy())
    n_lanes = max(2, k // 16 + 1)
    fl, rl = jsk.kmer_pack_wide(J(codes), k, n_lanes=n_lanes)
    tf, tr = tsk.kmer_pack_wide(T(codes), k, n_lanes=n_lanes)
    for ref, got in zip(fl + rl, tf + tr):
        assert np.array_equal(np.asarray(ref).astype(np.int64), got.numpy())
    h = tsk.hash_lanes(tf)
    assert np.array_equal(np.asarray(jsk.hash_lanes(fl)).astype(np.int64),
                          h.numpy())
    assert np.array_equal(np.asarray(jsk._lanes_less(fl, rl)),
                          tsk._lanes_less(tf, tr).numpy())


@pytest.mark.parametrize("own", [False, True])
@pytest.mark.parametrize("k,w", [(51, 51), (33, 17), (17, 10)])
def test_sketch_wide_equal(k, w, own):
    codes, lens = _batch()
    jkw = dict(own_lo=J(OWN_LO), own_hi=J(OWN_HI)) if own else {}
    tkw = dict(own_lo=T(OWN_LO), own_hi=T(OWN_HI)) if own else {}
    ref = jsk.sketch_wide(J(codes), J(lens), k=k, w=w, cap=4096, **jkw)
    got = tsk.sketch_wide(T(codes), T(lens), k=k, w=w, cap=4096, **tkw)
    assert got.n > 0
    _assert_same_minimizers(ref, got)
    if own:
        rid, pos = got.rid.numpy(), got.pos.numpy()
        assert np.all((pos >= OWN_LO[rid]) & (pos < OWN_HI[rid]))


def test_sketch_wide_cap_truncates_like_reference():
    codes, lens = _batch()
    ref = jsk.sketch_wide(J(codes), J(lens), k=51, w=51, cap=20)
    got = tsk.sketch_wide(T(codes), T(lens), k=51, w=51, cap=20)
    assert got.n == 20 < got.n_all
    _assert_same_minimizers(ref, got)


@pytest.mark.parametrize("k,w", [(15, 5), (31, 16)])
def test_sketch_wide_equals_sketch_for_small_k(k, w):
    """At k <= 31 the two-lane wide path is the plain sketch."""
    codes, lens = _batch()
    a = tsk.sketch(T(codes), T(lens), k=k, w=w, cap=4096,
                   own_lo=T(OWN_LO), own_hi=T(OWN_HI))
    b = tsk.sketch_wide(T(codes), T(lens), k=k, w=w, cap=4096,
                        own_lo=T(OWN_LO), own_hi=T(OWN_HI))
    assert a.n == b.n > 0 and a.n_all == b.n_all
    for f in ("rid", "pos", "hash", "strand"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module")
def hifi_world():
    """HiFi-like reads (0.5 % error) of a 40 kb genome, all <= 4 kb, plus
    one read of 20 kb (longer than CHUNK_LP, so it is halo-chunked) and one
    with long homopolymer runs.  The JAX index at k = 51, w = 51 is built
    once, for both tests that need it."""
    g = simulate_genome(40_000, seed=7)
    sim = simulate_reads(g, coverage=8, mean_len=2500, error_rate=0.005,
                         seed=8, min_len=1500)
    reads = [r for r in sim.reads if len(r) <= 4000]
    rng = np.random.default_rng(9)
    reads.append(mutate_read(g[5000:25000], 0.005, rng))
    runs = np.repeat(g[30000:31500], rng.integers(1, 6, 1500))
    reads.append(runs.astype(g.dtype))
    js = JStore.from_codes(reads)
    ts = convert.seqstore_from_arrays(js.words, js.word_start, js.length,
                                      js.names)
    rids = np.arange(len(js))
    return js, ts, rids, je.build_index(js, rids, k=51, w=51, max_occ=64)


@pytest.mark.parametrize("k,w", [(51, 51), (17, 10)])
def test_chunk_rows_equal(hifi_world, k, w):
    js, _, rids, _ = hifi_world
    lens = np.asarray(js.length, np.int64)
    assert lens.max() > te.CHUNK_LP
    ref = je._chunk_rows(rids, lens, k, w)
    got = te._chunk_rows(rids, lens, k, w)
    assert ref == got
    assert len(got) > len(rids)
    assert max(r[4] for r in got) <= te.CHUNK_LP


def test_build_index_k51_equal(hifi_world):
    js, ts, rids, jidx = hifi_world
    tidx = te.build_index(ts, rids, k=51, w=51, max_occ=64, device="cpu")
    n = tidx.h.shape[0]
    assert int(jidx.n) == tidx.n > 0
    assert np.array_equal(np.asarray(jidx.h)[:n].astype(np.int64),
                          tidx.h.numpy())
    assert np.array_equal(np.asarray(jidx.rid)[:n], tidx.rid.numpy())
    assert np.array_equal(np.asarray(jidx.pos)[:n], tidx.pos.numpy())
    assert np.array_equal(np.asarray(jidx.lens), tidx.lens.numpy())
    assert np.all(np.asarray(jidx.rid)[n:] == -1)
    # minimizers of the long read come from every one of its chunks
    p, _ = tidx.unpack()
    long_rid = int(np.argmax(np.asarray(js.length)))
    assert p[tidx.rid.numpy() == long_rid].max() > te.CHUNK_LP


def test_find_overlaps_k51_equal(hifi_world):
    """The raw_align stage's HiFi call: k = 51, w = 51."""
    js, ts, rids, jidx = hifi_world
    tidx = te.build_index(ts, rids, k=51, w=51, max_occ=64, device="cpu")
    mask = np.ones(len(js), bool)
    kw = dict(k=51, w=51, max_occ=16, min_cnt=4, min_span=500, top_k=4,
              query_mask=mask)
    ref = je.find_overlaps(js, rids, jidx, **kw)
    got = te.find_overlaps(ts, rids, tidx, device="cpu", **kw)
    assert len(ref) == len(got) > 20
    for f in te.REC_FIELDS:
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              np.asarray(getattr(got, f))), f
    long_rid = int(np.argmax(np.asarray(js.length)))
    q, t = np.asarray(got.qname), np.asarray(got.tname)
    assert np.any((q == long_rid) | (t == long_rid))
