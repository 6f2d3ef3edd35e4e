"""The port's long-k sketch (nextdenovo_tpu_torch/ops/sketch.py:
kmer_pack_wide, sketch_wide, hpc_compress) and the engine's HiFi route
(overlap/engine.py: _chunk_rows, build_index and find_overlaps at k = 51,
w = 51), raw and homopolymer-compressed (hpc), against the JAX package's, on
the same numpy inputs.  Tolerance: exact equality of every field.

One sketch batch shape is shared by the sketch_wide cases: the JAX side
compiles once per (shape, k, w, hpc, ownership)."""
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


HPC = pytest.mark.parametrize("hpc", [False, True], ids=["raw", "hpc"])


@HPC
@pytest.mark.parametrize("own", [False, True])
@pytest.mark.parametrize("k,w", [(51, 51), (33, 17), (17, 10)])
def test_sketch_wide_equal(k, w, own, hpc):
    codes, lens = _batch()
    jkw = dict(own_lo=J(OWN_LO), own_hi=J(OWN_HI)) if own else {}
    tkw = dict(own_lo=T(OWN_LO), own_hi=T(OWN_HI)) if own else {}
    ref = jsk.sketch_wide(J(codes), J(lens), k=k, w=w, cap=4096, hpc=hpc,
                          **jkw)
    got = tsk.sketch_wide(T(codes), T(lens), k=k, w=w, cap=4096, hpc=hpc,
                          **tkw)
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


@HPC
@pytest.mark.parametrize("k,w", [(51, 51), (17, 10)])
def test_chunk_rows_equal(hifi_world, k, w, hpc):
    js, _, rids, _ = hifi_world
    lens = np.asarray(js.length, np.int64)
    assert lens.max() > te.CHUNK_LP
    ref = je._chunk_rows(rids, lens, k, w, hpc=hpc)
    got = te._chunk_rows(rids, lens, k, w, hpc=hpc)
    assert ref == got
    assert len(got) > len(rids)
    assert max(r[4] for r in got) <= te.CHUNK_LP


def _assert_same_index(jidx, tidx):
    n = tidx.h.shape[0]
    assert int(jidx.n) == tidx.n > 0
    assert np.array_equal(np.asarray(jidx.h)[:n].astype(np.int64),
                          tidx.h.numpy())
    assert np.array_equal(np.asarray(jidx.rid)[:n], tidx.rid.numpy())
    assert np.array_equal(np.asarray(jidx.pos)[:n], tidx.pos.numpy())
    assert np.array_equal(np.asarray(jidx.lens), tidx.lens.numpy())
    assert np.all(np.asarray(jidx.rid)[n:] == -1)


def test_build_index_k51_equal(hifi_world):
    js, ts, rids, jidx = hifi_world
    tidx = te.build_index(ts, rids, k=51, w=51, max_occ=64, device="cpu")
    _assert_same_index(jidx, tidx)
    # minimizers of the long read come from every one of its chunks
    p, _ = tidx.unpack()
    long_rid = int(np.argmax(np.asarray(js.length)))
    assert p[tidx.rid.numpy() == long_rid].max() > te.CHUNK_LP


def test_build_index_k51_hpc_equal(hifi_world):
    """The hpc index of the same reads: the long read is chunked with the
    inflated hpc halos, the read of long runs compresses most."""
    js, ts, rids, raw = hifi_world
    jidx = je.build_index(js, rids, k=51, w=51, max_occ=64, hpc=True)
    tidx = te.build_index(ts, rids, k=51, w=51, max_occ=64, hpc=True,
                          device="cpu")
    _assert_same_index(jidx, tidx)
    assert tidx.n < raw.n
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


# --------------------------------------------------------------------------
# homopolymer compression

def _assert_same_hpc(codes, lens):
    ref = jsk.hpc_compress(J(codes), J(lens))
    got = tsk.hpc_compress(T(codes), T(lens))
    for name, x, y in zip(("codes_hpc", "pos_map", "lengths_hpc"), ref, got):
        assert tuple(y.shape) == x.shape, name
        assert np.array_equal(np.asarray(x).astype(np.int64),
                              y.numpy().astype(np.int64)), name
    return got


def test_hpc_compress_reference_cases():
    """The reference's two unit cases (tests/test_sketch_wide.py)."""
    codes = np.array([[0, 0, 1, 1, 1, 2, 3, 3, 0, 2, 2, 2]], np.int32)
    ch, pmap, lh = _assert_same_hpc(codes, np.array([12], np.int32))
    assert int(lh[0]) == 6
    assert ch[0, :6].tolist() == [0, 1, 2, 3, 0, 2]
    assert pmap[0, :6].tolist() == [0, 2, 5, 6, 8, 9]
    assert bool((ch[0, 6:] == 4).all())
    codes = np.tile(np.array([0, 1, 2, 3], np.int32), 8)[None, :]
    ch, pmap, lh = _assert_same_hpc(codes, np.array([32], np.int32))
    assert int(lh[0]) == 32
    assert np.array_equal(ch[0].numpy(), codes[0])
    assert np.array_equal(pmap[0].numpy(), np.arange(32))


def test_hpc_compress_ragged_batch():
    """Runs of 1-6 bases over codes 0-4 (runs of N included), lengths 0, 1,
    2 and full, and junk codes past each length, over the whole buffer."""
    rng = np.random.default_rng(11)
    B, L = 7, 400
    lens = np.array([L, 0, 1, 2, 137, L - 1, 250], np.int32)
    codes = rng.integers(0, 8, (B, L)).astype(np.int8)   # junk past lens
    for i in range(B):
        runs = np.repeat(rng.integers(0, 5, L), rng.integers(1, 7, L))
        codes[i, : lens[i]] = runs[: lens[i]]
    codes[0, 10:40] = 4                  # one long run of N
    codes[0, 40] = 0
    codes[6, :3] = 3                     # a row whose first base repeats
    codes[6, L - 1] = codes[6, 0]        # roll's wrap-around would match
    _, pmap, lh = _assert_same_hpc(codes, lens)
    assert lh.tolist()[1:4] == [0, 1, 1 + int(codes[3, 1] != codes[3, 0])]
    assert int(lh[0]) < L and int(pmap[0, 1:].max()) < L
    assert bool((pmap[:, 0] == 0).all())


class _Store:
    def __init__(self, seqs):
        self.seqs = [np.asarray(s, np.int8) for s in seqs]
        self.length = np.array([len(s) for s in self.seqs], np.int64)

    def get(self, rid):
        return self.seqs[int(rid)]


def _port_full(codes, k, w):
    m = tsk.sketch_wide(T(codes[None, :]), T(np.array([len(codes)])), k=k,
                        w=w, cap=len(codes), hpc=True)
    return set(zip(m.pos.tolist(), m.hash.tolist(), m.strand.tolist()))


def _port_chunked(store, k, w):
    got = set()
    rows = te._chunk_rows([0], store.length, k, w, hpc=True)
    assert len(rows) > 1, "the read must be chunked"
    for row in rows:
        m = te._sketch_rows(store, [row], k, w, 4096, "cpu", hpc=True)
        for p, h, st in zip(m.pos.tolist(), m.hash.tolist(),
                            m.strand.tolist()):
            key = (p + row[1], h, st)
            assert key not in got, "chunks emitted a duplicate minimizer"
            got.add(key)
    return got


def test_chunked_equals_full_hpc(monkeypatch):
    """Port only, after tests/test_chunked_sketch.py: with runs of 1-5
    bases the hpc halos make the chunked sketch the full-read one."""
    monkeypatch.setattr(te, "CHUNK_LP", 2048)
    rng = np.random.default_rng(9)
    base = rng.integers(0, 4, 4000)
    codes = np.repeat(base, rng.integers(1, 6, 4000))[:6000].astype(np.int8)
    full = _port_full(codes, 21, 11)
    assert len(full) > 100
    assert _port_chunked(_Store([codes]), 21, 11) == full


def test_long_run_past_hpc_halo_equal(monkeypatch):
    """A 1500-base run across a chunk's left halo (224 bases at k = 21,
    w = 11) loses minimizers next to it, in the reference and the port
    alike: the port's rows and index equal the reference's although the
    chunked sketch is not the full-read one."""
    monkeypatch.setattr(te, "CHUNK_LP", 2048)
    monkeypatch.setattr(je, "CHUNK_LP", 2048)
    rng = np.random.default_rng(13)
    read = rng.integers(0, 4, 6000).astype(np.int8)
    read[2000:3500] = 2
    other = rng.integers(0, 4, 1500).astype(np.int8)
    k, w = 21, 11
    lens = np.array([len(read), len(other)], np.int64)
    rows = te._chunk_rows([0, 1], lens, k, w, hpc=True)
    assert rows == je._chunk_rows([0, 1], lens, k, w, hpc=True)
    # the third row's left halo [2304, 2528) lies inside the run
    assert any(r[1] > 2000 and r[1] + r[2] < 3500 for r in rows)
    assert _port_chunked(_Store([read]), k, w) != _port_full(read, k, w)
    js = JStore.from_codes([read, other])
    ts = convert.seqstore_from_arrays(js.words, js.word_start, js.length,
                                      js.names)
    jidx = je.build_index(js, np.arange(2), k=k, w=w, max_occ=64, hpc=True)
    tidx = te.build_index(ts, np.arange(2), k=k, w=w, max_occ=64, hpc=True,
                          device="cpu")
    _assert_same_index(jidx, tidx)
