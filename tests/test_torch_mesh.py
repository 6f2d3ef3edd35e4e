"""The mesh path's modules (nextdenovo_tpu_torch/parallel/: mesh,
dist_overlap, dist_sort, dist_correct, dist_polish), n shards on the CPU,
against the JAX package's mesh functions on the virtual 8-device CPU mesh
(tests/conftest.py), on the same numpy inputs, for n in {1, 2, 8}; and the
n = 8 shards spread over k in {2, 4} device groups (`devices=[cpu] * k`,
one host thread a group) against the same JAX outputs, computed once
(distributed_correct and distributed_polish over groups:
tests/test_torch_mesh_groups.py).  Tolerance: exact equality."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nextdenovo_tpu.io.seqstore import SeqStore as JStore
from nextdenovo_tpu.io.simulate import (mutate_read, simulate_genome,
                                        simulate_reads)
from nextdenovo_tpu.parallel import dist_correct as jdc
from nextdenovo_tpu.parallel import dist_overlap as jdo
from nextdenovo_tpu.parallel import dist_polish as jdp
from nextdenovo_tpu.parallel import dist_sort as jds
from nextdenovo_tpu.parallel import mesh as jm
from nextdenovo_tpu_torch.correct.driver import (CORR_CHUNK_T, _TR,
                                                  run_correction)
from nextdenovo_tpu_torch.io.seqstore import SeqStore as TStore
from nextdenovo_tpu_torch.overlap.engine import build_index, find_overlaps
from nextdenovo_tpu_torch.overlap.records import OvlBlock
from nextdenovo_tpu_torch.ops.myers import myers_align
from nextdenovo_tpu_torch.overlap.sort import sort_filter_overlaps
from nextdenovo_tpu_torch.parallel import dist_correct as tdc
from nextdenovo_tpu_torch.parallel import dist_overlap as tdo
from nextdenovo_tpu_torch.parallel import dist_polish as tdp
from nextdenovo_tpu_torch.parallel import dist_sort as tds
from nextdenovo_tpu_torch.parallel import mesh as tm

from torch_port_util import assert_same_results

SHARDS = (1, 2, 8)
GROUPS = (2, 4)
FIELDS = ("qname", "tname", "rev", "qs", "qe", "ts", "te", "match")


_JMESH = {}
_JOUT = {}


def _jcached(key, fn):
    """One JAX output per key for the whole module: the tests of the port's
    one-group and grouped meshes share it."""
    if key not in _JOUT:
        _JOUT[key] = fn()
    return _JOUT[key]


def _jmesh(n):
    """One JAX mesh per shard count for the whole module."""
    if n not in _JMESH:
        _JMESH[n] = jm.make_mesh(n)
    return _JMESH[n]


def _tmesh(n, groups=1):
    """n shards on the CPU, in `groups` device groups (one: make_mesh's
    explicit device)."""
    if groups == 1:
        return tm.make_mesh(n, "cpu")
    return tm.make_mesh(n, devices=[torch.device("cpu")] * groups)


def _stores(reads):
    return JStore.from_codes(reads), TStore.from_codes(reads)


def _to_port_block(blk):
    return OvlBlock({k: np.asarray(v) for k, v in blk.data.items()})


def _same_blocks(a, b):
    assert list(a.data) == list(b.data)
    for k in a.data:
        assert np.array_equal(np.asarray(a.data[k]), np.asarray(b.data[k])), k


# ---------------------------------------------------------------------------
# partition_index


@pytest.fixture(scope="module")
def index_pair():
    from nextdenovo_tpu.overlap.engine import build_index as jbuild
    g = simulate_genome(20_000, seed=5)
    sim = simulate_reads(g, coverage=16, mean_len=4000, error_rate=0.03,
                         seed=6, min_len=2500)
    js, ts = _stores(sim.reads)
    rids = np.arange(len(js))
    return (jbuild(js, rids, k=15, w=5, max_occ=4),
            build_index(ts, rids, k=15, w=5, max_occ=4, device="cpu"))


@pytest.mark.parametrize("n", SHARDS)
def test_partition_index(index_pair, n):
    """The copied partition_index gives the JAX package's arrays on the same
    index; on the port's own index (compacted: the JAX index carries
    sentinel rows up to a half-octave length, which land on the last
    shard) every shard's block is the same up to padding rows."""
    import torch
    jidx, tidx = index_pair
    same = tidx._replace(h=torch.from_numpy(np.asarray(jidx.h, np.int64)),
                         rid=torch.from_numpy(np.asarray(jidx.rid)),
                         pos=torch.from_numpy(np.asarray(jidx.pos)))
    ref = jm.partition_index(jidx, n)
    for a, b in zip(ref, tm.partition_index(same, n)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pad = (0xFFFFFFFF, -1, 0, 0)
    for a, b, p in zip(ref, tm.partition_index(tidx, n), pad):
        a, b = a.reshape(n, -1), b.reshape(n, -1)
        h = min(a.shape[1], b.shape[1])
        assert np.array_equal(a[:, :h], b[:, :h])
        assert (a[:, h:] == p).all() and (b[:, h:] == p).all()
    assert (ref[1] >= 0).sum() > 1000


@pytest.mark.parametrize("k", GROUPS)
def test_partition_index_groups(index_pair, k):
    """The 8-shard partition sent to k groups: each shard's block of every
    index array, on its group's device, is the JAX package's row block of
    that shard."""
    jidx, tidx = index_pair
    same = tidx._replace(h=torch.from_numpy(np.asarray(jidx.h, np.int64)),
                         rid=torch.from_numpy(np.asarray(jidx.rid)),
                         pos=torch.from_numpy(np.asarray(jidx.pos)))
    mesh = _tmesh(8, k)
    for a, b in zip(jm.partition_index(jidx, 8), tm.partition_index(same, 8)):
        blocks = tm.shard_rows(mesh, b)
        assert len(blocks) == 8
        for s, blk in enumerate(blocks):
            assert blk.device == mesh.device_of(s)
            assert np.array_equal(blk.numpy(),
                                  a.reshape(8, -1)[s].astype(blk.numpy().dtype))


# ---------------------------------------------------------------------------
# distributed_overlap_step / distributed_overlap_autocap


def _hash_blocks(h, rid, pos, strand, n, H):
    """Index arrays sharded by hash range, H rows a shard (the layout of
    tests/test_dist.py)."""
    shift = 32 - max(1, (n - 1).bit_length()) if n > 1 else 32
    owner = (h >> shift) % n if n > 1 else np.zeros(len(h), np.int64)
    ih = np.full((n, H), 0xFFFFFFFF, np.uint32)
    irid = np.full((n, H), -1, np.int32)
    ipos = np.zeros((n, H), np.int32)
    istr = np.zeros((n, H), np.int32)
    for d in range(n):
        sel = np.nonzero(owner == d)[0]
        o = sel[np.argsort(h[sel], kind="stable")][:H]
        ih[d, : len(o)], irid[d, : len(o)] = h[o], rid[o]
        ipos[d, : len(o)], istr[d, : len(o)] = pos[o], strand[o]
    return [x.reshape(-1) for x in (ih, irid, ipos, istr)]


@pytest.fixture(scope="module")
def step_workload():
    """The workload of tests/test_dist.py: a 20 kb genome, 8 query rows of
    ~4 kb, an index of every read's minimizers."""
    from nextdenovo_tpu.ops.sketch import sketch as jsketch
    g = simulate_genome(20_000, seed=5)
    sim = simulate_reads(g, coverage=16, mean_len=4000, error_rate=0.03,
                         seed=6, min_len=2500)
    reads = sim.reads
    B, L = 8, 8192
    codes = np.zeros((B, L), np.int32)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        c = reads[i % len(reads)][:L]
        codes[i, : len(c)] = c
        lens[i] = len(c)
    allc = np.zeros((len(reads), L), np.int32)
    alll = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        allc[i, : len(r[:L])] = r[:L]
        alll[i] = len(r[:L])
    m = jsketch(jnp.asarray(allc), jnp.asarray(alll), k=15, w=5, cap=16384)
    nm = int(m.n)
    mins = [np.asarray(x[:nm]) for x in (m.hash, m.rid, m.pos, m.strand)]
    return codes, lens, mins, len(reads)


def _step_outputs(jout, n):
    recs = [np.asarray(x).reshape(n, -1) for x in jout[:8]]
    return ([{f: recs[i][s][recs[0][s] >= 0] for i, f in enumerate(FIELDS)}
             for s in range(n)],
            int(np.asarray(jout[8]).ravel()[0]),
            int(np.asarray(jout[9]).ravel()[0]))


def _assert_same_step(jout, tout, n):
    jrec, jn, jover = _step_outputs(jout, n)
    trec, tn, tover = tout
    assert len(trec) == n
    for s in range(n):
        for f in FIELDS:
            assert np.array_equal(jrec[s][f], trec[s][f].numpy()), (s, f)
    assert (jn, jover) == (tn, tover)
    return jn


@pytest.mark.parametrize("n,variant", [(1, "qmask"), (2, "qid0"),
                                       (8, "qmask"), (8, "qid0")])
def test_overlap_step(step_workload, n, variant):
    """Records per shard, n_ovl and n_over: with the pair-once gate
    (qmask), and with queries in a joint id space after 3 other ids (qid0 =
    3, no gate)."""
    jout, tout = _overlap_step_pair(step_workload, n, variant, 1)
    assert _assert_same_step(jout, tout, n) > 0


def _overlap_step_pair(step_workload, n, variant, groups):
    """(the JAX package's output, cached; the port's over `groups` device
    groups) of one overlap step: with the pair-once gate (qmask), or with
    queries in a joint id space after 3 other ids (qid0 = 3, no gate)."""
    codes, lens, mins, n_reads = step_workload
    qid0 = 3 if variant == "qid0" else 0
    qmask = np.ones(n_reads, np.int8) if variant == "qmask" else None
    args = [codes, lens, np.arange(len(codes), dtype=np.int32) + qid0] + \
        _hash_blocks(*mins, n, 16384 // n)
    kw = dict(k=15, w=5, cap_mini=4096, max_occ=8, diag_shift=8, cap_out=128,
              qid0=qid0)

    def jax_step():
        jmesh = _jmesh(n)
        jq = None if qmask is None else jm.replicate(jmesh, jnp.asarray(qmask))
        return jdo.distributed_overlap_step(
            *[jm.shard_rows(jmesh, jnp.asarray(a)) for a in args], jq,
            mesh=jmesh, n_shards=n, **kw)

    return (_jcached(("step", n, variant), jax_step),
            tdo.distributed_overlap_step(*args, qmask,
                                         mesh=_tmesh(n, groups), **kw))


@pytest.mark.parametrize("k,variant", [(k, v) for k in GROUPS
                                       for v in ("qmask", "qid0")])
def test_overlap_step_groups(step_workload, k, variant):
    """8 shards over k groups: every shard's records, n_ovl and n_over are
    the JAX package's."""
    jout, tout = _overlap_step_pair(step_workload, 8, variant, k)
    assert _assert_same_step(jout, tout, 8) > 0


@pytest.mark.parametrize("n", (1, 8))
def test_overlap_step_in_pieces(step_workload, monkeypatch, n):
    """The sketch batches, the lookup chunks and the query slices of
    _vote_emit cut at a few rows, anchors and queries give the records of
    one piece each."""
    codes, lens, mins, n_reads = step_workload
    args = [codes, lens, np.arange(len(codes), dtype=np.int32)] + \
        _hash_blocks(*mins, n, 16384 // n) + [np.ones(n_reads, np.int8)]
    kw = dict(k=15, w=5, cap_mini=4096, max_occ=8, diag_shift=8, cap_out=128,
              mesh=_tmesh(n), top_k=2)
    whole = tdo.distributed_overlap_step(*args, **kw)
    monkeypatch.setattr(tdo, "SKETCH_POSITIONS", 6000)
    monkeypatch.setattr(tdo, "LOOKUP_ROWS", 500)
    monkeypatch.setattr(tdo, "VOTE_ANCHORS", 700)
    cut = tdo.distributed_overlap_step(*args, **kw)
    assert whole[1:] == cut[1:] and whole[1] > 0
    for a, b in zip(whole[0], cut[0]):
        for f in FIELDS:
            assert np.array_equal(a[f].numpy(), b[f].numpy()), f
    # an emission cap met inside the slices: the first cap_out records
    kw["cap_out"] = whole[1] // n - 1
    capped = tdo.distributed_overlap_step(*args, **kw)
    monkeypatch.undo()
    ref = tdo.distributed_overlap_step(*args, **kw)
    assert capped[1:] == ref[1:] and capped[2] > 0
    for a, b in zip(ref[0], capped[0]):
        for f in FIELDS:
            assert np.array_equal(a[f].numpy(), b[f].numpy()), f


@pytest.mark.parametrize("n", (8,))
def test_overlap_autocap_overflow(step_workload, n):
    """Caps at 3/4 of what the busiest shard needs overflow the sketch cap
    and the emission cap: distributed_overlap_autocap doubles them once, to
    the same final caps and records as the JAX package's, and with no
    retry allowed both raise the same error."""
    import torch
    from nextdenovo_tpu_torch.ops.sketch import sketch
    codes, lens, mins, n_reads = step_workload
    args = [codes, lens, np.arange(len(codes), dtype=np.int32)] + \
        _hash_blocks(*mins, n, 16384 // n)
    kw = dict(k=15, w=5, max_occ=8, diag_shift=8)
    roomy = tdo.distributed_overlap_step(*args, mesh=_tmesh(n),
                                         cap_mini=1 << 20, cap_out=1 << 12,
                                         **kw)
    B = len(codes) // n
    need = max(sketch(torch.from_numpy(codes[s * B : (s + 1) * B]),
                      torch.from_numpy(lens[s * B : (s + 1) * B]), k=15,
                      w=5, cap=1 << 30).n_all for s in range(n))
    kw.update(cap_mini=need * 3 // 4,
              cap_out=max(len(r["qname"]) for r in roomy[0]) * 3 // 4)
    jmesh = _jmesh(n)
    jargs = [jm.shard_rows(jmesh, jnp.asarray(a)) for a in args]
    jout, jcaps = jdo.distributed_overlap_autocap(*jargs, mesh=jmesh,
                                                  n_shards=n, **kw)
    tout, tcaps = tdo.distributed_overlap_autocap(*args, mesh=_tmesh(n), **kw)
    assert jcaps == tcaps == (kw["cap_mini"] * 2, kw["cap_out"] * 2)
    assert _assert_same_step(jout, tout, n) == roomy[1]
    with pytest.raises(RuntimeError, match="still overflowing") as je:
        jdo.distributed_overlap_autocap(*jargs, mesh=jmesh, n_shards=n,
                                        max_retries=0, **kw)
    with pytest.raises(RuntimeError, match="still overflowing") as te:
        tdo.distributed_overlap_autocap(*args, mesh=_tmesh(n), max_retries=0,
                                        **kw)
    assert str(je.value) == str(te.value)


# ---------------------------------------------------------------------------
# distributed_sort_filter


@pytest.fixture(scope="module")
def sort_workload():
    """Raw records of a 40 kb genome at 12x (the port's engine, equal to
    the JAX package's), plus copies of ten records with te - 1: each copy
    ties its original on all seven sort keys of the seed-keyed view."""
    g = simulate_genome(40_000, seed=51)
    sim = simulate_reads(g, coverage=12, mean_len=6000, error_rate=0.08,
                         seed=52, min_len=2500)
    store = TStore.from_codes(sim.reads)
    lens = np.asarray(store.length, np.int64)
    rids = np.arange(len(store))
    idx = build_index(store, rids, k=15, w=5, max_occ=64, device="cpu")
    raw = find_overlaps(store, rids, idx, k=15, w=5, max_occ=16, min_cnt=4,
                        min_span=500, top_k=4, device="cpu")
    is_seed = lens >= 5000
    d = raw.data
    pick = np.nonzero(is_seed[d["qname"]] & (d["te"] - d["ts"] > 600))[0]
    pick = pick[:: max(1, len(pick) // 10)][:10]
    dup = {k: v[pick].copy() for k, v in d.items()}
    dup["te"] -= 1
    # the copies go first: a tie then crosses source shards
    tied = OvlBlock.concat_all([OvlBlock(dup), raw])
    return tied, is_seed, lens, len(pick)


@pytest.mark.parametrize("n", SHARDS)
def test_sort_filter(sort_workload, n):
    """The same SortResult as the JAX package's mesh sort: every block array
    and the blacklist, its seeds in the same (shard) order.  Rows that tie
    on the seven keys keep their order of arrival, as in the JAX package;
    with n > 1 that order is not the single-device path's."""
    raw, is_seed, lens, n_tied = sort_workload
    ref = _jcached(("sort", n), lambda: jds.distributed_sort_filter(
        raw, is_seed, lens, _jmesh(n), n))
    got = tds.distributed_sort_filter(raw, is_seed, lens, _tmesh(n))
    assert list(ref.blacklist.items()) == list(got.blacklist.items())
    assert len(ref.blacklist) > 0 and len(got.block) > 100 and n_tied == 10
    _same_blocks(ref.block, got.block)
    # each tie really is one: both rows of a pair reach the sort
    blk = got.block.data
    key = np.stack([blk[k] for k in ("qname", "match", "qs", "qe", "tname",
                                     "ts", "rev")], 1)
    _, cnt = np.unique(key, axis=0, return_counts=True)
    assert (cnt > 1).any()


@pytest.mark.parametrize("k", GROUPS)
def test_sort_filter_groups(sort_workload, k):
    """8 shards over k groups: the JAX package's SortResult, the blacklist
    in shard order."""
    raw, is_seed, lens, _ = sort_workload
    ref = _jcached(("sort", 8), lambda: jds.distributed_sort_filter(
        raw, is_seed, lens, _jmesh(8), 8))
    got = tds.distributed_sort_filter(raw, is_seed, lens, _tmesh(8, k))
    assert list(ref.blacklist.items()) == list(got.blacklist.items())
    assert len(got.block) > 100
    _same_blocks(ref.block, got.block)


def test_sort_overflow_raises():
    """A routing bucket under its load is an error, not a silent loss."""
    rec8 = np.zeros((4, 8), np.int32)
    rec8[:, 0], rec8[:, 4] = [0, 0, 0, 0], [1, 2, 3, 4]
    rec8[:, 3] = rec8[:, 6] = 1000
    rows, n_tot, n_sent = tds.distributed_seed_sort_step(
        rec8, np.arange(5) == 0, np.full(5, 1000, np.int32), cap_route=1,
        mesh=_tmesh(2))
    # two records of each source shard route to seed 0's shard, one fits
    assert (n_tot, n_sent) == (2, 4) and [len(r) for r in rows] == [2, 0]


# ---------------------------------------------------------------------------
# distributed_band_align


@pytest.fixture(scope="module")
def band_pairs():
    """tests/test_dist.py's 50 pairs of 500-4000 bases at 10 % error, plus
    six whose lengths differ by more than the Myers band takes: those
    retry on the wide band (R = 2)."""
    rng = np.random.default_rng(77)
    qs, ts = [], []
    for i in range(50):
        t = rng.integers(0, 4, int(rng.integers(500, 4000))).astype(np.uint8)
        q = mutate_read(t, 0.10, rng)
        if i % 4 == 0:
            q, t = t, q
        qs.append(q.astype(np.int8))
        ts.append(t.astype(np.int8))
    for i in range(6):
        t = rng.integers(0, 4, int(rng.integers(450, 600))).astype(np.uint8)
        q = mutate_read(t, 0.05, rng)
        cut = int(rng.integers(250, 300))
        q = q[cut:] if i % 2 else q[:-cut]
        qs.append(q.astype(np.int8))
        ts.append(t.astype(np.int8))
    return qs, ts


@pytest.fixture(scope="module")
def band_port(band_pairs):
    """The port's result, and the Myers tier alone on the six band-exit
    pairs.  distributed_band_align reads only the mesh's device, so one call
    stands for every shard count."""
    qs, ts = band_pairs
    return (tdc.distributed_band_align(qs, ts, _tmesh(8)),
            myers_align(qs[50:], ts[50:], device="cpu"))


@pytest.mark.parametrize("n", SHARDS)
def test_band_align(band_pairs, band_port, n):
    """The same dist, reached, ok and ops as the JAX package's; the six
    pairs past the Myers band failed its tier and came back ok from the
    R = 2 retry."""
    qs, ts = band_pairs
    got, exits = band_port
    assert_same_results(_jcached(("band", n), lambda: jdc.distributed_band_align(
        qs, ts, _jmesh(n), n)), got)
    assert not any(r["ok"] for r in exits)
    assert all(r["ok"] for r in got[50:])


@pytest.mark.parametrize("k", GROUPS)
def test_band_align_groups(band_pairs, k):
    """The pairs of at most 750 bases (four, and the six band-exit pairs)
    dealt round-robin to 8 shards over k groups, each group one band_align
    call: in input order, the JAX package's n = 8 results of the same pairs
    (its results are per pair: the whole set's, taken at these pairs).
    Short pairs keep it cheap: the plain aligner costs a step a column in
    every group's call, and the groups' threads contend for the
    interpreter."""
    qs, ts = band_pairs
    ref = _jcached(("band", 8), lambda: jdc.distributed_band_align(
        qs, ts, _jmesh(8), 8))
    pick = [i for i in range(len(qs)) if max(len(qs[i]), len(ts[i])) <= 750]
    got = tdc.distributed_band_align([qs[i] for i in pick],
                                     [ts[i] for i in pick], _tmesh(8, k))
    assert len(pick) == 10 and set(range(50, 56)) <= set(pick)
    assert_same_results([ref[i] for i in pick], got)
    assert all(r["ok"] for r in got[-6:])


# ---------------------------------------------------------------------------
# distributed_correct


def _sorted_block(reads, seed_len, top_k=1):
    store = TStore.from_codes(reads)
    lens = np.asarray(store.length, np.int64)
    rids = np.arange(len(store))
    idx = build_index(store, rids, k=15, w=5, max_occ=64, device="cpu")
    raw = find_overlaps(store, rids, idx, k=15, w=5, max_occ=16, min_cnt=4,
                        min_span=500, top_k=top_k, device="cpu")
    return store, sort_filter_overlaps(raw, lens >= seed_len, lens)


@pytest.fixture(scope="module")
def correct_workload():
    """tests/test_dist.py's correction workload cut to a 12 kb genome at 8x
    of 2.5 kb reads (5 seed jobs, 96 pairs of up to 4.3 kb)."""
    g = simulate_genome(12_000, seed=61)
    sim = simulate_reads(g, coverage=8, mean_len=2500, error_rate=0.08,
                         seed=62, min_len=1500)
    return sim.reads, _sorted_block(sim.reads, 2500)


CORRECT_KW = dict(min_len_seed=1500, min_cov_seed=1, min_len_aln=300,
                  min_cov=2)


@pytest.mark.parametrize("n", (2, 8))
def test_correct(correct_workload, monkeypatch, n):
    """The same {seed: (len, ide, seq)} as the JAX package's, in the same
    (shard) order; with n = 2 the jobs are aligned in groups of ~40 pairs."""
    reads, (store, srt) = correct_workload
    if n == 2:
        monkeypatch.setattr(tdc, "GROUP_PAIRS", 40)
    ref = jdc.distributed_correct(JStore.from_codes(reads), srt.block,
                                  srt.blacklist, _jmesh(n), n, **CORRECT_KW)
    got = tdc.distributed_correct(store, srt.block, srt.blacklist, _tmesh(n),
                                  **CORRECT_KW)
    assert list(ref.items()) == list(got.items())
    assert len(got) >= 3 and any(v[0] > 3 for v in got.values())


def test_correct_long_segment():
    """Supports over CORR_CHUNK_T bases: the mesh path aligns them whole
    where run_correction cuts them into pieces.  The port's mesh
    correction equals the JAX package's; whether it equals the port's
    run_correction is recorded, not required (on this seed the two
    corrected reads differ)."""
    g = simulate_genome(14_000, seed=71)
    rng = np.random.default_rng(72)
    # one seed of 13.2 kb and three supports of 12.6 kb inside it
    reads = [mutate_read(g[s : s + ln], 0.05, rng)
             for s, ln in ((0, 13_200), (200, 12_600), (400, 12_600),
                           (600, 12_600))]
    store, srt = _sorted_block(reads, 13_000)
    d = srt.block.data
    assert set(d["qname"]) == {0}
    long_ = d["qe"] - d["qs"] + 1 > CORR_CHUNK_T
    assert set(d["tname"][long_ & (d["tname"] != 0)]) == {1, 2, 3}
    kw = dict(min_len_seed=10_000, min_cov_seed=1, min_len_aln=300,
              min_cov=2)
    ref = jdc.distributed_correct(JStore.from_codes(reads), srt.block,
                                  srt.blacklist, _jmesh(2), 2, **kw)
    got = tdc.distributed_correct(store, srt.block, srt.blacklist, _tmesh(2),
                                  **kw)
    assert list(ref.items()) == list(got.items())
    assert len(got) == 1 and got[0][0] > 12_000
    single = run_correction(store, srt.block, srt.blacklist, device="cpu",
                            **kw)
    assert len(single) == 1
    mesh = np.frombuffer(got[0][2].upper().encode().translate(_TR), np.uint8)
    print(f"long segments: run_correction's corrected read ({len(single.get(0))}"
          f" bases) equals the mesh correction's ({len(mesh)} bases): "
          f"{np.array_equal(single.get(0), mesh)}")


# ---------------------------------------------------------------------------
# distributed_map_polish_reads, distributed_polish


@pytest.fixture(scope="module")
def polish_workload():
    """tests/test_dist.py's polish workload cut to an 8 kb genome at 12x
    and a draft contig of the genome at 2 % error."""
    g = simulate_genome(8_000, seed=91)
    sim = simulate_reads(g, coverage=12, mean_len=3000, error_rate=0.06,
                         seed=92, min_len=1500)
    draft = [mutate_read(g, 0.02, np.random.default_rng(93))]
    return sim.reads, draft


def test_map_polish_reads(polish_workload):
    reads, draft = polish_workload
    ref = jdp.distributed_map_polish_reads(draft, JStore.from_codes(reads),
                                           _jmesh(2), 2)
    got = tdp.distributed_map_polish_reads(draft, TStore.from_codes(reads),
                                           _tmesh(2))
    assert len(got) > 10
    _same_blocks(ref, got)


@pytest.mark.parametrize("k", GROUPS)
def test_map_polish_reads_groups(polish_workload, k):
    """ctg_align over 8 shards in k groups: the JAX package's n = 8
    records."""
    reads, draft = polish_workload
    ref = _jcached(("map", 8), lambda: jdp.distributed_map_polish_reads(
        draft, JStore.from_codes(reads), _jmesh(8), 8))
    got = tdp.distributed_map_polish_reads(draft, TStore.from_codes(reads),
                                           _tmesh(8, k))
    assert len(got) > 10
    _same_blocks(ref, got)


def test_polish(polish_workload):
    reads, draft = polish_workload
    from nextdenovo_tpu.polish.driver import map_polish_reads as jmap
    js = JStore.from_codes(reads)
    ovl = jmap(draft, js)
    ref = jdp.distributed_polish(draft, js, _jmesh(2), 2, ovl=ovl,
                                 split=False, window=4000)
    got = tdp.distributed_polish(draft, TStore.from_codes(reads), _tmesh(2),
                                 ovl=_to_port_block(ovl), split=False,
                                 window=4000)
    assert len(got) == len(ref) and sum(len(p) for p in got) > 7_000
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
