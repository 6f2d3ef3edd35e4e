"""The mesh path's routing, lookup and symmetrize pass on the CPU
(nextdenovo_tpu_torch/parallel/: mesh.bucketize_plain, dist_overlap's
_lookup through engine_anchor's plain version, dist_sort.seed_symmetrize),
each against a model: bucketize against a numpy model of the reference's
per-destination jnp.nonzero(size=cap), and a numpy model of the
route_buckets kernel (csrc/route.cu: blocks over chunks of rows, counts per
block, a warp's rank by its group of equal destinations, the warps before
it and the rounds before) against bucketize_plain; the lookup as
engine_anchor computes it (each minimizer a query row, the index shard's
packed positions, the qmask extended) against the plain lookup, with and
without the pair-once gate; the symmetrize pass against the JAX package's
distributed_seed_sort_step and a numpy model of the seed_symmetrize
kernel.  Inputs made from a seed with numpy.  Tolerance: exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextdenovo_tpu.parallel import dist_sort as jds
from nextdenovo_tpu_torch.parallel import dist_overlap as tdo
from nextdenovo_tpu_torch.parallel import dist_sort as tds
from nextdenovo_tpu_torch.parallel import mesh as tm

I32MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# bucketize


def _nonzero_model(fields, dest, valid, n, cap):
    """The reference's routing: per destination jnp.nonzero(sel,
    size=cap), and the counts the port reports beside it."""
    sel = np.ones(len(dest), bool) if valid is None else valid
    out, counts = [], np.zeros(n + 1, np.int64)
    for d in range(n):
        idx = np.nonzero(sel & (dest == d))[0]
        counts[d] = len(idx)
        out.append([f[idx[:cap]] for f in fields])
    counts[n] = int((sel & ((dest < 0) | (dest >= n))).sum())
    return out, counts


def _route_model(fields, dest, valid, n, cap, blocks, threads=256):
    """The route_buckets kernel in numpy: the grid's chunks, each block's
    counts, then per round of `threads` rows each warp's groups of one
    destination, ranked by the warps before and the rounds before.
    Returns the buckets cut from its (F, N) output as the wrapper cuts
    them, and the counts."""
    N, F = len(dest), len(fields)
    per = -(-N // blocks)
    chunk = max(32, -(-per // 32) * 32)
    valid = np.ones(N, bool) if valid is None else valid
    key = np.where(valid, np.where((dest >= 0) & (dest < n), dest, n), -1)
    blk = np.zeros((blocks, n + 1), np.int64)
    bounds = [(min(N, b * chunk), min(N, b * chunk + chunk))
              for b in range(blocks)]
    for b, (lo, hi) in enumerate(bounds):
        k = key[lo:hi]
        blk[b] = np.bincount(k[k >= 0], minlength=n + 1)
    tot = blk.sum(0)
    kept = np.minimum(tot[:n], cap)
    start = np.concatenate([[0], np.cumsum(kept)])
    out = np.full((F, N), -7, np.int64)
    for b, (lo, hi) in enumerate(bounds):
        base = blk[:b].sum(0)[:n].copy()
        for r0 in range(lo, hi, threads):
            rows = np.arange(r0, r0 + threads)
            kk = np.where(rows < hi, key[np.minimum(rows, N - 1)], -1)
            kk = np.where(kk == n, -1, kk)
            wk = kk.reshape(-1, 32)
            wcnt = np.zeros((len(wk), n), np.int64)
            below = np.zeros_like(wk)
            for w, lanes in enumerate(wk):
                for lane, k in enumerate(lanes):
                    if k >= 0:
                        below[w, lane] = (lanes[:lane] == k).sum()
                        wcnt[w, k] += 1
            first = base + np.cumsum(wcnt, 0) - wcnt
            base += wcnt.sum(0)
            for i, r in enumerate(rows):
                k = kk[i]
                if k < 0:
                    continue
                rank = first[i // 32, k] + below.ravel()[i]
                if rank < cap:
                    out[:, start[k] + rank] = [f[r] for f in fields]
    return [[out[f, start[d]:start[d + 1]] for f in range(F)]
            for d in range(n)], tot


def _route_case(seed, N, n, F, outside=0.0, valid_p=None):
    rng = np.random.default_rng(seed)
    fields = [rng.integers(-2**40, 2**40, N) for _ in range(F)]
    dest = rng.integers(0, n, N)
    if outside:
        out = rng.random(N) < outside
        dest[out] = rng.choice([-3, -1, n, n + 5], int(out.sum()))
    valid = None if valid_p is None else rng.random(N) < valid_p
    return fields, dest, valid


CASES = {
    "n1": (1, 700, 1, 4, 0.0, None),
    "n2_truncating": (2, 1000, 2, 5, 0.0, 0.8),
    "n8_outside": (3, 3000, 8, 8, 0.1, 0.7),
    "n8_all_valid": (4, 2500, 8, 4, 0.0, None),
    "n0_rows": (5, 0, 8, 4, 0.0, None),
}
CAPS = {"n1": 1000, "n2_truncating": 150, "n8_outside": 40,
        "n8_all_valid": 10**9, "n0_rows": 10}


@pytest.mark.parametrize("case", list(CASES))
def test_bucketize_plain_equals_nonzero(case):
    seed, N, n, F, outside, vp = CASES[case]
    fields, dest, valid = _route_case(seed, N, n, F, outside, vp)
    cap = CAPS[case]
    want, wcounts = _nonzero_model(fields, dest, valid, n, cap)
    t = torch.from_numpy
    got, counts = tm.bucketize_plain([t(f) for f in fields], t(dest),
                                     None if valid is None else t(valid), n,
                                     cap)
    assert counts.dtype == np.int64 and np.array_equal(counts, wcounts)
    for d in range(n):
        for a, b in zip(want[d], got[d]):
            assert np.array_equal(a, b.numpy())
    assert tm.bucket_drops(counts, cap) == \
        int(np.maximum(wcounts[:n] - cap, 0).sum() + wcounts[n])
    if case == "n2_truncating":
        assert (wcounts[:n] > cap).any()
    if case == "n8_outside":
        assert wcounts[n] > 0 and (wcounts[:n] > cap).any()


@pytest.mark.parametrize("case", [c for c in CASES if c != "n0_rows"])
@pytest.mark.parametrize("blocks", [1, 3, 7, 64])
def test_route_kernel_model_equals_plain(case, blocks):
    seed, N, n, F, outside, vp = CASES[case]
    fields, dest, valid = _route_case(seed, N, n, F, outside, vp)
    cap = CAPS[case]
    got, counts = _route_model(fields, dest, valid, n, cap, blocks)
    t = torch.from_numpy
    want, wcounts = tm.bucketize_plain([t(f) for f in fields], t(dest),
                                       None if valid is None else t(valid),
                                       n, cap)
    assert np.array_equal(counts, wcounts)
    for d in range(n):
        for a, b in zip(got[d], want[d]):
            assert np.array_equal(a, b.numpy())


def test_bucketize_cpu_takes_plain():
    fields, dest, valid = _route_case(9, 400, 4, 3, 0.05, 0.9)
    t = torch.from_numpy
    args = ([t(f) for f in fields], t(dest), t(valid), 4, 30)
    a, ca = tm.bucketize(*args)
    b, cb = tm.bucketize_plain(*args)
    assert np.array_equal(ca, cb)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# the mesh lookup through engine_anchor


def _index_blocks(rng, n, H, n_reads):
    """Index arrays sharded by hash range, H rows a shard, hashes drawn
    from a small pool (runs past max_occ) and the pads' 0xFFFFFFFF rows."""
    shift = 32 - max(1, (n - 1).bit_length()) if n > 1 else 32
    pool = np.unique(rng.integers(0, 2**32, 300))
    pool[-1] = 0xFFFFFFFF
    ih = np.full((n, H), 0xFFFFFFFF, np.uint32)
    irid = np.full((n, H), -1, np.int32)
    ipos = np.zeros((n, H), np.int32)
    istr = np.zeros((n, H), np.int32)
    owner = (pool >> shift) % n if n > 1 else np.zeros(len(pool), np.int64)
    for d in range(n):
        mine = pool[owner == d]
        if not len(mine):
            continue
        h = np.sort(rng.choice(mine, int(H * 0.8)))
        ih[d, : len(h)] = h
        irid[d, : len(h)] = rng.integers(0, n_reads, len(h))
        ipos[d, : len(h)] = rng.integers(0, 1 << 20, len(h))
        istr[d, : len(h)] = rng.integers(0, 2, len(h))
    return [x.reshape(-1) for x in (ih, irid, ipos, istr)], pool


@pytest.fixture(scope="module")
def lookup_case():
    rng = np.random.default_rng(17)
    n, H, n_reads, M = 2, 3000, 60, 1500
    blocks, pool = _index_blocks(rng, n, H, n_reads)
    mesh = tm.make_mesh(n, "cpu")
    index = tdo.index_shards(mesh, *blocks)
    h = np.where(rng.random(M) < 0.85, rng.choice(pool, M),
                 rng.integers(0, 2**32, M))
    recv = tuple(torch.from_numpy(x) for x in (
        h.astype(np.int64), rng.integers(0, 1 << 20, M),
        rng.integers(0, 2, M), rng.integers(0, n_reads, M)))
    return index, recv, n_reads, blocks


QMASKS = ("none", "full", "short", "int64")


def _qmask(kind, n_reads):
    rng = np.random.default_rng(3)
    if kind == "none":
        return None
    m = (rng.random(n_reads) < 0.5).astype(np.int8)
    if kind == "short":
        return torch.from_numpy(m[: n_reads // 3])
    if kind == "int64":
        return torch.from_numpy(m.astype(np.int64) * 300)
    return torch.from_numpy(m)


@pytest.mark.parametrize("qkind", QMASKS)
@pytest.mark.parametrize("max_occ", [1, 8, 16])
def test_lookup_through_engine_anchor(lookup_case, monkeypatch, qkind,
                                      max_occ):
    """The lookup as the card runs it (engine_anchor; here its plain
    version) equals the plain lookup on every shard, also in chunks."""
    index, recv, n_reads, _ = lookup_case
    qm = _qmask(qkind, n_reads)
    amask = tdo.anchor_mask(qm, index.rid_end, torch.device("cpu"))
    assert amask.dtype == torch.int8 and amask.shape[0] >= index.rid_end
    total = 0
    for ix in index.shards:
        want = tdo._lookup_plain(recv, *ix.unpacked(), qm, max_occ)
        got = tdo._lookup_anchor(recv, ix, amask, max_occ)
        for a, b in zip(want, got):
            assert torch.equal(a, b)
        monkeypatch.setattr(tdo, "LOOKUP_ROWS", 333)
        cut = tdo._lookup_anchor(recv, ix, amask, max_occ)
        monkeypatch.undo()
        for a, b in zip(want, cut):
            assert torch.equal(a, b)
        total += want[0].shape[0]
    assert total > 100


def test_index_shards_fields(lookup_case):
    """Each shard's packed block holds the index arrays it was made from."""
    index, _, n_reads, arrays = lookup_case
    blocks = [x.reshape(len(index.shards), -1) for x in arrays]
    for d, ix in enumerate(index.shards):
        assert ix.h.dtype == torch.int64
        assert ix.rid.dtype == ix.posst.dtype == ix.bucket.dtype \
            == torch.int32
        for got, want in zip(ix.unpacked(), blocks):
            assert np.array_equal(got.numpy(), want[d].astype(np.int64))
    assert index.rid_end == max(int(ix.rid.max()) + 1 for ix in index.shards)
    assert index.rid_end <= n_reads


# ---------------------------------------------------------------------------
# seed_symmetrize


def _raw_records(rng, R, n_reads, negative=False):
    lens = rng.integers(400, 4000, n_reads)
    q = rng.integers(0, n_reads + 3, R)
    t = rng.integers(0, n_reads + 3, R)
    t[: R // 10] = q[: R // 10]
    if negative:
        q[R // 10 : R // 5] = -rng.integers(1, 50, R // 10)
    qs = rng.integers(0, 2000, R)
    ts = rng.integers(0, 2000, R)
    qe = qs + rng.integers(300, 2500, R)
    te = ts + rng.integers(300, 2500, R)
    rec = np.stack([q, rng.integers(0, 2, R), qs, qe, t, ts, te,
                    rng.integers(0, 3000, R)], 1)
    is_seed = rng.random(n_reads) < 0.6
    return rec, is_seed, lens


def _sym_model(rec, is_seed, lens, n):
    """The seed_symmetrize kernel, record by record, in numpy (the
    destination a truncated % made non-negative)."""
    q, rev, qs, qe, t, ts, te, match = rec.T
    keep = (q != t) & (qe - qs >= 500) & (te - ts >= 500)
    top = len(lens) - 1
    sq, st = np.clip(q, 0, top), np.clip(t, 0, top)
    vq = keep & is_seed[sq] & (lens[sq] >= qe)
    vt = keep & is_seed[st] & (lens[st] >= te)
    cols = np.stack([np.concatenate(p) for p in (
        (q, t), (rev, rev), (qs, ts), (qe - 1, te - 1), (t, q), (ts, qs),
        (te - 1, qe - 1), (match, match))])
    d = np.fmod(cols[0], n)
    return cols, np.concatenate([vq, vt]), np.where(d < 0, d + n, d)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_symmetrize_kernel_model(n):
    rng = np.random.default_rng(20 + n)
    rec, is_seed, lens = _raw_records(rng, 2000, 80, negative=True)
    cols, valid, dest = tds.seed_symmetrize(
        torch.from_numpy(rec), torch.from_numpy(is_seed),
        torch.from_numpy(lens), n)
    mc, mv, md = _sym_model(rec, is_seed, lens, n)
    assert cols.shape == (8, 4000) and valid.dtype == torch.bool
    assert np.array_equal(mc, cols.numpy())
    assert np.array_equal(mv, valid.numpy())
    assert np.array_equal(md, dest.numpy())
    assert mv.sum() > 100 and (mv & (mc[0] < 0)).any()


def test_symmetrize_equals_jax_step():
    """The valid rows of seed_symmetrize are the records the JAX package's
    distributed_seed_sort_step (one shard, a cap that drops none) routes
    and sorts, as a multiset; its n_sent is their count."""
    rng = np.random.default_rng(31)
    R, n_reads = 1500, 70
    rec, is_seed, lens = _raw_records(rng, R, n_reads)
    out = jds.distributed_seed_sort_step(
        jnp.asarray(rec.astype(np.int32)), jnp.asarray(is_seed),
        jnp.asarray(lens.astype(np.int32)), cap_route=2 * R + 8, mesh=None,
        n_shards=1)
    cols = [np.asarray(x) for x in out[:8]]
    keep = cols[0] != I32MAX
    jrows = np.stack([c[keep] for c in cols], 1).astype(np.int64)
    tc, tv, _ = tds.seed_symmetrize(torch.from_numpy(rec),
                                    torch.from_numpy(is_seed),
                                    torch.from_numpy(lens), 1)
    trows = tc.numpy()[:, tv.numpy()].T
    order = lambda x: x[np.lexsort(x.T[::-1])]
    assert len(trows) > 100 and int(np.asarray(out[9]).ravel()[0]) == \
        len(trows)
    assert np.array_equal(order(jrows), order(trows))
