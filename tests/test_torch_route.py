"""The mesh path's routing, lookup and seed route on the CPU
(nextdenovo_tpu_torch/parallel/: mesh.bucketize_plain, dist_overlap's
_lookup through engine_anchor's plain version, dist_sort.seed_route_plain
and seed_symmetrize_plain), each against a model: bucketize against a numpy
model of the reference's per-destination jnp.nonzero(size=cap); a numpy
model of the routing kernels of csrc/route.cu (route_count: tiles of rows,
2-byte keys, each tile's counts, the last block's scan of the tiles by
groups; route_scatter: a tile's ranks by __match_any_sync steps and warp
counters, the block scan into each destination's run, the kept rows staged
by slot and written through a pointer table into buckets of their kept
size) against bucketize_plain, at several tile sizes and at the kernels'
tile of 2048 rows (n up to 4096, cap 0, every row outside, a short last
tile); the same for the seed route (both views' keys from one record, two
view tiles a record tile, the views' fields made from the records) against
seed_symmetrize_plain then bucketize_plain; the lookup as engine_anchor
computes it (each minimizer a query row, the index shard's packed
positions, the qmask extended) against the plain lookup, with and without
the pair-once gate; the views and the seed route against the JAX package's
distributed_seed_sort_step.  Inputs made from a seed with numpy.
Tolerance: exact equality."""
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


TILE, SEED_TILE, THREADS, WARPS = tm.ROUTE_TILE, tm.ROUTE_SEED_TILE, 256, 8
NONE = 0xFFFF
# the target view's fields from a record's columns (t, rev, ts, te, q, qs,
# qe, match), one column a nibble
T_COLS = 0x73206514


SCAN_INTS = 6144     # route.cu: the last block's chunk of the table


def _scan_tiles_model(blk, threads=THREADS):
    """route.cu's scan_tiles in the last count block: each tile's exclusive
    prefix a column, and the columns' totals.  Narrow tables: chunks of
    SCAN_INTS // n1 tiles, each column's tiles of a chunk in groups (one
    thread a group and column), the column's carry from chunk to chunk;
    wide ones: a thread a column."""
    tiles, n1 = blk.shape
    out = np.zeros_like(blk)
    if n1 > threads // 2:
        run = np.zeros(n1, np.int64)
        for b in range(tiles):
            out[b] = run
            run = run + blk[b]
        return out, run
    G, TB = threads // n1, SCAN_INTS // n1
    carry = np.zeros(n1, np.int64)
    for c0 in range(0, tiles, TB):
        tab = blk[c0:c0 + TB]
        nb = len(tab)
        seg = -(-nb // G)
        bounds = [(min(nb, g * seg), min(nb, min(nb, g * seg) + seg))
                  for g in range(G)]
        part = np.stack([tab[b0:b1].sum(0) for b0, b1 in bounds])
        first = carry + np.cumsum(part, 0) - part
        carry = carry + part.sum(0)
        for g, (b0, b1) in enumerate(bounds):
            run = first[g].copy()
            for b in range(b0, b1):
                out[c0 + b] = run
                run = run + tab[b]
    return out, carry


def _block_scan_model(a, threads=THREADS):
    """route.cu's block_exclusive_scan: a run of ceil(n / threads) entries
    a thread, the threads' sums scanned."""
    n = len(a)
    per = -(-n // threads)
    spans = [(min(n, t * per), min(n, min(n, t * per) + per))
             for t in range(threads)]
    sums = np.array([a[b0:b1].sum() for b0, b1 in spans], np.int64)
    before = np.cumsum(sums) - sums
    out = np.zeros(n, np.int64)
    for (b0, b1), run in zip(spans, before):
        out[b0:b1] = run + np.cumsum(a[b0:b1]) - a[b0:b1]
    return out, int(sums.sum())


def _rank_tile_model(skey, n, first, cap):
    """route_scatter's ranking of one tile of keys (NONE past its rows):
    each warp's rows in steps of 32 lanes, __match_any_sync's lanes below
    and a counter a destination; the warps' counters scanned, the tile's
    runs by destination; each row's slot, kept where its bucket position
    is below cap.  Returns (slot a row, NONE where not kept; the
    destination of each slot; sbase; the routed rows)."""
    steps = len(skey) // (WARPS * 32)
    kk = skey.reshape(WARPS, steps, 32)
    wcnt = np.zeros((WARPS, n), np.int64)
    rk = np.zeros((WARPS, steps, 32), np.int64)
    below_mask = np.tril(np.ones((32, 32), bool), -1)    # lane l' < l
    for j in range(steps):
        k = kk[:, j, :]
        routed = k < n
        kc = np.where(routed, k, 0)
        peers = (k[:, :, None] == k[:, None, :]) & below_mask
        base = np.where(routed, np.take_along_axis(wcnt, kc, 1), 0)
        rk[:, j, :] = base + peers.sum(2)
        for w in range(WARPS):
            np.add.at(wcnt[w], k[w][routed[w]], 1)
    before_w = np.cumsum(wcnt, 0) - wcnt
    tstart, routed_rows = _block_scan_model(wcnt.sum(0))
    wc = before_w + tstart
    sbase = first - tstart
    routed = kk < n
    kc = np.where(routed, kk, 0)
    sl = np.take_along_axis(wc, kc.reshape(WARPS, -1), 1).reshape(kk.shape) \
        + rk
    sdest = np.full(len(skey), NONE, np.int64)
    sdest[sl[routed]] = kk[routed]
    kept = routed & (sl + sbase[kc] < cap)
    return np.where(kept, sl, NONE).ravel(), sdest, sbase, routed_rows


def _scatter_model(tiles, tile, keys, values, n, F, first, counts, cap):
    """route_scatter: each tile ranked (_rank_tile_model), each field's kept
    rows staged at their slots and each slot written at its bucket's
    address (a pointer table into one memory, guard words between the
    buckets that no write may touch).  tiles: (lo, rows) of each tile;
    values(i, rows) the field i of the key rows `rows`.  Returns the
    buckets read back from the memory."""
    kept = np.minimum(counts[:n], cap)
    table = np.concatenate([[0], np.cumsum(F * kept + 3)])[:-1] + 3
    mem = np.full(int(table[-1] + F * kept[-1] + 3), -7, np.int64)
    for b, (lo, rows) in enumerate(tiles):
        skey = np.full(tile, NONE, np.int64)
        skey[:rows] = keys[lo:lo + rows]
        slot, sdest, sbase, routed = _rank_tile_model(skey, n, first[b, :n],
                                                      cap)
        sl = np.arange(routed)
        d = sdest[sl]
        pos = sl + sbase[d]
        out = pos < cap
        assert (pos >= 0).all()
        has = slot[:rows] != NONE
        for i in range(F):
            stage = np.full(len(skey), -9, np.int64)
            stage[slot[:rows][has]] = values(i, np.arange(lo, lo + rows))[has]
            addr = table[d[out]] + i * kept[d[out]] + pos[out]
            mem[addr] = stage[sl[out]]
    got = [mem[t:t + F * k].reshape(F, k) for t, k in zip(table, kept)]
    guard = np.ones(len(mem), bool)
    for t, k in zip(table, kept):
        guard[t:t + F * k] = False
    assert (mem[guard] == -7).all()
    return got


def _route_model(fields, dest, valid, n, cap, tile=TILE):
    """route_count and route_scatter in numpy, rows in tiles of `tile`
    (a multiple of 256: WARPS warps x steps x 32 lanes; the kernels' is
    2048): keys (d, n outside, NONE not valid), each tile's counts, the
    last block's scan, then each tile's scatter.  Returns the buckets and
    the counts."""
    N, F = len(dest), len(fields)
    valid = np.ones(N, bool) if valid is None else valid
    keys = np.where(valid, np.where((dest >= 0) & (dest < n), dest, n), NONE)
    tiles = [(lo, min(tile, N - lo)) for lo in range(0, N, tile)]
    blk = np.stack([np.bincount(keys[lo:lo + r][keys[lo:lo + r] != NONE],
                                minlength=n + 1) for lo, r in tiles])
    first, counts = _scan_tiles_model(blk)
    got = _scatter_model(tiles, tile, keys, lambda i, rows: fields[i][rows],
                         n, F, first, counts, cap)
    return [list(g) for g in got], counts


def _seed_route_model(rec, is_seed, lens, n, cap, tile=SEED_TILE):
    """seed_route_count and seed_route_scatter in numpy, records in tiles of
    `tile` (the kernels' is 512): a record tile makes both views' keys from
    one read (the keep gate, each side's clamped gathers, the seed floor-mod
    n) and counts into two view tiles (query views first, then target
    views); the scatter builds each kept view's fields from its record (the
    target view's columns T_COLS, ends made inclusive)."""
    R = len(rec)
    q, qs, qe, t, ts, te = (rec[:, c] for c in (0, 2, 3, 4, 5, 6))
    keep = (q != t) & (qe - qs >= 500) & (te - ts >= 500)
    top = len(lens) - 1
    sq, st = np.clip(q, 0, top), np.clip(t, 0, top)
    vq = keep & is_seed[sq] & (lens[sq] >= qe)
    vt = keep & is_seed[st] & (lens[st] >= te)
    fmod = lambda x: np.where(np.fmod(x, n) < 0, np.fmod(x, n) + n,
                              np.fmod(x, n))
    keys = np.concatenate([np.where(vq, fmod(q), NONE),
                           np.where(vt, fmod(t), NONE)])
    rt = [(lo, min(tile, R - lo)) for lo in range(0, R, tile)]
    tiles = rt + [(R + lo, r) for lo, r in rt]
    blk = np.stack([np.bincount(keys[lo:lo + r][keys[lo:lo + r] != NONE],
                                minlength=n + 1) for lo, r in tiles])
    first, counts = _scan_tiles_model(blk)

    def values(i, rows):
        side = rows >= R
        col = np.where(side, (T_COLS >> (4 * i)) & 15, i)
        return rec[rows - side * R, col] - (1 if i in (3, 6) else 0)

    got = _scatter_model(tiles, tile, keys, values, n, 8, first, counts, cap)
    return [list(g) for g in got], counts


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


def _tile_for(N, blocks):
    """Rows a tile for about `blocks` tiles over N rows: a multiple of 256
    (WARPS warps x 32 lanes x steps), at most the kernels' TILE."""
    return min(TILE, 256 * max(1, -(-N // blocks // 256)))


def _same_as_plain(got, counts, fields, dest, valid, n, cap):
    t = torch.from_numpy
    want, wcounts = tm.bucketize_plain([t(f) for f in fields], t(dest),
                                       None if valid is None else t(valid),
                                       n, cap)
    assert np.array_equal(counts, wcounts)
    for d in range(n):
        assert len(got[d]) == len(fields)
        for a, b in zip(got[d], want[d]):
            assert np.array_equal(a, b.numpy())
    return wcounts


@pytest.mark.parametrize("case", [c for c in CASES if c != "n0_rows"])
@pytest.mark.parametrize("blocks", [1, 3, 7, 64])
def test_route_kernel_model_equals_plain(case, blocks):
    """The model of route_count and route_scatter at about `blocks` tiles
    equals bucketize_plain, buckets and counts."""
    seed, N, n, F, outside, vp = CASES[case]
    fields, dest, valid = _route_case(seed, N, n, F, outside, vp)
    cap = CAPS[case]
    got, counts = _route_model(fields, dest, valid, n, cap,
                               _tile_for(N, blocks))
    _same_as_plain(got, counts, fields, dest, valid, n, cap)


# (seed, N, n, F, outside, valid_p, cap) at the kernels' tile
TILE_CASES = {
    "n512": (41, 9000, 512, 2, 0.02, 0.9, 10**6),
    "n4096": (42, 12000, 4096, 3, 0.01, 0.95, 10**6),
    "n4096_truncating": (43, 9000, 4096, 1, 0.0, None, 1),
    "cap0": (44, 5000, 8, 4, 0.05, 0.8, 0),
    "all_outside": (45, 3000, 8, 3, 1.0, None, 100),
    "N_not_a_tile_multiple": (46, 3 * 2048 + 777, 8, 5, 0.03, 0.7, 10**6),
    "one_destination_most_rows": (47, 2 * 2048, 8, 4, 0.0, None, 3000),
}


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_route_kernel_model_tile_cases(case):
    """The model at the kernels' tile of 2048 rows: many destinations (a
    tile's keys mostly apart), cap 0, every row outside, a last tile cut
    short, a bucket whose cap cuts inside a tile."""
    seed, N, n, F, outside, vp, cap = TILE_CASES[case]
    fields, dest, valid = _route_case(seed, N, n, F, outside, vp)
    if case == "one_destination_most_rows":
        dest[np.random.default_rng(seed).random(N) < 0.9] = 3
    got, counts = _route_model(fields, dest, valid, n, cap)
    wcounts = _same_as_plain(got, counts, fields, dest, valid, n, cap)
    if case == "all_outside":
        assert wcounts[n] == N and not wcounts[:n].any()
    if case == "cap0":
        assert wcounts[:n].sum() > 0
    if case == "one_destination_most_rows":
        assert wcounts[3] > cap > wcounts[3] - TILE


def test_route_kernel_model_scan_chunks():
    """The model where the last block scans its table in several chunks
    (127 destinations: 48 tiles a chunk; 118 tiles of 256 rows)."""
    fields, dest, valid = _route_case(49, 30000, 127, 2, 0.02, 0.9)
    assert -(-30000 // 256) > 2 * (SCAN_INTS // 128)
    got, counts = _route_model(fields, dest, valid, 127, 10**6, 256)
    _same_as_plain(got, counts, fields, dest, valid, 127, 10**6)


def test_scan_tiles_model_groups():
    """The scan's chunks and groups of tiles, narrow and wide: each tile's
    exclusive prefix and the totals equal a plain cumulative sum, also
    where the tiles are fewer than the groups and over several chunks."""
    rng = np.random.default_rng(48)
    for tiles, n1 in ((1, 2), (5, 9), (650, 9), (1769, 6), (2100, 9),
                      (37, 128), (3, 129), (20, 4097)):
        blk = rng.integers(0, 300, (tiles, n1))
        first, tot = _scan_tiles_model(blk)
        assert np.array_equal(first, np.cumsum(blk, 0) - blk)
        assert np.array_equal(tot, blk.sum(0))
    for n in (1, 7, 256, 300, 4096):
        a = rng.integers(0, 50, n)
        got, total = _block_scan_model(a)
        assert np.array_equal(got, np.cumsum(a) - a) and total == a.sum()


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
    """The views as the seed route's kernels make them, record by record,
    in numpy (the destination a truncated % made non-negative)."""
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
    cols, valid, dest = tds.seed_symmetrize_plain(
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
    tc, tv, _ = tds.seed_symmetrize_plain(torch.from_numpy(rec),
                                          torch.from_numpy(is_seed),
                                          torch.from_numpy(lens), 1)
    trows = tc.numpy()[:, tv.numpy()].T
    order = lambda x: x[np.lexsort(x.T[::-1])]
    assert len(trows) > 100 and int(np.asarray(out[9]).ravel()[0]) == \
        len(trows)
    assert np.array_equal(order(jrows), order(trows))


# ---------------------------------------------------------------------------
# the seed route: seed_route_count and seed_route_scatter


SEED_CASES = {"n1": (1, SEED_TILE, 10**6), "n2": (2, TILE, 10**6),
              "n8": (8, SEED_TILE, 10**6), "n8_truncating": (8, TILE, 150),
              "n512": (512, SEED_TILE, 10**6)}


@pytest.mark.parametrize("case", list(SEED_CASES))
def test_seed_route_model_equals_plain(case):
    """The model of the fused seed route at the kernels' tile and at 2048
    (2500 records, not a multiple of either; ids negative, past the reads
    and equal) equals
    seed_symmetrize_plain then bucketize_plain, buckets and counts."""
    n, tile, cap = SEED_CASES[case]
    rng = np.random.default_rng(50 + n)
    rec, is_seed, lens = _raw_records(rng, 2500, 90, negative=True)
    got, counts = _seed_route_model(rec, is_seed, lens, n, cap, tile)
    t = torch.from_numpy
    want, wcounts = tds.seed_route_plain(t(rec), t(is_seed), t(lens), n, cap)
    assert np.array_equal(counts, wcounts) and wcounts[n] == 0
    for d in range(n):
        assert len(got[d]) == 8
        for a, b in zip(got[d], want[d]):
            assert np.array_equal(a, b.numpy())
    cols, valid, dest = tds.seed_symmetrize_plain(t(rec), t(is_seed),
                                                  t(lens), n)
    assert wcounts.sum() == int(valid.sum()) > 500
    if case == "n8_truncating":
        assert (wcounts[:n] > cap).any()


def test_seed_route_cpu_takes_plain():
    rng = np.random.default_rng(60)
    rec, is_seed, lens = _raw_records(rng, 700, 40)
    t = torch.from_numpy
    args = (t(rec), t(is_seed), t(lens), 4, 90)
    a, ca = tds.seed_route(*args)
    b, cb = tds.seed_route_plain(*args)
    assert np.array_equal(ca, cb)
    for x, y in zip(a, b):
        assert len(x) == 8
        for u, v in zip(x, y):
            assert torch.equal(u, v)


def test_seed_route_equals_jax_step():
    """seed_route on one shard holds the records the JAX package's
    distributed_seed_sort_step (one shard, a cap that drops none) routes
    and sorts, as a multiset, and counts them as its n_sent."""
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
    buckets, counts = tds.seed_route(torch.from_numpy(rec),
                                     torch.from_numpy(is_seed),
                                     torch.from_numpy(lens), 1, 2 * R + 8)
    trows = torch.stack(buckets[0], 1).numpy()
    order = lambda x: x[np.lexsort(x.T[::-1])]
    assert int(np.asarray(out[9]).ravel()[0]) == int(counts.sum()) \
        == len(trows) > 100
    assert np.array_equal(order(jrows), order(trows))
