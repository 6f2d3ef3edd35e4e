"""The overlap engine's device program (nextdenovo_tpu_torch/overlap/engine.py)
split into the plain versions of its three CUDA kernels (engine_anchor_plain,
vote_corridor_plain, chain_emit_plain), against the JAX package's jitted
_vote_emit and _match_block on the CPU, on numpy anchor sets made from a seed
and on a batch of the 30 kb world of tests/test_torch_engine.py; and numpy
models of the kernels' own algorithms (csrc/engine.cu: a thread a minimizer,
its lookup within a bucket of the index's directory, blocks' offsets from
the totals of the blocks before; a warp a group, its runs of bins counted
once into a tile of te.VOTE_TILE runs with a loop for larger groups; a warp
a group walking its corridor segments in one pass) against the plain
versions, on hashes over [0, 2^32) and at the tile's edge, and the group
starts both kernels share; the directory against numpy.  Tolerance: exact,
every record field, n_out and overflow."""
import jax
import numpy as np
import pytest
import torch

from nextdenovo_tpu.io.seqstore import SeqStore as JStore
from nextdenovo_tpu.io.simulate import simulate_genome, simulate_reads
from nextdenovo_tpu.overlap import engine as je
from nextdenovo_tpu_torch import convert
from nextdenovo_tpu_torch.overlap import engine as te

A_PAD = 4096              # the JAX side's anchor slots: one compile a top_k
CAP_OUT = 64
KW = dict(k=15, diag_shift=8, min_cnt=4, min_span=500)
_jvote = jax.jit(je._vote_emit, static_argnames=(
    "k", "diag_shift", "min_cnt", "min_span", "cap_out", "top_k"))


def _anchor_set(rng, n_q, n_t, per, spurious=0.0, spread=300, qlen=20000):
    """(qr, t_rid, t_pos, rel, qpos) int64: per (query, target) one true
    diagonal on a random strand, `per` anchors along it, `spurious` x as
    many at random, in a random order."""
    n = n_q * n_t * per
    qr = np.repeat(np.arange(n_q), n_t * per)
    t_rid = np.tile(np.repeat(np.arange(n_q, n_q + n_t), per), n_q)
    rel = np.repeat(rng.integers(0, 2, n_q * n_t), per)
    off = np.repeat(rng.integers(-qlen, qlen, n_q * n_t), per)
    qpos = rng.integers(0, qlen, n)
    t_pos = np.abs(np.where(rel == 0, qpos - off, off - qpos)
                   + rng.integers(-spread, spread + 1, n))
    m = int(n * spurious)
    cols = [np.concatenate([a, b]) for a, b in zip(
        (qr, t_rid, t_pos, rel, qpos),
        (rng.integers(0, n_q, m), rng.integers(n_q, n_q + n_t, m),
         rng.integers(0, qlen, m), rng.integers(0, 2, m),
         rng.integers(0, qlen, m)))]
    p = rng.permutation(len(cols[0]))
    return tuple(c[p].astype(np.int64) for c in cols)


def _sets():
    rng = np.random.default_rng(41)
    one = tuple(np.array([v], np.int64) for v in (0, 1, 5000, 0, 5300))
    singles = tuple(np.concatenate([a, b]) for a, b in zip(
        _anchor_set(rng, 3, 40, 1), _anchor_set(rng, 3, 10, 8, spread=20)))
    # two bins of 6 anchors a group, far apart: the first bin wins the tie
    qpos = np.concatenate([np.arange(6) * 600, np.arange(6) * 600 + 100])
    t_pos = np.concatenate([qpos[:6] + 1000, qpos[6:] + 9000])
    ties = (np.zeros(12, np.int64), np.ones(12, np.int64), t_pos,
            np.zeros(12, np.int64), qpos)
    # every bin of the group within 2 of the best: rounds 2-4 find -1
    qpos = np.arange(40, dtype=np.int64) * 250
    blank = (np.zeros(40, np.int64), np.full(40, 3, np.int64),
             qpos + 700 + (np.arange(40) % 3) * 256, np.zeros(40, np.int64),
             qpos)
    # more than CAP_OUT records: the overflow is counted
    rnd = _anchor_set(rng, 8, 30, 8, spurious=1.0)
    return {"one anchor": one, "one-anchor groups": singles,
            "tied bins": ties, "all blanked": blank, "random": rnd}


SETS = _sets()


def _torch(a):
    return tuple(torch.from_numpy(x) for x in a)


@pytest.mark.parametrize("top_k", [1, 4])
@pytest.mark.parametrize("name", list(SETS))
def test_vote_emit_equals_jax(name, top_k):
    anchors = SETS[name]
    A = len(anchors[0])
    assert A <= A_PAD
    pad = lambda x: np.concatenate([x, np.zeros(A_PAD - A, x.dtype)])
    take = np.arange(A_PAD) < A
    jrec, jn, jover = _jvote(*(pad(x).astype(np.int32) for x in anchors),
                             take, cap_out=CAP_OUT, top_k=top_k, **KW)
    rec, n, over = te._vote_emit(*_torch(anchors), cap_out=CAP_OUT,
                                 top_k=top_k, **KW)
    assert (n, over) == (int(jn), int(jover))
    for f in te.REC_FIELDS:
        assert np.array_equal(np.asarray(jrec[f])[:n], rec[f].numpy()), f
    if name == "random":
        assert over > 0
    if name == "tied bins":
        assert n == 1


def test_match_block_equals_jax():
    """One batch of the 30 kb world, top_k 4, the pair-once gate on, one
    read cut into two halo rows: _match_block's records through the plain
    engine_anchor and vote kernels equal the JAX package's jitted
    _match_block."""
    g = simulate_genome(30_000, seed=3)
    sim = simulate_reads(g, coverage=12, mean_len=3000, error_rate=0.10,
                         seed=4)
    js = JStore.from_codes(sim.reads)
    ts = convert.seqstore_from_arrays(js.words, js.word_start, js.length,
                                      js.names)
    rids = np.arange(len(js))
    k, w = 15, 5
    jidx = je.build_index(js, rids, k=k, w=w, max_occ=64)
    tidx = te.build_index(ts, rids, k=k, w=w, max_occ=64, device="cpu")
    lens = np.asarray(js.length)
    r0 = int(np.argmax(lens))
    L, half = int(lens[r0]), int(lens[r0]) // 2
    # a read in two rows as _chunk_rows cuts one: each owns half, with halos
    rows = [(r0, 0, 0, half, half + w + k - 2),
            (r0, half - (w - 1), w - 1, L - half + w - 1, L - half + w - 1),
            (int(rids[1]), 0, 0, int(lens[1]), int(lens[1])),
            (int(rids[2]), 0, 0, int(lens[2]), int(lens[2]))]
    qmask = (lens >= 2500).astype(np.int8)
    cap = 2 * len(rows) * 4096 // w + 1024
    jm = je._sketch_rows(js, rows, k, w, len(rows), cap=cap)
    tm = te._sketch_rows(ts, rows, k, w, cap, "cpu")
    base = np.array([r[0] for r in rows], np.int32)
    pbase = np.array([r[1] for r in rows], np.int32)
    kw = dict(k=k, max_occ=16, diag_shift=8, min_cnt=4, min_span=500,
              cap_out=256, top_k=4)
    packed, meta = je._match_block(jm.rid, jm.pos, jm.hash, jm.strand,
                                   base, pbase, qmask, jidx, **kw)
    rec, n, over = te._match_block(
        tm.rid, tm.pos, tm.hash, tm.strand, torch.from_numpy(base).long(),
        torch.from_numpy(pbase).long(), torch.from_numpy(qmask), tidx, **kw)
    assert (n, over) == (int(meta[0]), int(meta[1])) and n > 10
    packed = np.asarray(packed)
    for i, f in enumerate(te.REC_FIELDS):
        assert np.array_equal(packed[i, :n], rec[f].numpy()), f
    assert int(rec["qname"].eq(r0).sum()) > 0


def test_empty_inputs():
    """No minimizer gives no anchor, no anchor no record; the plain vote
    and chain versions take empty tensors."""
    e = torch.zeros(0, dtype=torch.int64)
    idx = (torch.tensor([5, 9], dtype=torch.int64),
           torch.tensor([0, 1], dtype=torch.int32),
           torch.tensor([0, 0], dtype=torch.int32))
    out = te.engine_anchor(e, e, e, e, torch.zeros(2, dtype=torch.int64),
                           torch.zeros(2, dtype=torch.int64),
                           torch.zeros(2, dtype=torch.int8), *idx, max_occ=16)
    assert len(out) == 5 and all(x.shape == (0,) for x in out)
    assert te._vote_emit(*out, cap_out=8, top_k=4, **KW)[1:] == (0, 0)
    k2, q2 = te.vote_corridor(e, e, e, e, e, diag_shift=8, top_k=4)
    assert k2.shape == q2.shape == (0,)
    emit, rec = te.chain_emit(e, e, e, e, k=15, top_k=4, min_cnt=4,
                              min_span=500)
    assert emit.shape == (0,) and rec.shape == (8, 0)


# ---------------------------------------------------------------------------
# numpy models of the CUDA kernels' algorithms (csrc/engine.cu)

FULL = 0xFFFFFFFF


def _lower_bound(a, lo, hi, x):
    while lo < hi:                        # first i in [lo, hi): a[i] >= x
        mid = lo + ((hi - lo) >> 1)
        if a[mid] < x:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _directory(ih):
    """anchor_directory in numpy: the first entry of hash >= i << (32 - b),
    and the shift 32 - b."""
    s = 32 - te.directory_bits(len(ih))
    b = np.arange((1 << (32 - s)) + 1, dtype=np.int64) << s
    return np.searchsorted(ih, b, "left"), s


def _anchor_model(args, max_occ, threads=te.ANCHOR_THREADS):
    """engine_anchor_kernel: a thread a minimizer, its first entry by a
    lower bound within its bucket of the directory (the whole index for a
    hash outside [0, 2^32)), its count by the run of equal entries from
    there (at most max_occ, none past the bucket), the three gates' verdicts
    as a mask of the first 32 occurrences (past them, the gates again); the
    exclusive scan of the taken counts within blocks of `threads`, each
    block's offset the totals of the blocks before it.  Every output slot is
    written exactly once."""
    (rid, pos, h, strand, rbase, pbase, qmask, ih, irid, ipos) = (
        x.numpy().astype(np.int64) for x in args)
    H, M = len(ih), len(h)
    bucket, shift = _directory(ih)
    lo = np.zeros(M, np.int64)
    cnt = np.zeros(M, np.int64)
    take = np.zeros(M, np.int64)
    mask = np.zeros(M, np.int64)
    qg = rbase[rid] if M else np.zeros(0, np.int64)
    gate = lambda a, m: not (irid[a] == qg[m] or irid[a] < 0 or (
        qmask[irid[a]] > 0 and irid[a] < qg[m]))
    for m in range(M):
        b0, b1 = 0, H
        if 0 <= h[m] <= FULL:
            b0, b1 = bucket[h[m] >> shift], bucket[(h[m] >> shift) + 1]
        lo[m] = _lower_bound(ih, b0, b1, h[m])
        while (cnt[m] < max_occ and lo[m] + cnt[m] < b1
               and ih[lo[m] + cnt[m]] == h[m]):
            cnt[m] += 1
        taken = [gate(lo[m] + o, m) for o in range(cnt[m])]
        take[m] = sum(taken)
        mask[m] = sum(1 << o for o, t in enumerate(taken[:32]) if t)
    nb = -(-M // threads)
    blocks = np.zeros(nb * threads, np.int64)
    blocks[:M] = take
    blocks = blocks.reshape(nb, threads)
    off = (np.cumsum(blocks, 1) - blocks).reshape(-1)[:M]
    btot = blocks.sum(1)
    out = np.zeros((5, int(btot.sum())), np.int64)
    written = np.zeros(out.shape[1], np.int64)
    for m in range(M):
        w = int(btot[: m // threads].sum() + off[m])
        for o, a in enumerate(range(lo[m], lo[m] + cnt[m])):
            if (mask[m] >> o) & 1 if o < 32 else gate(a, m):
                out[:, w] = (qg[m], irid[a], ipos[a] & ((1 << 30) - 1),
                             (strand[m] ^ (ipos[a] >> 30)) & 1,
                             pos[m] + pbase[rid[m]])
                written[w] += 1
                w += 1
    assert (written == 1).all()
    return list(out)


def _group_starts(*keys):
    s = np.arange(len(keys[0])) == 0
    for kk in keys:
        s[1:] |= kk[1:] != kk[:-1]
    return np.append(np.nonzero(s)[0], len(keys[0]))


def _run_key(cnt, off):
    return ((int(cnt) + 1) << 32) | (FULL - int(off))


def _vote_runs(kb, tile):
    """vote_runs: one pass over a group's key_b in 32s, run starts where
    key_b >> 10 changes (the previous 32's last bin carried to lane 0), a
    run's count its next start's offset less its own: in the same 32 by the
    ballot, else when a later 32's first start (or the group's end) closes
    the open run.  Returns the tile's (keys, bins relative to the first),
    or None once the runs outgrow the tile."""
    n = len(kb)
    d = kb >> 10
    keys, bins = {}, {}
    R = open_idx = open_off = carry = 0
    for base in range(0, n, 32):
        i = base + np.arange(32)
        inn = i < n
        dl = np.where(inn, d[np.minimum(i, n - 1)], 0)
        dp = np.concatenate([[carry], dl[:-1]])
        lanes = np.nonzero(inn & ((i == 0) | (dl != dp)))[0]
        if len(lanes):
            if base and open_idx < tile:
                keys[open_idx] = _run_key(base + lanes[0] - open_off,
                                          open_off)
            for r, lane in enumerate(lanes):
                if R + r < tile:
                    bins[R + r] = int(dl[lane] - d[0])
                    if r + 1 < len(lanes):
                        keys[R + r] = _run_key(lanes[r + 1] - lane,
                                               base + lane)
            open_idx, open_off = R + len(lanes) - 1, base + lanes[-1]
            R += len(lanes)
            if R > tile:
                return None
        carry = dl[31]
    keys[open_idx] = _run_key(n - open_off, open_off)
    return [keys[j] for j in range(R)], [bins[j] for j in range(R)]


def _vote_model(key_q, key_t, key_b, diag, qpos, diag_shift, top_k,
                tile=te.VOTE_TILE):
    """vote_corridor_kernel: per group the runs counted once into a tile of
    `tile` runs, top_k rounds of a packed argmax over it (a round's bin
    blanks the runs within 2 of it in place); a group of more runs (or of
    bins 2^31 apart) takes the loop over the group, each run's end by binary
    search, every round.  Then each anchor's corridor."""
    width = 1 << diag_shift
    key_t2 = np.empty_like(key_t)
    qp2 = np.empty_like(qpos)
    gs = _group_starts(key_q, key_t)
    for s, e in zip(gs[:-1], gs[1:]):
        kb = key_b[s:e]
        d = kb >> 10
        bb, ok, prim = [], [], 0
        t = _vote_runs(kb, tile) if d[-1] - d[0] <= te.I32MAX else None
        if t is not None:
            keys, bins = t
            for r in range(top_k):
                if r:
                    keys = [k_ & FULL if abs(b - bins_r) <= 2 else k_
                            for k_, b in zip(keys, bins)]
                j = int(np.argmax(keys))
                assert keys.count(keys[j]) == 1   # offsets make keys unique
                bc, bins_r = (keys[j] >> 32) - 1, bins[j]
                bb.append(int(d[0]) + bins_r)
                prim = bc if r == 0 else prim
                ok.append(bc * 2 >= prim and bc > 0)
        else:
            runs = [0] + list(np.nonzero(d[1:] != d[:-1])[0] + 1)
            for r in range(top_k):
                best = 0
                for i in runs:
                    cur = int(np.searchsorted(kb[i + 1:], (d[i] + 1) * 1024)) + 1
                    if any(abs(int(d[i]) - b) <= 2 for b in bb):
                        cur = -1
                    best = max(best, _run_key(cur, i))
                bc, first = (best >> 32) - 1, FULL - (best & FULL)
                bb.append(int(d[first]))
                prim = bc if r == 0 else prim
                ok.append(bc * 2 >= prim and bc > 0)
        for i in range(s, e):
            corr, bestd = top_k, 1 << 30
            for r in range(top_k):
                di = abs(int(diag[i]) - ((bb[r] - (1 << 20)) * width
                                         + width // 2))
                if ok[r] and di <= width and di < bestd:
                    corr, bestd = r, di
            key_t2[i] = key_t[i] * (top_k + 1) + corr
            qp2[i] = qpos[i] if corr < top_k else te.I32MAX
    return key_t2, qp2


def _link_q(dq, dt, k):
    """The quantised link score, in PyTorch's float32 steps."""
    dq, dt = torch.tensor(dq), torch.tensor(dt)
    dd = torch.abs(dq - dt).to(torch.float32)
    alpha = torch.clamp(torch.minimum(dq, dt), max=k).to(torch.float32)
    beta = 0.01 * k * dd + 0.5 * torch.log2(dd + 1.0)
    return torch.round(torch.clamp(alpha - beta, min=0.0) * 8.0).to(
        torch.int64).numpy()


def _chain_model(kq2, kt2, qp2, tp2, k, top_k, min_cnt, min_span,
                 gstart=None):
    """chain_emit_kernel: per group (gstart's, by default the (key_q,
    t_rid * 2 + rel) runs) one pass in 32s; a lane's link to the anchor
    before it (shuffled, or carried from the previous 32); every anchor
    written zero; per corridor present in the 32 the warp reduces the link
    sum, near count and int32 extents (identity values outside the
    corridor, the plain version's +-2^30 for an anchor without one), and
    lane c keeps corridor c's; at the group's end each corridor's record
    goes to its last anchor, corridor 0's extent suppressing the others."""
    kc, inf = top_k + 1, 1 << 30
    imax, imin = 2**31 - 1, -2**31
    A = len(kq2)
    emit = np.zeros(A, bool)
    rec = np.zeros((8, A), np.int64)
    gs = _group_starts(kq2, kt2 // kc) if gstart is None else gstart
    for s, e in zip(gs[:-1], gs[1:]):
        if s >= e:
            break
        key_tq = int(kt2[s]) // kc
        acc = {}                  # corridor: [sum, cnt, qmin, qmax, tmin,
        cq, ct, cc = te.I32MAX, 0, -1  # tmax, last, last near]
        for base in range(s, e, 32):
            i = base + np.arange(32)
            inn = i < e
            ii = np.minimum(i, e - 1)
            q = np.where(inn, qp2[ii], te.I32MAX)
            t = np.where(inn, tp2[ii], 0)
            c = np.where(inn, kt2[ii] - key_tq * kc, -1)
            pq, pt, pc = (np.concatenate([[x0], x[:-1]])
                          for x0, x in ((cq, q), (ct, t), (cc, c)))
            near = inn & (q != te.I32MAX)
            link = (near & (i > s) & (pc == c) & (pq != te.I32MAX)
                    & (q > pq) & (t > pt))
            lq = np.zeros(32, np.int64)
            if link.any():
                lq[link] = _link_q(q[link] - pq[link], t[link] - pt[link], k)
            for x in sorted(set(c[inn].tolist())):
                mine = inn & (c == x)
                hi = int(np.nonzero(mine)[0].max())
                r = [int(lq[mine].sum()), int((mine & near).sum()),
                     int(np.where(mine, np.where(near, q, inf), imax).min()),
                     int(np.where(mine, np.where(near, q, -inf), imin).max()),
                     int(np.where(mine, np.where(near, t, inf), imax).min()),
                     int(np.where(mine, np.where(near, t, -inf), imin).max())]
                a = acc.setdefault(x, [0, 0, imax, imin, imax, imin, -1, 0])
                a[:6] = [a[0] + r[0], a[1] + r[1], min(a[2], r[2]),
                         max(a[3], r[3]), min(a[4], r[4]), max(a[5], r[5])]
                a[6], a[7] = base + hi, bool(near[hi])
            cq, ct, cc = q[31], t[31], c[31]
        a0 = acc.get(0, [0, 0, 0, 0])
        qs0, qe0 = ((a0[2], a0[3] + k) if a0[1] > 0 else (-inf, -inf))
        for x, (total, cnt, qmin, qmax, tmin, tmax, last, lnear) in acc.items():
            qs, qe, ts, te_ = qmin, qmax + k, tmin, tmax + k
            oq = min(qe, qe0) - max(qs, qs0)
            span = min(qe - qs, te_ - ts)
            if (lnear and (x == 0 or oq * 2 < qe - qs) and cnt >= min_cnt
                    and span >= min_span):
                emit[last] = True
                rec[:, last] = (kq2[s], key_tq & 1, qs, qe, key_tq >> 1,
                                ts, te_, min(total // 8 + k, span))
    return emit, rec


def _runs_group(rng, lens, q=0, t=1, spacing=(1, 2, 3, 5)):
    """One forward (query q, target t) group whose diagonal bins are
    len(lens) runs of lens[j] anchors each, bins spaced by a random choice
    of `spacing` (so that the +-2 blanking takes some neighbours), each run
    on a query window of its own (so that secondary corridors make
    records); the diagonals are negative (targets ahead of the query)."""
    lens = np.asarray(lens)
    bins = np.cumsum(rng.choice(spacing, len(lens)))
    n = int(lens.sum())
    diag = (np.repeat(bins, lens) * 256 + rng.integers(0, 256, n)) - (1 << 20)
    # run j's anchors at query positions [2000 j, 2000 j + 2000)
    qpos = (np.repeat(np.arange(len(lens)), lens) * 2000
            + rng.integers(0, 2000, n))
    return (np.full(n, q), np.full(n, t), qpos - diag, np.zeros(n, np.int64),
            qpos)


def _cat(*sets):
    return tuple(np.concatenate(c).astype(np.int64) for c in zip(*sets))


def _tile_sets():
    """Sets at the vote tile's edge (te.VOTE_TILE runs): groups of tile - 1,
    tile and tile + 1 runs, one of 2 x tile, many one-anchor groups around
    one group past the tile, and runs of more than 32 anchors that start and
    end on a 32's edges."""
    rng = np.random.default_rng(47)
    T = te.VOTE_TILE
    # runs of 1-3 anchors, a few of 6-11 that win the rounds
    few = lambda n: np.where(rng.random(n) < 0.03, rng.integers(6, 12, n),
                             rng.integers(1, 4, n))
    edge = _cat(*(_runs_group(rng, few(n), t=t)
                  for t, n in ((1, T - 1), (2, T), (3, T + 1))))
    twice = _runs_group(rng, few(2 * T), t=4)
    singles = _cat(*(_runs_group(rng, [1], t=t) for t in range(5, 400)
                     if t != 200),
                   _runs_group(rng, few(T + 7), t=200))
    long_ = _cat(_runs_group(rng, [33, 31, 32, 64, 1, 70, 2, 32, 40], t=7,
                             spacing=(3,)),
                 _runs_group(rng, [5, 27, 64, 33], q=1, t=7, spacing=(4,)))
    return {f"{T - 1}, {T}, {T + 1} runs": edge, f"{2 * T} runs": twice,
            "one-anchor groups around one past the tile": singles,
            "long runs on 32 edges": long_}


TILE_SETS = _tile_sets()


@pytest.mark.parametrize("top_k", [1, 4])
@pytest.mark.parametrize("name", ["one-anchor groups", "all blanked",
                                  "random"])
def test_vote_and_chain_models_equal_plain(name, top_k):
    """The vote and chain kernels' algorithms, modelled, give the plain
    versions' tensors on the inputs _vote_emit hands them: the vote at the
    kernel's tile and at a tile of 2 runs (groups of more runs take the
    loop), the chain on the first sort's group starts."""
    vi = te._vote_inputs(*_torch(SETS[name]), diag_shift=8)
    k2, q2 = te.vote_corridor_plain(*vi[:5], diag_shift=8, top_k=top_k)
    for tile in (te.VOTE_TILE, 2):
        mk2, mq2 = _vote_model(*(x.numpy() for x in vi[:5]), 8, top_k, tile)
        assert np.array_equal(mk2, k2.numpy())
        assert np.array_equal(mq2, q2.numpy())
    ci = te._chain_inputs(vi[0], k2, q2, vi[5])
    emit, rec = te.chain_emit_plain(*ci, k=15, top_k=top_k, min_cnt=4,
                                    min_span=500)
    memit, mrec = _chain_model(*(x.numpy() for x in ci), 15, top_k, 4, 500,
                               te.group_starts(vi[0], vi[1]).numpy())
    assert np.array_equal(memit, emit.numpy())
    assert np.array_equal(mrec, rec.numpy())
    assert name != "random" or emit.sum() > CAP_OUT


@pytest.mark.parametrize("top_k", [1, 4, 8])
@pytest.mark.parametrize("name", list(TILE_SETS))
def test_tile_edge_models_equal_plain(name, top_k):
    """At the vote tile's edge (te.VOTE_TILE runs a group, below, at and
    past it), with runs longer than 32 anchors on a 32's edges: the vote
    model (tile path and loop) and the chain model on the first sort's
    group starts give the plain versions' tensors; every group past the
    tile takes the loop."""
    vi = te._vote_inputs(*_torch(TILE_SETS[name]), diag_shift=8)
    kb = vi[2].numpy()
    gs = _group_starts(vi[0].numpy(), vi[1].numpy())
    runs = [len(np.unique(kb[s:e] >> 10)) for s, e in zip(gs[:-1], gs[1:])]
    assert max(runs) >= te.VOTE_TILE - 1 or name.startswith("long runs")
    past = [r > te.VOTE_TILE for r in runs]
    assert [_vote_runs(kb[s:e], te.VOTE_TILE) is None
            for s, e in zip(gs[:-1], gs[1:])] == past
    k2, q2 = te.vote_corridor_plain(*vi[:5], diag_shift=8, top_k=top_k)
    mk2, mq2 = _vote_model(*(x.numpy() for x in vi[:5]), 8, top_k)
    assert np.array_equal(mk2, k2.numpy()) and np.array_equal(mq2, q2.numpy())
    ci = te._chain_inputs(vi[0], k2, q2, vi[5])
    emit, rec = te.chain_emit_plain(*ci, k=15, top_k=top_k, min_cnt=4,
                                    min_span=500)
    memit, mrec = _chain_model(*(x.numpy() for x in ci), 15, top_k, 4, 500,
                               te.group_starts(vi[0], vi[1]).numpy())
    assert np.array_equal(memit, emit.numpy())
    assert np.array_equal(mrec, rec.numpy())


@pytest.mark.parametrize("top_k", [1, 4, 8])
@pytest.mark.parametrize("name", list(SETS) + list(TILE_SETS))
def test_group_starts_shared(name, top_k):
    """The premise of handing chain_emit vote_corridor's group starts: the
    (key_q, key_t) groups of the first sort's order and the (key_q,
    key_t2 // (top_k + 1)) groups of the second's are the same index
    ranges (the second sort permutes anchors only inside a group).  And
    group_starts gives them, then A to the end."""
    vi = te._vote_inputs(*_torch((SETS | TILE_SETS)[name]), diag_shift=8)
    k2, q2 = te.vote_corridor_plain(*vi[:5], diag_shift=8, top_k=top_k)
    kq2, kt2, _, _ = te._chain_inputs(vi[0], k2, q2, vi[5])
    A = vi[0].shape[0]
    first = _group_starts(vi[0].numpy(), vi[1].numpy())
    second = _group_starts(kq2.numpy(), kt2.numpy() // (top_k + 1))
    assert np.array_equal(first, second)
    for gs in (te.group_starts(vi[0], vi[1]),
               te.group_starts(kq2, kt2 // (top_k + 1))):
        want = np.full(A + 1, A)
        want[: len(first) - 1] = first[:-1]
        assert np.array_equal(gs.numpy(), want)
    if name in ("random", "one-anchor groups"):
        assert (vi[3] < 0).any() and (np.diff(first) == 1).any()


@pytest.mark.parametrize("top_k", [1, 4, 8])
def test_chain_model_equals_plain_on_sorted_keys(top_k):
    """chain_emit on any keys in the second sort's order, not only the
    vote's: corridors of every digit with anchors without a corridor
    (I32MAX) among them, and targets that follow the queries closely across
    corridor boundaries, so that a link there would score; the model on the
    (key_q, key_t2 // (top_k + 1)) starts gives the plain version's
    tensors."""
    rng = np.random.default_rng(53 + top_k)
    n, kc = 3000, top_k + 1
    kq2 = rng.integers(0, 4, n)
    kt2 = rng.integers(0, 30, n) * kc + rng.integers(0, kc, n)
    qp2 = np.where(rng.random(n) < 0.1, te.I32MAX, rng.integers(0, 20000, n))
    tp2 = np.abs(qp2 % te.I32MAX + 1000 + rng.integers(-40, 41, n))
    order = np.lexsort((tp2, qp2, kt2, kq2))
    ci = tuple(np.asarray(x[order], np.int64) for x in (kq2, kt2, qp2, tp2))
    emit, rec = te.chain_emit_plain(*_torch(ci), k=15, top_k=top_k,
                                    min_cnt=4, min_span=500)
    memit, mrec = _chain_model(*ci, 15, top_k, 4, 500)
    assert np.array_equal(memit, emit.numpy())
    assert np.array_equal(mrec, rec.numpy())
    assert emit.sum() > 20


def _anchor_index(rng, hashes, n_reads=50):
    """A sorted index of these int64 hashes: hash 0xFFFFFFFF rows are filter
    rows (rid -1), the others random rids, positions and strands."""
    h = np.sort(np.asarray(hashes, np.int64))
    irid = np.where(h == FULL, -1, rng.integers(0, n_reads, len(h)))
    ipos = rng.integers(0, 20000, len(h)) | (rng.integers(0, 2, len(h)) << 30)
    return h, irid.astype(np.int32), ipos.astype(np.int32)


def _anchor_args(rng, index, qh, n_reads=50):
    """engine_anchor's arguments for the query hashes qh against index: six
    rows (read 3 thrice, with position bases), the pair-once gate on about
    half the reads."""
    M = len(qh)
    qmask = (rng.random(n_reads) < 0.5).astype(np.int8)
    return (rng.integers(0, 6, M).astype(np.int64),
            rng.integers(0, 16384, M).astype(np.int64),
            np.asarray(qh, np.int64), rng.integers(0, 2, M).astype(np.int64),
            np.array([3, 3, 17, 20, 41, 3], np.int64),
            np.array([0, 15000, 0, 0, 0, 30000], np.int64), qmask) + index


def _anchor_sets():
    """{case: (engine_anchor's arguments as numpy, max_occ)}.  A synthetic
    index of small hashes (all in the directory's first bucket: runs of more
    than max_occ entries, filter rows at the end, self hits, the pair-once
    gate on half the reads, absent hashes, minimizers of hash 0xFFFFFFFF,
    one read in three rows) at max_occ 16 and 1 and with the gate off; then
    hashes over [0, 2^32), each set checked for what it holds."""
    rng = np.random.default_rng(43)
    n_reads, H, M = 50, 2000, 1500
    h = np.concatenate([np.sort(rng.integers(0, 300, H - 20)) * 7,
                        np.full(20, 0xFFFFFFFF)]).astype(np.int64)
    irid = np.concatenate([rng.integers(0, n_reads, H - 20),
                           np.full(20, -1)]).astype(np.int32)
    ipos = (rng.integers(0, 20000, H) | (rng.integers(0, 2, H) << 30)
            ).astype(np.int32)
    qh = (rng.integers(0, 330, M) * 7 + (rng.random(M) < 0.1)).astype(np.int64)
    qh[:5] = 0xFFFFFFFF
    qmask = (rng.random(n_reads) < 0.5).astype(np.int8)
    small = (rng.integers(0, 6, M).astype(np.int64),
             rng.integers(0, 16384, M).astype(np.int64), qh,
             rng.integers(0, 2, M).astype(np.int64),
             np.array([3, 3, 17, 20, 41, 3], np.int64),
             np.array([0, 15000, 0, 0, 0, 30000], np.int64), qmask,
             h, irid, ipos)
    sets = {"max_occ 16": (small, 16), "max_occ 1": (small, 1),
            "gate off": (small[:6] + (np.zeros(n_reads, np.int8),)
                         + small[7:], 16)}
    uni = lambda n: rng.integers(0, 1 << 32, n)
    pick = lambda a, n: rng.choice(np.asarray(a, np.int64), n)
    s = 32 - te.directory_bits(2000)
    # hashes at the bucket edges i << s - 1, i << s, i << s + 1, each 1-3
    # times; queries at the edges +-2 of these buckets and of others
    ed = rng.choice(np.arange(1, 1 << (32 - s)), 60, replace=False)
    edge = (ed[:, None] << s) + np.array([-1, 0, 1])
    edge = np.repeat(edge.ravel(), rng.integers(1, 4, edge.size))
    idx = _anchor_index(rng, np.concatenate([edge, uni(2000 - len(edge))]))
    near = (np.concatenate([ed, rng.integers(1, 1 << (32 - s), 40)])[:, None]
            << s) + np.arange(-2, 3)
    sets["bucket edges"] = (_anchor_args(rng, idx, pick(near.ravel(), 1500)),
                            16)
    # 600 entries in five buckets of 2^7: the others empty
    s7 = 32 - te.directory_bits(600)
    few = (rng.choice(1 << (32 - s7), 5, replace=False)[:, None] << s7
           ) + rng.integers(0, 1 << s7, (5, 120))
    idx = _anchor_index(rng, few.ravel())
    sets["empty buckets"] = (_anchor_args(rng, idx, np.concatenate(
        [uni(700), pick(few.ravel(), 300)])), 16)
    # 150 entries (distinct hashes and runs) in one bucket
    full_b = (77 << s) + np.repeat(rng.choice(1 << s, 100, replace=False),
                                   rng.integers(1, 3, 100))[:150]
    idx = _anchor_index(rng, np.concatenate([full_b, uni(2000 - len(full_b))]))
    sets["a bucket of more than 32 entries"] = (_anchor_args(
        rng, idx, np.concatenate([pick(full_b, 600), pick(full_b, 300) + 1,
                                  uni(333)])), 16)
    # 400 filter rows at the end and 30 entries just below them, in the
    # last bucket
    top = FULL - rng.integers(1, 40, 30)
    idx = _anchor_index(rng, np.concatenate([np.full(400, FULL), top,
                                             uni(1570)]))
    sets["hundreds of filter rows"] = (_anchor_args(rng, idx, np.concatenate(
        [np.full(50, FULL), pick(top, 300), FULL - rng.integers(0, 60, 300),
         pick(idx[0], 350)])), 16)
    # runs of 20-40 entries, and the largest hash's run ending at H
    runs = np.repeat(uni(30), rng.integers(20, 41, 30))
    last = np.full(25, runs.max() + 3)
    idx = _anchor_index(rng, np.concatenate([runs, last]))
    sets["runs past max_occ, one ending at H"] = (_anchor_args(
        rng, idx, np.concatenate([pick(runs, 500), last[:200], uni(77)])), 16)
    sets["runs past 32 at max_occ 40"] = (
        sets["runs past max_occ, one ending at H"][0], 40)
    # negative hashes and hashes of 2^32 and more, in the index and queried
    odd = np.array([-(1 << 40), -7, -1, 1 << 32, (1 << 32) + 5, 1 << 45],
                   np.int64)
    idx = _anchor_index(rng, np.concatenate([np.repeat(odd, 3), uni(1900),
                                             np.full(50, FULL)]))
    sets["hashes past 2^32 and negative"] = (_anchor_args(
        rng, idx, np.concatenate([pick(odd, 300), odd + 1, -odd[3:],
                                  pick(idx[0], 600)])), 16)
    sets["no minimizer"] = (_anchor_args(rng, idx, np.zeros(0, np.int64)), 16)
    return sets


ANCHOR_SETS = _anchor_sets()


def _bucket_sizes(ih):
    return np.diff(_directory(ih)[0])


@pytest.mark.parametrize("case", list(ANCHOR_SETS))
def test_engine_anchor_model_equals_plain(case):
    """engine_anchor_kernel, modelled (the directory, the bounded
    scan, the taken mask, the block offsets from per-block totals at the
    kernel's block size and at 32), give the plain version's anchors in
    order: on a synthetic index
    of small hashes (runs of more than max_occ entries, filter rows, self
    hits, the pair-once gate, absent hashes, 0xFFFFFFFF minimizers, a read
    in three rows) and on hashes over [0, 2^32): at bucket edges, in empty
    buckets, in a bucket of more than 32 entries, among hundreds of filter
    rows, in runs past max_occ and one ending at H (also at max_occ 40, past
    the mask's 32), negative and of 2^32 and more; M not a multiple of the
    block, and M = 0."""
    args, max_occ = ANCHOR_SETS[case]
    args = _torch(args)
    got = te.engine_anchor(*args, max_occ=max_occ)
    for threads in (te.ANCHOR_THREADS, 32):
        want = _anchor_model(args, max_occ, threads)
        for x, y in zip(want, got):
            assert np.array_equal(x, y.numpy())
    M, ih, qh = len(args[0]), args[7].numpy(), args[2].numpy()
    sizes = _bucket_sizes(ih)
    assert M % 32 and M % te.ANCHOR_THREADS or case == "no minimizer"
    assert (len(want[0]) > 100) == (case != "no minimizer")
    if case == "bucket edges":
        s = 32 - te.directory_bits(len(ih))
        assert ((qh & ((1 << s) - 1)) == 0).sum() > 100
        assert ((qh & ((1 << s) - 1)) == (1 << s) - 1).sum() > 100
    if case == "empty buckets":
        assert (sizes == 0).mean() > 0.9 and (qh > 0).all()
    if case == "a bucket of more than 32 entries":
        assert sizes.max() > 100
    if case == "hundreds of filter rows":
        assert (ih == FULL).sum() == 400 and sizes[-1] > 400
    if case.startswith("runs past"):
        assert (qh == ih[-1]).any() and (ih == ih[-1]).sum() > 16
        assert (np.bincount(np.unique(ih, return_inverse=True)[1]) > 33).any()
    if case == "hashes past 2^32 and negative":
        assert (qh < 0).any() and (qh > FULL).any()
        assert (ih < 0).any() and (ih > FULL).any()


@pytest.mark.parametrize("H", [0, 1, 8, 9, 2000, 70_000])
def test_anchor_directory(H):
    """anchor_directory equals np.searchsorted of the buckets' bounds i <<
    (32 - b) into the index hashes (filter rows and a repeated hash among
    them), in int32, with b the least that leaves at most 8 entries a
    bucket on average."""
    rng = np.random.default_rng(H)
    h = np.sort(np.concatenate([rng.integers(0, 1 << 32, H - H // 10),
                                np.full(H // 10, FULL)]))
    if H > 8:
        h[: H // 5] = h[H // 5]
    got = te.anchor_directory(torch.from_numpy(h))
    want, s = _directory(h)
    b = 32 - s
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert H <= 8 << b and (b == 0 or H > 8 << (b - 1))
    assert [te.directory_bits(n) for n in (10_128_568, 1 << 40)] == [21, 24]


def test_match_block_with_and_without_directory():
    """_match_block gives the same records with find_overlaps' directory
    handed in and with engine_anchor making its own; a directory of the
    wrong size is refused."""
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    g = simulate_genome(20_000, seed=5)
    sim = simulate_reads(g, coverage=8, mean_len=2500, error_rate=0.10,
                         seed=6)
    ts = SeqStore.from_codes(sim.reads)
    k, w = 15, 5
    idx = te.build_index(ts, np.arange(len(ts)), k=k, w=w, max_occ=64,
                         device="cpu")
    rows = te._chunk_rows(np.arange(6), np.asarray(ts.length), k, w)
    m = te._sketch_rows(ts, rows, k, w, 2 * len(rows) * 4096 // w + 1024,
                        "cpu")
    base = torch.tensor([r[0] for r in rows], dtype=torch.int64)
    pbase = torch.tensor([r[1] for r in rows], dtype=torch.int64)
    qmask = torch.ones(len(ts), dtype=torch.int8)
    kw = dict(k=k, max_occ=16, diag_shift=8, min_cnt=4, min_span=500,
              cap_out=256, top_k=4)
    call = lambda **b: te._match_block(m.rid, m.pos, m.hash, m.strand, base,
                                       pbase, qmask, idx, **kw, **b)
    (r0, n0, o0), (r1, n1, o1) = call(), call(bucket=te.anchor_directory(
        idx.h))
    assert (n0, o0) == (n1, o1) and n0 > 5
    for f in te.REC_FIELDS:
        assert torch.equal(r0[f], r1[f]), f
    with pytest.raises(ValueError, match="bucket"):
        call(bucket=torch.zeros(3, dtype=torch.int32))
