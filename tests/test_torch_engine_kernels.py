"""The overlap engine's device program (nextdenovo_tpu_torch/overlap/engine.py)
split into the plain versions of its three CUDA kernels (engine_anchor_plain,
vote_corridor_plain, chain_emit_plain), against the JAX package's jitted
_vote_emit and _match_block on the CPU, on numpy anchor sets made from a seed
and on a batch of the 30 kb world of tests/test_torch_engine.py; and numpy
models of the kernels' own algorithms (csrc/engine.cu: a thread a minimizer,
a warp a group walking runs of bins and corridor segments) against the plain
versions.  Tolerance: exact, every record field, n_out and overflow."""
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


def _anchor_model(args, max_occ):
    """engine_anchor_kernel: a thread a minimizer, the binary searches, the
    first max_occ occurrences, the three gates; offsets by cumsum."""
    (rid, pos, h, strand, rbase, pbase, qmask, ih, irid, ipos) = (
        x.numpy().astype(np.int64) for x in args)
    out = [[] for _ in range(5)]
    for m in range(len(h)):
        lo = int(np.searchsorted(ih, h[m], "left"))
        cnt = min(int(np.searchsorted(ih, h[m], "right")) - lo, max_occ)
        qg = rbase[rid[m]]
        for a in range(lo, lo + cnt):
            tr = irid[a]
            if tr == qg or tr < 0 or (qmask[tr] > 0 and tr < qg):
                continue
            for o, v in zip(out, (qg, tr, ipos[a] & ((1 << 30) - 1),
                                  (strand[m] ^ (ipos[a] >> 30)) & 1,
                                  pos[m] + pbase[rid[m]])):
                o.append(v)
    return [np.array(o, np.int64) for o in out]


def _group_starts(*keys):
    s = np.arange(len(keys[0])) == 0
    for kk in keys:
        s[1:] |= kk[1:] != kk[:-1]
    return np.append(np.nonzero(s)[0], len(keys[0]))


def _vote_model(key_q, key_t, key_b, diag, qpos, diag_shift, top_k):
    """vote_corridor_kernel: per group, top_k rounds of a packed argmax over
    the runs of bins (a run's end by binary search), then each anchor's
    corridor."""
    width = 1 << diag_shift
    key_t2 = np.empty_like(key_t)
    qp2 = np.empty_like(qpos)
    gs = _group_starts(key_q, key_t)
    for s, e in zip(gs[:-1], gs[1:]):
        kb = key_b[s:e]
        d = kb >> 10
        runs = [0] + list(np.nonzero(d[1:] != d[:-1])[0] + 1)
        bb, ok, prim = [], [], 0
        for r in range(top_k):
            best = 0
            for i in runs:
                cur = i + 1 + int(np.searchsorted(kb[i + 1:], (d[i] + 1) * 1024)) - i
                if any(abs(int(d[i]) - b) <= 2 for b in bb):
                    cur = -1
                best = max(best, ((cur + 1) << 32) | (FULL - i))
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


def _chain_model(kq2, kt2, qp2, tp2, k, top_k, min_cnt, min_span):
    """chain_emit_kernel: per (query, t_rid * 2 + rel) group, its corridor
    segments in order, each found 32 anchors at a time (the in-segment
    anchors of a 32 are a prefix), corridor 0's extent for the others."""
    kc, inf = top_k + 1, 1 << 30
    A = len(kq2)
    emit = np.zeros(A, bool)
    rec = np.zeros((8, A), np.int64)
    for s, e in zip(*(lambda g: (g[:-1], g[1:]))(
            _group_starts(kq2, kt2 // kc))):
        qs0 = qe0 = -inf
        a = s
        while a < e:
            b = e
            for base in range(a, e, 32):
                i = np.arange(base, base + 32)
                inn = (i < e) & (kt2[np.minimum(i, A - 1)] == kt2[a])
                n_in = int(inn.sum())
                assert inn[:n_in].all()           # a prefix of the 32
                if n_in < 32:
                    b = base + n_in
                    break
            q, t = qp2[a:b], tp2[a:b]
            near = q != te.I32MAX
            dq, dt = np.diff(q), np.diff(t)
            link = near[1:] & near[:-1] & (dq > 0) & (dt > 0)
            total = int(_link_q(dq[link], dt[link], k).sum())
            cnt = int(near.sum())
            qs = int(q[near].min()) if cnt else inf
            qe = (int(q[near].max()) if cnt else -inf) + k
            ts = int(t[near].min()) if cnt else inf
            te_ = (int(t[near].max()) if cnt else -inf) + k
            key_tq = int(kt2[a]) // kc
            corr = int(kt2[a]) - key_tq * kc
            if corr == 0 and cnt:
                qs0, qe0 = qs, qe
            oq = min(qe, qe0) - max(qs, qs0)
            span = min(qe - qs, te_ - ts)
            if (near[-1] and (corr == 0 or oq * 2 < qe - qs)
                    and cnt >= min_cnt and span >= min_span):
                emit[b - 1] = True
                rec[:, b - 1] = (kq2[a], key_tq & 1, qs, qe, key_tq >> 1,
                                 ts, te_, min(total // 8 + k, span))
            a = b
    return emit, rec


@pytest.mark.parametrize("top_k", [1, 4])
@pytest.mark.parametrize("name", ["one-anchor groups", "all blanked",
                                  "random"])
def test_vote_and_chain_models_equal_plain(name, top_k):
    """The vote and chain kernels' algorithms, modelled, give the plain
    versions' tensors on the inputs _vote_emit hands them."""
    vi = te._vote_inputs(*_torch(SETS[name]), diag_shift=8)
    k2, q2 = te.vote_corridor_plain(*vi[:5], diag_shift=8, top_k=top_k)
    mk2, mq2 = _vote_model(*(x.numpy() for x in vi[:5]), 8, top_k)
    assert np.array_equal(mk2, k2.numpy()) and np.array_equal(mq2, q2.numpy())
    ci = te._chain_inputs(vi[0], k2, q2, vi[5])
    emit, rec = te.chain_emit_plain(*ci, k=15, top_k=top_k, min_cnt=4,
                                    min_span=500)
    memit, mrec = _chain_model(*(x.numpy() for x in ci), 15, top_k, 4, 500)
    assert np.array_equal(memit, emit.numpy())
    assert np.array_equal(mrec, rec.numpy())
    assert name != "random" or emit.sum() > CAP_OUT


@pytest.mark.parametrize("case", ["max_occ 16", "max_occ 1", "gate off"])
def test_engine_anchor_model_equals_plain(case):
    """A synthetic index (hashes of more than max_occ entries, filter rows
    at the end, self hits, the pair-once gate on half the reads, absent
    hashes, minimizers of hash 0xFFFFFFFF, one read in three rows): the
    kernel's per-minimizer loop gives the plain version's anchors, in
    order."""
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
    if case == "gate off":
        qmask[:] = 0
    args = _torch((rng.integers(0, 6, M).astype(np.int64),
                   rng.integers(0, 16384, M).astype(np.int64), qh,
                   rng.integers(0, 2, M).astype(np.int64),
                   np.array([3, 3, 17, 20, 41, 3], np.int64),
                   np.array([0, 15000, 0, 0, 0, 30000], np.int64), qmask,
                   h, irid, ipos))
    max_occ = 1 if case == "max_occ 1" else 16
    got = te.engine_anchor(*args, max_occ=max_occ)
    want = _anchor_model(args, max_occ)
    assert len(want[0]) > 100
    for x, y in zip(want, got):
        assert np.array_equal(x, y.numpy())
