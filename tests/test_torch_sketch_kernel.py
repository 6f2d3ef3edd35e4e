"""Numpy models of the sketch kernels of nextdenovo_tpu_torch/csrc/sketch.cu
(sketch_minimizers, hpc_compress) against the plain versions of
ops/sketch.py, and against the JAX package's sketch, sketch_wide and
hpc_compress.  Tolerance: exact equality of every field, n and n_all.

The models follow the kernels' own algorithms, not the plain versions':
a block a tile of a row, its tile index taken from a ticket, 2 or 4
positions a thread (sketch_tile); the codes read through the row pitch and
packed 16 bases to a word from two ballots (MSB first, and LSB first
complemented for the reverse complement); each lane of a k-mer one funnel
shift of two neighbouring words, the first lane masked when it carries
fewer than 16 bases, a lane that carries no base folded into the hash's
seed; the window minima of (hash, position) pairs by doubling, two levels a
pass while two remain, and one overlapping pick a window start; each selected position's rank from the
warps' sums and a ballot a position slot; each tile's output offset by a
decoupled look-back over status words of its predecessors, a word a lane;
the hpc scan of a row in rounds with its running count.  The CUDA kernels
themselves are held against the plain versions on the card by
chip_smoke.py (phase sketch)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextdenovo_tpu.ops import sketch as jsk
from nextdenovo_tpu_torch.ops import sketch as tsk

THREADS = tsk.SKETCH_THREADS
HPC_THREADS = 1024        # hpc_compress's rounds
LB_LANES = 32             # the look-back: a warp, a status word a lane
UMAX = 0xFFFFFFFF
M32 = np.uint64(0xFFFFFFFF)
ST_AGG, ST_INC = 1, 2     # a status word's flag: the tile's count, or the
                          # inclusive count of the tiles up to it


def _mix32(x):
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7feb352d)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846ca68b)
    return x ^ (x >> np.uint32(16))


def _spread16(x):
    """Bit m of a 16-bit x to bit 2m."""
    x = x.astype(np.uint32)
    for s, m in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                 (1, 0x55555555)):
        x = (x | (x << np.uint32(s))) & np.uint32(m)
    return x


def _brev16(x):
    """The 16 low bits of x reversed (__brev(x) >> 16 on the card)."""
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(16):
        out |= ((x.astype(np.uint32) >> np.uint32(i)) & np.uint32(1)) \
            << np.uint32(15 - i)
    return out


def pack_words(codes2):
    """Two ballots a chunk of 32 codes -> words W (16 bases MSB first) and
    RW (16 bases LSB first, complemented), two a chunk as lanes 0 and 1
    write them."""
    c = codes2.reshape(-1, 32).astype(np.uint64)
    bits = np.uint64(1) << np.arange(32, dtype=np.uint64)
    b0 = ((c & np.uint64(1)) * bits).sum(1).astype(np.uint64)
    b1 = (((c >> np.uint64(1)) & np.uint64(1)) * bits).sum(1).astype(np.uint64)
    W, RW = [], []
    for half in (0, 1):                   # lanes 0 and 1 of the warp
        x0 = ((b0 >> np.uint64(16 * half)) & np.uint64(0xFFFF)).astype(
            np.uint32)
        x1 = ((b1 >> np.uint64(16 * half)) & np.uint64(0xFFFF)).astype(
            np.uint32)
        v = _spread16(x0) | (_spread16(x1) << np.uint32(1))
        W.append(_spread16(_brev16(x0)) | (_spread16(_brev16(x1))
                                            << np.uint32(1)))
        RW.append(~v)
    return (np.stack(W, 1).reshape(-1).astype(np.uint32),
            np.stack(RW, 1).reshape(-1).astype(np.uint32))


def _fsl(lo, hi, s):
    """__funnelshift_l(lo, hi, s): the high word of (hi:lo) << s."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v << s.astype(np.uint64)) >> np.uint64(32)) & M32


def _fsr(lo, hi, s):
    """__funnelshift_r(lo, hi, s): the low word of (hi:lo) >> s."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (v >> s.astype(np.uint64)) & M32


def tile_keys(row, ln, k, w, t0, np_):
    """Hashes and strands of the np_ positions a block hashes, from t0 -
    (w - 1): (h uint32, strand) each (np_,), h UMAX where no k-mer
    counts."""
    NB = -(-k // 16)                      # lanes that carry bases
    N = max(2, k // 16 + 1)               # the plain version's lanes
    base = t0 - (w - 1)
    P0 = (base - 16 * N) // 16 * 16       # the first packed position
    nw = (np_ + 32 * NB + 64) // 16       # words packed: whole chunks
    p = P0 + np.arange(16 * nw)
    inrow = (p >= 0) & (p < ln)
    cd = np.zeros(16 * nw, np.int64)
    cd[inrow] = row[p[inrow]].astype(np.int64) & 3
    W, RW = pack_words(cd)
    W, RW = np.append(W, 0), np.append(RW, 0)
    q = np.arange(np_)
    pq = base + q
    ok = (pq >= 0) & (pq + k <= ln)
    pc = np.where(ok, pq, max(0, base + 16 * N))  # any in-range address
    rf, rr = pc + k - 16 * NB - P0, pc - P0
    nb0 = k - 16 * (NB - 1)
    m0 = np.uint64(UMAX if nb0 >= 16 else (1 << 2 * nb0) - 1)
    f, r = [], []
    for l in range(NB):
        uf, ur = (rf >> 4) + l, (rr >> 4) + NB - 1 - l
        fl = _fsl(W[uf + 1], W[uf], 2 * (rf & 15))
        rl = _fsr(RW[ur], RW[ur + 1], 2 * (rr & 15))
        if l == 0:
            fl, rl = fl & m0, rl & m0
        f.append(fl.astype(np.uint32))
        r.append(rl.astype(np.uint32))
    less = np.zeros(np_, bool)
    eq = np.ones(np_, bool)
    for l in range(NB):
        d = eq & (f[l] != r[l])
        less[d] = f[l][d] < r[l][d]
        eq &= ~d
    h = np.full(np_, 0x9e3779b9, np.uint32)
    if N > NB:                            # a leading lane of no base
        h = _mix32(h)
    for l in range(NB):
        h = _mix32(np.where(less, f[l], r[l]) ^ h)
    h = np.where(ok & ~eq, h, np.uint32(UMAX))
    strand = np.where(less, 0, 1).astype(np.int64)
    return h, strand


def _pick(a_h, a_x, b_h, b_x):
    """The pair of the lesser hash, the first (left) one on a tie."""
    take = b_h < a_h
    return np.where(take, b_h, a_h), np.where(take, b_x, a_x)


def tile_marks(h, x, k, w, t0, ln, tile):
    """Window minima by doubling over the hashed positions, as the kernel's
    passes go: from level d to d + 2 (four spans of 2^d, picked in pairs)
    while two levels remain, else to d + 1, up to p = floor(log2 w); then
    each window start's pick of level p at q and q + w - 2^p; a start that
    counts marks its argmin in the tile.  Returns (markh (tile,) uint32,
    UMAX unmarked, and its strands)."""
    np_ = h.shape[0]
    p2 = w.bit_length() - 1
    d = 0
    while d < p2:
        hh = 1 << d
        nh, nx = h.copy(), x.copy()
        if d + 2 <= p2:
            n = np_ - 4 * hh + 1
            sl = lambda o: (h[o:o + n], x[o:o + n])
            a = _pick(*sl(0), *sl(hh))
            c = _pick(*sl(2 * hh), *sl(3 * hh))
            nh[:n], nx[:n] = _pick(*a, *c)
            d += 2
        else:
            n = np_ - 2 * hh + 1
            nh[:n], nx[:n] = _pick(h[:n], x[:n], h[hh:hh + n], x[hh:hh + n])
            d += 1
        h, x = nh, nx
    q = np.arange(tile + w - 1)
    s = t0 - (w - 1) + q
    off = w - (1 << p2)
    mh, mx = _pick(h[q], x[q], h[q + off], x[q + off])
    at = (mx >> 1) - (w - 1)
    good = (s >= 0) & (s + w + k - 1 <= ln) & (at >= 0) & (at < tile) \
        & (mh != UMAX)
    markh = np.full(tile, UMAX, np.uint32)
    mstr = np.zeros(tile, np.int64)
    markh[at[good]] = mh[good]
    mstr[at[good]] = mx[good] & 1
    return markh, mstr


def tile_compact(markh, mstr, b, t0, L, tile, np_, own, pos_map):
    """The tile's selected positions in order: each thread its per
    consecutive positions; a position's rank the selected positions of the
    warps before (their sums), of the lanes before in each slot j (a ballot
    a slot), and of its own slots before.  Returns (count, pos, hash,
    strand) in rank order."""
    per = np_ // THREADS
    t = np.arange(THREADS * per).reshape(THREADS, per)
    i = t0 + t
    inb = (t < tile) & (i < L)
    sel = np.zeros(t.shape, bool)
    sel[inb] = markh[t[inb]] != UMAX
    op = i.copy()
    if pos_map is not None:
        op[inb] = pos_map[b, i[inb]]
    if own[0] is not None:
        sel &= (op >= own[0][b]) & (op < own[1][b])
    by_warp = sel.reshape(-1, 32, per)    # (warp, lane, slot)
    wtot = by_warp.sum((1, 2))
    lanes_before = np.cumsum(by_warp.sum(2), axis=1) - by_warp.sum(2)
    first = (np.cumsum(wtot) - wtot)[:, None] + lanes_before
    rank = first.reshape(-1)[:, None] + np.cumsum(sel, axis=1) - sel
    n = int(wtot.sum())
    pos = np.zeros(n, np.int64)
    hh = np.zeros(n, np.int64)
    st = np.zeros(n, np.int64)
    r = rank[sel]
    assert sorted(r) == list(range(n))
    pos[r] = op[sel]
    hh[r] = markh[t[sel]]
    st[r] = mstr[t[sel]]
    return n, pos, hh, st


def look_back(status, g, stats):
    """One look-back of tile g over its predecessors' status words, in
    windows of LB_LANES (lane d reads tile g - 1 - d): the nearest inclusive
    count ends it; an unpublished word (0) before it makes the warp read the
    window again (None here: try later)."""
    excl, end = 0, g - 1
    while True:
        d = np.arange(LB_LANES)
        idx = end - d
        v = [(ST_INC, 0) if j < 0 else status[j] for j in idx]
        flag = np.array([x[0] for x in v])
        val = np.array([x[1] for x in v])
        inc = np.nonzero(flag == ST_INC)[0]
        dp = inc[0] if len(inc) else len(d)
        if (flag[: dp + (1 if len(inc) else 0)] == 0).any():
            stats["waits"] += 1
            return None
        excl += int(val[: dp + 1].sum())
        if len(inc):
            return excl
        stats["windows_past"] += 1
        end -= LB_LANES


def minimizers_model(buf, pitch, B, L, lengths, k, w, stride, own_lo=None,
                     own_hi=None, pos_map=None, rng=None, stats=None,
                     late_first=False, per=0):
    """sketch_minimizers: (out (4, stride), n_all).  The blocks take their
    tickets, and so their tiles, in a shuffled order when rng is given, and
    each step advances a block chosen at random (rng) or the first
    unfinished one: compute and publish its count, then look back, then
    write.  A look-back that meets an unpublished predecessor waits; stats
    (a dict) counts such waits and the windows a look-back went past.
    late_first: every block computes first, then the last tile looks back
    first, and so on down.  per: positions a thread (sketch_tile)."""
    np_, tile = tsk.sketch_tile(w, per)
    n_tiles = -(-L // tile)
    G = B * n_tiles
    flat = np.asarray(buf).reshape(-1)
    out = np.full((4, stride), -7, np.int64)        # never-written marker
    status = [(0, 0)] * G
    n_all = [None]
    order = np.arange(G) if rng is None else rng.permutation(G)
    state = {}
    live = list(order)
    stats = {} if stats is None else stats
    stats.update(waits=0, windows_past=0)

    def step(g):
        if g not in state:
            b, t0 = g // n_tiles, (g % n_tiles) * tile
            ln = min(max(int(lengths[b]), 0), L)
            row = flat[b * pitch : b * pitch + L]
            h, strand = tile_keys(row, ln, k, w, t0, np_)
            x = (np.arange(np_, dtype=np.int64) << 1) | strand
            markh, mstr = tile_marks(h, x, k, w, t0, ln, tile)
            c = tile_compact(markh, mstr, b, t0, L, tile, np_,
                             (own_lo, own_hi), pos_map)
            status[g] = (ST_INC if g == 0 else ST_AGG, c[0])
            state[g] = (b, c)
            return False
        b, (n, pos, hh, st) = state[g]
        excl = 0 if g == 0 else look_back(status, g, stats)
        if excl is None:
            return False
        status[g] = (ST_INC, excl + n)
        if g == G - 1:
            n_all[0] = excl + n
        o = excl + np.arange(n)
        put = o < stride
        out[0, o[put]] = b
        out[1, o[put]] = pos[put]
        out[2, o[put]] = hh[put]
        out[3, o[put]] = st[put]
        return True

    if late_first:
        for g in order:
            step(g)
        live = sorted(live, reverse=True)
    while live:
        j = 0 if rng is None or late_first else int(rng.integers(len(live)))
        if step(live[j]):
            live.pop(j)
    return out, (n_all[0] if G else 0)


def hpc_model(buf, pitch, B, L, lengths):
    """hpc_compress: a row in rounds of a thread a position, kept positions
    placed by the round's scan plus the running count, then the padding."""
    flat = np.asarray(buf).reshape(-1)
    codes_hpc = np.full((B, L), 7, np.int8)          # every entry written
    pos_map = np.full((B, L), -7, np.int64)
    lens_hpc = np.zeros(B, np.int32)
    for b in range(B):
        ln = min(max(int(lengths[b]), 0), L)
        kept = 0
        for c0 in range(0, ln, HPC_THREADS):
            p = c0 + np.arange(HPC_THREADS)
            inr = p < ln
            c = np.where(inr, flat[b * pitch + np.minimum(p, ln - 1)], 0)
            prev = flat[b * pitch + np.maximum(np.minimum(p, ln - 1) - 1, 0)]
            keep = inr & ((p == 0) | (c != prev))
            o = kept + np.cumsum(keep) - keep
            codes_hpc[b, o[keep]] = c[keep]
            pos_map[b, o[keep]] = p[keep]
            kept += int(keep.sum())
        codes_hpc[b, kept:] = 4
        pos_map[b, kept:] = 0
        lens_hpc[b] = kept
    return codes_hpc, pos_map, lens_hpc


def model_sketch(buf, pitch, B, L, lengths, k, w, cap, own_lo=None,
                 own_hi=None, hpc=False, rng=None, stats=None,
                 late_first=False, per=0):
    """The kernels' path of sketch / sketch_wide: the first min(n_all, cap)
    columns of the kernel's output as Minimizers, as the wrapper reads
    them."""
    pos_map = None
    if hpc:
        ch, pos_map, lengths = hpc_model(buf, pitch, B, L, lengths)
        buf, pitch = ch, L
    out, n_all = minimizers_model(buf, pitch, B, L, lengths, k, w,
                                  max(0, min(cap, B * L)), own_lo, own_hi,
                                  pos_map, rng, stats, late_first, per)
    n = min(n_all, out.shape[1])
    rid, pos, h, strand = torch.from_numpy(out[:, :n]).unbind(0)
    return tsk.Minimizers(rid=rid, pos=pos, hash=h, strand=strand, n=n,
                          n_all=n_all)


def assert_same(got, ref):
    assert (got.n, got.n_all) == (ref.n, ref.n_all)
    for f in ("rid", "pos", "hash", "strand"):
        x, y = getattr(got, f), getattr(ref, f)
        assert x.dtype == y.dtype == torch.int64, f
        assert torch.equal(x, y), f


def edge_batch(rng, k, w, B=8, L=2100, pad=0):
    """Rows of the edge cases in a (B, L + pad) int8 buffer (the columns
    past L and past each row's length hold random codes, N included): a row
    of length 0, one a base shorter than w + k - 1, N codes, homopolymer
    runs, a tandem repeat of period 3 (tied hashes), an (AT)* run (every
    even k-mer a palindrome), random rows of length L and just past a
    tile."""
    buf = rng.integers(0, 5, (B, L + pad)).astype(np.int8)
    lens = np.minimum([0, max(w + k - 2, 0), L, L, 1500, 1200, L,
                       tsk.sketch_tile(w)[1] + 3], L)[:B].astype(np.int32)
    buf[2, :L:7] = 4                                        # N codes
    buf[3, :L] = np.repeat(rng.integers(0, 4, L),
                           rng.integers(1, 40, L))[:L]
    buf[3, L // 4 : L // 2] = 1                             # one long run
    n4, n5 = lens[4], lens[5]
    buf[4, :n4] = np.tile([0, 1, 2], n4 // 3 + 1)[:n4]      # tandem repeat
    buf[5, :n5] = np.tile([0, 3], n5 // 2 + 1)[:n5]         # palindromes
    buf[5, 300:310] = 2
    return buf, lens


KS = [1, 15, 17, 31, 32, 51, 127]
WS = [1, 5, 17, 51]


@pytest.mark.parametrize("w", WS)
@pytest.mark.parametrize("k", KS)
def test_kernel_model_equals_plain(k, w):
    """The kernels' model against the plain version at every (k, w): the
    sketch family (k <= 31) and the wide family."""
    rng = np.random.default_rng(1000 * k + w)
    buf, lens = edge_batch(rng, k, w)
    B, L = buf.shape
    got = model_sketch(buf, L, B, L, lens, k, w, cap=B * L)
    codes, lt = torch.from_numpy(buf), torch.from_numpy(lens)
    ref = tsk.sketch_wide_plain(codes, lt, k, w, cap=B * L)
    assert ref.n_all > 0
    assert_same(got, ref)
    if k <= 31:
        assert_same(got, tsk.sketch_plain(codes, lt, k, w, cap=B * L))
    if k % 2 == 0:
        # no k-mer of the (AT)* run of row 5 is selected: each is its own
        # reverse complement
        p = got.pos[got.rid == 5]
        assert not bool(((p + k <= 300) | ((p >= 310) & (p + k <= 1200)))
                        .any())


@pytest.mark.parametrize("k,w", [(15, 5), (17, 17), (51, 51), (32, 1)])
def test_own_gate_cap_and_column_slice(k, w):
    """Own gates, a truncating cap, and a column slice codes[:, :L] of a
    wider buffer read through its row pitch."""
    rng = np.random.default_rng(7 * k + w)
    buf, lens = edge_batch(rng, k, w, pad=333)
    B, L = buf.shape[0], buf.shape[1] - 333
    view = torch.from_numpy(buf)[:, :L]
    assert not view.is_contiguous()
    lo = rng.integers(-5, 900, B).astype(np.int32)
    hi = (lo + rng.integers(0, 1500, B)).astype(np.int32)
    lt = torch.from_numpy(lens)
    full = tsk.sketch_wide_plain(view, lt, k, w, cap=B * L)
    cap = full.n_all // 2
    ref = tsk.sketch_wide_plain(view, lt, k, w, cap=cap,
                                own_lo=torch.from_numpy(lo),
                                own_hi=torch.from_numpy(hi))
    got = model_sketch(buf, L + 333, B, L, lens, k, w, cap, lo, hi)
    assert 0 < ref.n <= cap
    assert_same(got, ref)
    got = model_sketch(buf, L + 333, B, L, lens, k, w, cap=cap)
    assert got.n == cap < got.n_all == full.n_all
    assert_same(got, tsk.sketch_wide_plain(view, lt, k, w, cap=cap))
    if k <= 31:
        assert_same(got, tsk.sketch_plain(view, lt, k, w, cap=cap))


@pytest.mark.parametrize("k,w", [(51, 51), (17, 5), (127, 17)])
def test_hpc_model_equals_plain(k, w):
    """hpc_compress over the whole buffer, then the hpc sketch with its own
    gate on original positions, from a column-sliced view."""
    rng = np.random.default_rng(k + w)
    buf, lens = edge_batch(rng, k, w, pad=64)
    B, L = buf.shape[0], buf.shape[1] - 64
    view = torch.from_numpy(buf)[:, :L]
    lt = torch.from_numpy(lens)
    ch, pm, lh = hpc_model(buf, L + 64, B, L, lens)
    rc, rp, rl = tsk.hpc_compress_plain(view, lt)
    assert rc.dtype == torch.int8 and rp.dtype == torch.int64
    assert np.array_equal(ch, rc.numpy()) and np.array_equal(pm, rp.numpy())
    assert np.array_equal(lh, rl.numpy())
    lo = np.full(B, 200, np.int32)
    hi = np.full(B, 1700, np.int32)
    ref = tsk.sketch_wide_plain(view, lt, k, w, cap=B * L, hpc=True,
                                own_lo=torch.from_numpy(lo),
                                own_hi=torch.from_numpy(hi))
    got = model_sketch(buf, L + 64, B, L, lens, k, w, B * L, lo, hi,
                       hpc=True)
    assert ref.n > 0
    assert_same(got, ref)


@pytest.mark.parametrize("k,w", [(16, 17), (47, 5), (48, 51), (128, 1),
                                 (tsk.SKETCH_K_MAX, 17)])
def test_lane_edges_model_equals_plain(k, w):
    """k at the lanes' edges: one full lane and an empty first one (16, 48,
    128), a first lane of 15 bases (47), nine lanes (143, the kernel's
    largest k)."""
    rng = np.random.default_rng(31 * k + w)
    buf, lens = edge_batch(rng, k, w)
    B, L = buf.shape
    got = model_sketch(buf, L, B, L, lens, k, w, cap=B * L)
    ref = tsk.sketch_wide_plain(torch.from_numpy(buf), torch.from_numpy(lens),
                                k, w, cap=B * L)
    assert ref.n_all > 0
    assert_same(got, ref)


@pytest.mark.parametrize("k,w", [(15, 5), (51, 51), (1, 1), (143, 17)])
def test_wide_blocks_model_equals_plain(k, w):
    """The layout of 4 positions a thread (tiles of 1024 - 2 (w - 1)), which
    the kernel takes where a launch of 2 a thread would not fit on the card
    at once: own gates, a truncating cap and a column slice."""
    rng = np.random.default_rng(77 * k + w)
    buf, lens = edge_batch(rng, k, w, L=3100, pad=40)
    B, L = buf.shape[0], buf.shape[1] - 40
    lo = rng.integers(-5, 900, B).astype(np.int32)
    hi = (lo + rng.integers(0, 2500, B)).astype(np.int32)
    view, lt = torch.from_numpy(buf)[:, :L], torch.from_numpy(lens)
    full = tsk.sketch_wide_plain(view, lt, k, w, cap=B * L)
    for cap, own in ((B * L, (None, None)), (full.n_all // 2, (lo, hi))):
        got = model_sketch(buf, L + 40, B, L, lens, k, w, cap, *own, per=4)
        own_t = [None if o is None else torch.from_numpy(o) for o in own]
        ref = tsk.sketch_wide_plain(view, lt, k, w, cap=cap, own_lo=own_t[0],
                                    own_hi=own_t[1])
        assert ref.n > 0
        assert_same(got, ref)


def _leftmost_argmins(h, ln, k, w):
    """The positions some window of a row selects, by a direct scan: the
    leftmost of the least hash of each window start that counts."""
    out = set()
    for s in range(0, ln - (w + k - 1) + 1):
        j = s + int(np.argmin(h[s : s + w]))
        if h[j] != UMAX:
            out.add(j)
    return out


@pytest.mark.parametrize("period,k,w", [(3, 15, 17), (4, 17, 51), (2, 31, 5)])
def test_hash_ties_leftmost_wins(period, k, w):
    """Rows of a short tandem repeat: each window holds the same k-mer (so
    the same hash) several times, and its leftmost one must win."""
    rng = np.random.default_rng(period * 100 + k)
    B, L = 4, 1500
    buf = np.zeros((B, L), np.int8)
    for b in range(B):
        unit = rng.integers(0, 4, period)
        buf[b] = np.tile(unit, L // period + 1)[:L]
    buf[3, 700:] = rng.integers(0, 4, L - 700)     # repeat, then random
    lens = np.array([L, L - 1, 1000, L], np.int32)
    got = model_sketch(buf, L, B, L, lens, k, w, cap=B * L)
    codes, lt = torch.from_numpy(buf), torch.from_numpy(lens)
    assert_same(got, tsk.sketch_wide_plain(codes, lt, k, w, cap=B * L))
    h, _ = tile_keys(buf[0], L, k, 1, 0, -(-L // THREADS) * THREADS)
    want = _leftmost_argmins(h[:L], L, k, w)
    assert len(set(h[list(want)].tolist())) < len(want)   # tied hashes
    assert sorted(want) == got.pos[got.rid == 0].tolist()


@pytest.mark.parametrize("w", [tsk.sketch_tile(1)[1] + 77,
                               tsk.SKETCH_W_MAX])
def test_window_past_the_tile(w):
    """w larger than a whole tile: the block hashes more positions (a
    multiple of the threads) and owns a tile of at least as many as its
    threads."""
    k = 15
    np_, tile = tsk.sketch_tile(w)
    assert np_ % THREADS == 0 and tile >= THREADS
    assert np_ == tile + 2 * (w - 1)
    rng = np.random.default_rng(w)
    B, L = 3, 2 * w + 1500
    buf = rng.integers(0, 5, (B, L)).astype(np.int8)
    lens = np.array([L, w + k - 1, w + k + 700], np.int32)
    got = model_sketch(buf, L, B, L, lens, k, w, cap=B * L)
    ref = tsk.sketch_wide_plain(torch.from_numpy(buf), torch.from_numpy(lens),
                                k, w, cap=B * L)
    assert ref.n_all > 0
    assert_same(got, ref)


@pytest.mark.parametrize("late_first", [False, True])
def test_shuffled_tiles_same_output(late_first):
    """The blocks take their tiles in a shuffled order and advance in a
    random interleaving (look-backs wait on unpublished tiles), or all
    compute before the last tile looks back first (look-backs walk past
    whole windows of status words): the output is the in-order one and the
    plain version's, also under a truncating cap and own gates."""
    seed = 1 + late_first
    rng = np.random.default_rng(seed)
    k, w = 15, 5
    B, L = 24, 3100                       # 7 tiles a row: 168 tiles
    buf = rng.integers(0, 5, (B, L)).astype(np.int8)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lo = rng.integers(-5, 1500, B).astype(np.int32)
    hi = (lo + rng.integers(0, 2500, B)).astype(np.int32)
    codes, lt = torch.from_numpy(buf), torch.from_numpy(lens)
    ref = tsk.sketch_wide_plain(codes, lt, k, w, cap=B * L)
    cap = ref.n_all - 1000
    stats = {}
    for c, own in ((B * L, (None, None)), (cap, (lo, hi))):
        want = model_sketch(buf, L, B, L, lens, k, w, c, *own)
        got = model_sketch(buf, L, B, L, lens, k, w, c, *own,
                           rng=np.random.default_rng(seed + 10), stats=stats,
                           late_first=late_first)
        assert_same(got, want)
        own_t = [None if o is None else torch.from_numpy(o) for o in own]
        assert_same(got, tsk.sketch_wide_plain(codes, lt, k, w, cap=c,
                                               own_lo=own_t[0],
                                               own_hi=own_t[1]))
    assert stats["windows_past" if late_first else "waits"] > 0


def test_rows_i32_clamps_wide_types():
    """The wrapper's int32 rows: int32 as given, int64 clamped so that each
    comparison with a position in [0, L) keeps its result."""
    t = torch.tensor([-(1 << 40), -3, 0, 5, 1 << 40])
    got = tsk._rows_i32("own_lo", t, 5, t.device, -1, 101)
    assert got.dtype == torch.int32
    assert got.tolist() == [-1, -1, 0, 5, 101]
    pos = torch.arange(100)
    assert torch.equal(pos[None] >= t[:, None], pos[None] >= got[:, None])
    t32 = torch.tensor([3, 4], dtype=torch.int32)
    assert tsk._rows_i32("lengths", t32, 2, t32.device, 0, 9) is t32
    with pytest.raises(ValueError):
        tsk._rows_i32("lengths", t32, 3, t32.device, 0, 9)


def test_codes_pitch():
    buf = torch.zeros((4, 96), dtype=torch.int8)
    assert tsk._codes_pitch(buf) == 96
    assert tsk._codes_pitch(buf[1:3, :40]) == 96
    assert tsk._codes_pitch(buf[:1, :0]) == 96
    for bad in (buf.to(torch.int32), buf[:, ::2], buf.t()):
        with pytest.raises(ValueError):
            tsk._codes_pitch(bad)


# ---- one JAX comparison per family, at k <= 31 ----------------------------

def _jax_minimizers(ref):
    n = int(ref.n)
    return tsk.Minimizers(
        *(torch.from_numpy(np.asarray(getattr(ref, f))[:n].astype(np.int64))
          for f in ("rid", "pos", "hash", "strand")), n, int(ref.n_all))


def _jax_batch():
    rng = np.random.default_rng(3)
    buf, lens = edge_batch(rng, 15, 5, B=6, L=1100)
    return buf, lens, np.array([0, 0, 30, 0, 100, 0], np.int32), \
        np.array([0, 9, 1000, 1100, 900, 1100], np.int32)


def test_sketch_model_equals_jax():
    buf, lens, lo, hi = _jax_batch()
    B, L = buf.shape
    ref = jsk.sketch(jnp.asarray(buf.astype(np.int32)), jnp.asarray(lens),
                     k=15, w=5, cap=900, own_lo=jnp.asarray(lo),
                     own_hi=jnp.asarray(hi))
    got = model_sketch(buf, L, B, L, lens, 15, 5, 900, lo, hi)
    assert got.n == 900 < got.n_all
    assert_same(got, _jax_minimizers(ref))


def test_sketch_wide_hpc_model_equals_jax():
    buf, lens, lo, hi = _jax_batch()
    B, L = buf.shape
    ref = jsk.sketch_wide(jnp.asarray(buf.astype(np.int32)),
                          jnp.asarray(lens), k=17, w=10, cap=4096, hpc=True,
                          own_lo=jnp.asarray(lo), own_hi=jnp.asarray(hi))
    got = model_sketch(buf, L, B, L, lens, 17, 10, 4096, lo, hi, hpc=True)
    assert got.n > 0
    assert_same(got, _jax_minimizers(ref))


@pytest.mark.parametrize("k,w", [(1, 17), (15, 1), (17, 5), (31, 1),
                                 (32, 5), (51, 5), (127, 1)])
def test_grid_model_equals_jax(k, w):
    """The kernel's model against the JAX package's sketch (k <= 31) or
    sketch_wide on the edge rows, each k of the grid once."""
    rng = np.random.default_rng(1000 * k + w)
    buf, lens = edge_batch(rng, k, w)
    B, L = buf.shape
    got = model_sketch(buf, L, B, L, lens, k, w, cap=B * L)
    fn = jsk.sketch if k <= 31 else jsk.sketch_wide
    ref = fn(jnp.asarray(buf.astype(np.int32)), jnp.asarray(lens), k=k, w=w,
             cap=B * L)
    assert got.n_all > 0
    assert_same(got, _jax_minimizers(ref))


def test_hpc_model_equals_jax():
    buf, lens, _, _ = _jax_batch()
    B, L = buf.shape
    rc, rp, rl = jsk.hpc_compress(jnp.asarray(buf), jnp.asarray(lens))
    ch, pm, lh = hpc_model(buf, L, B, L, lens)
    assert np.array_equal(np.asarray(rc), ch)
    assert np.array_equal(np.asarray(rp).astype(np.int64), pm)
    assert np.array_equal(np.asarray(rl), lh)
