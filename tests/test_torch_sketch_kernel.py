"""Numpy models of the sketch kernels of nextdenovo_tpu_torch/csrc/sketch.cu
(sketch_select, sketch_emit, hpc_compress) against the plain versions of
ops/sketch.py, and against the JAX package's sketch, sketch_wide and
hpc_compress at k <= 31.  Tolerance: exact equality of every field, n and
n_all.

The models follow the kernels' own algorithms, not the plain versions':
blocks of one tile of a row with a halo of w - 1 positions on the left and
w + k - 2 on the right, the codes read through the row pitch; the k-mers by
a direct loop over k bases into lanes; the leftmost argmin of each window
start of the tile and its left halo; tile counts; each block's first output
the sum of the counts before it, its positions scanned in rounds; the hpc
scan of a row in rounds with its running count.  The CUDA kernels
themselves are held against the plain versions on the card by
chip_smoke.py (phase sketch)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextdenovo_tpu.ops import sketch as jsk
from nextdenovo_tpu_torch.ops import sketch as tsk

TILE = tsk.SKETCH_TILE
THREADS = 256             # sketch_emit's rounds: a thread a position
HPC_THREADS = 1024        # hpc_compress's rounds
UMAX = 0xFFFFFFFF


def _mix32(x):
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7feb352d)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846ca68b)
    return x ^ (x >> np.uint32(16))


def _lanes(k):
    return max(2, k // 16 + 1)


def select_model(buf, pitch, B, L, lengths, k, w, own_lo=None, own_hi=None,
                 pos_map=None):
    """sketch_select: per block (row b, tile j) -> (hash, flags, counts)."""
    N = _lanes(k)
    flat = np.asarray(buf).reshape(-1)
    n_tiles = -(-L // TILE)
    hsh = np.zeros((B, L), np.uint32)
    flags = np.zeros((B, L), np.uint8)
    counts = np.zeros(B * n_tiles, np.int32)
    np_ = TILE + 2 * (w - 1)
    nc = np_ + k - 1
    for blk in range(B * n_tiles):
        b, t0 = blk // n_tiles, (blk % n_tiles) * TILE
        ln = min(max(int(lengths[b]), 0), L)
        p0 = t0 - (w - 1)
        p = p0 + np.arange(nc)
        inrow = (p >= 0) & (p < ln)
        sc = np.zeros(nc, np.uint32)
        sc[inrow] = flat[b * pitch + p[inrow]].astype(np.int64) & 3
        # the direct k-base loop into N lanes, MSB first
        pq = p0 + np.arange(np_)
        f = np.zeros((N, np_), np.uint32)
        r = np.zeros((N, np_), np.uint32)
        for l in range(N):
            jf, jr = k - 1 - 16 * (N - 1 - l), 16 * (N - 1 - l)
            for q in range(16):
                if jf - q >= 0:
                    f[l] |= sc[jf - q : jf - q + np_] << np.uint32(2 * q)
                if jr + q < k:
                    r[l] |= (sc[jr + q : jr + q + np_] ^ np.uint32(3)) \
                        << np.uint32(2 * q)
        less = np.zeros(np_, bool)
        eq = np.ones(np_, bool)
        for l in range(N):
            d = eq & (f[l] != r[l])
            less[d] = f[l][d] < r[l][d]
            eq &= ~d
        h = np.full(np_, 0x9e3779b9, np.uint32)
        for l in range(N):
            h = _mix32(np.where(less, f[l], r[l]) ^ h)
        ok = (pq >= 0) & (pq + k <= ln)
        h = np.where(ok & ~eq, h, np.uint32(UMAX))
        strand = np.where(ok & less, 0, 1).astype(np.uint8)
        # the leftmost argmin of each window start that counts
        qs = np.arange(TILE + w - 1)
        s = p0 + qs
        best, arg = h[qs].copy(), np.zeros(len(qs), np.int64)
        for o in range(1, w):
            v = h[qs + o]
            take = v < best
            best = np.where(take, v, best)
            arg = np.where(take, o, arg)
        a = (s + arg - t0)[(s >= 0) & (s + w + k - 1 <= ln)]
        mark = np.zeros(TILE, bool)
        mark[a[(a >= 0) & (a < TILE)]] = True
        t = np.arange(min(TILE, L - t0))
        i = t0 + t
        ht = h[w - 1 + t]
        sel = mark[t] & (ht != UMAX)
        if own_lo is not None:
            op = i if pos_map is None else pos_map[b, i]
            sel &= (op >= own_lo[b]) & (op < own_hi[b])
        flags[b, i] = strand[w - 1 + t] | (sel.astype(np.uint8) << 1)
        hsh[b, i[sel]] = ht[sel]
        counts[blk] = int(sel.sum())
    return hsh, flags, counts


def emit_model(hsh, flags, counts, pos_map, B, L, stride):
    """sketch_emit: each block's first output the sum of the counts before
    it, its positions in rounds of a thread a position."""
    n_tiles = -(-L // TILE)
    out = np.full((4, stride), -7, np.int64)        # never-written marker
    total = 0
    for g in range(B * n_tiles):
        base = int(counts[:g].sum())
        b, t0 = g // n_tiles, (g % n_tiles) * TILE
        for r0 in range(0, TILE, THREADS):
            i = t0 + r0 + np.arange(THREADS)
            f = np.where(i < L, flags[b, np.minimum(i, L - 1)], 0)
            sel = (f & 2) != 0
            o = base + np.cumsum(sel) - sel
            put = sel & (o < stride)
            ii, oo = i[put], o[put]
            out[0, oo] = b
            out[1, oo] = ii if pos_map is None else pos_map[b, ii]
            out[2, oo] = hsh[b, ii]
            out[3, oo] = f[put] & 1
            base += int(sel.sum())
        total = base
    return out, total


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
                 own_hi=None, hpc=False):
    """The kernels' path of sketch / sketch_wide: the first min(n_all, cap)
    columns of emit's output as Minimizers, as the wrapper reads them."""
    pos_map = None
    if hpc:
        ch, pos_map, lengths = hpc_model(buf, pitch, B, L, lengths)
        buf, pitch = ch, L
    hsh, flags, counts = select_model(buf, pitch, B, L, lengths, k, w,
                                      own_lo, own_hi, pos_map)
    out, n_all = emit_model(hsh, flags, counts, pos_map, B, L,
                            max(0, min(cap, B * L)))
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
    lens = np.minimum([0, max(w + k - 2, 0), L, L, 1500, 1200, L, TILE + 3],
                      L)[:B].astype(np.int32)
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


def test_hpc_model_equals_jax():
    buf, lens, _, _ = _jax_batch()
    B, L = buf.shape
    rc, rp, rl = jsk.hpc_compress(jnp.asarray(buf), jnp.asarray(lens))
    ch, pm, lh = hpc_model(buf, L, B, L, lens)
    assert np.array_equal(np.asarray(rc), ch)
    assert np.array_equal(np.asarray(rp).astype(np.int64), pm)
    assert np.array_equal(np.asarray(rl), lh)
