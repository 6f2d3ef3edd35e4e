"""The Myers pair's input streams built from one flat array of the pairs
(nextdenovo_tpu_torch/ops/myers.py: flat_pairs, build_streams_plain, which
build_streams runs for CPU tensors) against the JAX package's jitted
_build_streams on the pads its _myers_dispatch would build for the same
pairs, and a numpy model of the myers_streams kernel (csrc/streams.cu:
tiles of 32 pairs x 64 columns staged through shared memory, a thread
eight columns of one pair; one more row of blocks for the window words, a
thread a (word, pair)) against build_streams_plain.  Inputs made from a seed with numpy.  Tolerance:
exact equality, bit for bit (the window words compared as uint32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextdenovo_tpu.ops import myers as jm
from nextdenovo_tpu_torch.ops import myers as tm

NW, W = 8, 256


def _swapped(qs, ts, off=None):
    """The pairs as _myers_batch lays them out: m >= n, off per pair (or as
    given)."""
    sw = [(t, q) if len(q) < len(t) else (q, t) for q, t in zip(qs, ts)]
    qs = [np.asarray(a, np.uint8) for a, _ in sw]
    ts = [np.asarray(b, np.uint8) for _, b in sw]
    m = np.array([len(a) for a in qs], np.int32)
    n = np.array([len(b) for b in ts], np.int32)
    if off is None:
        off = np.clip((W - (m - n)) // 2, 16, W - 16).astype(np.int32)
    return qs, ts, m, n, np.asarray(off, np.int32)


def _jax_streams(qs, ts, m, n, off):
    """The JAX package's streams on _myers_dispatch's half-octave pads."""
    qp_w = jm._half_octave(int(m.max()) + W + 2)
    n_pad = jm._half_octave(int(n.max()) + 1)
    qpad = np.full((len(qs), qp_w), 4, np.int8)
    tpad = np.full((len(qs), n_pad), 4, np.int8)
    for b in range(len(qs)):
        qpad[b, : m[b]] = qs[b]
        tpad[b, : n[b]] = ts[b]
    out = jm._build_streams(jnp.asarray(qpad), jnp.asarray(tpad),
                            jnp.asarray(off), nw=NW)
    return [np.asarray(x) for x in out]


def _port_streams(qs, ts, m, n, off):
    flat, starts = tm.flat_pairs(qs, ts)
    t = torch.from_numpy
    fl = t(flat)
    return tm.build_streams(fl, fl, t(starts[0]), t(starts[1]), t(m), t(n),
                            t(off), nw=NW)


def _streams_model(flat, starts, m, n, off, n_pad, TP=32, TC=64):
    """The myers_streams kernel, block by block and thread by thread, in
    numpy: tiles of TP pairs x TC columns, eight columns of one pair a
    thread into the tile, then the tile's rows out; one more row of blocks
    for the window words, a thread a (word, pair)."""
    B = len(m)
    q8 = flat.view(np.int8)
    qtop = np.full((n_pad, B), -99, np.int32)
    tch = np.full((n_pad, B), -99, np.int32)
    win = np.zeros((4, NW, B), np.uint32)
    col_tiles = -(-n_pad // TC)
    for bx in range(-(-B // TP)):
        b0 = bx * TP
        for by in range(col_tiles + 1):
            if by == col_tiles:
                for t in range(256):
                    lane, w = t % 32, t // 32
                    b = b0 + lane
                    if b >= B:
                        continue
                    for r in range(32):
                        k = 32 * w + r - off[b]
                        c = int(q8[starts[0, b] + k]) if 0 <= k < m[b] else 4
                        if 0 <= c < 4:
                            win[c, w, b] |= np.uint32(1 << r)
                continue
            c0 = by * TC
            tt = np.zeros((TP, TC), np.int8)
            qq = np.zeros((TP, TC), np.int8)
            for t in range(256):
                p, j0 = t >> 3, (t & 7) * 8
                b = b0 + p
                if b >= B:
                    continue
                i0 = c0 + j0 + W - off[b]
                for jj in range(8):
                    j = c0 + j0 + jj
                    i = max(i0 + jj, 0)
                    tt[p, j0 + jj] = q8[starts[1, b] + j] if j < n[b] else 4
                    qq[p, j0 + jj] = q8[starts[0, b] + i] if i < m[b] else 4
            for c in range(TC):
                j = c0 + c
                if j >= n_pad:
                    break
                nb = min(TP, B - b0)
                tch[j, b0 : b0 + nb] = tt[:nb, c]
                qtop[j, b0 : b0 + nb] = qq[:nb, c]
    return qtop, tch, win


def _pairs(rng, B, lo, hi, skew=0):
    qs, ts = [], []
    for _ in range(B):
        L = int(rng.integers(lo, hi + 1))
        t = rng.integers(0, 4, L).astype(np.int8)
        q = t.copy()
        hit = rng.random(L) < 0.12
        q[hit] = rng.integers(0, 4, int(hit.sum()))
        if skew:
            q = np.concatenate([q, rng.integers(0, 4, skew).astype(np.int8)])
        qs.append(q)
        ts.append(t)
    return qs, ts


def _sets():
    rng = np.random.default_rng(41)
    e = np.zeros(0, np.int8)
    one = lambda L: rng.integers(0, 4, L).astype(np.int8)
    yield "empty", [e, e, one(5)], [e, one(3), e]
    x = one(300)
    yield "m_eq_n", [x, one(200)], [x.copy(), one(200)]
    # off clamped at 16 (m - n > 224) and at W - 16 (m == n)
    yield "m_gg_n", [one(900), one(400), one(40)], [one(300), one(150),
                                                     one(40)]
    yield "b1", [one(777)], [one(700)]
    yield "n_codes", [np.where(one(300) == 0, 4, one(300)).astype(np.int8)], \
        [one(280)]
    yield "ragged", *_pairs(rng, 33, 1, 600, skew=50)
    yield "b5120", *_pairs(rng, 5120, 0, 24)


SETS = {name: (qs, ts) for name, qs, ts in _sets()}
# the band offset at both ends of the wrapper's clamp and past it (the
# wrapper's own m >= n never reaches W - 16)
OFFS = {"ragged": None, "m_gg_n": [16, 16, 240], "b1": [240],
        "m_eq_n": [0, 255]}


def _case(name):
    qs, ts = SETS[name.split(":")[0]]
    return _swapped(qs, ts, OFFS[name.split(":")[0]] if ":" in name
                    else None)


CASES = list(SETS) + [f"{k}:off" for k in OFFS if OFFS[k] is not None]


@pytest.mark.parametrize("name", CASES)
def test_streams_equal_jax(name):
    """qtop, tch (the port's n_pad = max(n, 1) columns, the JAX package's
    first as many of its padded columns) and the window words."""
    qs, ts, m, n, off = _case(name)
    jq, jt, jw = _jax_streams(qs, ts, m, n, off)
    tq, tt, tw = _port_streams(qs, ts, m, n, off)
    n_pad = max(int(n.max()), 1)
    assert tq.shape == (n_pad, len(qs)) and tt.shape == (n_pad, len(qs))
    assert tq.dtype == tt.dtype == tw.dtype == torch.int32
    assert np.array_equal(jq[:n_pad], tq.numpy())
    assert np.array_equal(jt[:n_pad], tt.numpy())
    assert np.array_equal(jw.astype(np.uint32), tw.numpy().view(np.uint32))


@pytest.mark.parametrize("name", [c for c in CASES if c != "b5120"])
def test_kernel_model_equals_plain(name):
    qs, ts, m, n, off = _case(name)
    flat, starts = tm.flat_pairs(qs, ts)
    n_pad = max(int(n.max()), 1)
    mq, mt, mw = _streams_model(flat, starts, m, n, off, n_pad)
    tq, tt, tw = _port_streams(qs, ts, m, n, off)
    assert np.array_equal(mq, tq.numpy())
    assert np.array_equal(mt, tt.numpy())
    assert np.array_equal(mw, tw.numpy().view(np.uint32))


def test_flat_pairs_layout():
    qs = [np.array([1, 2, 3], np.int8), np.zeros(0, np.int8)]
    ts = [np.array([0], np.int8), np.array([3, 3], np.int8)]
    flat, starts = tm.flat_pairs(qs, ts)
    assert flat.dtype == np.uint8 and starts.dtype == np.int64
    assert flat.tolist() == [1, 2, 3, 0, 3, 3]
    assert starts.tolist() == [[0, 3], [3, 4]]
    flat, starts = tm.flat_pairs([], [])
    assert flat.shape == (0,) and starts.shape == (2, 0)


def test_n_pad_given_and_read():
    """n_pad read from n when not given, as the caller passes it."""
    qs, ts, m, n, off = _swapped(*SETS["ragged"])
    flat, starts = tm.flat_pairs(qs, ts)
    t = torch.from_numpy
    fl = t(flat)
    a = tm.build_streams(fl, fl, t(starts[0]), t(starts[1]), t(m), t(n),
                         t(off), nw=NW)
    b = tm.build_streams(fl, fl, t(starts[0]), t(starts[1]), t(m), t(n),
                         t(off), nw=NW, n_pad=int(n.max()))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
