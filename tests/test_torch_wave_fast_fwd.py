"""The R = 1 forward wavefront wave_fast_fwd (ops/align.py of the port).

On the card the forward pass runs one warp a pair: lane l keeps band cells
4l .. 4l+3 of the last two wavefronts in registers; under the fixed in-word
cadence every neighbour is static, so a step takes one cell across a lane
edge by shuffle; once a word every lane plans the re-centring itself from a
lane-then-warp argmin, reads its codes from two byte windows the word
before staged in shared memory, and shifts both wavefronts by delta through
a shared buffer with 8 INF guard cells a side; a word that touches no
matrix edge runs its steps without the edge and done tests.  The kernel
cannot run here, so these tests hold, on the CPU and exactly:

  (a) a numpy model of the kernel (its lanes, the one shuffle a step, the
      code windows staged a word ahead with clamped indices, the lane's
      code words read from them once a word and at constant byte offsets
      a step, byte_ne and the sign test, the guarded shift, the split into
      edge-free and general words, the done freeze) equals
      wave_fast_fwd_plain on the shifting / lost-band set of
      test_torch_align_fast.py, the degenerate pairs, ragged batches and
      pairs with |m - n| > 200 both ways; across them every delta lies in
      [-8, 8], delta reaches both ends, and the j-side and m-side clamps
      each decide words;
  (b) a word is run edge-free exactly when none of its cells lies on or
      outside the matrix edge, and the word holding m + n never is;
  (c) over every delta, step and lane the codes the model reads from the
      windows equal qpad / rtpad at the reference's clamped indices;
  (d) the lane-then-warp argmin equals _lowest_argmin on inputs full of
      ties and INF.

band_align(R=1) itself is held against the JAX package's Pallas kernels by
test_torch_align_fast.py and test_torch_wave_fast_tb.py.  The constants
and the order of operations mirror nextdenovo_tpu_torch/csrc/wave_fast.cu
(wave_fast_fwd_kernel, window_load, codes12, codes4, fast_step)."""
import functools

import numpy as np
import pytest
import torch

from nextdenovo_tpu_torch.ops import align as ta

from test_torch_align_fast import _shifting_set
from test_torch_wave_fast_tb import _chip_smoke, _degenerate, _ragged
from test_torch_wave_fwd import _byte_eq, _byte_sign

# csrc/wave_fast.cu: FW band cells, PACK anti-diagonals a word, CPL cells a
# lane, GUARD INF cells each side of the shift buffer, WIN bytes a code
# window
FW, PACK, CPL, LANES, GUARD, WIN = 128, 16, 4, 32, 8, 160
INF = 1 << 28
T_FRONT = 24
OP_DIAG, OP_UP, OP_LEFT = 0, 1, 2
UNWRITTEN = -999         # what tb / base hold before the kernel writes them


def _clamp_pairs():
    """chip_smoke.fast_clamp_pairs at the seed the card runs it with."""
    c = _chip_smoke()
    return c.fast_clamp_pairs(np.random.default_rng(c.CLAMP_SEED))


def _lane_argmin(v):
    """(B, FW) -> the (value, index) every lane holds after the lane's
    ascending strict-< scan of its 4 cells, the warp's minimum
    (__reduce_min_sync), the lowest lane holding it (__ffs of a ballot) and
    that lane's index (one shuffle)."""
    B = v.shape[0]
    cells = v.reshape(B, LANES, CPL)
    bv, bi = cells[:, :, 0].copy(), np.zeros((B, LANES), np.int64)
    for k in range(1, CPL):
        take = cells[:, :, k] < bv
        bv = np.where(take, cells[:, :, k], bv)
        bi = np.where(take, k, bi)
    gv = bv.min(axis=1, keepdims=True)
    src = np.argmax(bv == gv, axis=1)[:, None]     # the ballot's lowest bit
    gi = np.take_along_axis(bi, src, 1) + CPL * src
    return np.repeat(gv, LANES, 1), np.repeat(gi, LANES, 1)


def _byte_ne(a, b):
    """byte_ne: the top bit of each byte set where the two words differ
    (the complement of byte_eq)."""
    return ~_byte_eq(a, b) & np.uint32(0xFFFFFFFF)


def _inner(base, a0, m, n):
    """The kernel's edge-free word: every cell of its 16 steps lies inside
    1 <= i <= m, 1 <= j <= n."""
    return ((base >= 1) & (base + (FW - 1) + PACK // 2 <= m)
            & (a0 - base - (FW - 1) >= 1) & (a0 + PACK // 2 - 1 - base <= n))


def _window(codes, start):
    """window_load + window_store: byte p of a window is codes[clamp(start
    + p)] truncated to a byte, p < WIN; codes (B, ·), start (B,) -> (B, WIN)
    uint64."""
    idx = np.clip(start[:, None] + np.arange(WIN)[None, :], 0,
                  codes.shape[1] - 1)
    return (np.take_along_axis(codes, idx, 1) & 0xFF).astype(np.uint64)


def _codes12(win, off):
    """codes12: lane l's three words from byte off + 4l of a window, read as
    four aligned 32-bit words and funnel-shifted; off (B,) -> (B, LANES, 3)
    uint64.  Every word read lies in the window."""
    byte = off[:, None] + CPL * np.arange(LANES)[None, :]
    first = byte // 4
    assert first.min() >= 0 and (first.max() + 4) * 4 <= WIN
    words = (win[:, 0::4] | win[:, 1::4] << 8 | win[:, 2::4] << 16
             | win[:, 3::4] << 24)                           # (B, WIN // 4)
    w = np.stack([np.take_along_axis(words, first + r, 1) for r in range(4)],
                 2)
    sh = (8 * (byte % 4))[..., None].astype(np.uint64)
    return ((w[..., :3] | w[..., 1:] << 32) >> sh) & 0xFFFFFFFF


def _codes4(w, off):
    """codes4<off>: the four bytes from byte off on of three code words."""
    if off % 4 == 0:
        return w[..., off // 4]
    x = w[..., off // 4] | (w[..., off // 4 + 1] << 32)
    return (x >> (8 * (off % 4))) & 0xFFFFFFFF


def _word(q, rt, m, n, a0, A, Bv, lo_prev, dist, wq, wt, st):
    """One word of the warps in this batch (all live), given the windows
    the word before staged: returns (bits (B, FW) as uint32, base, A, Bv,
    dist, the next word's windows)."""
    B = len(m)
    rows = np.arange(B)
    lane = np.arange(LANES)
    end = m + n
    # ---- the re-centring, on every lane
    bv, bi = _lane_argmin(A.reshape(B, FW))
    assert (bv == bv[:, :1]).all() and (bi == bi[:, :1]).all()
    bv, bi = bv[:, 0], bi[:, 0]
    d0 = np.where(bv >= INF, 0, np.clip(bi - FW // 2, -8, 8))
    jb = (a0 + PACK - 1) - n - (lo_prev + 8)       # the j-side clamp
    mb = m - (lo_prev + 8)                          # the m-side clamp
    d1 = np.maximum(d0, jb)
    d2 = np.minimum(d1, mb)
    delta = np.maximum(d2, -lo_prev)
    delta = np.where(dist < INF, 0, delta)
    base = lo_prev + delta
    st["deltas"] += delta.tolist()
    # a clamp decides a word where it moved delta and delta stayed there
    st["j_clamp"] += int(((jb > d0) & (delta == jb)).sum())
    st["m_clamp"] += int(((mb < d1) & (delta == mb)).sum())
    # ---- the word's codes from its windows, then the next word's windows
    # from this word's base
    qw, tw = _codes12(wq, delta + 8), _codes12(wt, delta + 8)
    wq, wt = _window(q, base), _window(rt, T_FRONT + n - a0 - 23 + base)
    inner = _inner(base, a0, m, n)
    st["inner"] += int(inner.sum())
    st["words"] += B
    assert not (inner & (end >= a0) & (end < a0 + PACK)).any()
    # ---- the shift by delta through the guarded buffer, where delta != 0
    sh = np.nonzero(delta != 0)[0]
    if len(sh):
        sbuf = np.full((len(sh), 2, FW + 2 * GUARD), INF, np.int64)
        dst = GUARD + CPL * lane[:, None] + np.arange(CPL)[None, :]
        sbuf[:, 0, dst] = A[sh]
        sbuf[:, 1, dst] = Bv[sh]
        src = dst[None] + delta[sh, None, None]
        assert src.min() >= 0 and src.max() < FW + 2 * GUARD
        r = np.arange(len(sh))[:, None, None]
        A, Bv = A.copy(), Bv.copy()
        A[sh] = sbuf[r, 0, src]
        Bv[sh] = sbuf[r, 1, src]
    # ---- the 16 steps: edge-free words take the plain step, the others the
    # general one (edge tests, done freeze, capture at a == m + n)
    gen = ~inner[:, None, None]
    bits = np.zeros((B, LANES, CPL), np.uint64)
    done = dist < INF
    i0 = base[:, None, None] + CPL * lane[None, :, None] + \
        np.arange(CPL)[None, None, :]
    mm, nn = m[:, None, None], n[:, None, None]
    inf_col = np.full((B, 1), INF, np.int64)
    for s in range(PACK):
        H = (s + 1) // 2
        if s % 2 == 0:      # UP of cell 0 from lane l - 1, INF on lane 0
            nb = np.concatenate([inf_col, A[:, :-1, -1]], 1)
            up = np.concatenate([nb[:, :, None], A[:, :, :-1]], 2)
            left = A
        else:               # LEFT of cell 3 from lane l + 1, INF on lane 31
            nb = np.concatenate([A[:, 1:, 0], inf_col], 1)
            up = A
            left = np.concatenate([A[:, :, 1:], nb[:, :, None]], 2)
        ne = _byte_ne(_codes4(qw, H), _codes4(tw, 7 + H - s))
        msub = np.stack([_byte_sign(ne, k) for k in range(CPL)], 2)
        cd = Bv - msub
        pu = up <= left
        v = np.minimum(np.minimum(up, left) + 1, cd)
        pd = v == cd
        op = np.where(pd, OP_DIAG, np.where(pu, OP_UP, OP_LEFT))
        i = i0 + H
        j = a0 + s - i
        ve = np.where(i == 0, j, v)
        ope = np.where(i == 0, OP_LEFT, op)
        ve = np.where(j == 0, i, ve)
        ope = np.where(j == 0, OP_UP, ope)
        ve = np.where((i < 0) | (i > mm) | (j < 0) | (j > nn), INF, ve)
        ve = np.where(done[:, None, None], A, ve)
        v = np.where(gen, ve, v)
        op = np.where(gen, ope, op)
        bits |= op.astype(np.uint64) << np.uint64(2 * s)
        Bv, A = A, v
        at = ~inner & (a0 + s == end)
        if at.any():
            # (m, n) is cell m - base - (s + 1) / 2 of wavefront a
            w_t = m - base - H
            inb = at & (w_t >= 0) & (w_t < FW)
            wc = np.clip(w_t, 0, FW - 1)
            cand = A[rows, wc // CPL, wc % CPL]
            dist = np.where(inb, np.minimum(dist, cand), dist)
            done = np.where(at, dist < INF, done)
    return bits.reshape(B, FW).astype(np.uint32), base, A, Bv, dist, wq, wt


def kernel_model(qpad, rtpad, mn, n_words, stats=None):
    """What wave_fast_fwd_kernel computes, every warp at once (pairs as the
    first axis, lanes as the second, a lane's cells as the third): (tb, base,
    stats) as numpy arrays, tb as UNWRITTEN where the kernel writes nothing.
    A warp stops after its pair's last word.  `stats` (a dict) collects every
    word's delta, the words the j-side and the m-side clamps decided, the
    edge-free words and all words."""
    q, rt, mn = qpad.numpy(), rtpad.numpy(), mn.numpy().astype(np.int64)
    B = q.shape[0]
    st = stats if stats is not None else {}
    st.setdefault("deltas", [])
    for key in ("j_clamp", "m_clamp", "inner", "words"):
        st.setdefault(key, 0)
    m, n = mn[:, 0], mn[:, 1]
    last_word = np.minimum((m + n) // PACK, n_words - 1)
    A = np.full((B, LANES, CPL), INF, np.int64)    # wavefront a-1
    Bv = A.copy()                                   # wavefront a-2
    lo_prev = np.zeros(B, np.int64)
    dist = np.full(B, INF, np.int64)
    tb = np.full((B, n_words, FW), UNWRITTEN, np.int64)
    base_out = np.full((B, n_words), UNWRITTEN, np.int64)
    # word 0's windows, from the band start -8 of a word -1
    wq, wt = _window(q, np.full(B, -8)), _window(rt, T_FRONT + n - 15)
    for word in range(int(last_word.max()) + 1):
        L = np.nonzero(word <= last_word)[0]
        bits, base, A[L], Bv[L], dist[L], wq[L], wt[L] = _word(
            q[L], rt[L], m[L], n[L], word * PACK, A[L], Bv[L], lo_prev[L],
            dist[L], wq[L], wt[L], st)
        tb[L, word] = bits.view(np.int32)
        base_out[L, word] = base
        lo_prev[L] = base + 8
    # base past a pair's last word is written 0
    base_out[np.arange(n_words)[None, :] > last_word[:, None]] = 0
    assert (base_out != UNWRITTEN).all()
    return tb, base_out, np.stack([dist, (dist < INF).astype(np.int64)], 1)


# ---------------------------------------------------------------------------
# the model against wave_fast_fwd_plain


def _inputs(qs, ts):
    """The tensors _band_align_R(R=1) hands wave_fast_fwd for these pairs."""
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    n_words = (int((m + n).max()) + 1 + PACK - 1) // PACK
    qpad = ta.pad_for_align(qs, int(m.max()), ta.FAST_W)
    rtpad = ta.pad_for_align([np.asarray(t)[::-1] for t in ts], int(n.max()),
                             ta.FAST_W, front=ta.T_FRONT)
    return (torch.from_numpy(qpad), torch.from_numpy(rtpad),
            torch.from_numpy(np.stack([m, n], axis=1)), n_words)


SETS = {"shifting / lost band": _shifting_set,
        "|m-n| > 200 both ways": _clamp_pairs}
SETS.update({f"degenerate {q_len},{t_len}":
             functools.partial(_degenerate, q_len, t_len)
             for q_len, t_len in ((0, 5), (5, 0), (1, 1), (0, 0))})
SETS.update({f"ragged B={B}": functools.partial(_ragged, B)
             for B in (1, 3, 5, 33)})


@functools.lru_cache(maxsize=None)
def _model_run(name):
    """(model outputs, plain outputs, defined words, model stats) of a set."""
    qpad, rtpad, mn, n_words = _inputs(*SETS[name]())
    st = {}
    got = kernel_model(qpad, rtpad, mn, n_words, st)
    want = [x.numpy() for x in ta.wave_fast_fwd_plain(qpad, rtpad, mn,
                                                      n_words)]
    return got, want, ta.wave_fwd_defined(mn, n_words).numpy(), st


@pytest.mark.parametrize("name", list(SETS))
def test_kernel_model_equals_plain(name):
    """tb on the defined words, all of base and stats, exactly."""
    (tb, base, stats), (want_tb, want_base, want_stats), words, st = \
        _model_run(name)
    assert not (tb[words] == UNWRITTEN).any()
    assert np.array_equal(np.where(words[:, :, None], tb, 0), want_tb)
    assert np.array_equal(base, want_base)
    assert np.array_equal(stats, want_stats)
    assert len(st["deltas"]) == st["words"] == int(words.sum())


def test_delta_bounds_and_clamps():
    """Over the sets: every delta lies in [-8, 8] (the shift buffer's
    guards), both ends are reached, and the j-side and m-side clamps each
    decide words, also on the |m-n| > 200 set alone, which the card runs;
    the edge-free words are the larger part of the long pairs' words."""
    deltas, j_clamp, m_clamp = [], 0, 0
    for name in SETS:
        st = _model_run(name)[3]
        deltas += st["deltas"]
        j_clamp += st["j_clamp"]
        m_clamp += st["m_clamp"]
    assert min(deltas) == -8 and max(deltas) == 8
    assert j_clamp > 0 and m_clamp > 0
    st = _model_run("|m-n| > 200 both ways")[3]
    assert min(st["deltas"]) == -8 and max(st["deltas"]) == 8
    assert st["j_clamp"] > 0 and st["m_clamp"] > 0, st
    assert st["inner"] > st["words"] // 2


# ---------------------------------------------------------------------------
# edge-free words, code reads, the argmin


def _word_cells(base, a0):
    """(i, j) of every cell of the word's 16 steps."""
    s = np.arange(PACK)[:, None]
    i = base + (s + 1) // 2 + np.arange(FW)[None, :]
    return i, a0 + s - i


def test_edge_free_words_exact():
    """A word is run edge-free exactly when no cell of its 16 steps lies on
    or outside the matrix edge (i <= 0, j <= 0, i > m, j > n); the word
    holding m + n never is."""
    rng = np.random.default_rng(91)
    n_inner = 0
    for _ in range(3000):
        m, n = (int(x) for x in rng.integers(0, 2500, 2))
        a0 = PACK * int(rng.integers(0, (m + n) // PACK + 1))
        centre = a0 // 2 - FW // 2
        base = int(rng.choice([
            centre + int(rng.integers(-40, 41)), 0, 1, m - 135, m - 134,
            a0 - 128, a0 - 127, a0 + 7 - n, a0 + 6 - n]))
        i, j = _word_cells(base, a0)
        edge_free = bool(((i >= 1) & (i <= m) & (j >= 1) & (j <= n)).all())
        inner = bool(_inner(base, a0, m, n))
        assert inner == edge_free, (base, a0, m, n)
        if a0 <= m + n < a0 + PACK:
            assert not inner, (base, a0, m, n)
        n_inner += inner
    assert n_inner > 300


def test_code_reads_equal_clamped_indices():
    """Over every delta, step and lane, the four codes a lane reads (its
    three words from the windows the word before staged, at byte delta + 8 +
    4 lane, then the constant offsets) are q[clamp(i)] and
    rt[clamp(T_FRONT + n - j)] of its cells, truncated to a byte, for bands
    inside, across and outside both sequences."""
    rng = np.random.default_rng(92)
    lane = np.arange(LANES)[None, :, None]
    k = np.arange(CPL)[None, None, :]
    deltas = np.arange(-8, 9)
    for _ in range(60):
        m, n = (int(x) for x in rng.integers(0, 700, 2))
        QP, TP = m + 400, n + 400
        q = rng.integers(-128, 128, (1, QP)).repeat(len(deltas), 0)
        rt = rng.integers(-128, 128, (1, TP)).repeat(len(deltas), 0)
        a0 = PACK * int(rng.integers(0, (m + n) // PACK + 3))
        lo_prev = np.full(len(deltas), int(rng.integers(-200, m + 200)))
        # the windows the word before (band start lo_prev - 8) staged
        wq = _window(q, lo_prev - 8)
        wt = _window(rt, T_FRONT + n - a0 - 15 + lo_prev)
        qw, tw = _codes12(wq, deltas + 8), _codes12(wt, deltas + 8)
        base = (lo_prev + deltas)[:, None, None]
        for s in range(PACK):
            H = (s + 1) // 2
            i = base + H + CPL * lane + k
            j = a0 + s - i
            want_q = np.take_along_axis(q, np.clip(i, 0, QP - 1).reshape(
                len(deltas), -1), 1).reshape(i.shape) & 0xFF
            want_t = np.take_along_axis(rt, np.clip(
                T_FRONT + n - j, 0, TP - 1).reshape(len(deltas), -1),
                1).reshape(i.shape) & 0xFF
            got_q, got_t = _codes4(qw, H), _codes4(tw, 7 + H - s)
            for c in range(CPL):
                assert np.array_equal((got_q >> (8 * c)) & 0xFF,
                                      want_q[..., c]), (s, c)
                assert np.array_equal((got_t >> (8 * c)) & 0xFF,
                                      want_t[..., c]), (s, c)


def test_lane_warp_argmin_equals_lowest_argmin():
    rng = np.random.default_rng(93)
    B = 400
    v = rng.integers(0, 4, (B, FW)) + 17            # many ties
    v[rng.random((B, FW)) < 0.3] = INF
    v[::7] = INF                                    # all INF
    v[1::7] = INF + rng.integers(0, 3, (len(v[1::7]), FW))   # past INF
    v[2::7, -1] = 0                                 # the last cell alone
    v[3::7] = 5                                     # all equal
    v[4::7, 3::4] = 2                               # ties across lanes
    bv, bi = _lane_argmin(v)
    want_v, want_i = ta._lowest_argmin(torch.from_numpy(v),
                                       torch.arange(FW)[None, :], FW)
    assert (bv == want_v.numpy()[:, None]).all()
    assert (bi == want_i.numpy()[:, None]).all()
