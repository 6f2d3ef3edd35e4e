"""The R = 2 forward wavefront, wave_fwd (nextdenovo_tpu_torch/ops/align.py).

On the card the forward pass runs one warp a pair: lane l keeps band cells
8l .. 8l+7 of the last two wavefronts in registers, the cells across a lane
edge come by shuffle, the codes a word of 16 anti-diagonals reads are staged
a word ahead as bytes in a shared window, and every lane plans the band
itself from a lane-then-shuffle argmin.  The kernel cannot run here, so
these tests hold, on the CPU and exactly:

  (a) wave_fwd_plain on ragged batches equals each pair run alone, and the
      port's band_align(R=2) equals the JAX package's Pallas kernels in
      interpret mode on the same batches;
  (b) a numpy model of the kernel (its lane layout, shifts, neighbour
      reuse, byte windows, byte compares and edge-free words) equals
      wave_fwd_plain, and
      over random legal band plans every code a word reads lies inside the
      window staged for it and reads as qpad / rtpad read directly;
  (c) the lane-then-shuffle argmin equals _lowest_argmin on inputs full of
      ties and INF;
  (d) a word the kernel runs without the matrix edge tests has no cell
      with i <= 0, j <= 0, i > m or j > n, and no clamp of the plan acts
      in it.

The constants below mirror nextdenovo_tpu_torch/csrc/wave.cu
(wave_fwd_kernel, window_load, codes8, byte_eq, byte_sign)."""
import numpy as np
import pytest
import torch

from nextdenovo_tpu.ops import align as ja
from nextdenovo_tpu_torch.ops import align as ta

from torch_port_util import assert_same_results, rand_pair

# csrc/wave.cu: W band cells, PACK anti-diagonals a word, CPL cells a lane,
# WIN_WORDS 32-bit words of a code window, INF
W, PACK, CPL, LANES = 256, 16, 8, 32
WIN_BYTES = 96 * 4
INF = 1 << 28
OP_DIAG, OP_UP, OP_LEFT = 0, 1, 2


def _ragged_pairs():
    """An empty pair, pairs of 7 to 1400 bases, and |m - n| > 200 both
    ways."""
    rng = np.random.default_rng(71)
    qs, ts = [np.zeros(0, np.int8)], [rng.integers(0, 4, 40).astype(np.int8)]
    for L in (7, 120, 500, 1400):
        q, t = rand_pair(rng, L, 0.12)
        qs.append(q)
        ts.append(t)
    t = rng.integers(0, 4, 900).astype(np.int8)
    qs += [t[150:530].copy(), t]
    ts += [t, t[100:420].copy()]
    return qs, ts


def _inputs(qs, ts):
    """The tensors _band_align_R hands wave_fwd for these pairs."""
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    n_words = (int((m + n).max()) + 1 + PACK - 1) // PACK
    qpad = ta.pad_for_align(qs, int(m.max()), ta.BAND_W)
    rtpad = ta.pad_for_align([np.asarray(t)[::-1] for t in ts], int(n.max()),
                             ta.BAND_W)
    return (torch.from_numpy(qpad), torch.from_numpy(rtpad),
            torch.from_numpy(np.stack([m, n], axis=1)), n_words)


@pytest.fixture(scope="module")
def ragged_fwd():
    qpad, rtpad, mn, n_words = _inputs(*_ragged_pairs())
    return (qpad, rtpad, mn, n_words), ta.wave_fwd_plain(qpad, rtpad, mn,
                                                         n_words)


def test_wave_fwd_batch_equals_each_pair_alone(ragged_fwd):
    (qpad, rtpad, mn, n_words), (tb, lo, stats) = ragged_fwd
    words = ta.wave_fwd_defined(mn, n_words)
    for b in range(qpad.shape[0]):
        nw = int(mn[b].sum()) // PACK + 1        # the pair's own words
        tb_b, lo_b, st_b = ta.wave_fwd_plain(qpad[b:b + 1], rtpad[b:b + 1],
                                             mn[b:b + 1], nw)
        assert bool(words[b, :nw].all()) and not bool(words[b, nw:].any())
        assert torch.equal(tb[b, :nw], tb_b[0]), b
        assert torch.equal(lo[b, :nw * PACK], lo_b[0]), b
        assert bool((lo[b, nw * PACK:] == 0).all()), b
        assert torch.equal(stats[b], st_b[0]), b
    assert bool(stats[:, 1].all())


def test_wave_tier_ragged_equal_jax():
    qs, ts = _ragged_pairs()
    ref = ja.band_align(qs, ts, R=2, interpret=True)
    got = ta.band_align(qs, ts, R=2, device="cpu")
    assert_same_results(ref, got)
    assert sum(r["ok"] for r in got) >= 5


# ---------------------------------------------------------------------------
# a numpy model of wave_fwd_kernel


def _byte_eq(a, b):
    """byte_eq: the top bit of each byte set where the two words agree."""
    x = (a ^ b).astype(np.uint64)
    return (~((((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x)) & 0xFFFFFFFF).astype(
        np.uint32)


def _byte_sign(x, k):
    """byte_sign<k> (prmt's sign mode): -1 where byte k's top bit is set."""
    return np.where((x >> (8 * k + 7)) & 1, -1, 0).astype(np.int64)


def test_byte_eq_every_byte_pair():
    a = np.repeat(np.arange(256, dtype=np.uint32), 256)
    b = np.tile(np.arange(256, dtype=np.uint32), 256)
    for k in range(4):                       # each byte of the word in turn
        got = _byte_sign(_byte_eq(a << (8 * k), b << (8 * k)), k)
        assert np.array_equal(got, -(a == b).astype(np.int64))
    # neighbours never leak into a byte: all four bytes at once
    rng = np.random.default_rng(72)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    y = np.where(rng.random(4096) < 0.5, x,
                 rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32))
    y = np.where(rng.random(4096) < 0.5, y, x ^ 0x00FF0000)
    eq = _byte_eq(x, y)
    for k in range(4):
        want = ((x >> (8 * k)) & 0xFF) == ((y >> (8 * k)) & 0xFF)
        assert np.array_equal(_byte_sign(eq, k), -want.astype(np.int64))


def _plan_lo(lo1, s_total, s, a, m, n):
    lo_a = max(max(lo1 + (1 if s_total > s else 0), a - n), 0)
    return min(min(lo_a, m), lo1 + 1)


def _window(codes, base):
    """window_load + pack4: code[clamp(base + p)] as a byte, p < WIN_BYTES."""
    idx = np.clip(base + np.arange(WIN_BYTES), 0, len(codes) - 1)
    return (codes[idx] & 0xFF).astype(np.uint8)


def _lane_reads(win, off):
    """codes8: lane l reads the 32-bit words off_l // 4 .. + 2 and keeps the
    8 bytes from off_l on; every word it loads must lie in the window."""
    assert off.min() >= 0 and (off.max() // 4 + 3) * 4 <= WIN_BYTES
    return win[off[:, None] + np.arange(CPL)[None, :]]


def _inner_word(lo1, a0, m, n):
    """The word runs without the edge tests and with s1 fixed (the kernel's
    `inner`): its band starts lie in [lo1, lo1 + 16]."""
    return (lo1 >= 1 and lo1 + PACK + (W - 1) <= m and a0 - lo1 - W >= 1
            and a0 + PACK - 1 - lo1 <= n)


def _lane_argmin(v):
    """(B, W) -> the (value, index) every lane holds after the lane's
    ascending strict-< scan of its 8 cells and five xor-shuffle rounds."""
    B = v.shape[0]
    cells = v.reshape(B, LANES, CPL)
    bv, bi = cells[:, :, 0].copy(), np.zeros((B, LANES), np.int64)
    for k in range(1, CPL):
        take = cells[:, :, k] < bv
        bv = np.where(take, cells[:, :, k], bv)
        bi = np.where(take, k, bi)
    bi = bi + CPL * np.arange(LANES)[None, :]
    for d in (16, 8, 4, 2, 1):
        src = np.arange(LANES) ^ d
        ov, oi = bv[:, src], bi[:, src]
        take = (ov < bv) | ((ov == bv) & (oi < bi))
        bv, bi = np.where(take, ov, bv), np.where(take, oi, bi)
    return bv, bi


def _words(codes8):
    """The lane's 8 codes as codes8 hands them over: two 32-bit words."""
    c = codes8.astype(np.uint32)
    lo = c[:, 0] | c[:, 1] << 8 | c[:, 2] << 16 | c[:, 3] << 24
    hi = c[:, 4] | c[:, 5] << 8 | c[:, 6] << 16 | c[:, 7] << 24
    return lo, hi


def _kernel_model(q, rt, m, n, n_words):
    """One warp's run of wave_fwd_kernel on one pair, lanes as rows."""
    lane = np.arange(LANES)
    k = np.arange(CPL)
    A = np.full((LANES, CPL), INF, np.int64)     # wavefront a-1
    P = np.full((LANES, CPL + 1), INF, np.int64)  # a-2 as the L of a-1
    lo1 = 0
    end = m + n
    last_word = min(end // PACK, n_words - 1)
    tb = np.zeros((n_words, W), np.uint32)
    lo_out = np.zeros(n_words * PACK, np.int32)
    dist, reached = INF, 0
    qb, tbase = 0, n - 15
    n_inner = 0

    def step(s1, oq, ot, a, lo_a, edge):
        nonlocal A, P, bits
        q_lo, q_hi = _words(_lane_reads(wq, oq))
        t_lo, t_hi = _words(_lane_reads(wt, ot))
        eq = (_byte_eq(q_lo, t_lo), _byte_eq(q_hi, t_hi))
        sm1 = np.stack([_byte_sign(eq[c // 4], c % 4) for c in range(CPL)], 1)
        if s1:      # the cell above lane l's top comes from lane l + 1
            nb = np.concatenate([A[1:, 0], [INF]])
            L = np.concatenate([A, nb[:, None]], axis=1)
        else:       # the cell below lane l's bottom from lane l - 1
            nb = np.concatenate([[INF], A[:-1, CPL - 1]])
            L = np.concatenate([nb[:, None], A], axis=1)
        up, left, diag = L[:, :CPL], L[:, 1:], P[:, s1:s1 + CPL]
        cdm = diag + sm1
        pu = up <= left
        ul = np.where(pu, up, left)
        pd = cdm <= ul
        v = np.where(pd, cdm, ul) + 1
        op = np.where(pd, OP_DIAG, np.where(pu, OP_UP, OP_LEFT))
        if edge:
            i = lo_a + CPL * lane[:, None] + k[None, :]
            j = a - i
            v = np.where(i == 0, j, v)
            op = np.where(i == 0, OP_LEFT, op)
            v = np.where(j == 0, i, v)
            op = np.where(j == 0, OP_UP, op)
            v = np.where((i < 0) | (i > m) | (j < 0) | (j > n), INF, v)
        bits = (bits >> 2) | (op.astype(np.uint64) << 30)
        A, P = v, L

    for word in range(last_word + 1):
        a0 = word * PACK
        wq, wt = _window(q, qb), _window(rt, tbase)
        bv, bi = _lane_argmin(A.reshape(1, W))
        assert (bv == bv[:, :1]).all() and (bi == bi[:, :1]).all()
        bv, bi = int(bv[0, 0]), int(bi[0, 0])
        s_total = 0 if bv >= INF else min(max(bi - W // 2, 0), PACK)
        qb_n, tb_n = lo1, n - (a0 + PACK) + lo1 - 15
        bits = np.zeros((LANES, CPL), np.uint64)
        if _inner_word(lo1, a0, m, n):
            # s1 = 1 for s < s_total, then 0; the query window moves while
            # s1 = 1, the target's after
            n_inner += 1
            L0 = lo1
            oq = L0 + 1 - qb + CPL * lane
            ot = n - a0 + L0 + 2 - tbase + CPL * lane
            for s in range(PACK):
                a = a0 + s
                lo_a = L0 + min(s + 1, s_total)
                assert lo_a == _plan_lo(lo1, s_total, s, a, m, n)
                if s < s_total:
                    step(1, oq + s, ot, a, lo_a, False)
                else:
                    step(0, oq + s_total - 1, ot - 1 + s_total - s, a, lo_a,
                         False)
                assert a != end
                lo_out[a] = lo_a
                lo1 = lo_a
        else:
            for s in range(PACK):
                a = a0 + s
                lo_a = _plan_lo(lo1, s_total, s, a, m, n)
                assert lo_a - lo1 in (0, 1)
                step(lo_a - lo1, lo_a - qb + CPL * lane,
                     n - a + lo_a + 1 - tbase + CPL * lane, a, lo_a, True)
                lo_out[a] = lo_a
                if a == end:
                    w_t = m - lo_a
                    dist = int(A.reshape(-1)[w_t]) if 0 <= w_t < W else INF
                    reached = 1
                lo1 = lo_a
        tb[word] = bits.reshape(-1).astype(np.uint32)
        qb, tbase = qb_n, tb_n
    return tb.view(np.int32), lo_out, np.array([dist, reached], np.int32), \
        n_inner


def test_kernel_model_equals_plain(ragged_fwd):
    (qpad, rtpad, mn, n_words), (tb, lo, stats) = ragged_fwd
    words = ta.wave_fwd_defined(mn, n_words).numpy()
    q, rt, mn_np = qpad.numpy(), rtpad.numpy(), mn.numpy()
    inner = 0
    for b in range(q.shape[0]):
        m, n = int(mn_np[b, 0]), int(mn_np[b, 1])
        tb_k, lo_k, st_k, n_inner = _kernel_model(q[b], rt[b], m, n, n_words)
        assert np.array_equal(np.where(words[b][:, None], tb_k, 0),
                              tb[b].numpy()), b
        assert np.array_equal(lo_k, lo[b].numpy()), b
        assert np.array_equal(st_k, stats[b].numpy()), b
        inner += n_inner
    assert inner > 60           # the edge-free words were exercised


def _random_plans(rng, n_plans):
    """(m, n, lo per anti-diagonal) from the kernel's plan rule with random
    shift budgets a word (any budget is legal: the argmin decides it)."""
    for _ in range(n_plans):
        m, n = (int(x) for x in rng.integers(0, 3000, 2))
        if rng.random() < 0.2:
            m = int(rng.integers(0, 40))
        n_words = (m + n) // PACK + 1
        lo, lo1 = np.zeros(n_words * PACK, np.int64), 0
        for word in range(n_words):
            s_total = int(rng.choice([0, PACK, rng.integers(0, PACK + 1)]))
            for s in range(PACK):
                a = word * PACK + s
                lo1 = lo[a] = _plan_lo(lo1, s_total, s, a, m, n)
        yield m, n, lo


def test_code_windows_cover_every_read():
    rng = np.random.default_rng(73)
    lane = np.arange(LANES)
    for m, n, lo in _random_plans(rng, 30):
        QP, TP = m + 700, n + 700
        q = rng.integers(-128, 128, QP)
        rt = rng.integers(-128, 128, TP)
        qb, tbase, lo1 = 0, n - 15, 0
        for word in range(len(lo) // PACK):
            a0 = word * PACK
            wq, wt = _window(q, qb), _window(rt, tbase)
            for s in range(PACK):
                a = a0 + s
                i = lo[a] + CPL * lane[:, None] + np.arange(CPL)[None, :]
                ti = n - (a - i) + 1
                got_q = _lane_reads(wq, lo[a] - qb + CPL * lane)
                got_t = _lane_reads(wt, n - a + lo[a] + 1 - tbase + CPL * lane)
                assert np.array_equal(got_q, q[np.clip(i, 0, QP - 1)] & 0xFF)
                assert np.array_equal(got_t, rt[np.clip(ti, 0, TP - 1)] & 0xFF)
            qb, tbase = lo1, n - (a0 + PACK) + lo1 - 15
            lo1 = lo[a0 + PACK - 1]


def test_lane_shuffle_argmin_equals_lowest_argmin():
    rng = np.random.default_rng(74)
    B = 400
    v = rng.integers(0, 4, (B, W)) + 17             # many ties
    v[rng.random((B, W)) < 0.3] = INF
    v[::7] = INF                                    # all INF
    v[1::7] = INF + rng.integers(0, 3, (len(v[1::7]), W))   # past INF
    v[2::7, -1] = 0                                 # the last cell alone
    v[3::7] = 5                                     # all equal
    bv, bi = _lane_argmin(v)
    want_v, want_i = ta._lowest_argmin(torch.from_numpy(v),
                                       torch.arange(W)[None, :], W)
    assert (bv == want_v.numpy()[:, None]).all()
    assert (bi == want_i.numpy()[:, None]).all()


def test_edge_free_words_hold_no_edge_cell():
    """Brute force over random plans: a word the kernel runs as edge-free
    has no cell on or outside the matrix edge in any of its 16 steps, and
    its band shifts exactly on its first s_total steps."""
    rng = np.random.default_rng(75)
    w = np.arange(W)
    n_inner = n_words = 0
    for m, n, lo in _random_plans(rng, 80):
        for word in range((m + n) // PACK + 1):
            a0 = word * PACK
            lo1 = int(lo[a0 - 1]) if a0 else 0
            n_words += 1
            if not _inner_word(lo1, a0, m, n):
                continue
            n_inner += 1
            steps = lo[a0:a0 + PACK] - np.concatenate([[lo1], lo[a0:a0 + PACK - 1]])
            s_total = int(steps.sum())
            assert list(steps) == [1] * s_total + [0] * (PACK - s_total)
            for s in range(PACK):
                i = lo[a0 + s] + w
                j = a0 + s - i
                assert i.min() >= 1 and i.max() <= m, (m, n, a0 + s)
                assert j.min() >= 1 and j.max() <= n, (m, n, a0 + s)
    assert n_inner > n_words // 10
