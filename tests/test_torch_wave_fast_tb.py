"""The R = 1 traceback walk, wave_fast_tb (nextdenovo_tpu_torch/ops/align.py).

On the card the walk runs one warp a pair: the pair's 512 B word rows and
their bases stream ahead of the walk through a ring of TB_S words in shared
memory, each row between two OP_NONE sentinel lanes, so that a walk that
steps out of the band stops at its next step without a bound test; a DIAG
is one step of t -= 2 with any word crossing folded in; the warp collects a
word's ops and writes its 16 bytes when the walk leaves it, and rows the
walk never reaches are written OP_NONE.
The kernel cannot run here, so these tests hold, on the CPU and exactly:

  (a) a numpy model of the kernel (its steps, crossings, ring of words and
      bases with its copy groups and sentinels, per-word flushes and
      OP_NONE rows) equals
      wave_fast_tb_plain on the shifting / lost-band set of
      test_torch_align_fast.py, the degenerate pairs, ragged batches, walks
      with a DIAG across a word crossing, bases moved so that walks leave
      the band, and decisions drawn at random (walks that step out of the
      band inside a word); the model also shows that no row above a pair's last
      anti-diagonal is read and that every byte of ops is written;
  (b) the port's band_align(R=1) equals the JAX package's Pallas kernels in
      interpret mode on a small ragged batch.

The constants and the order of operations mirror
nextdenovo_tpu_torch/csrc/wave_fast.cu (wave_fast_tb_kernel)."""
import functools
import os
import sys

import numpy as np
import pytest
import torch

from nextdenovo_tpu.ops import align as ja
from nextdenovo_tpu_torch.ops import align as ta

from test_torch_align_fast import _shifting_set
from torch_port_util import assert_same_results, rand_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# csrc/wave_fast.cu: FW band cells, PACK anti-diagonals a word, TB_S ring
# stages a warp
FW, PACK, TB_S = 128, 16, 8
OP_DIAG, OP_UP, OP_LEFT, OP_NONE = 0, 1, 2, 3
GARBAGE = 0xAA          # what ops holds before the kernel writes it
SENTINEL = 0xFFFFFFFF   # the ring's words at lanes -1 and 128


class _Ring:
    """A warp's ring: stage k % TB_S receives word k's row and base in copy
    group k's turn; a copy may land any time between its issue and the wait
    that covers it, so a stage is unreadable from a refill's issue until a
    wait lands it.  Beside a row's 128 words sit two sentinels, lanes -1 and
    128, all ones (OP_NONE at every step)."""

    def __init__(self, tb, base, top):
        self.tb, self.base, self.top = tb, base, top
        self.stage = {}              # stage -> (word, group)
        self.groups = 0              # commit groups issued
        self.landed = 0              # groups 0 .. landed - 1 have landed

    def fetch(self, k):
        if k >= 0:
            assert k <= self.top, "a row above the walk's first word"
            self.stage[k % TB_S] = (k, self.groups)
        self.groups += 1

    def wait(self, pending):
        self.landed = max(self.landed, self.groups - pending)

    def _check(self, k):
        word, group = self.stage[k % TB_S]
        assert word == k and group < self.landed, (k, word, group)

    def row_word(self, k, lane):
        self._check(k)
        assert -1 <= lane <= FW, lane        # inside the row or a sentinel
        if lane in (-1, FW):
            return SENTINEL
        return int(self.tb[k, lane]) & 0xFFFFFFFF

    def base_of(self, k):
        if k < 0:                    # stage of no word: read, never used
            return None
        self._check(k)
        return int(self.base[k])


def _corr(base_k, base_below):
    if base_below is None:
        return None
    return min(max(base_k - base_below - 8, -FW + 1), FW - 1)


def model_wave_fast_tb(tb, base, mn, stats=None):
    """What wave_fast_tb_kernel computes, warp by warp: (ops, ok) as numpy
    arrays.  `stats` (a dict) counts the walks' steps and crossings, the
    crossings made by a DIAG from s = 0 and from s = 1, the walks that
    stepped out of the band and stopped at a sentinel, and those that left
    it at a crossing."""
    tb, base, mn = tb.numpy(), base.numpy(), mn.numpy()
    B, n_words, _ = tb.shape
    a_max = n_words * PACK
    ops = np.full((B, a_max), GARBAGE, np.uint8)
    ok = np.zeros(B, bool)
    st = stats if stats is not None else {}
    for key in ("steps", "crossings", "diag_s0", "diag_s1", "sentinel",
                "crossing_exit"):
        st.setdefault(key, 0)
    for b in range(B):
        m, end = int(mn[b, 0]), int(mn[b, 0]) + int(mn[b, 1])
        out = ops[b]
        if end < 0 or end >= a_max:
            out[:] = OP_NONE
            continue
        top = end >> 4
        out[(top + 1) * PACK:] = OP_NONE
        ring = _Ring(tb[b], base[b], top)
        for s in range(TB_S):
            ring.fetch(top - s)
        base0 = int(base[b, 0])
        ring.wait(TB_S - 2)
        cur, t = top, end
        base_top = ring.base_of(top)
        base_nxt = ring.base_of(top - 1)
        corr = _corr(base_top, base_nxt)
        lane = m - base_top - ((end & (PACK - 1)) + 1) // 2
        alive = 0 <= lane < FW
        if not alive:
            lane = 0
        rec = [OP_NONE] * PACK          # the ops of word cur, slot by slot
        last = None                  # (op, s) of the step before a crossing

        def step(refill):
            # the decision word at the walk's lane, a sentinel's (OP_NONE)
            # when the step before left the band
            nonlocal t, lane, alive, last
            word = ring.row_word(cur, lane)
            if refill:
                ring.fetch(cur - (TB_S - 1))
            s = t & (PACK - 1)
            op = (word >> (2 * s)) & 3
            st["sentinel"] += not 0 <= lane < FW
            rec[s] = op
            st["steps"] += 1
            last = (op, s)
            alive = op != OP_NONE
            p = t & 1
            if op == OP_DIAG:
                t -= 2
            elif op == OP_LEFT:
                t -= 1
                lane += p
            else:                    # UP, or NONE: the walk ends
                t -= 1
                lane += p - 1

        while alive and t > 0:
            t_floor = max(cur * PACK, 1)
            while alive and t >= t_floor:
                step(False)
            if not alive or t <= 0:
                break
            # the walk enters word cur - 1, if its lane is in the band, and
            # its lane moves by corr
            st["crossings"] += 1
            if last[0] == OP_DIAG:
                st[f"diag_s{last[1]}"] += 1
            out[cur * PACK:(cur + 1) * PACK] = rec
            rec = [OP_NONE] * PACK
            cur -= 1
            alive = 0 <= lane < FW and 0 <= lane + corr < FW
            lane += corr
            if not alive:
                st["crossing_exit"] += 1
                break
            ring.wait(TB_S - 3)
            base_cur, base_nxt = base_nxt, ring.base_of(cur - 1)
            corr = _corr(base_cur, base_nxt)
            step(True)
        out[cur * PACK:(cur + 1) * PACK] = rec
        out[:cur * PACK] = OP_NONE
        ok[b] = alive and 0 <= lane < FW and lane == -base0
    return ops, ok


def _forward(qs, ts):
    """wave_fast_fwd_plain's tb / base for these pairs, as _band_align_R
    builds its inputs."""
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    n_words = (int((m + n).max()) + 1 + PACK - 1) // PACK
    qpad = ta.pad_for_align(qs, int(m.max()), ta.FAST_W)
    rtpad = ta.pad_for_align([np.asarray(t)[::-1] for t in ts], int(n.max()),
                             ta.FAST_W, front=ta.T_FRONT)
    mn = torch.from_numpy(np.stack([m, n], axis=1))
    tb, base, _ = ta.wave_fast_fwd_plain(torch.from_numpy(qpad),
                                         torch.from_numpy(rtpad), mn, n_words)
    return tb, base, mn


@functools.lru_cache(maxsize=None)
def _ragged_fwd(B):
    return _forward(*_ragged(B))


def _ragged(B):
    rng = np.random.default_rng(80 + B)
    qs, ts = [], []
    for _ in range(B):
        q, t = rand_pair(rng, int(rng.integers(20, 400)), 0.12)
        qs.append(q)
        ts.append(t)
    return qs, ts


def _degenerate(q_len, t_len):
    rng = np.random.default_rng(q_len * 7 + t_len)
    return ([rng.integers(0, 4, q_len).astype(np.int8)],
            [rng.integers(0, 4, t_len).astype(np.int8)])


def _assert_model_equals_plain(tb, base, mn, stats=None):
    ops, ok = model_wave_fast_tb(tb, base, mn, stats)
    want_ops, want_ok = ta.wave_fast_tb_plain(tb, base, mn)
    assert not (ops == GARBAGE).any(), "a byte of ops left unwritten"
    assert np.array_equal(ops, want_ops.numpy())
    assert np.array_equal(ok, want_ok.numpy())
    return ok


@pytest.fixture(scope="module")
def shifting_fwd():
    return _forward(*_shifting_set())


def test_model_shifting_set(shifting_fwd):
    """Bases that re-centre by +-60, a pair whose band is lost, identical
    and unrelated pairs; the set's many crossings include DIAGs from s = 0
    and s = 1 that land in the word below."""
    st = {}
    ok = _assert_model_equals_plain(*shifting_fwd, stats=st)
    assert ok[0] and not ok[1] and ok[4] and ok[5]
    assert st["diag_s0"] > 0 and st["diag_s1"] > 0, st


@pytest.mark.parametrize("q_len,t_len", [(0, 5), (5, 0), (1, 1), (0, 0)])
def test_model_degenerate(q_len, t_len):
    """One pair alone in a launch of one word; (0, 5) starts outside the band
    (lane -3), as in the reference."""
    ok = _assert_model_equals_plain(*_forward(*_degenerate(q_len, t_len)))
    assert bool(ok[0]) == ((q_len, t_len) != (0, 5))


@pytest.mark.parametrize("B", [1, 3, 5, 33])
def test_model_ragged(B):
    st = {}
    ok = _assert_model_equals_plain(*_ragged_fwd(B), stats=st)
    assert ok.sum() >= B - 1 and st["crossings"] > 0


def test_model_diag_across_word_crossing():
    """Runs of DIAGs from an even end (an identical pair: every crossing is
    a DIAG from s = 0, landing on s = 14 of the word below) and from an odd
    end (the query lacks the first base: DIAGs from s = 1, landing on
    s = 15)."""
    rng = np.random.default_rng(84)
    s = rng.integers(0, 4, 300).astype(np.int8)
    st_even, st_odd = {}, {}
    ok = _assert_model_equals_plain(*_forward([s], [s.copy()]), stats=st_even)
    assert ok.all() and st_even["diag_s1"] == 0
    assert st_even["diag_s0"] == st_even["crossings"] > 0
    ok = _assert_model_equals_plain(*_forward([s[1:].copy()], [s.copy()]),
                                    stats=st_odd)
    assert ok.all() and st_odd["diag_s1"] > 0


def _chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("by", [300, 40])
def test_model_band_exits(shifting_fwd, by):
    """base moved over a run of words in every other pair: the walks leave
    the band mid-way at a crossing (by 300, the correction is clamped to
    +-127) or walk on in shifted lanes (by 40); the even pairs keep their
    walks."""
    shift_base = _chip_smoke().shift_base
    for tb, base, mn in (_ragged_fwd(33), shifting_fwd):
        moved = shift_base(base, mn, by)
        st = {}
        ok = _assert_model_equals_plain(tb, moved, mn, stats=st)
        assert st["crossing_exit"] > 0 and not ok.all()
        want_ok = ta.wave_fast_tb_plain(tb, base, mn)[1].numpy()
        assert np.array_equal(ok[0::2], want_ok[0::2])


def test_model_random_decisions():
    """Decisions drawn at random, walks started near the band's edges: walks
    step out of the band inside a word and stop at a sentinel, stop at
    NONE, and leave the band at crossings of every correction."""
    rng = np.random.default_rng(85)
    tb, base, mn = _chip_smoke().random_fast_tb(rng, 64, 48)
    st = {}
    _assert_model_equals_plain(tb, base, mn, stats=st)
    assert st["sentinel"] > 0 and st["crossing_exit"] > 0, st
    assert st["diag_s0"] > 0 and st["diag_s1"] > 0, st


def test_model_rows_past_the_end(shifting_fwd):
    """Garbage in the rows and bases above a pair's last anti-diagonal, which
    wave_fast_fwd leaves undefined on the card, changes nothing."""
    tb, base, mn = shifting_fwd
    words = ta.wave_fwd_defined(mn, tb.shape[1])
    garbage = lambda v: torch.tensor(v, dtype=torch.int32)
    tb_g = torch.where(words[:, :, None], tb, garbage(-1))
    base_g = torch.where(words, base, garbage(-999))
    ops, ok = model_wave_fast_tb(tb_g, base_g, mn)
    want_ops, want_ok = ta.wave_fast_tb_plain(tb, base, mn)
    assert np.array_equal(ops, want_ops.numpy())
    assert np.array_equal(ok, want_ok.numpy())


def test_fast_tier_ragged_equal_jax():
    qs, ts = _ragged(5)
    ref = ja.band_align(qs, ts, R=1, interpret=True)
    got = ta.band_align(qs, ts, R=1, device="cpu")
    assert_same_results(ref, got)
    assert sum(r["ok"] for r in got) >= 4
