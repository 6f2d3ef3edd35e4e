"""The R = 2 traceback walk, wave_tb (nextdenovo_tpu_torch/ops/align.py).

On the card the walk runs one warp a pair, each walking its own pair's rows
of decisions.  Here, on the CPU: the port's wide-band tier against the JAX
package's Pallas kernels in interpret mode on batches whose walks end at
very different times, and the property the card's layout relies on: a
batch's walks equal each pair's walk alone, on real wavefront output, on
output whose band start `lo` was moved so that walks leave the band, and on
output whose rows past a pair's last anti-diagonal hold garbage.
Tolerance: exact equality."""
import os
import sys

import numpy as np
import pytest
import torch

from nextdenovo_tpu.io.simulate import mutate_read
from nextdenovo_tpu.ops import align as ja
from nextdenovo_tpu_torch.ops import align as ta

from torch_port_util import assert_same_results, rand_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ragged_pairs():
    """Five pairs of mixed lengths, one of them with an empty query."""
    rng = np.random.default_rng(51)
    qs, ts = [np.zeros(0, np.int8)], [rng.integers(0, 4, 60).astype(np.int8)]
    for L in (7, 90, 600, 1400):
        q, t = rand_pair(rng, L, 0.12)
        qs.append(q)
        ts.append(t)
    return qs, ts


def _indel_pairs():
    """Insertions and deletions of 150-400 bases, in the query and in the
    target."""
    rng = np.random.default_rng(52)
    qs, ts = [], []
    for k, cut in enumerate((150, 400, 250, 350)):
        L = 1100 if cut <= 250 else 900
        t = rng.integers(0, 4, L).astype(np.uint8)
        q = mutate_read(t, 0.08, rng)
        at = int(rng.integers(200, len(q) - 200))
        if k < 2:          # an insertion
            q = np.concatenate([q[:at], rng.integers(0, 4, cut), q[at:]])
        else:              # a deletion
            q = np.concatenate([q[:at], q[at + cut:]])
        q, t = q.astype(np.int8), t.astype(np.int8)
        if k % 2:          # the other orientation: the target carries it
            q, t = t, q
        qs.append(q)
        ts.append(t)
    return qs, ts


@pytest.mark.parametrize("which", ["ragged", "indels"])
def test_wave_tier_equal_jax(which):
    qs, ts = _ragged_pairs() if which == "ragged" else _indel_pairs()
    assert max(max(len(q), len(t)) for q, t in zip(qs, ts)) <= 1500
    ref = ja.band_align(qs, ts, R=2, interpret=True)
    got = ta.band_align(qs, ts, R=2, device="cpu")
    assert_same_results(ref, got)
    assert any(r["ok"] for r in got)


@pytest.fixture(scope="module")
def wave_fwd_out():
    """wave_fwd_plain's tb / lo for pairs of 0-800 bases and one with a
    200-base insertion, as _band_align_R builds its inputs."""
    rng = np.random.default_rng(53)
    qs, ts = [np.zeros(0, np.int8)], [np.zeros(0, np.int8)]
    for L in (20, 150, 400, 700, 800):
        q, t = rand_pair(rng, L, 0.12)
        qs.append(q)
        ts.append(t)
    t = rng.integers(0, 4, 600).astype(np.int8)
    qs.append(np.concatenate([t[:300], rng.integers(0, 4, 200).astype(np.int8),
                              t[300:]]))
    ts.append(t)
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    n_words = (int((m + n).max()) + 1 + ta.PACK - 1) // ta.PACK
    qpad = ta.pad_for_align(qs, int(m.max()), ta.BAND_W)
    rtpad = ta.pad_for_align([t[::-1] for t in ts], int(n.max()), ta.BAND_W)
    mn = torch.from_numpy(np.stack([m, n], axis=1))
    tb, lo, _ = ta.wave_fwd_plain(torch.from_numpy(qpad),
                                  torch.from_numpy(rtpad), mn, n_words)
    return tb, lo, mn


@pytest.mark.parametrize("case", ["real", "lo moved", "rows past the end"])
def test_wave_tb_batch_equals_each_pair_alone(wave_fwd_out, case):
    tb, lo, mn = wave_fwd_out
    if case == "lo moved":
        sys.path.insert(0, ROOT)
        import chip_smoke
        lo = chip_smoke.shift_lo(lo, mn)    # as the card's band-exit set
    elif case == "rows past the end":
        # the walk reads no row above a pair's last anti-diagonal, which
        # wave_fwd leaves undefined on the card
        words = ta.wave_fwd_defined(mn, tb.shape[1])
        tb = torch.where(words[:, :, None], tb,
                         torch.tensor(-1, dtype=torch.int32))
        end = (mn[:, 0] + mn[:, 1])[:, None]
        a = torch.arange(lo.shape[1])[None, :]
        lo = torch.where(a <= end, lo, torch.tensor(-7, dtype=torch.int32))
    ops, ok = ta.wave_tb_plain(tb, lo, mn)
    want_ops, want_ok = ta.wave_tb_plain(*wave_fwd_out)
    for b in range(tb.shape[0]):
        nw = int(mn[b].sum()) // ta.PACK + 1     # the pair's own rows only
        ops_b, ok_b = ta.wave_tb_plain(tb[b:b + 1, :nw].contiguous(),
                                       lo[b:b + 1, :nw * ta.PACK].contiguous(),
                                       mn[b:b + 1])
        assert torch.equal(ops[b, :nw * ta.PACK], ops_b[0]), (case, b)
        assert bool((ops[b, nw * ta.PACK:] == ta.OP_NONE).all()), (case, b)
        assert bool(ok[b]) == bool(ok_b[0]), (case, b)
    if case == "lo moved":
        assert not bool(ok.all())            # some walks left the band
        assert bool(ok[0::2].all())          # the pairs whose lo stayed
    else:
        assert torch.equal(ops, want_ops) and torch.equal(ok, want_ok)
        assert bool(ok.all())
