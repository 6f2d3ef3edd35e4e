"""The port's fixed-cadence narrow-band tier, band_align(R=1)
(nextdenovo_tpu_torch/ops/align.py, plain PyTorch versions on the CPU)
against the JAX package's Pallas kernels _fwd_kernel_fast and
_tb_onehot_kernel in interpret mode, on the same numpy inputs.  Tolerance:
exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nextdenovo_tpu.ops import align as ja
from nextdenovo_tpu_torch.ops import align as ta

from torch_port_util import assert_same_results, rand_pair


def _small_set():
    rng = np.random.default_rng(0)
    qs, ts = [], []
    for _ in range(6):
        q, t = rand_pair(rng, int(rng.integers(30, 200)), 0.15)
        qs.append(q)
        ts.append(t)
    return qs, ts


def _shifting_set():
    """Identical pairs, a pair whose band is lost, an unrelated pair, a
    long noisy pair, and pairs whose band has to move both ways."""
    rng = np.random.default_rng(4)
    r = lambda n: rng.integers(0, 4, n).astype(np.int8)
    qs, ts = [], []
    s = r(500)
    qs.append(s)
    ts.append(s.copy())                 # identical
    t = r(400)
    qs.append(t[100:300].copy())        # drifts > 8 lanes per word: lost
    ts.append(t)
    qs.append(r(600))                   # unrelated
    ts.append(r(700))
    q, t = rand_pair(rng, 1000, 0.12)   # long and noisy
    qs.append(q)
    ts.append(t)
    t2 = r(1200)                        # +60 then -60: both directions
    qs.append(np.concatenate([t2[:300], r(60), t2[300:700], t2[760:]]))
    ts.append(t2)
    qs.append(t2)                       # the same with the roles swapped
    ts.append(qs[-2].copy())
    return qs, ts


def _port_forward(qs, ts):
    """wave_fast_fwd on these pairs as _band_align_R(R=1) calls it."""
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    n_words = (int((m + n).max()) + 1 + 15) // 16
    mn = torch.from_numpy(np.stack([m, n], axis=1))
    tb, base, stats = ta.wave_fast_fwd(
        torch.from_numpy(ta.pad_for_align(qs, int(m.max()), ta.FAST_W)),
        torch.from_numpy(ta.pad_for_align([np.asarray(t)[::-1] for t in ts],
                                          int(n.max()), ta.FAST_W,
                                          front=ta.T_FRONT)), mn, n_words)
    return m, n, n_words, mn, tb, base, stats


@pytest.fixture(scope="module")
def shifting():
    qs, ts = _shifting_set()
    return qs, ts, ta.band_align(qs, ts, R=1, device="cpu"), \
        _port_forward(qs, ts)


def test_fast_tier_small_equal():
    qs, ts = _small_set()
    ref = ja.band_align(qs, ts, R=1, interpret=True)
    got = ta.band_align(qs, ts, R=1, device="cpu")
    assert all(r["ok"] and r["reached"] for r in got)
    assert_same_results(ref, got)


def test_fast_tier_shifting_and_lost_band_equal(shifting):
    qs, ts, got, _ = shifting
    ref = ja.band_align(qs, ts, R=1, interpret=True)
    assert_same_results(ref, got)
    assert got[0]["dist"] == 0 and got[0]["ok"]
    assert np.all(got[0]["ops"] == 0) and len(got[0]["ops"]) == 500
    assert not got[1]["ok"]             # the band was lost, on both sides
    assert got[4]["ok"] and got[5]["ok"]


@pytest.mark.parametrize("q_len,t_len", [(0, 5), (5, 0), (1, 1), (0, 0)])
def test_fast_tier_degenerate_equal(q_len, t_len):
    rng = np.random.default_rng(q_len * 7 + t_len)
    q = rng.integers(0, 4, q_len).astype(np.int8)
    t = rng.integers(0, 4, t_len).astype(np.int8)
    ref = ja.band_align([q], [t], R=1, interpret=True)
    got = ta.band_align([q], [t], R=1, device="cpu")
    assert_same_results(ref, got)


def test_fast_forward_words_and_bases_equal(shifting):
    """The forward kernel's own outputs where the port defines them: packed
    traceback words, word bases and [dist, done]; the bases show the band
    re-centred in both directions."""
    qs, ts, _, (m, n, n_words, mn, tb, base, stats) = shifting
    B0 = len(qs)
    # the JAX side, padded as its wrapper pads (32 pairs, 2048-step chunks)
    jq = list(qs) + [np.zeros(1, np.int8)] * (32 - B0)
    jt = list(ts) + [np.zeros(1, np.int8)] * (32 - B0)
    jm = np.array([len(q) for q in jq], np.int32)
    jn = np.array([len(t) for t in jt], np.int32)
    a_max = ((int((jm + jn).max()) + 1 + 2047) // 2048) * 2048
    bucket = lambda x: ((int(x) + 2047) // 2048) * 2048
    jtb, jlo, jstats = ja.band_align_fwd_fast(
        jnp.asarray(ja.pad_for_align(jq, bucket(jm.max()), 128)),
        jnp.asarray(ja.pad_for_align([np.asarray(t)[::-1] for t in jt],
                                     bucket(jn.max()), 128,
                                     front=ja.T_FRONT)),
        jnp.asarray(np.stack([jm, jn], axis=1)), a_max=a_max, interpret=True)
    jtb = np.asarray(jtb).transpose(1, 0, 2)[:B0]             # (B, words, 128)
    jbase = np.asarray(jlo).reshape(a_max // 16, 32, 128)[:, :B0, 0].T
    jstats = np.asarray(jstats).reshape(32, 128)[:B0, :2]
    defined = ta.wave_fwd_defined(mn, n_words).numpy()
    assert np.array_equal(stats.numpy(), jstats)
    assert np.array_equal(base.numpy()[defined], jbase[:, :n_words][defined])
    assert np.array_equal(tb.numpy()[defined], jtb[:, :n_words][defined])
    # re-centring fired in both directions on the +60 / -60 pair
    for b in (4, 5):
        last = int((m[b] + n[b]) // 16)
        delta = np.diff(base.numpy()[b, : last + 1]) - 8
        assert delta.max() > 0 and delta.min() < 0, (b, delta)


def test_fast_traceback_plain_walk_matches_ops(shifting):
    """wave_fast_tb on the forward outputs gives band_align(R=1)'s ops, and
    a path that leaves the band is reported, not followed."""
    qs, ts, res, (m, n, n_words, mn, tb, base, _) = shifting
    ops, ok = ta.wave_fast_tb(tb, base, mn)
    assert ops.shape == (len(qs), n_words * 16) and ops.dtype == torch.uint8
    for b, r in enumerate(res):
        o = ops[b].numpy()
        assert np.array_equal(o[o != ta.OP_NONE], r["ops"])
        assert bool(ok[b]) == r["ok"]
        if r["ok"]:        # the ops consume exactly the two sequences
            assert int(np.sum(r["ops"] != ta.OP_LEFT)) == m[b]
            assert int(np.sum(r["ops"] != ta.OP_UP)) == n[b]


def test_r_must_be_a_known_tier():
    q = np.zeros(10, np.int8)
    with pytest.raises(ValueError, match="R must be"):
        ta.band_align([q], [q], R=4, device="cpu")
