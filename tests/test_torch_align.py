"""The port's wavefront tier and two-tier band_align
(nextdenovo_tpu_torch/ops/align.py, plain PyTorch versions on the CPU)
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs.  Tolerance: exact equality."""
import numpy as np
import pytest

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


def test_wave_tier_small_equal():
    qs, ts = _small_set()
    ref = ja.band_align(qs, ts, R=2, interpret=True)
    got = ta.band_align(qs, ts, R=2, device="cpu")
    assert all(r["ok"] and r["reached"] for r in got)
    assert_same_results(ref, got)


def test_wave_tier_long_noisy_and_mismatched_equal():
    rng = np.random.default_rng(2)
    qs, ts = [], []
    for _ in range(2):
        q, t = rand_pair(rng, 1500, 0.12)
        qs.append(q)
        ts.append(t)
    t = rng.integers(0, 4, 400).astype(np.int8)
    qs.append(t[100:300].copy())       # very different lengths
    ts.append(t)
    qs.append(rng.integers(0, 4, 600).astype(np.int8))   # unrelated
    ts.append(rng.integers(0, 4, 700).astype(np.int8))
    t2 = rng.integers(0, 4, 1200).astype(np.int8)
    ins = np.concatenate([t2[:600], rng.integers(0, 4, 500).astype(np.int8),
                          t2[600:]])
    qs.append(ins)                     # a 500-base insertion mid-way
    ts.append(t2)
    ref = ja.band_align(qs, ts, R=2, interpret=True)
    got = ta.band_align(qs, ts, R=2, device="cpu")
    assert_same_results(ref, got)


@pytest.mark.parametrize("q_len,t_len", [(0, 5), (5, 0), (1, 1), (0, 0)])
def test_wave_tier_degenerate_equal(q_len, t_len):
    rng = np.random.default_rng(q_len * 7 + t_len)
    q = rng.integers(0, 4, q_len).astype(np.int8)
    t = rng.integers(0, 4, t_len).astype(np.int8)
    ref = ja.band_align([q], [t], R=2, interpret=True)
    got = ta.band_align([q], [t], R=2, device="cpu")
    assert_same_results(ref, got)


def test_two_tier_retry_equal():
    """Myers first, the wavefront tier on pairs that left its band: the
    set holds |m - n| > 200 pairs, so the retry tier runs in both."""
    rng = np.random.default_rng(3)
    qs, ts = _small_set()
    s = rng.integers(0, 4, 500).astype(np.int8)
    qs.append(s)
    ts.append(s.copy())
    t = rng.integers(0, 4, 900).astype(np.int8)
    qs.append(t[100:500].copy())       # |m - n| = 500
    ts.append(t)
    qs.append(t)
    ts.append(t[300:650].copy())       # |m - n| = 550, swapped roles
    from nextdenovo_tpu_torch.ops.myers import myers_align
    first = myers_align(qs, ts, device="cpu")
    assert sum(not r["ok"] for r in first) >= 2     # the retry tier has work
    ref = ja.band_align(qs, ts, interpret=True)
    got = ta.band_align(qs, ts, device="cpu")
    assert all(r["ok"] for r in got)
    assert_same_results(ref, got)


def test_pad_for_align_equal():
    rng = np.random.default_rng(1)
    seqs = [rng.integers(0, 4, n).astype(np.int8) for n in (5, 300, 0)]
    assert np.array_equal(ja.pad_for_align(seqs, 300, 256),
                          ta.pad_for_align(seqs, 300, 256))


def test_r1_tier_not_ported():
    """The name dates from when R=1 was refused.  The fixed-cadence tier
    now runs (tests/test_torch_align_fast.py holds it against the JAX
    kernels); only an R that names no tier is refused."""
    q = np.zeros(10, np.int8)
    (r,) = ta.band_align([q], [q], R=1, device="cpu")
    assert r["ok"] and r["reached"] and r["dist"] == 0 and len(r["ops"]) == 10
    with pytest.raises(ValueError, match="R must be"):
        ta.band_align([q], [q], R=3, device="cpu")


def test_hq_is_accepted_and_ignored():
    rng = np.random.default_rng(6)
    q, t = rand_pair(rng, 300, 0.1)
    a = ta.band_align([q], [t], device="cpu")
    b = ta.band_align([q], [t], hq=True, device="cpu")
    assert_same_results(a, b)


def _native_pairs():
    """16 seeded pairs: noisy, equal, unrelated, very different lengths, and
    lengths 0, 1 and 2."""
    rng = np.random.default_rng(16)
    qs, ts = [], []
    for n, err in ((40, 0.1), (300, 0.15), (900, 0.12), (1500, 0.02),
                   (120, 0.0), (60, 0.3)):
        q, t = rand_pair(rng, n, err)
        qs.append(q)
        ts.append(t)
    t = rng.integers(0, 4, 500).astype(np.int8)
    qs += [t[100:250].copy(), rng.integers(0, 4, 200).astype(np.int8)]
    ts += [t, rng.integers(0, 4, 260).astype(np.int8)]
    for q_len, t_len in ((0, 5), (5, 0), (1, 1), (2, 2), (1, 2), (2, 40),
                         (0, 0), (2, 1)):
        qs.append(rng.integers(0, 4, q_len).astype(np.int8))
        ts.append(rng.integers(0, 4, t_len).astype(np.int8))
    return qs, ts


@pytest.mark.parametrize("hq", [False, True])
def test_band_align_native_equal(hq):
    qs, ts = _native_pairs()
    assert len(qs) == 16
    ref = ja.band_align_native(qs, ts, hq=hq)
    got = ta.band_align_native(qs, ts, hq=hq)
    assert sum(r["ok"] for r in got) >= 8
    assert_same_results(ref, got)


def test_band_align_never_routes_to_native(monkeypatch):
    """The port's band_align on the CPU runs the plain versions of its
    tiers; only callers that name band_align_native reach the native
    aligner."""
    def refuse(*a, **k):
        raise AssertionError("band_align reached band_align_native")

    monkeypatch.setattr(ta, "band_align_native", refuse)
    qs, ts = _small_set()
    for R in (None, 1, 2):
        for hq in (False, True):
            res = ta.band_align(qs[:2], ts[:2], R=R, hq=hq, device="cpu")
            assert all(r["ok"] for r in res)
