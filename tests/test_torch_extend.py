"""The port's affine-gap extender (nextdenovo_tpu_torch/ops/extend.py,
plain PyTorch version on the CPU) against the JAX package's Pallas kernel
in interpret mode and against the native scalar loop, on the same numpy
inputs.  Tolerance: exact equality."""
import numpy as np
import pytest

import jax.numpy as jnp

from nextdenovo_tpu.io.simulate import mutate_read
from nextdenovo_tpu.ops import extend as je
from nextdenovo_tpu_torch.native import affine_extend_cpu
from nextdenovo_tpu_torch.ops import extend as te


def _pairs(rng, n=8, err=0.12):
    """Diverged tails and short queries."""
    qs, ts = [], []
    for i in range(n):
        L = int(rng.integers(60, 320))
        t = rng.integers(0, 4, L).astype(np.int8)
        q = mutate_read(t.astype(np.uint8), err, rng).astype(np.int8)
        if i % 4 == 2:  # diverged tail: best endpoint < (m, n)
            q = np.concatenate([q[: L // 2],
                                rng.integers(0, 4, L // 2).astype(np.int8)])
        if i % 5 == 3:  # short query: extension stops early
            q = q[: max(20, L // 3)]
        qs.append(q)
        ts.append(t)
    return qs, ts


def _edge_pairs(rng):
    """Perfect match, off-band pair, m = 1, n = 1."""
    t200 = rng.integers(0, 4, 200).astype(np.int8)
    t600 = rng.integers(0, 4, 600).astype(np.int8)
    r = lambda n: rng.integers(0, 4, n).astype(np.int8)
    qs = [t200.copy(), t600[:100].copy(), r(1), r(50), r(1)]
    ts = [t200, t600, r(50), r(1), r(1)]
    return qs, ts


def _tie_pairs(rng, n=24):
    """Short two-letter pairs: many cells share the best score."""
    qs = [rng.integers(0, 2, int(rng.integers(4, 40))).astype(np.int8)
          for _ in range(n)]
    ts = [rng.integers(0, 2, int(rng.integers(4, 40))).astype(np.int8)
          for _ in range(n)]
    return qs, ts


def _jax_planes(qs, ts, rows=8):
    """The JAX kernel's (B, 3, 128) planes for these pairs, padded as
    nextdenovo_tpu.ops.extend.affine_extend pads them."""
    B0 = len(qs)
    padB = (-B0) % rows
    qs = list(qs) + [np.zeros(1, np.int8)] * padB
    ts = list(ts) + [np.zeros(1, np.int8)] * padB
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    bucket = lambda x: ((int(x) + 2047) // 2048) * 2048
    spg = je.STEPS_PER_GRID
    a_max = ((int((m + n).max()) + 1 + spg - 1) // spg) * spg
    m_max, n_max = bucket(m.max()), bucket(n.max())
    tf = je.TF + max(0, (m_max - n_max + 1) // 2)
    tf = (tf + 7) // 8 * 8
    qpad = je.pad_for_extend(qs, m_max, je.QF)
    TP = ((tf + n_max + 3 * 128 + 127) // 128) * 128
    rtpad = np.full((len(ts), TP), 5, np.int32)
    for b, t in enumerate(ts):
        t = np.asarray(t)[::-1]
        rtpad[b, tf + n_max - len(t) : tf + n_max] = t
        rtpad[b, : tf + n_max - len(t)] = 4
    out = np.asarray(je.affine_extend_fwd(
        jnp.asarray(qpad), jnp.asarray(rtpad),
        jnp.asarray(np.stack([m, n], axis=1)), a_max=a_max, n_max=n_max,
        tf=tf, rows=rows, interpret=True))
    out = out.transpose(0, 2, 1, 3).reshape(len(qs), 4, 128)
    return out[:B0, :3]


@pytest.mark.parametrize("name,make,seed", [
    ("mix", _pairs, 11), ("edges", _edge_pairs, 13), ("ties", _tie_pairs, 17)])
def test_affine_extend_equals_jax_kernel(name, make, seed):
    qs, ts = make(np.random.default_rng(seed))
    ref = je.affine_extend(qs, ts, rows=8, interpret=True)
    got = te.affine_extend(qs, ts, device="cpu")
    assert len(ref) == len(got) == len(qs)
    for i, (x, y) in enumerate(zip(ref, got)):
        assert x == y, (name, i, x, y)      # all five fields
    if name == "edges":
        assert got[0]["score"] == 400 and (got[0]["qe"], got[0]["te"]) == (200, 200)
        assert not got[1]["reached"] and got[1]["score"] >= 180
        assert got[1]["score_end"] == te.NINF


@pytest.mark.parametrize("name,make,seed", [
    ("mix", _pairs, 11), ("edges", _edge_pairs, 13), ("ties", _tie_pairs, 17)])
def test_affine_extend_equals_native_loop(name, make, seed):
    """Same band and tie order as the native scalar loop, which reports an
    unreached (m, n) by its own sentinel."""
    qs, ts = make(np.random.default_rng(seed))
    got = te.affine_extend(qs, ts, device="cpu")
    for q, t, g in zip(qs, ts, got):
        w = affine_extend_cpu(q.astype(np.uint8), t.astype(np.uint8))
        assert (g["score"], g["qe"], g["te"]) == (w["score"], w["qe"], w["te"])
        assert g["reached"] == w["reached"]
        if w["reached"]:
            assert g["score_end"] == w["score_end"]


def test_tie_set_holds_both_kinds_of_tie():
    """The tie set really has a best score shared by two lanes on the same
    anti-diagonal and one shared on different anti-diagonals, so the
    host-side tie-break (earliest anti-diagonal, then lowest lane) is
    exercised by the comparisons above."""
    qs, ts = _tie_pairs(np.random.default_rng(17))
    planes = te.affine_extend_fwd(qs, ts, device="cpu")
    same = diff = 0
    for p in planes:
        lanes = np.nonzero(p[0] == p[0].max())[0]
        if len(lanes) > 1:
            a = p[1][lanes]
            diff += int(len(set(a.tolist())) > 1)
            same += int(np.sum(a == a.min()) > 1)
    assert same >= 1 and diff >= 1, (same, diff)


@pytest.mark.parametrize("name,make,seed", [
    ("mix", _pairs, 11), ("ties", _tie_pairs, 17)])
def test_lane_planes_equal_jax_planes(name, make, seed):
    """best, besta and end per lane, for the real (non-padded) rows."""
    qs, ts = make(np.random.default_rng(seed))
    ref = _jax_planes(qs, ts)
    got = te.affine_extend_fwd(qs, ts, device="cpu")
    assert got.shape == ref.shape == (len(qs), 3, 128)
    assert np.array_equal(ref, got)


def test_sub_batching_changes_nothing(monkeypatch):
    qs, ts = _pairs(np.random.default_rng(11))
    whole = te.affine_extend(qs, ts, device="cpu")
    monkeypatch.setattr(te, "EXT_BUDGET", 1500)
    calls = []
    orig = te.ext_fwd
    monkeypatch.setattr(te, "ext_fwd",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    assert te.affine_extend(qs, ts, device="cpu") == whole
    assert len(calls) > 1


def test_empty_batch_and_default_device():
    import torch
    assert te.affine_extend([], [], device="cpu") == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            te.affine_extend([np.zeros(5, np.int8)], [np.zeros(5, np.int8)])
