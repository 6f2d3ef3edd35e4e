"""The port's segment reductions and minimizer sketch
(nextdenovo_tpu_torch/ops/segment.py, ops/sketch.py) against the JAX
package's, on the same numpy inputs.  Tolerance: exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextdenovo_tpu.ops import segment as jseg
from nextdenovo_tpu.ops import sketch as jsk
from nextdenovo_tpu_torch.ops import segment as tseg
from nextdenovo_tpu_torch.ops import sketch as tsk


def _segments(seed=0, n=300):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    vals = rng.integers(-50, 50, n).astype(np.int32)
    pay = rng.integers(0, 1000, n).astype(np.int32)
    return keys, vals, pay


def test_segment_starts_equal():
    keys, _, _ = _segments()
    assert np.array_equal(np.asarray(jseg.segment_starts(jnp.asarray(keys))),
                          tseg.segment_starts(torch.from_numpy(keys)).numpy())


@pytest.mark.parametrize("name", ["segment_sum", "segment_max", "segment_min",
                                  "segment_broadcast_last"])
def test_segment_reductions_equal(name):
    keys, vals, _ = _segments(1)
    js = jseg.segment_starts(jnp.asarray(keys))
    ts = tseg.segment_starts(torch.from_numpy(keys))
    ref = getattr(jseg, name)(jnp.asarray(vals), js)
    got = getattr(tseg, name)(torch.from_numpy(vals), ts)
    assert np.array_equal(np.asarray(ref), got.numpy())


def test_segment_argmax_equal():
    keys, vals, pay = _segments(3)
    vals = (vals // 10).astype(np.int32)          # many ties: first wins
    js = jseg.segment_starts(jnp.asarray(keys))
    ts = tseg.segment_starts(torch.from_numpy(keys))
    rs, rp = jseg.segment_argmax(jnp.asarray(vals), jnp.asarray(pay), js)
    gs, gp = tseg.segment_argmax(torch.from_numpy(vals),
                                 torch.from_numpy(pay), ts)
    assert np.array_equal(np.asarray(rs), gs.numpy())
    assert np.array_equal(np.asarray(rp), gp.numpy())


@pytest.mark.parametrize("k", [3, 8, 15, 17, 31])
def test_kmer_pack_and_hash_equal(k):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (2, 200)).astype(np.int32)
    (jfh, jfl), (jrh, jrl) = jsk.kmer_pack(jnp.asarray(codes), k)
    (tfh, tfl), (trh, trl) = tsk.kmer_pack(torch.from_numpy(codes), k)
    for ref, got in ((jfh, tfh), (jfl, tfl), (jrh, trh), (jrl, trl)):
        assert np.array_equal(np.asarray(ref).astype(np.int64), got.numpy())
    ref = jsk.hash_kmer(jfh, jfl)
    got = tsk.hash_kmer(tfh, tfl)
    assert np.array_equal(np.asarray(ref).astype(np.int64), got.numpy())


@pytest.mark.parametrize("w", [1, 5, 10, 16])
def test_sliding_min_pair_equal(w):
    rng = np.random.default_rng(w)
    val = rng.integers(0, 50, (2, 120)).astype(np.uint32)   # many ties
    val[0, 7] = 0xFFFFFFFF                                  # top-bit values
    val[1, 40:44] = 0x80000001
    idx = np.tile(np.arange(120, dtype=np.int32), (2, 1))
    rv, ri = jsk.sliding_min_pair(jnp.asarray(val), jnp.asarray(idx), w)
    gv, gi = tsk.sliding_min_pair(torch.from_numpy(val.astype(np.int64)),
                                  torch.from_numpy(idx.astype(np.int64)), w)
    assert np.array_equal(np.asarray(rv).astype(np.int64), gv.numpy())
    assert np.array_equal(np.asarray(ri).astype(np.int64), gi.numpy())


@pytest.mark.parametrize("k,w", [(15, 5), (17, 10)])
@pytest.mark.parametrize("own", [False, True])
def test_sketch_equal(k, w, own):
    rng = np.random.default_rng(1)
    lens = np.array([900, 400, 1024], np.int32)
    codes = np.zeros((3, 1024), np.int32)
    for i, l in enumerate(lens):
        codes[i, :l] = rng.integers(0, 4, l)
    olo = np.array([0, 100, 50], np.int32)
    ohi = np.array([900, 300, 1000], np.int32)
    jkw = dict(own_lo=jnp.asarray(olo), own_hi=jnp.asarray(ohi)) if own else {}
    tkw = dict(own_lo=torch.from_numpy(olo),
               own_hi=torch.from_numpy(ohi)) if own else {}
    ref = jsk.sketch(jnp.asarray(codes), jnp.asarray(lens), k=k, w=w,
                     cap=2048, **jkw)
    got = tsk.sketch(torch.from_numpy(codes), torch.from_numpy(lens), k=k,
                     w=w, cap=2048, **tkw)
    n = int(ref.n)
    assert n == got.n > 0 and int(ref.n_all) == got.n_all
    for f in ("rid", "pos", "hash", "strand"):
        assert np.array_equal(np.asarray(getattr(ref, f))[:n].astype(np.int64),
                              getattr(got, f).numpy()), f


def test_sketch_cap_truncates_like_reference():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, (2, 512)).astype(np.int32)
    lens = np.array([512, 512], np.int32)
    ref = jsk.sketch(jnp.asarray(codes), jnp.asarray(lens), k=15, w=5, cap=64)
    got = tsk.sketch(torch.from_numpy(codes), torch.from_numpy(lens), k=15,
                     w=5, cap=64)
    assert got.n == int(ref.n) == 64 and got.n_all == int(ref.n_all) > 64
    assert np.array_equal(np.asarray(ref.pos)[:64].astype(np.int64),
                          got.pos.numpy())
