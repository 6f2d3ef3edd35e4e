"""Sub-batching, ragged batches and the defined plane rows of the port's
Myers aligner (nextdenovo_tpu_torch/ops/myers.py, plain PyTorch versions on
the CPU), against the JAX package on the same numpy inputs.  Tolerance:
exact equality (the path is integer)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextdenovo_tpu.ops import myers as jm
from nextdenovo_tpu_torch.ops import myers as tm

from torch_port_util import assert_same_results, rand_pair

NW, W = 8, 256


def _pairs(seed, n, lo, hi, err=0.12):
    rng = np.random.default_rng(seed)
    ps = [rand_pair(rng, int(rng.integers(lo, hi + 1)), err) for _ in range(n)]
    return [p[0] for p in ps], [p[1] for p in ps]


def _padded(qs, ts):
    """(qpad, tpad, m, n, off) as _myers_batch lays a batch out (m >= n),
    the columns padded to a multiple of 8 (the JAX scan's unroll)."""
    sw = [(t, q) if len(q) < len(t) else (q, t) for q, t in zip(qs, ts)]
    m = np.array([len(a) for a, _ in sw], np.int32)
    n = np.array([len(b) for _, b in sw], np.int32)
    off = np.clip((W - (m - n)) // 2, 16, W - 16).astype(np.int32)
    qpad = np.full((len(sw), int(m.max()) + W + 2), 4, np.int8)
    tpad = np.full((len(sw), (int(n.max()) + 7) // 8 * 8), 4, np.int8)
    for b, (a, c) in enumerate(sw):
        qpad[b, : len(a)] = a
        tpad[b, : len(c)] = c
    return qpad, tpad, m, n, off


def _torch_fwd(qpad, tpad, n, off):
    t = torch.from_numpy
    qtop, tch, win0 = tm._build_streams(t(qpad), t(tpad), t(off), nw=NW)
    return tm.myers_fwd(win0, qtop, tch, t(n), t(off), nw=NW), (win0, tch)


@pytest.fixture(scope="module")
def batch140():
    qs, ts = _pairs(21, 140, 40, 300)
    return qs, ts, jm.myers_align(qs, ts, nw=NW)


# pairs of <= 300 columns are estimated at 1024 columns: 64 KiB of planes each
@pytest.mark.parametrize("max_plane_bytes,n_batches",
                         [(1 << 32, 1), (128 << 16, 2), (64 << 16, 3)])
def test_sub_batches_give_the_same_results(batch140, monkeypatch,
                                           max_plane_bytes, n_batches):
    qs, ts, ref = batch140
    sizes = []
    run = tm._myers_batch
    monkeypatch.setattr(
        tm, "_myers_batch",
        lambda q, t, nw, dev: sizes.append(len(q)) or run(q, t, nw, dev))
    got = tm.myers_align(qs, ts, nw=NW, max_plane_bytes=max_plane_bytes,
                         device="cpu")
    assert len(sizes) == n_batches and sum(sizes) == len(qs)
    assert_same_results(ref, got)


def test_fwd_defined_marks_rows_up_to_nv():
    nvec = torch.tensor([0, 1, 5, 9, 9], dtype=torch.int32)
    d = tm.myers_fwd_defined(nvec, 9)
    assert d.dtype == torch.bool and tuple(d.shape) == (9, 5)
    want = np.arange(1, 10)[:, None] <= nvec.numpy()[None, :]
    assert np.array_equal(d.numpy(), want)


def test_tb_reads_defined_rows_only():
    """Whatever stands in the plane rows above a pair's own last column,
    myers_tb returns the same."""
    qs, ts = _pairs(22, 12, 5, 200)
    qpad, tpad, m, n, off = _padded(qs, ts)
    (score, planes, final), _ = _torch_fwd(qpad, tpad, n, off)
    t = torch.from_numpy
    ref = tm.myers_tb(planes, t(m), t(n), t(off), nw=NW)
    defined = tm.myers_fwd_defined(t(n), planes.shape[0])[:, None, None, :]
    assert bool((~defined).any())
    junk = torch.full_like(planes, 0x5A5A5A5A)
    for other in (torch.zeros_like(planes), junk):
        got = tm.myers_tb(torch.where(defined, planes, other), t(m), t(n),
                          t(off), nw=NW)
        for a, b in zip(ref, got):
            assert torch.equal(a, b)


def _carry_span(win0, tch, off, b=0):
    """Words a carry crosses in column 1 of pair b: the longest run of
    all-ones sums above a word whose add overflowed."""
    vp = tm._row_mask(torch.from_numpy(off[b : b + 1]).to(torch.int64), NW)[:, 0]
    eq = sum(np.where(int(tch[0, b]) == c,
                      win0[c, :, b].numpy().view(np.uint32).astype(np.uint64), 0)
             for c in range(4))
    eq = eq & vp.numpy().astype(np.uint64)      # row mask of column 1 = VP
    vp = vp.numpy().astype(np.uint64)
    a = eq & vp
    best = run = 0
    gen = False
    for k in range(NW):
        s = a[k] + vp[k]
        if gen and (s & 0xFFFFFFFF) == 0xFFFFFFFF:
            run += 1
            best = max(best, run)
            continue
        gen, run = bool(s >> 32), 0
    return best


def test_carry_crosses_several_words():
    """A first text character that matches the query once, at the band's
    centre, sends a carry through every all-ones word above it; then long
    exact-match and one-letter runs after an indel."""
    rng = np.random.default_rng(23)
    qs, ts = [], []
    for cut in (0, 3, 17):
        body = rng.integers(0, 4, 60).astype(np.int8)
        t = np.concatenate([np.zeros(1, np.int8), np.full(150, 1, np.int8),
                            body, np.full(70, 2, np.int8)])
        q = np.concatenate([t[:40], t[40 + cut:], np.full(cut, 3, np.int8)])
        qs.append(q)
        ts.append(t)
    qpad, tpad, m, n, off = _padded(qs, ts)
    (score, planes, final), (win0, tch) = _torch_fwd(qpad, tpad, n, off)
    assert _carry_span(win0, tch, off) >= 2
    j = jnp.asarray
    jq, jt, jw = jm._build_streams(j(qpad), j(tpad), j(off), nw=NW)
    js, jp, jf = jm.myers_fwd(jw, jq, jt, j(n), j(off), nw=NW)
    assert np.array_equal(np.asarray(js), score.numpy())
    assert np.array_equal(np.asarray(jp), planes.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(jf), final.numpy().view(np.uint32))
    assert_same_results(jm.myers_align(qs, ts, nw=NW),
                        tm.myers_align(qs, ts, nw=NW, device="cpu"))


@pytest.mark.parametrize("B", [1, 7, 33])
def test_ragged_batch_sizes(B):
    qs, ts = _pairs(30 + B, B, 30, 250)
    got = tm._myers_batch(qs, ts, NW, torch.device("cpu"))
    assert_same_results(jm.myers_align(qs, ts, nw=NW), got)


def test_row_pitch_admits_padded_planes_only():
    """myers_tb takes what myers_fwd returns: the narrow view of a tensor
    whose last dimension was padded, or a contiguous tensor, with every row
    on a 16-byte boundary; nothing else."""
    from nextdenovo_tpu_torch.device import row_pitch
    cpu = torch.device("cpu")
    buf = torch.zeros((5, 2, NW, 32), dtype=torch.int32)
    shape = (5, 2, NW, 7)
    assert row_pitch("planes", buf[..., :7], shape, torch.int32, cpu) == 32
    assert row_pitch("planes", buf[..., :8].contiguous(), (5, 2, NW, 8),
                     torch.int32, cpu) == 8
    for bad in (buf[..., :7].transpose(0, 1), buf[..., 0:14:2],
                buf[..., :7].to(torch.int64), buf[..., :6],
                buf[..., :7].contiguous(), buf[..., 2:9]):
        with pytest.raises(ValueError):
            row_pitch("planes", bad, shape, torch.int32, cpu)
