"""io/refformats.py of the port against the JAX package's: each writer's
bytes on disk are equal, and what one package writes the other reads back
to the same arrays (2bit, varint .ovl in modes 8 and 10, the .bl sidecar,
the indexed fasta).  Tolerance: exact equality."""
import numpy as np
import pytest

from nextdenovo_tpu.io import refformats as jref
from nextdenovo_tpu.overlap.records import OvlBlock as JBlock
from nextdenovo_tpu_torch.io import refformats as tref
from nextdenovo_tpu_torch.overlap.records import OvlBlock as TBlock

PKGS = {"jax": (jref, JBlock), "torch": (tref, TBlock)}
DIRECTIONS = [("jax", "torch"), ("torch", "jax")]


def _cols(rng, n=400, mode10=False):
    # names start at 1: a first record named 0 loses its qlen in the
    # reference's delta encoding (prev names start at 0)
    qn = np.sort(rng.integers(1, 50, n))
    qs, ts = rng.integers(0, 20000, n), rng.integers(0, 20000, n)
    alq = rng.integers(500, 30000, n)
    cols = dict(qname=qn, rev=rng.integers(0, 2, n), qs=qs, qe=qs + alq,
                tname=rng.integers(1, 5000, n), ts=ts,
                te=ts + alq + rng.integers(-400, 400, n),
                match=rng.integers(100, 30000, n))
    if mode10:
        cols["ide"] = rng.integers(0, 10001, n)
    return {k: v.astype(np.int32) for k, v in cols.items()}


def _name_lens(cols):
    """qlen/tlen constant per name, as the repeat-0 encoding needs."""
    out = []
    for key, end in (("qname", "qe"), ("tname", "te")):
        arr = (cols[end] + 100).astype(np.int64)
        first = {}
        for i, nm in enumerate(cols[key].tolist()):
            arr[i] = first.setdefault(nm, arr[i])
        out.append(arr)
    return out


@pytest.mark.parametrize("src,dst", DIRECTIONS)
@pytest.mark.parametrize("mode", [8, 10])
def test_ovl_cross_roundtrip(tmp_path, src, dst, mode):
    cols = _cols(np.random.default_rng(mode), mode10=mode == 10)
    kw = {}
    if mode == 10:
        kw["qlen"], kw["tlen"] = _name_lens(cols)
    paths = {}
    for name, (mod, blk_cls) in PKGS.items():
        paths[name] = str(tmp_path / f"{name}.ovl")
        mod.write_ovl(paths[name], blk_cls(dict(cols)), mode=mode, **kw)
    assert open(paths["jax"], "rb").read() == open(paths["torch"], "rb").read()
    got, extras = PKGS[dst][0].read_ovl(paths[src])
    ref, ref_extras = PKGS[src][0].read_ovl(paths[src])
    assert extras["mode"] == ref_extras["mode"] == mode
    assert sorted(got.data) == sorted(ref.data)
    for k in ref.data:
        assert np.array_equal(got.data[k], ref.data[k]), k
    keys = cols if mode == 8 else [k for k in cols if k != "match"]
    for k in keys:
        assert np.array_equal(got.data[k], cols[k]), k
    if mode == 10:
        for k in ("qlen", "tlen"):
            assert np.array_equal(extras[k], kw[k]), k
            assert np.array_equal(extras[k], ref_extras[k]), k


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_2bit_cross_roundtrip(tmp_path, src, dst):
    rng = np.random.default_rng(2)
    seqs = [rng.integers(0, 4, int(n)).astype(np.uint8)
            for n in [1, 15, 16, 17, 1000, 4097]]
    names = [10, 11, 12, 13, 14, 15]
    paths = {}
    for name, (mod, _) in PKGS.items():
        paths[name] = str(tmp_path / f"{name}.2bit")
        mod.write_2bit(paths[name], seqs, names=names)
    assert open(paths["jax"], "rb").read() == open(paths["torch"], "rb").read()
    got, got_names = PKGS[dst][0].read_2bit(paths[src])
    assert got_names == names
    for a, b in zip(seqs, got):
        assert np.array_equal(a, b)


def _cns_info(rng, n=60, m=150):
    st = rng.integers(0, 5000, (n, 9)).astype(np.int32)
    st[:, 0] = rng.integers(0, 4, n)            # con: some contained
    rid = rng.integers(0, n, m)
    s = rng.integers(10, 8000, m)
    alns = np.stack([rid, s, s + rng.integers(50, 3000, m)], 1)
    return (st, rng.random(n) < 0.8, alns.astype(np.int32),
            rng.integers(1000, 20000, n).astype(np.int32))


@pytest.mark.parametrize("name_off", [0, 1])
def test_write_bl_bytes_equal(tmp_path, name_off):
    args = _cns_info(np.random.default_rng(5 + name_off))
    out = []
    for name, (mod, _) in PKGS.items():
        p = str(tmp_path / f"{name}.bl")
        mod.write_bl(p, *args, name_off=name_off)
        out.append(open(p, "rb").read())
    assert out[0] and out[0] == out[1]


def test_write_seqs_fasta_idx_bytes_equal(tmp_path):
    rng = np.random.default_rng(6)
    seqs = [rng.integers(0, 4, int(n)).astype(np.uint8)
            for n in [1, 33, 700, 5000]]
    out = []
    for name, (mod, _) in PKGS.items():
        p = str(tmp_path / f"{name}.fa")
        mod.write_seqs_fasta_idx(p, seqs, names=[3, 9, 27, 81])
        out.append((open(p, "rb").read(), open(p + ".idx", "rb").read()))
    assert out[0][0] and out[0] == out[1]
