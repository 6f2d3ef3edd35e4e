"""Hygiene of the port: it imports neither jax nor the JAX package, it
never runs on the CPU unasked, and a missing compiler is an error rather
than a quiet switch to the plain versions."""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    code = """
import importlib, pkgutil, sys
import nextdenovo_tpu_torch
mods = ["nextdenovo_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(nextdenovo_tpu_torch.__path__,
                                          "nextdenovo_tpu_torch.")]
for m in mods:
    if m.endswith("__main__"):
        continue
    importlib.import_module(m)
import nextdenovo_tpu_torch.__main__
import chip_smoke
import chip_profile
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "nextdenovo_tpu" or m.startswith("nextdenovo_tpu."))
assert len(mods) >= 34, mods
print("BAD", bad)
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def test_port_sources_name_no_jax_import():
    """No source line of the port imports jax or the JAX package."""
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|nextdenovo_tpu)(\.|\s|$)")
    hits = []
    files = [os.path.join(ROOT, f)
             for f in ("chip_smoke.py", "chip_profile.py", "chip_variants.py")]
    for dp, _, fs in os.walk(os.path.join(ROOT, "nextdenovo_tpu_torch")):
        files += [os.path.join(dp, f) for f in fs if f.endswith(".py")]
    for p in files:
        for i, line in enumerate(open(p), 1):
            if pat.match(line):
                hits.append((p, i, line.strip()))
    assert not hits, hits


def _no_cuda():
    import torch
    return not torch.cuda.is_available()


def test_default_device_raises_without_cuda(tmp_path):
    """With no CUDA device the default entry points raise; they do not run
    on the CPU."""
    if not _no_cuda():
        pytest.skip("a CUDA device is present")
    from nextdenovo_tpu_torch.correct.driver import run_correction
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    from nextdenovo_tpu_torch.ops.align import band_align
    from nextdenovo_tpu_torch.ops.extend import affine_extend
    from nextdenovo_tpu_torch.ops.myers import myers_align
    from nextdenovo_tpu_torch.overlap.engine import build_index
    from nextdenovo_tpu_torch.overlap.records import OvlBlock
    from nextdenovo_tpu_torch.pipeline.config import load_config
    from nextdenovo_tpu_torch.pipeline.run import run_pipeline
    from torch_port_util import write_correct_cfg
    q = np.zeros(50, np.int8)
    with pytest.raises(RuntimeError, match="CUDA"):
        band_align([q], [q])
    with pytest.raises(RuntimeError, match="CUDA"):
        band_align([q], [q], R=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        myers_align([q], [q])
    with pytest.raises(RuntimeError, match="CUDA"):
        affine_extend([q], [q])
    store = SeqStore.from_codes([np.zeros(2000, np.uint8)])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index(store, np.arange(1), k=15, w=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_correction(store, OvlBlock.empty(), {})
    from nextdenovo_tpu_torch.overlap import cns
    from nextdenovo_tpu_torch.polish import driver as polish
    with pytest.raises(RuntimeError, match="CUDA"):
        cns.cns_overlap_stage(store, np.arange(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        cns.realign_overlaps(store, OvlBlock.empty())
    with pytest.raises(RuntimeError, match="CUDA"):
        cns.extend_overlap_ends(store, OvlBlock.empty(True))
    with pytest.raises(RuntimeError, match="CUDA"):
        polish.map_polish_reads([np.zeros(2000, np.uint8)], store)
    with pytest.raises(RuntimeError, match="CUDA"):
        polish.polish_one(np.zeros(2000, np.uint8), [], store, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        polish.run_polish([np.zeros(2000, np.uint8)], store)
    (tmp_path / "input.fofn").write_text("reads.fa\n")
    for task in ("correct", "all"):
        cfg = load_config(write_correct_cfg(tmp_path, "d", 10_000, "wd_d",
                                            task=task))
        with pytest.raises(RuntimeError, match="CUDA"):
            run_pipeline(cfg)
        assert not os.path.exists(tmp_path / "wd_d")


def test_cuda_tensor_path_never_takes_plain_version(monkeypatch):
    """A wrapper takes its plain version only for a CPU tensor: for any
    other device it goes to the kernel library, and a missing nvcc there is
    a clear error."""
    import torch
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.ops import align, extend, myers, sketch
    from nextdenovo_tpu_torch.overlap import engine
    from nextdenovo_tpu_torch.parallel import dist_overlap, dist_sort, mesh
    monkeypatch.setattr(_build, "_kernels", None)
    monkeypatch.setattr(_build, "KERNEL_LIB",
                        os.path.join(str(_build.BUILD_DIR), "absent.so"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernels()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    called = []
    assert sorted(_build.LAUNCHES) == sorted(
        ["myers_fwd", "myers_tb", "wave_fwd", "wave_tb", "ext_fwd",
         "wave_fast_fwd", "wave_fast_tb", "engine_anchor", "vote_corridor",
         "chain_emit", "sketch_minimizers", "hpc_compress",
         "myers_streams", "route_count", "route_scatter",
         "seed_route_count", "seed_route_scatter"])
    for mod, name in ((myers, "myers_fwd_plain"), (myers, "myers_tb_plain"),
                      (align, "wave_fwd_plain"), (align, "wave_tb_plain"),
                      (align, "wave_fast_fwd_plain"),
                      (align, "wave_fast_tb_plain"),
                      (extend, "ext_fwd_plain"),
                      (engine, "engine_anchor_plain"),
                      (engine, "vote_corridor_plain"),
                      (engine, "chain_emit_plain"),
                      (sketch, "sketch_plain"), (sketch, "sketch_wide_plain"),
                      (sketch, "hpc_compress_plain"),
                      (myers, "build_streams_plain"),
                      (mesh, "bucketize_plain"),
                      (dist_sort, "seed_symmetrize_plain"),
                      (dist_sort, "seed_route_plain"),
                      (dist_overlap, "_lookup_plain")):
        monkeypatch.setattr(mod, name,
                            lambda *a, **k: called.append(1))
    meta = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        myers.myers_fwd(meta(4, 8, 2), meta(5, 2), meta(5, 2), meta(2),
                        meta(2), nw=8)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        myers.myers_tb(meta(5, 2, 8, 4), meta(4), meta(4), meta(4), nw=8)
    # the planes as myers_fwd hands them on: a narrow view of padded rows
    with pytest.raises(RuntimeError, match="nvcc not found"):
        myers.myers_tb(meta(5, 2, 8, 32)[..., :2], meta(2), meta(2), meta(2),
                       nw=8)
    # the mask of defined plane rows is plain tensor code: no library
    defined = myers.myers_fwd_defined(meta(2), 5)
    assert defined.dtype == torch.bool and tuple(defined.shape) == (5, 2)
    assert tuple(align.wave_fwd_defined(meta(2, 2), 4).shape) == (2, 4)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        align.wave_fwd(meta(2, 640), meta(2, 640), meta(2, 2), 4)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        align.wave_tb(meta(2, 4, 256), meta(2, 64), meta(2, 2))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        align.wave_fast_fwd(meta(2, 640), meta(2, 640), meta(2, 2), 4)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        align.wave_fast_tb(meta(2, 4, 128), meta(2, 4), meta(2, 2))
    meta8 = lambda *s: torch.empty(s, dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        extend.ext_fwd(meta8(2, 64), meta8(2, 64), meta(2, 2))
    m64 = lambda *s: torch.empty(s, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        engine.engine_anchor(m64(6), m64(6), m64(6), m64(6), m64(2), m64(2),
                             torch.empty(9, dtype=torch.int8, device="meta"),
                             m64(5), meta(5), meta(5), max_occ=16)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        engine.vote_corridor(*(m64(7),) * 5, diag_shift=8, top_k=4)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        engine.chain_emit(*(m64(7),) * 4, k=15, top_k=4, min_cnt=4,
                          min_span=500)
    codes8 = torch.empty((2, 50), dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sketch.sketch(codes8, meta(2), k=15, w=5, cap=64)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sketch.sketch_wide(codes8, meta(2), k=51, w=51, cap=64, hpc=True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sketch.hpc_compress(codes8, meta(2))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        myers.build_streams(meta8(40), meta8(40), m64(2), m64(2), meta(2),
                            meta(2), meta(2), nw=8, n_pad=9)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mesh.bucketize((m64(6), m64(6)), m64(6), None, 2, 4)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        dist_sort.seed_route(m64(3, 8),
                             torch.empty(5, dtype=torch.bool, device="meta"),
                             m64(5), 2, 4)
    ix = dist_overlap.IndexShard(m64(5), meta(5), meta(5), meta(2))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        dist_overlap._lookup((m64(6),) * 4, ix, None,
                             torch.empty(9, dtype=torch.int8, device="meta"),
                             16)
    assert not called
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_chip_smoke_fails_without_cuda():
    if not _no_cuda():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card():
    """Each CUDA kernel against its plain version on the card (also part of
    chip_smoke.py); skipped where there is no card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    sys.path.insert(0, ROOT)
    import chip_smoke
    rng = np.random.default_rng(7)
    qs, ts = chip_smoke.make_pairs(rng, 16, 300, 900)
    dev = torch.device("cuda")
    res = chip_smoke.compare_kernels(qs, ts, dev, "test")
    res.update(chip_smoke.compare_fast_kernels(qs, ts, dev, "test"))
    eq, et = chip_smoke.ext_tail_pairs(rng, 32)
    res.update(chip_smoke.compare_ext_kernel(eq, et, dev, "test"))
    res.update(chip_smoke.sketch_sets(dev, rng, ks=(15, 51), ws=(5, 51),
                                      slices=((15, 5), (51, 51))))
    assert len(res) == 9 and all(v["exact"] for v in res.values())
