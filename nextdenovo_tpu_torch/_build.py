"""Builds and loads the package's compiled parts at first use.

Two shared libraries go into `nextdenovo_tpu_torch/build/` (git-ignored):

  * `libndt_kernels.so` — the hand-written CUDA kernels of `csrc/*.cu`,
    compiled by `nvcc` for sm_90a with a plain C interface and loaded with
    ctypes (no PyTorch headers: a build takes seconds, not minutes).  One
    `nvcc` process per source runs in parallel, then one link.
  * `libndtpu.so` — the host C++ of `native/` (consensus, overlap filter,
    event expansion), compiled by `g++`.

Each is rebuilt when a source is newer than the library.  A missing
compiler raises; nothing here hands back a substitute.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "build")
KERNEL_LIB = os.path.join(BUILD_DIR, "libndt_kernels.so")
NATIVE_LIB = os.path.join(BUILD_DIR, "libndtpu.so")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-Wno-unused-function", "-shared"]

# launches per kernel wrapper: a wrapper adds one (count_launch) where it
# launches its CUDA kernel and nowhere else, so a run can show which kernels
# it used; CARD_LAUNCHES holds the same counts by card index
LAUNCHES = {"myers_fwd": 0, "myers_tb": 0, "wave_fwd": 0, "wave_tb": 0,
            "ext_fwd": 0, "wave_fast_fwd": 0, "wave_fast_tb": 0,
            "engine_anchor": 0, "vote_corridor": 0, "chain_emit": 0,
            "sketch_minimizers": 0, "hpc_compress": 0,
            "myers_streams": 0, "route_count": 0, "route_scatter": 0,
            "seed_route_count": 0, "seed_route_scatter": 0}
CARD_LAUNCHES = {}

_lock = threading.Lock()
_count_lock = threading.Lock()
_load_lock = threading.Lock()
_kernels = None


def count_launch(name: str, dev) -> None:
    """One launch of kernel `name` on CUDA device `dev`: the mesh's cards
    launch from threads of their own, so the counts are kept under a
    lock."""
    with _count_lock:
        LAUNCHES[name] += 1
        card = CARD_LAUNCHES.setdefault(dev.index or 0,
                                        dict.fromkeys(LAUNCHES, 0))
        card[name] += 1


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        CARD_LAUNCHES.clear()


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of nextdenovo_tpu_torch/csrc "
            "are compiled at first use and need the CUDA toolkit (PATH or "
            "CUDA_HOME); on a machine without it only device='cpu' works")
    return path


def _stale(lib: str, srcs) -> bool:
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < max(os.path.getmtime(s) for s in srcs))


def _check(proc: subprocess.Popen, what: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (exit {proc.returncode}):\n"
                           f"{out.decode(errors='replace')}")


def kernel_sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def native_sources():
    return [os.path.join(NATIVE_DIR, f)
            for f in ("consensus.cpp", "ovl_filter.cpp", "graph.cpp")]


def _start_kernel_objects(nvcc: str, tag: str):
    procs = []
    for src in kernel_sources():
        obj = os.path.join(
            BUILD_DIR, os.path.basename(src)[:-3] + f".{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", obj, src]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    return procs


def _finish_kernel_lib(nvcc: str, procs, tag: str) -> None:
    objs = []
    for src, obj, p in procs:
        _check(p, f"nvcc {os.path.basename(src)}")
        objs.append(obj)
    tmp = KERNEL_LIB + f".{tag}.tmp"
    link = subprocess.Popen([nvcc, "-shared", "-o", tmp, *objs],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    _check(link, "nvcc link")
    os.replace(tmp, KERNEL_LIB)
    for o in objs:
        os.unlink(o)


def _start_native(tag: str):
    gxx = os.environ.get("CXX") or shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host library of "
                           "nextdenovo_tpu_torch/native needs a C++ compiler")
    tmp = NATIVE_LIB + f".{tag}.tmp"
    cmd = [gxx, *GXX_FLAGS, "-I", NATIVE_DIR, "-o", tmp, *native_sources()]
    return tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)


def build(native: bool = True, kernels: bool = True) -> dict:
    """(Re)build the stale ones of the requested libraries, every compiler
    process started together.  Returns the seconds each build took (empty
    when nothing was stale)."""
    secs = {}
    with _lock:
        do_native = native and _stale(
            NATIVE_LIB, native_sources() + [os.path.join(NATIVE_DIR, "ndtpu.h")])
        do_kernels = kernels and _stale(KERNEL_LIB, kernel_sources())
        if not (do_native or do_kernels):
            return secs
        nvcc = find_nvcc() if do_kernels else None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tag = str(os.getpid())
        t0 = time.time()
        nat = _start_native(tag) if do_native else None
        if do_kernels:
            _finish_kernel_lib(nvcc, _start_kernel_objects(nvcc, tag), tag)
            secs["kernels"] = time.time() - t0
        if nat is not None:
            _check(nat[1], "g++ native")
            os.replace(nat[0], NATIVE_LIB)
            secs["native"] = time.time() - t0
    return secs


def kernels() -> ctypes.CDLL:
    """The loaded CUDA kernel library with argtypes set."""
    global _kernels
    with _load_lock:
        if _kernels is None:
            _kernels = _load_kernels()
    return _kernels


def _load_kernels() -> ctypes.CDLL:
    build(native=False)
    lib = ctypes.CDLL(KERNEL_LIB)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ndt_myers_fwd.restype = ci
    lib.ndt_myers_fwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                  ci, ci, ci, ci, vp]
    lib.ndt_myers_tb.restype = ci
    lib.ndt_myers_tb.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                 ci, ci, ci, ci, vp]
    lib.ndt_wave_fwd.restype = ci
    lib.ndt_wave_fwd.argtypes = [vp, vp, vp, vp, vp, vp,
                                 ci, ci, ci, ci, ci, vp]
    lib.ndt_wave_tb.restype = ci
    lib.ndt_wave_tb.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.ndt_ext_fwd.restype = ci
    lib.ndt_ext_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                ci, vp]
    lib.ndt_wave_fast_fwd.restype = ci
    lib.ndt_wave_fast_fwd.argtypes = [vp, vp, vp, vp, vp, vp,
                                      ci, ci, ci, ci, vp]
    lib.ndt_wave_fast_tb.restype = ci
    lib.ndt_wave_fast_tb.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    ll = ctypes.c_longlong
    lib.ndt_engine_anchor.restype = ci
    lib.ndt_engine_anchor.argtypes = [vp] * 13 + [ci, ll, ll, ci, ci, vp]
    lib.ndt_vote_corridor.restype = ci
    lib.ndt_vote_corridor.argtypes = [vp] * 7 + [ci, ci, ci, vp]
    lib.ndt_chain_emit.restype = ci
    lib.ndt_chain_emit.argtypes = [vp] * 7 + [ll, ci, ci, ci, ci, ci,
                                              ctypes.c_float, vp]
    lib.ndt_sketch_minimizers.restype = ci
    lib.ndt_sketch_minimizers.argtypes = [vp, ll] + [vp] * 5 + [ll, vp, vp,
                                                                ll] \
        + [ci] * 4 + [vp]
    lib.ndt_sketch_layout.restype = ci
    lib.ndt_sketch_layout.argtypes = [ci] * 4
    lib.ndt_hpc_compress.restype = ci
    lib.ndt_hpc_compress.argtypes = [vp, ll] + [vp] * 4 + [ci, ci, vp]
    lib.ndt_myers_streams.restype = ci
    lib.ndt_myers_streams.argtypes = [vp] * 10 + [ci, ci, ci, vp]
    lib.ndt_route_resident.restype = ci
    lib.ndt_route_resident.argtypes = [ci]
    lib.ndt_route_count.restype = ci
    lib.ndt_route_count.argtypes = [vp, vp, ci, ci, vp, vp, vp, vp, vp]
    lib.ndt_route_scatter.restype = ci
    lib.ndt_route_scatter.argtypes = [ctypes.POINTER(vp), ci, vp, vp, vp, ci,
                                      ci, ci, ctypes.POINTER(vp), vp, vp]
    lib.ndt_seed_route_count.restype = ci
    lib.ndt_seed_route_count.argtypes = [vp, vp, vp, ci, ll, ci, vp, vp, vp,
                                         vp, vp]
    lib.ndt_seed_route_scatter.restype = ci
    lib.ndt_seed_route_scatter.argtypes = [vp, ci, vp, vp, vp, ci, ci,
                                           ctypes.POINTER(vp), vp, vp]
    lib.ndt_error_string.restype = ctypes.c_char_p
    lib.ndt_error_string.argtypes = [ci]
    return lib


def check_launch(name: str, rc: int) -> None:
    """Raise when a kernel's C entry reported a CUDA error."""
    if rc != 0:
        msg = kernels().ndt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"{msg} (error {rc})")
