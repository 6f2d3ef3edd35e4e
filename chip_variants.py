#!/usr/bin/env python3
"""Compare versions of a wavefront or engine kernel on one card, in turns.

    python3 chip_variants.py [--latency] A.cu [B.cu ...]
    python3 chip_variants.py --kernel wave_fwd A.cu [B.cu ...]
    python3 chip_variants.py --kernel wave_fast_tb A.cu [B.cu ...]
    python3 chip_variants.py --kernel wave_fast_fwd A.cu [B.cu ...]
    python3 chip_variants.py --kernel vote_corridor A.cu [B.cu ...]
    python3 chip_variants.py --kernel chain_emit A.cu [B.cu ...]
    python3 chip_variants.py --kernel engine_anchor A.cu [B.cu ...]
    python3 chip_variants.py --kernel sketch_minimizers [--phases] [A.cu ...]
    python3 chip_variants.py --kernel route_buckets [--phases] [A.cu ...]
    python3 chip_variants.py --turns PARENT_DIR
    python3 chip_variants.py --match-turns PARENT_DIR
    python3 chip_variants.py --mesh-memory PARENT_DIR
    python3 chip_variants.py --sketch-turns PARENT_DIR
    python3 chip_variants.py --route-turns PARENT_DIR

Each A.cu is a whole copy of nextdenovo_tpu_torch/csrc/wave.cu whose
wave_tb_kernel differs; keep the copies in a git-ignored directory.  The
script builds the package, makes tb/lo with its wave_fwd for 640 pairs of
11000-12288 columns, holds the package's wave_tb against wave_tb_plain on
the first 64 pairs, and builds each copy into a library of its own.  Every
copy must give the package's ops and ok at 64 and 640 pairs, on those tb/lo
and with lo moved so that walks leave the band (chip_smoke.shift_lo).  Then
every copy is timed at both sizes twice, in the order given and in reverse
(CUDA events, 5 launches after a warm one, each with its OP_NONE prefill of
ops, which copies that write only the slots they visit need), and the
script prints ms a launch and cycles a step of the longest walk at the SM
clock nvidia-smi reports.  A copy that exports
`int ndt_dbg(void* host, int n)`, copying 6 int64 counters a pair (loop
cycles, cycles in word changes, cycles waiting for copies, steps, word
changes) from an instrumented kernel, gets them summarised.

--kernel wave_fwd, --kernel wave_fast_fwd: each A.cu is a whole copy of
csrc/wave.cu (csrc/wave_fast.cu) whose forward kernel differs (keep one copy
of an earlier kernel among them as the yardstick).  Every copy is built into
a library of its own and held, with the package's kernel, against its plain
version on the ragged batches B = 1, 3, 5, 33, 130 of 200-1500 bases, the
|m-n| > 200 sets (chip_smoke.skewed_pairs, and chip_smoke.fast_clamp_pairs,
whose R = 1 re-centring reaches -8 and 8 and meets both clamps), the
degenerate set and a batch of m + n from 0 to 24.6k: tb on the words
wave_fwd_defined marks, lo (base) and stats, exactly.  On 64 pairs of
11000-12288 columns the plain version runs once, against the package's
kernel, which is then the yardstick for the copies at 8, 64, 256 and 640
pairs.  Then the package's kernel and every copy are timed in turns, in the
order given and in reverse, at those sizes (CUDA events, 3 launches after a
warm one, output buffers allocated once and lo / base zeroed once, so no
allocation or fill is timed); the script prints ms a launch and cycles an
anti-diagonal of the longest pair at the SM clock nvidia-smi reports.

--kernel wave_fast_tb: each A.cu is a whole copy of csrc/wave_fast.cu
whose wave_fast_tb_kernel differs (keep one copy of an earlier kernel among
them as the yardstick).  Every copy is built into a library of its own and
held, with the package's wave_fast_tb, against wave_fast_tb_plain on tb/base
from the package's wave_fast_fwd for the ragged batches B = 1, 3, 5, 33, 130
of 200-1500 bases, the degenerate set, a batch of m + n from 0 to 24.6k and
64 pairs of 1-3 kb with base moved so that walks leave the band
(chip_smoke.shift_base), and on random decisions (chip_smoke.random_fast_tb):
ops and ok, exactly.  On 640 pairs of 11000-12288 columns
wave_fast_tb_plain runs once on the first 64, against the package's kernel,
which is then the yardstick for the copies at 8, 64, 256 and 640 pairs.
Then the package's kernel and every copy are timed in turns, in the
order given and in reverse, at those sizes (CUDA events, 5 launches after a
warm one, each with its OP_NONE prefill of ops, which copies that write only
the slots they visit need); the script prints ms a launch and cycles a step
of the longest walk at the SM clock nvidia-smi reports.

--kernel vote_corridor, --kernel chain_emit: each A.cu is a whole copy of
csrc/engine.cu (keep a copy of an earlier engine.cu among them as the
yardstick).  Every copy is built into a library of its own and held, with
the package's kernel, against the plain version (vote_corridor_plain,
chain_emit_plain) on one 16-row batch of the main path's stage 01
(chip_smoke.main_batch, top_k 4) and on chip_smoke.engine_tile_sets (the
vote tile's edge at top_k 1, 4 and 8), exactly; each launch is handed the
(key_q, key_t) group starts _vote_emit makes (group_starts) and the exact
group count G.  Then the package's kernel and every copy are timed in
turns, in the order given and in reverse, on the main path's batch and on
the tile-edge groups (CUDA events around 5 launches after a warm one, the
device asleep ~1 ms first so that the host's launch time is not measured);
the package's kernel also as its wrapper launches it, with G = A.

--kernel engine_anchor: each A.cu is a whole copy of csrc/engine.cu with the
package's ndt_engine_anchor signature.  Every copy is built into a library of
its own and held, with the package's kernel, against engine_anchor_plain on
one 16-row batch of the main path's stage 01 and on chip_smoke's synthetic and
full-range index sets (chip_smoke.engine_anchor_sets), exactly.  Then the
package's kernel and every copy are timed in turns, in the order given and in
reverse, on the main path's batch: 5 launches after a warm one between two
events (the device asleep first), and each launch between its own events,
warm and with the L2 flushed before it (a 256 MB write).

--kernel sketch_minimizers: each A.cu is a whole copy of csrc/sketch.cu with
the package's ndt_sketch_minimizers signature.  Every copy is built into a
library of its own and held, with the package's kernel, against
sketch_wide_plain (every field, n and n_all) on the main path's query batch,
a batch of its index build, the HiFi batch, edge rows at a few (k, w) (w past
a tile among them) and a mesh-sized launch of 2560 tiles.  Then every copy
is timed in turns, in the order given and in reverse, at the three batches
(its memset and launch, CUDA events around 5 calls after a device sleep),
and each call's device time by operation (the memset, the kernel) is read
from torch.profiler.  A copy that exports `int ndt_dbg(void* host, int n)`,
copying 12 int64 a block (the global timer at its start, clock64 at the
ends of its phases, the global timer at its end, its ticket), gets them
summarised at each batch; --phases adds two such copies made from the
package's sketch.cu (sketch_phase_copies): as it is, and with release
stores and acquire loads of the look-back's status words.

--kernel route_buckets: each A.cu is a whole copy of csrc/route.cu with the
package's four routing entries (ndt_route_count, ndt_route_scatter,
ndt_seed_route_count, ndt_seed_route_scatter).  The script first runs this
checkout's main and mesh paths (use_mesh = 8, one card) to record the mesh
path's routing calls.  Every copy is built into a library of its own and
held, with the package's, against bucketize_plain and seed_route_plain on
the three recorded shapes (stage 01's sketch route, 4 fields; the lookup's
route back, 5 fields; the sort's seed route) and on synthetic sets (n = 8
with a truncating cap, n = 4096, cap = 0, every row outside, records with
ids out of range), exactly.  Then every copy is timed in turns, in the
order given and in reverse, at the three shapes: the count launch (its
memset and kernel), the scatter launch (the pointer table's copy and the
kernel) and both, CUDA events around 5 calls after a device sleep, and
each operation's device time by torch.profiler.  A copy that exports
`int ndt_dbg(void* host, int n, int which)`, copying 8 int64 a block of
the count (which = 0) or scatter (1) kernel, gets them summarised;
--phases adds such a copy made from the package's route.cu
(route_phase_copy): the global timer at a block's start and end, clock64
at the ends of its phases (count: keys and counts, the ticket, the last
block's scan; scatter: keys, ranks, scans, slots, fields).

--turns PARENT_DIR: this checkout against an earlier tree unpacked in
PARENT_DIR (git archive), in turns parent, this, this, parent.  First
--engine-anchor-turn of each (a process each): engine_anchor at the main
path's batch through the package's public wrapper, its kernels' device time by
name from torch.profiler and the whole call by the host clock, warm and with
the L2 flushed before each call.  Then each tree's own chip_smoke main, mesh
(use_mesh = 8) and HiFi paths in a workdir of their own, and where the
machine has two cards or more each tree's mesh_cards; every stage file of
the first parent and the first of this checkout's runs must be byte-equal.
Each turn's walls (main, mesh, HiFi) and mesh spans (mesh/sketch_route,
mesh/lookup_route, mesh/sort_route, mesh/sort: calls, seconds) are printed
at the end, a line a turn.

--route-turns PARENT_DIR: the routing of the earlier tree in PARENT_DIR
against this checkout's, at the mesh path's three recorded shapes (this
checkout's main and mesh paths run first, in a process of their own, and
save the calls: --route-calls FILE), a process a tree in turns parent,
this, this, parent (--route-turn DIR FILE): the launches alone (after a
device sleep) and the wrapper's whole call, for each shape; where the tree
has no seed_route, its seed_symmetrize then bucketize.  Every turn's
counts and bucket checksums must agree.

--match-turns PARENT_DIR: stage 01's overlap search of the main path (all
reads indexed at k = 15, w = 5; the seeds queried in chunks of 2000 as the
pipeline queries them) with each tree's package, a process each, in turns
parent, this, this in each mode of MATCH_TURN_MODES (comma-separated;
default plain_sketch,plain_first; see match_turn), this, parent
(--match-turn DIR [MODE]).  Each process makes three calls: the first
cold, as in the pipeline, the second warm, both with the spans
engine/host_fill and engine/match (wall and CPU time over the call, the
first five batches, the median and the longest) and the caching
allocator's counters over the call (cudaMalloc and cudaFree calls,
retries); the third under torch.profiler, its device time by kernel name.

--mesh-memory PARENT_DIR: the mesh path's device memory by phase, the earlier
tree in PARENT_DIR then this checkout, a process each (--mesh-memory-turn
DIR): each tree's own chip_smoke main path, then its mesh path (use_mesh =
8, one card) with the peak allocated memory read and reset around every
Mesh.for_each_card phase and around dist_overlap's build_index (and
index_shards, where the tree has it); one line a phase (MiB allocated
before, peak, after), then the mesh path's peak.

--sketch-turns PARENT_DIR: the sketch kernels of the earlier tree in
PARENT_DIR against this checkout's, a process each (--sketch-turn DIR), in
turns parent, this, this, parent: at the main path's query batch, a batch
of its index build and the HiFi batch, the launches alone (after a device
sleep) and the wrapper's whole call; each tree's sketch.cu registers,
spills and SASS instructions.

--latency first runs a one-warp microbenchmark: a chain of dependent
shared-memory loads, the same chain with the walk's mask, compare and two
selects between the loads, and two chains of dependent integer
instructions; it prints cycles an iteration.
"""
from __future__ import annotations

import ctypes
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

LATENCY_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ int lds32(unsigned addr) {
    int v;
    asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
    return v;
}
__global__ void k_lat(long long* out, int n, int seed) {
    __shared__ __align__(1024) int s[1024];
    for (int i = threadIdx.x; i < 1024; i += blockDim.x)
        s[i] = ((i * 7 + 13) & 1023) * 4;
    __syncthreads();
    const unsigned base = (unsigned)__cvta_generic_to_shared(s);
    long long t0 = clock64();
    unsigned a = base | (unsigned)(seed * 4);
    for (int k = 0; k < n; ++k) a = base | (unsigned)lds32(a);
    long long t1 = clock64();
    unsigned b = base | (unsigned)(seed * 4);
    int sh = seed & 15;
    for (int k = 0; k < n; ++k) {
        const uint32_t w = (uint32_t)lds32(b);
        const uint32_t x = w & (3u << sh);
        const bool d = x == 0, l = x == (2u << sh);
        b = d ? (base | (w & 0xFFC))
              : (l ? (base | ((w >> 2) & 0xFFC)) : (base | ((w << 2) & 0xFFC)));
        sh = (sh + 1) & 15;
    }
    long long t2 = clock64();
    int x = seed;
#pragma unroll 16
    for (int k = 0; k < n; ++k) x = x * 3 + 1;
    long long t3 = clock64();
    int y = seed;
#pragma unroll 16
    for (int k = 0; k < n; ++k) {
        const bool p = (y & 3) == 0;
        y = p ? (y ^ 0x55) : (y + 7);
    }
    long long t4 = clock64();
    if (threadIdx.x == 0) {
        out[0] = t1 - t0; out[1] = t2 - t1; out[2] = t3 - t2; out[3] = t4 - t3;
        out[4] = (long long)a + b + x + y;
    }
}
extern "C" int lat_run(void* out, int n) {
    k_lat<<<1, 32>>>((long long*)out, n, 3);
    return (int)cudaDeviceSynchronize();
}
"""


def log(*a):
    print(*a, flush=True)


def compile_so(nvcc, flags, src, so):
    return subprocess.Popen([nvcc, *flags, "-shared", "-o", so, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def latency(nvcc, flags, tmp):
    import torch
    src, so = os.path.join(tmp, "lat.cu"), os.path.join(tmp, "lat.so")
    with open(src, "w") as fh:
        fh.write(LATENCY_CU)
    p = compile_so(nvcc, flags, src, so)
    if p.wait() != 0:
        raise RuntimeError(p.stdout.read().decode())
    lib = ctypes.CDLL(so)
    lib.lat_run.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = torch.zeros(8, dtype=torch.int64, device="cuda")
    n = 4096
    if lib.lat_run(out.data_ptr(), n) != 0:
        raise RuntimeError("latency kernel failed")
    o = [v / n for v in out.cpu().tolist()[:4]]
    log(f"[latency] cycles an iteration: dependent shared load {o[0]:.1f}; "
        f"load + mask, compare, two selects {o[1]:.1f}; IMAD chain {o[2]:.1f}; "
        f"compare + select chain {o[3]:.1f}")


def build_copies(nvcc, flags, tmp, srcs, symbol, argtypes):
    """{name: ctypes library} for each copy, all nvcc processes at once."""
    procs = []
    for k, src in enumerate(srcs):
        so = os.path.join(tmp, f"v{k}.so")
        procs.append((os.path.basename(src)[:-3], so,
                      compile_so(nvcc, flags, src, so)))
    libs = {}
    for name, so, p in procs:
        if p.wait() != 0:
            raise RuntimeError(f"{name}: build failed\n"
                               f"{p.stdout.read().decode()}")
        lib = ctypes.CDLL(so)
        getattr(lib, symbol).restype = ctypes.c_int
        getattr(lib, symbol).argtypes = argtypes
        libs[name] = lib
    return libs


def main_forward(srcs, kernel) -> int:
    """--kernel wave_fwd or wave_fast_fwd: the two forward passes differ
    only in their C entry, their inputs and plain version and the width of
    their second output (lo per anti-diagonal, base per word)."""
    import numpy as np
    import torch
    import chip_smoke as c
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.ops import align as A
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fast = kernel == "wave_fast_fwd"
    symbol = "ndt_" + kernel
    inputs = c.fast_inputs if fast else c.wave_inputs
    plain = A.wave_fast_fwd_plain if fast else A.wave_fwd_plain
    width = A.FAST_W if fast else A.BAND_W
    # the sizes after n_words in the C entry: a_max for wave_fwd
    extra = (lambda nw: ()) if fast else (lambda nw: (nw * A.PACK,))
    c.phase_env()
    _build.build(native=False)
    libs = {"package": _build.kernels()}
    libs.update(build_copies(
        _build.find_nvcc(), _build.NVCC_FLAGS,
        tempfile.mkdtemp(prefix="chip_variants_"), srcs, symbol,
        [vp] * 6 + [ci] * (4 + len(extra(1))) + [vp]))
    d = torch.device("cuda")

    def buffers(wi):
        B, nw = wi["qpad"].shape[0], wi["n_words"]
        cols = nw if fast else nw * A.PACK
        return (torch.empty((B, nw, width), dtype=torch.int32, device=d),
                torch.zeros((B, cols), dtype=torch.int32, device=d),
                torch.empty((B, 2), dtype=torch.int32, device=d))

    def run(lib, wi, out):
        B, QP = wi["qpad"].shape
        nw = wi["n_words"]
        rc = getattr(lib, symbol)(
            wi["qpad"].data_ptr(), wi["rtpad"].data_ptr(), wi["mn"].data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), B, QP,
            wi["rtpad"].shape[1], nw, *extra(nw),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: error {rc}")
        return out

    def same(x, y):
        return all(torch.equal(a, b) for a, b in zip(x, y))

    rng = np.random.default_rng(7)
    sets = [(f"ragged B={b}", c.make_pairs(rng, b, 200, 1500))
            for b in (1, 3, 5, 33, 130)]
    qs, ts = c.mixed_length_pairs(rng, n=40, hi=12300)
    empty = np.zeros(0, np.int8)
    sets += [("|m-n| > 200", c.skewed_pairs(rng)),
             ("|m-n| > 200 (clamps)",
              c.fast_clamp_pairs(np.random.default_rng(c.CLAMP_SEED))),
             ("degenerate", c.degenerate_pairs(rng)),
             ("mixed m+n 0..24.6k", ([empty] + qs, [empty] + ts))]
    for tag, (qs, ts) in sets:
        wi = inputs(qs, ts, d)
        want = c.fwd_defined(wi, plain(wi["qpad"], wi["rtpad"], wi["mn"],
                                       wi["n_words"]))
        for name, lib in libs.items():
            if not same(c.fwd_defined(wi, run(lib, wi, buffers(wi))), want):
                raise RuntimeError(f"{name} differs from {kernel}_plain on "
                                   f"'{tag}'")
        log(f"[variants] {tag}: every kernel equal to {kernel}_plain")
    qs, ts = c.make_pairs(rng, 640, 11000, 12288)
    wi64 = inputs(qs[:64], ts[:64], d)
    want = c.fwd_defined(wi64, plain(wi64["qpad"], wi64["rtpad"],
                                     wi64["mn"], wi64["n_words"]))
    got = run(libs["package"], wi64, buffers(wi64))
    if not same(c.fwd_defined(wi64, got), want):
        raise RuntimeError(f"the package's {kernel} differs from "
                           f"{kernel}_plain at 64 pairs of 11000-12288")
    log(f"[variants] package {kernel} equal to {kernel}_plain at 64 pairs "
        f"of 11000-12288 columns")
    sizes = (8, 64, 256, 640)
    wis = {nb: inputs(qs[:nb], ts[:nb], d) for nb in sizes}
    outs = {nb: buffers(wis[nb]) for nb in sizes}
    for nb in sizes:
        wi = wis[nb]
        want = c.fwd_defined(wi, run(libs["package"], wi, buffers(wi)))
        for name, lib in libs.items():
            if not same(c.fwd_defined(wi, run(lib, wi, buffers(wi))), want):
                raise RuntimeError(f"{name} differs from the package's "
                                   f"{kernel} at {nb} pairs")
    log(f"[variants] every copy equal to the package's {kernel} at "
        + ", ".join(map(str, sizes)) + " pairs")
    times = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for nb in sizes:
                _, ms = c.timed(lambda: run(libs[name], wis[nb], outs[nb]), 3)
                times.setdefault((name, nb), []).append(ms)
    mhz = c.sm_clock_mhz()
    for nb in sizes:
        diags = int((wis[nb]["m_np"] + wis[nb]["n_np"]).max()) + 1
        for name in libs:
            t = times[(name, nb)]
            log(f"[variants] {kernel} {name} {nb} pairs: "
                + " / ".join(f"{x:.3f}" for x in t) + f" ms; "
                f"{min(t) * 1e6 / diags * mhz / 1e3:.0f} cycles an "
                f"anti-diagonal (longest pair {diags}, {mhz:.0f} MHz)")
    return 0


def main_wave_fast_tb(srcs) -> int:
    import numpy as np
    import torch
    import chip_smoke as c
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.ops import align as A
    c.phase_env()
    _build.build(native=False)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs = {"package": _build.kernels()}
    libs.update(build_copies(_build.find_nvcc(), _build.NVCC_FLAGS,
                             tempfile.mkdtemp(prefix="chip_variants_"), srcs,
                             "ndt_wave_fast_tb",
                             [vp, vp, vp, vp, vp, ci, ci, ci, vp]))
    d = torch.device("cuda")

    def run(lib, tb, base, mn):
        B, nw, _ = tb.shape
        ops = torch.full((B, nw * A.PACK), A.OP_NONE, dtype=torch.uint8,
                         device=d)
        ok = torch.empty(B, dtype=torch.uint8, device=d)
        rc = lib.ndt_wave_fast_tb(
            tb.data_ptr(), base.data_ptr(), mn.data_ptr(), ops.data_ptr(),
            ok.data_ptr(), B, nw, nw * A.PACK,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: error {rc}")
        return ops, ok.to(torch.bool)

    def forward(qs, ts):
        fi = c.fast_inputs(qs, ts, d)
        tb, base, _ = A.wave_fast_fwd(fi["qpad"], fi["rtpad"], fi["mn"],
                                      fi["n_words"])
        return tb, base, fi["mn"]

    def same(x, y):
        return all(torch.equal(a, b) for a, b in zip(x, y))

    rng = np.random.default_rng(7)
    sets = [(f"ragged B={b}", c.make_pairs(rng, b, 200, 1500), 0)
            for b in (1, 3, 5, 33, 130)]
    qs, ts = c.mixed_length_pairs(rng, n=40, hi=12300)
    empty = np.zeros(0, np.int8)
    sets += [("degenerate", c.degenerate_pairs(rng), 0),
             ("mixed m+n 0..24.6k", ([empty] + qs, [empty] + ts), 0),
             ("band exits (base +-300)", c.make_pairs(rng, 64, 1000, 3000),
              300)]
    inputs = []
    for tag, (qs, ts), by in sets:
        tb, base, mn = forward(qs, ts)
        if by:
            base = c.shift_base(base, mn, by)
        inputs.append((tag, tb, base, mn))
    inputs.append(("random decisions",
                   *(x.to(d) for x in c.random_fast_tb(rng))))
    for tag, tb, base, mn in inputs:
        want = A.wave_fast_tb_plain(tb, base, mn)
        for name, lib in libs.items():
            if not same(run(lib, tb, base, mn), want):
                raise RuntimeError(f"{name} differs from wave_fast_tb_plain "
                                   f"on '{tag}'")
        log(f"[variants] {tag}: every kernel equal to wave_fast_tb_plain "
            f"({int(want[1].sum())} of {len(mn)} ok)")
    qs, ts = c.make_pairs(rng, 640, 11000, 12288)
    tb, base, mn = forward(qs, ts)
    if not same(run(libs["package"], tb[:64], base[:64], mn[:64]),
                A.wave_fast_tb_plain(tb[:64], base[:64], mn[:64])):
        raise RuntimeError("the package's wave_fast_tb differs from "
                           "wave_fast_tb_plain at 64 pairs of 11000-12288")
    log("[variants] package wave_fast_tb equal to wave_fast_tb_plain at 64 "
        "pairs of 11000-12288 columns")
    sizes = (8, 64, 256, 640)
    want = {nb: run(libs["package"], tb[:nb], base[:nb], mn[:nb])
            for nb in sizes}
    for nb in sizes:
        for name, lib in libs.items():
            if not same(run(lib, tb[:nb], base[:nb], mn[:nb]), want[nb]):
                raise RuntimeError(f"{name} differs from the package's "
                                   f"wave_fast_tb at {nb} pairs")
    log("[variants] every copy equal to the package's wave_fast_tb at "
        + ", ".join(map(str, sizes)) + " pairs")
    times = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for nb in sizes:
                _, ms = c.timed(lambda: run(libs[name], tb[:nb], base[:nb],
                                            mn[:nb]), 5)
                times.setdefault((name, nb), []).append(ms)
    steps = (want[max(sizes)][0] != A.OP_NONE).sum(dim=1)
    mhz = c.sm_clock_mhz()
    for nb in sizes:
        longest = int(steps[:nb].max())
        for name in libs:
            t = times[(name, nb)]
            log(f"[variants] wave_fast_tb {name} {nb} pairs: "
                + " / ".join(f"{x:.3f}" for x in t) + f" ms; "
                f"{min(t) * 1e6 / longest * mhz / 1e3:.0f} cycles a step "
                f"(longest walk {longest} steps, {mhz:.0f} MHz)")
    return 0


def main_engine(srcs, kernel) -> int:
    """--kernel vote_corridor or chain_emit: copies of csrc/engine.cu, each
    launched through the engine's own launch helper with its library."""
    import numpy as np
    import torch
    import chip_smoke as c
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.overlap import engine as E
    vp, ci = ctypes.c_void_p, ctypes.c_int
    argtypes = ([vp] * 7 + [ci, ci, ci, vp] if kernel == "vote_corridor"
                else [vp] * 7 + [ctypes.c_longlong, ci, ci, ci, ci, ci,
                                 ctypes.c_float, vp])
    c.phase_env()
    _build.build(native=False)
    libs = {"package": _build.kernels()}
    libs.update(build_copies(_build.find_nvcc(), _build.NVCC_FLAGS,
                             tempfile.mkdtemp(prefix="chip_variants_"), srcs,
                             "ndt_" + kernel, argtypes))
    d = torch.device("cuda")
    s1 = c.STAGE01
    kw = dict(k=s1["k"], min_cnt=s1["min_cnt"], min_span=s1["min_span"])
    mb = c.main_batch(d)
    sets = [("main-path batch", E.engine_anchor(*mb["args"],
                                                max_occ=s1["max_occ"]),
             s1["top_k"])]
    sets += [(f"{tag}, top_k {top_k}", tuple(torch.from_numpy(x).to(d)
                                            for x in a), top_k)
             for tag, a, top_k, _ in c.engine_tile_sets(
                 np.random.default_rng(19))]

    def inputs(anchors, top_k):
        """(launch function of (lib, G), the plain version's outputs,
        exact G, A) on these anchors."""
        vi = E._vote_inputs(*anchors, diag_shift=8)
        gstart = E.group_starts(vi[0], vi[1])
        A = vi[0].shape[0]
        G = int((gstart < A).sum())
        vp_ = E.vote_corridor_plain(*vi[:5], diag_shift=8, top_k=top_k)
        if kernel == "vote_corridor":
            out = (torch.empty_like(vi[1]), torch.empty_like(vi[4]))
            return (lambda lib, g: E._vote_launch(
                lib, *vi[1:5], gstart, *out, g, 8, top_k) or out), vp_, G, A
        chi = E._chain_inputs(vi[0], *vp_, vi[5])
        out = (torch.empty(A, dtype=torch.bool, device=d),
               torch.empty((8, A), dtype=torch.int64, device=d))
        return (lambda lib, g: E._chain_launch(
            lib, *chi, gstart, *out, g, top_k=top_k, **kw) or out), \
            E.chain_emit_plain(*chi, top_k=top_k, **kw), G, A

    prepared = {}
    for tag, anchors, top_k in sets:
        run, want, G, A = inputs(anchors, top_k)
        for name, lib in libs.items():
            for g in ((G, A) if name == "package" else (G,)):
                got = run(lib, g)
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise RuntimeError(f"{name} differs from {kernel}_plain "
                                       f"on '{tag}' (G = {g})")
        log(f"[variants] {tag}: every copy equal to {kernel}_plain "
            f"(A={A}, {G} groups)")
        if tag == "main-path batch" or tag.endswith("top_k 4"):
            prepared[tag] = (run, G, A)
    times = {}
    order = list(libs)
    for names in (order, order[::-1]):
        for name in names:
            for tag, (run, G, A) in prepared.items():
                gs = (("G", G), ("A", A)) if name == "package" else (("G", G),)
                for gn, g in gs:
                    ms = c._events_ms(lambda: run(libs[name], g), 5)
                    times.setdefault((name, gn, tag), []).append(ms)
    for tag, (run, G, A) in prepared.items():
        for (name, gn, t_), t in times.items():
            if t_ == tag:
                log(f"[variants] {kernel} {name}"
                    f"{' (grid from A, as the wrapper)' if gn == 'A' else ''}"
                    f", {tag} (A={A}, {G} groups): "
                    + " / ".join(f"{x:.4f}" for x in t) + " ms")
    return 0


def main_engine_anchor(srcs) -> int:
    """--kernel engine_anchor: copies of csrc/engine.cu with the package's
    engine_anchor signature, each launched through the engine's own launch
    helper with its library."""
    import numpy as np
    import torch
    import chip_smoke as c
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.overlap import engine as E
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    c.phase_env()
    _build.build(native=False)
    libs = {"package": _build.kernels()}
    libs.update(build_copies(_build.find_nvcc(), _build.NVCC_FLAGS,
                             tempfile.mkdtemp(prefix="chip_variants_"), srcs,
                             "ndt_engine_anchor",
                             [vp] * 13 + [ci, ll, ll, ci, ci, vp]))
    d = torch.device("cuda")
    mo = c.STAGE01["max_occ"]
    mb = c.main_batch(d)
    rng = np.random.default_rng(19)
    sets = [("main-path batch", mb["args"], mo)] + [
        (tag, tuple(torch.from_numpy(x).to(d) for x in a), m)
        for tag, a, m in c.engine_anchor_sets(rng)]
    stream = torch.cuda.current_stream(d).cuda_stream

    def launches(lib, args, m):
        """(launch, out, directory): lib's launch function on args, the
        output it writes and the directory it reads (hold it)."""
        M, H = args[0].shape[0], args[7].shape[0]
        bucket = E.anchor_directory(args[7])
        ins = [t.data_ptr() for t in args + (bucket,)]
        stat, nb = E._anchor_stat(M, d)
        cap = M * m                       # as the wrapper: the bound of A
        out = torch.empty((5, cap), dtype=torch.int64, device=d)
        launch = functools.partial(
            E._anchor_launch, lib, ins, stat, out.data_ptr(), M, H, cap,
            32 - E.directory_bits(H), m, stream)
        launch()
        A = int(stat[nb]) if M else 0
        return launch, out[:, :A], bucket

    for tag, args, m in sets:
        want = E.engine_anchor_plain(*args, max_occ=m)
        for name, lib in libs.items():
            _, out, _ = launches(lib, args, m)
            if not all(torch.equal(x, y) for x, y in zip(out, want)):
                raise RuntimeError(f"{name} differs from engine_anchor_plain "
                                   f"on '{tag}'")
        log(f"[variants] {tag}: every copy equal to engine_anchor_plain "
            f"(M={args[0].shape[0]}, H={args[7].shape[0]}, "
            f"A={want[0].shape[0]})")
    flush = torch.empty(c.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=d)
    prepared = {name: launches(lib, mb["args"], mo)
                for name, lib in libs.items()}
    times = {}
    for names in (list(libs), list(libs)[::-1]):
        for name in names:
            launch = prepared[name][0]
            for how, t in (
                    ("alone", lambda: c._events_ms(launch, 5)),
                    ("each warm", lambda: c._each_ms(launch, None)),
                    ("each L2 flushed", lambda: c._each_ms(launch, flush))):
                times.setdefault((name, how), []).append(t())
    for (name, how), t in times.items():
        log(f"[variants] engine_anchor {name}, main-path batch, {how}: "
            + " / ".join(f"{x:.4f}" for x in t) + " ms")
    return 0


def engine_anchor_turn(tree) -> int:
    """--engine-anchor-turn DIR: engine_anchor of the package in the
    checkout DIR at the main path's batch, called as find_overlaps calls it
    (with the directory made before, where the package has one): the whole
    call by the host clock, and the device time of the kernels whose name
    holds engine_anchor and of the call's other device work by
    torch.profiler, each warm and with the L2 flushed before each call (5
    calls after a warm one).  Prints one JSON line.  Only the package's
    public wrapper is used, so that two checkouts compare."""
    import chip_smoke as c
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.overlap import engine as E
    if not E.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {E.__file__}, not the package in {tree}")
    c.phase_env()
    _build.build(native=False)
    d = torch.device("cuda")
    mb = c.main_batch(d)
    args, reps = mb["args"], 5
    kw = dict(max_occ=c.STAGE01["max_occ"])
    if hasattr(E, "anchor_directory"):
        kw["bucket"] = E.anchor_directory(args[7])
    call = lambda: E.engine_anchor(*args, **kw)
    flush = torch.empty(c.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=d)
    res = {"tree": tree, "A": int(call()[0].shape[0])}
    for how, fl in (("warm", None), ("L2 flushed", flush)):
        call()
        wall = 0.0
        for _ in range(reps):
            if fl is not None:
                fl.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if fl is not None:
                    fl.zero_()
                call()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and (fl is None or "Fill" not in e.key)):
                by_name[e.key[:60]] = (e.device_time_total / 1e3 / reps,
                                       e.count / reps)
        kern = [v for k, v in by_name.items() if "engine_anchor" in k]
        res[how] = dict(
            whole_call_ms=wall * 1e3 / reps,
            kernels_ms=sum(v[0] for v in kern),
            launches=sum(v[1] for v in kern),
            other_device_ms=sum(v[0] for k, v in by_name.items()
                                if "engine_anchor" not in k),
            device_ms_by_name={k: v[0] for k, v in by_name.items()})
    log(json.dumps({"engine_anchor_turn": res}))
    return 0


SPANS = ("engine/host_fill", "engine/match")


def match_turn(tree, mode="") -> int:
    """--match-turn DIR [MODE]: one turn of --match-turns with the package
    in the checkout DIR.  MODE plain_sketch runs every sketch through the
    plain version, plain_first only the first call's; warm_alloc first
    allocates and frees 4 GiB on the card, so that the caching allocator
    holds one segment to split; warm_kernels first runs find_overlaps on
    the 16 shortest seeds, which launches every kernel of the call once.
    Prints one JSON line."""
    import chip_smoke as c
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    from nextdenovo_tpu_torch.io.simulate import simulate_genome, simulate_reads
    from nextdenovo_tpu_torch.ops import sketch as S
    from nextdenovo_tpu_torch.overlap import engine as E
    from nextdenovo_tpu_torch.utils.trace import get_tracer
    if not E.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {E.__file__}, not the package in {tree}")
    c.phase_env()
    _build.build(native=False)
    d = torch.device("cuda")
    s1 = c.STAGE01
    genome = simulate_genome(c.GENOME_SIZE, seed=1)
    sim = simulate_reads(genome, coverage=c.COVERAGE, mean_len=c.MEAN_LEN,
                         error_rate=c.ERROR_RATE, seed=2)
    store = SeqStore.from_codes(sim.reads)
    lens = np.asarray(store.length, np.int64)
    seed_mask = lens >= c.SEED_CUTOFF
    seeds = np.nonzero(seed_mask)[0]
    idx = E.build_index(store, np.arange(len(store)), k=s1["k"], w=s1["w"],
                        max_occ=s1["index_max_occ"], device=d)
    kern = (E.sketch, E.sketch_wide)
    plain = (S.sketch_plain, S.sketch_wide_plain) if mode else kern

    def stage01():
        n = 0
        for q0 in range(0, len(seeds), 2000):
            n += len(E.find_overlaps(
                store, seeds[q0 : q0 + 2000], idx, k=s1["k"], w=s1["w"],
                max_occ=s1["max_occ"], min_cnt=s1["min_cnt"],
                min_span=s1["min_span"], top_k=s1["top_k"],
                query_mask=seed_mask, device=d))
        torch.cuda.synchronize()
        return n

    keys = ("segment.all.allocated", "segment.all.freed",
            "num_alloc_retries", "num_device_alloc", "num_device_free")
    tr = get_tracer()
    res = {"tree": tree, "mode": mode, "calls": []}
    m0 = torch.cuda.memory_stats()
    if mode == "warm_alloc":
        del m0
        torch.empty(4 << 30, dtype=torch.uint8, device=d)
        m0 = torch.cuda.memory_stats()
    elif mode == "warm_kernels":
        E.find_overlaps(store, seeds[np.argsort(lens[seeds])[:16]], idx,
                        k=s1["k"], w=s1["w"], max_occ=s1["max_occ"],
                        min_cnt=s1["min_cnt"], min_span=s1["min_span"],
                        top_k=s1["top_k"], query_mask=seed_mask, device=d)
        torch.cuda.synchronize()
        m1 = torch.cuda.memory_stats()
        res["warm_kernels_segments"] = (m1["segment.all.allocated"]
                                        - m0["segment.all.allocated"])
    for call in range(3):
        E.sketch, E.sketch_wide = plain if (
            mode == "plain_sketch" or (mode == "plain_first" and call == 0)
        ) else kern
        tr.reset()
        m0 = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        if call < 2:
            n = stage01()
            one = dict(wall_s=time.perf_counter() - t0, records=n)
            m1 = torch.cuda.memory_stats()
            one["allocator"] = {k: m1.get(k, 0) - m0.get(k, 0)
                                for k in keys}
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                n = stage01()
            one = dict(profiled_wall_s=time.perf_counter() - t0, records=n)
            by_name = {}
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    by_name[e.key[:60]] = (round(e.device_time_total / 1e3,
                                                 3), e.count)
            one["device_ms_by_name"] = dict(sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:20])
            one["device_ms"] = sum(v[0] for v in by_name.values())
        one["spans"] = {}
        for name in SPANS:
            walls = [sp.wall for sp in tr.spans if sp.name == name]
            one["spans"][name] = dict(
                n=len(walls), wall_s=sum(walls),
                cpu_s=sum(sp.cpu for sp in tr.spans if sp.name == name),
                first5_s=[round(x, 5) for x in walls[:5]],
                median_s=round(float(np.median(walls)), 6),
                max_s=round(max(walls, default=0.0), 5))
        res["calls"].append(one)
    log(json.dumps({"match_turn": res}))
    return 0


def main_match_turns(parent) -> int:
    """--match-turns PARENT: match_turn of PARENT and this checkout in
    turns (see the module's docstring)."""
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)
    modes = os.environ.get("MATCH_TURN_MODES", "plain_sketch,plain_first")
    turns = [(parent, ""), (here, "")]
    turns += [(here, m) for m in modes.split(",")] + [(here, ""), (parent, "")]
    for tree, mode in turns:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--match-turn", tree] + ([mode] if mode else []),
                           cwd=here)
        if r.returncode:
            return r.returncode
    return 0


def mesh_memory_turn(tree) -> int:
    """--mesh-memory-turn DIR: one tree of --mesh-memory."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as c
    from nextdenovo_tpu_torch.parallel import dist_overlap as DO
    from nextdenovo_tpu_torch.parallel import mesh as M
    if not M.__file__.startswith(tree):
        raise RuntimeError(f"imported {M.__file__}, not the package in {tree}")
    peaks = []

    def measured(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            peaks.append((name(a), before, torch.cuda.max_memory_allocated(),
                          torch.cuda.memory_allocated()))
            return out
        return run

    each = M.Mesh.for_each_card
    M.Mesh.for_each_card = measured(lambda a: a[1], each)
    for name in ("build_index", "index_shards"):
        if hasattr(DO, name):
            setattr(DO, name, measured(lambda a, n=name: n,
                                       getattr(DO, name)))
    d = torch.device("cuda")
    c.phase_env()
    c.phase_build()
    w = tempfile.mkdtemp(prefix="chip_variants_mem_")
    _, f = c.phase_main_path(d, c.GENOME_SIZE, w)
    _, peak = c.phase_mesh_path(d, w, f["sim"], f["genome"])
    mib = lambda x: x / 2**20
    for name, before, top, after in peaks:
        log(f"[mesh-memory] {tree}: {name:<20} before {mib(before):8.1f} MiB, "
            f"peak {mib(top):8.1f} MiB, after {mib(after):8.1f} MiB")
    log(f"[mesh-memory] {tree}: the mesh path's peak {mib(peak):.1f} MiB "
        f"(since the last phase's reset)")
    return 0


def main_mesh_memory(parent) -> int:
    """--mesh-memory PARENT: mesh_memory_turn of PARENT, then of this
    checkout."""
    here = os.path.dirname(os.path.abspath(__file__))
    for tree in (os.path.abspath(parent), here):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--mesh-memory-turn", tree], cwd=here)
        if r.returncode:
            return r.returncode
    return 0


SKETCH_PHASE_MARKS = (
    # (text in csrc/sketch.cu, what goes before it): thread 0 stamps clock64
    # at the end of each phase; slots 1..9 of a block's 12
    ("    if (tid == 0) s_g = (int)atomicAdd(ticket, 1u);\n",
     "    long long* dbg = g_dbg + (int64_t)min(blockIdx.x, 16383u) * 12;\n"
     "    if (tid == 0) { dbg[0] = gtime(); dbg[1] = clock64(); }\n"),
    ("    const int b = g / n_tiles;\n",
     "    if (tid == 0) dbg[2] = clock64();\n"),
    ("    // (2) the canonical hash", "    if (tid == 0) dbg[3] = clock64();\n"),
    ("    // (3) spans of 2^d", "    if (tid == 0) dbg[4] = clock64();\n"),
    ("    const int off = w - (1 << p2);\n",
     "    if (tid == 0) dbg[5] = clock64();\n"),
    ("    // (4) selection", "    if (tid == 0) dbg[6] = clock64();\n"),
    ("    if (tid == 0)\n        st_status(status + g, (g == 0",
     "    if (tid == 0) dbg[7] = clock64();\n"),
    ("    // (6) each selected", "    if (tid == 0) dbg[8] = clock64();\n"))
SKETCH_PHASES = ("ticket", "codes and packing", "hashes", "doubling",
                 "marks", "selection and ranks", "look-back", "writes")


def sketch_phase_copies(tmp):
    """Two instrumented copies of the package's csrc/sketch.cu in tmp, each
    exporting ndt_dbg: thread 0 of each block stamps the global timer at
    its start and end, clock64 at the end of each phase (SKETCH_PHASES) and
    its ticket.  sketch_phases.cu as it is; sketch_phases_acqrel.cu with
    release stores and acquire loads of the status words.  Returns their
    paths."""
    from nextdenovo_tpu_torch import _build
    src = open(os.path.join(_build.CSRC_DIR, "sketch.cu")).read()
    head = ("__device__ long long g_dbg[16384 * 12];\n\nnamespace {\n\n"
            "__device__ __forceinline__ long long gtime() {\n"
            "    long long t;\n"
            "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "    return t;\n}\n")
    s = src.replace("namespace {\n", head, 1)
    for mark, stamp in SKETCH_PHASE_MARKS:
        if s.count(mark) != 1:
            raise RuntimeError(f"sketch.cu: no single {mark!r}")
        s = s.replace(mark, stamp + mark)
    end = "            out[3 * stride + o] = mstr[t];\n        }\n    }\n"
    if s.count(end) != 1:
        raise RuntimeError("sketch.cu: no single end of the writes")
    s = s.replace(end, end + "    if (tid == 0) { dbg[9] = clock64(); "
                  "dbg[10] = gtime(); dbg[11] = g; }\n")
    s = s.replace('extern "C" {\n', 'extern "C" {\n\n'
                  '// copies n blocks\' stamps out, then zeroes them all\n'
                  'int ndt_dbg(void* host, int n) {\n'
                  '    int e = (int)cudaMemcpyFromSymbol(host, g_dbg, '
                  '(size_t)n * 12 * 8);\n'
                  '    void* p = nullptr;\n'
                  '    if (e == 0) e = (int)cudaGetSymbolAddress(&p, g_dbg);\n'
                  '    if (e == 0) e = (int)cudaMemset(p, 0, sizeof(g_dbg));\n'
                  '    return e;\n}\n', 1)
    acq = s.replace("st.relaxed.gpu.global.u64", "st.release.gpu.global.u64") \
        .replace("ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64")
    out = []
    for name, text in (("sketch_phases.cu", s),
                       ("sketch_phases_acqrel.cu", acq)):
        out.append(os.path.join(tmp, name))
        with open(out[-1], "w") as fh:
            fh.write(text)
    return out


def main_sketch_minimizers(srcs) -> int:
    """--kernel sketch_minimizers [--phases] A.cu ...: see the module's
    docstring."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as c
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.ops import sketch as S
    from nextdenovo_tpu_torch.overlap.engine import CHUNK_LP
    c.phase_env()
    _build.build(native=False)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs = {"package": _build.kernels()}
    tmp = tempfile.mkdtemp(prefix="chip_variants_")
    if "--phases" in srcs:
        srcs = [x for x in srcs if x != "--phases"] + sketch_phase_copies(tmp)
    libs.update(build_copies(
        _build.find_nvcc(), _build.NVCC_FLAGS, tmp, srcs,
        "ndt_sketch_minimizers",
        [vp, ll] + [vp] * 5 + [ll, vp, vp, ll] + [ci] * 4 + [vp]))
    d = torch.device("cuda")
    to = lambda a: torch.from_numpy(a).to(d)
    store = c.main_store()
    rows, _, _ = c.main_query_rows(store)
    hs, hr = c.hifi_sketch_rows()
    shapes = {"main": (c._batch_tensors(d, store, rows), 15, 5,
                       2 * 16 * CHUNK_LP // 5 + 1024),
              "index": (c._batch_tensors(d, store, c.main_index_rows(store)),
                        15, 5, 2 * 32 * CHUNK_LP // 5 + 1024),
              "hifi": (c._batch_tensors(d, hs, hr), 51, 51,
                       2 * 32 * CHUNK_LP // 51 + 1024)}
    sets = dict(shapes)
    rng = np.random.default_rng(5)
    for k, w in ((1, 1), (15, 5), (48, 51), (143, 17), (15, 2048)):
        buf, lens = c.sketch_edge_batch(rng, k, w, L=max(2100, 2 * w + 1500))
        sets[f"edge k={k} w={w}"] = ((to(buf), to(lens), None, None), k, w,
                                     buf.size)
    view, ml = c.mesh_sized_codes(d, rng)
    sets["mesh-sized"] = ((view, ml, None, None), 15, 5, view.numel())

    def launcher(lib, args, k, w, cap):
        codes, lens, lo, hi = args
        sb = S._buffers(codes, lens, k, w, cap, lo, hi)
        B, L = codes.shape

        def go():
            rc = lib.ndt_sketch_minimizers(
                codes.data_ptr(), sb.pitch, sb.lens.data_ptr(),
                S._ptr(sb.own_lo), S._ptr(sb.own_hi), None,
                sb.out.data_ptr(), sb.out.shape[1], sb.n_all.data_ptr(),
                sb.status.data_ptr(), sb.status.shape[0], B, L, k, w,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: error {rc}")
        return sb, go

    for tag, (args, k, w, cap) in sets.items():
        codes, lens, lo, hi = args
        ref = S.sketch_wide_plain(codes, lens, k, w, cap, own_lo=lo,
                                  own_hi=hi)
        want = torch.stack([ref.rid, ref.pos, ref.hash, ref.strand])
        for name, lib in libs.items():
            sb, go = launcher(lib, args, k, w, cap)
            go()
            n_all = int(sb.n_all)
            if n_all != ref.n_all or not torch.equal(sb.out[:, :ref.n], want):
                raise RuntimeError(f"{name} differs from sketch_wide_plain on "
                                   f"{tag} ({n_all} against {ref.n_all})")
    log(f"[variants] every copy equal to sketch_wide_plain on "
        f"{', '.join(sets)}")
    times = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for tag, (args, k, w, cap) in shapes.items():
                _, go = launcher(libs[name], args, k, w, cap)
                times.setdefault((name, tag), []).append(c._events_ms(go))
    for name in libs:
        dev_ms = {}
        for tag, (args, k, w, cap) in shapes.items():
            _, go = launcher(libs[name], args, k, w, cap)
            go()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    go()
                torch.cuda.synchronize()
            dev_ms[tag] = {
                ("kernel" if "sketch" in e.key else e.key[:24]):
                round(e.device_time_total / 1e3 / 5, 5)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        log(f"[variants] {name}: " + "; ".join(
            f"{tag} " + " / ".join(f"{x:.4f}" for x in times[(name, tag)])
            + f" ms, device {json.dumps(dev_ms[tag])}" for tag in shapes))
    for name, lib in libs.items():
        if not hasattr(lib, "ndt_dbg"):
            continue
        for tag, (args, k, w, cap) in shapes.items():
            sb, go = launcher(lib, args, k, w, cap)
            G = sb.status.shape[0] - 1        # at most
            buf = (ctypes.c_longlong * (G * 12))()
            dbg = lambda: lib.ndt_dbg(ctypes.cast(buf, ctypes.c_void_p), G)
            torch.cuda.synchronize()
            rc = dbg()                        # clears the earlier stamps
            go()
            torch.cuda.synchronize()
            if rc != 0 or dbg() != 0:
                raise RuntimeError("ndt_dbg failed")
            a = np.frombuffer(buf, dtype=np.int64).reshape(G, 12)
            a = a[a[:, 1] != 0]           # the blocks the copy launched
            G = a.shape[0]
            ph = np.diff(a[:, 1:10], axis=1)
            t0 = a[:, 0].min()
            log(f"[variants] {name} {tag}, {G} blocks, cycles a phase "
                f"(median / max over blocks): " + ", ".join(
                    f"{SKETCH_PHASES[j]} {int(np.median(ph[:, j]))}/"
                    f"{int(ph[:, j].max())}" for j in range(ph.shape[1]))
                + f"; block starts {(a[:, 0] - t0).max() / 1e3:.2f} us "
                f"after the first, ends {(a[:, 10] - t0).min() / 1e3:.2f}-"
                f"{(a[:, 10] - t0).max() / 1e3:.2f} us; ticket != blockIdx "
                f"in {int((a[:, 11] != np.arange(G)).sum())} blocks")
    return 0


ROUTE_PHASE_MARKS = (
    # (text in csrc/route.cu, what goes before it, what replaces it or
    # None): thread 0 of a block stamps the global timer and clock64
    ("    int* cnt = sm + THREADS;\n", None,
     "    int* cnt = sm + THREADS;\n    long long* dbg = g_dbg + (int64_t)min("
     "blockIdx.x, 16383u) * 8;\n    if (tid == 0) { dbg[0] = gtime(); "
     "dbg[1] = clock64(); }\n"),
    ("    int* const rows[1] = {blk + (int64_t)blockIdx.x * n1};\n",
     "    if (tid == 0) dbg[2] = clock64();\n", None),
    ("    if (publish_last(cnt, rows, 1, n1, ticket, gridDim.x)) {\n"
     "        scan_tiles(blk, gridDim.x, n1, counts, sm, sm + THREADS);\n"
     "        if (tid == 0) *ticket = 0;\n    }\n", None,
     "    const bool lb = publish_last(cnt, rows, 1, n1, ticket, gridDim.x);\n"
     "    if (tid == 0) dbg[3] = clock64();\n"
     "    if (lb) {\n"
     "        scan_tiles(blk, gridDim.x, n1, counts, sm, sm + THREADS);\n"
     "        if (tid == 0) *ticket = 0;\n    }\n"
     "    if (tid == 0) { dbg[4] = clock64(); dbg[5] = gtime(); "
     "dbg[6] = lb; }\n"),
    ("    int64_t lo, rlo = 0;\n    int rows, side = 0;\n",
     "    long long* dbg = g_dbg2 + (int64_t)min(blockIdx.x, 16383u) * 8;\n"
     "    if (tid == 0) { dbg[0] = gtime(); dbg[1] = clock64(); }\n", None),
    ("    // (1) a row's rank", "    if (tid == 0) dbg[2] = clock64();\n",
     None),
    ("    // (2) per destination", "    if (tid == 0) dbg[3] = clock64();\n",
     None),
    ("    // (3) each row's slot", "    if (tid == 0) dbg[4] = clock64();\n",
     None),
    ("    // (4) the kept rows staged", "    if (tid == 0) dbg[5] = clock64();\n",
     None),
    ("        return;\n    }\n    constexpr int PAIRS", None,
     "        if (tid == 0) { dbg[6] = clock64(); dbg[7] = gtime(); }\n"
     "        return;\n    }\n    constexpr int PAIRS"),
    # the last block's scan, its chunk's steps (g_dbg3)
    ("    const int G = THREADS / n1, TB = SCAN_INTS / n1;\n",
     "    if (tid == 0) g_dbg3[0] = clock64();\n", None),
    ("        __syncthreads();\n        const int seg = (nb + G - 1) / G;\n",
     None, "        __syncthreads();\n        if (tid == 0) g_dbg3[1] = "
     "clock64();\n        const int seg = (nb + G - 1) / G;\n"),
    ("        if (tid < n1) {\n            int run = carry;\n",
     "        if (tid == 0) g_dbg3[2] = clock64();\n", None),
    ("        if (g < G) {\n            int run = part[tid];\n",
     "        if (tid == 0) g_dbg3[3] = clock64();\n", None),
    ("        for (int i = tid; i < m; i += THREADS) src[i] = tab[i];\n",
     "        if (tid == 0) g_dbg3[4] = clock64();\n", None),
    ("    if (tid < n1) counts[tid] = carry;\n",
     "    if (tid == 0) g_dbg3[5] = clock64();\n", None),
    ("        __syncthreads();\n    }\n}\n\ncudaError_t smem_attr", None,
     "        __syncthreads();\n    }\n    if (tid == 0) { dbg[6] = clock64(); "
     "dbg[7] = gtime(); }\n}\n\ncudaError_t smem_attr"))
ROUTE_PHASES = {0: ("keys and counts", "ticket", "scan"),
                1: ("prefetch and keys", "ranks", "scans", "slots",
                    "fields")}

def route_entries():
    """The four routing entries' ctypes signatures (as _build sets them)."""
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    pv = ctypes.POINTER(vp)
    return {"ndt_route_count": [vp, vp, ci, ci, vp, vp, vp, vp, vp],
            "ndt_route_scatter": [pv, ci, vp, vp, vp, ci, ci, ci, pv, vp, vp],
            "ndt_seed_route_count": [vp, vp, vp, ci, ll, ci, vp, vp, vp, vp,
                                     vp],
            "ndt_seed_route_scatter": [vp, ci, vp, vp, vp, ci, ci, pv, vp,
                                       vp],
            "ndt_route_resident": [ci]}


def route_phase_copy(tmp):
    """An instrumented copy of the package's csrc/route.cu in tmp,
    exporting ndt_dbg: thread 0 of each count block (g_dbg) and scatter
    block (g_dbg2) stamps the global timer at its start and end and
    clock64 at the ends of its phases (ROUTE_PHASES).  Returns its path."""
    from nextdenovo_tpu_torch import _build
    src = open(os.path.join(_build.CSRC_DIR, "route.cu")).read()
    head = ("__device__ long long g_dbg[16384 * 8];\n"
            "__device__ long long g_dbg2[16384 * 8];\n"
            "__device__ long long g_dbg3[8];\n\nnamespace {\n\n"
            "__device__ __forceinline__ long long gtime() {\n"
            "    long long t;\n"
            "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "    return t;\n}\n")
    s = src.replace("namespace {\n", head, 1)
    for mark, before, instead in ROUTE_PHASE_MARKS:
        if s.count(mark) != 1:
            raise RuntimeError(f"route.cu: no single {mark!r}")
        s = s.replace(mark, instead if instead is not None
                      else before + mark)
    s = s.replace('extern "C" {\n', 'extern "C" {\n\n'
                  '// copies n blocks\' stamps of the count (which = 0) or\n'
                  '// scatter (1) kernel out, then zeroes them\n'
                  'int ndt_dbg(void* host, int n, int which) {\n'
                  '    void* p = nullptr;\n'
                  '    int e = which ? (int)cudaGetSymbolAddress(&p, g_dbg2)\n'
                  '                  : (int)cudaGetSymbolAddress(&p, g_dbg);\n'
                  '    if (e == 0) e = (int)cudaMemcpy(host, p, (size_t)n * 64,'
                  ' cudaMemcpyDeviceToHost);\n'
                  '    if (e == 0) e = (int)cudaMemset(p, 0, 16384 * 64);\n'
                  '    return e;\n}\n\n'
                  '// the last count block\'s scan: 8 stamps\n'
                  'int ndt_dbg3(void* host) {\n'
                  '    return (int)cudaMemcpyFromSymbol(host, g_dbg3, 64);\n'
                  '}\n', 1)
    out = os.path.join(tmp, "route_phases.cu")
    with open(out, "w") as fh:
        fh.write(s)
    return out


def mesh_route_calls(d):
    """The mesh path's routing calls of this checkout's main and mesh paths
    (use_mesh = 8 on the one card): {bucketize_4, bucketize_5, seed_route:
    their arguments on d}."""
    import chip_smoke as c
    w = tempfile.mkdtemp(prefix="chip_variants_route_")
    _, f = c.phase_main_path(d, c.GENOME_SIZE, w)
    c.phase_mesh_path(d, w, f["sim"], f["genome"], capture=True)
    calls = {k: c.mesh_call(k, d) for k in ("bucketize_4", "bucketize_5",
                                            "seed_route")}
    c.MESH_CALLS.clear()
    return calls


def main_route_buckets(srcs) -> int:
    """--kernel route_buckets [--phases] A.cu ...: see the module's
    docstring."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as c
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.parallel import dist_sort as DS
    from nextdenovo_tpu_torch.parallel import mesh as MS
    c.phase_env()
    c.phase_build()
    d = torch.device("cuda")
    calls = mesh_route_calls(d)
    tmp = tempfile.mkdtemp(prefix="chip_variants_")
    if "--phases" in srcs:
        srcs = [x for x in srcs if x != "--phases"] + [route_phase_copy(tmp)]
    entries = route_entries()
    libs = {"package": _build.kernels()}
    libs.update(build_copies(_build.find_nvcc(), _build.NVCC_FLAGS, tmp,
                             srcs, "ndt_route_count",
                             entries["ndt_route_count"]))
    for name, lib in libs.items():
        for sym, args in entries.items():
            getattr(lib, sym).restype = ctypes.c_int
            getattr(lib, sym).argtypes = args
        if hasattr(lib, "ndt_dbg"):
            lib.ndt_dbg.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
            lib.ndt_dbg3.argtypes = [ctypes.c_void_p]
    for name, src in [("package", os.path.join(_build.CSRC_DIR, "route.cu"))] \
            + [(os.path.basename(x)[:-3], x) for x in srcs]:
        log(f"[variants] {name}: registers, spill and stack bytes, SASS "
            f"instructions: {json.dumps(c.sketch_sass(src))}")
    rng = np.random.default_rng(29)
    # (tag, the launches from a library, plain) of the exactness sets
    sets = []
    for key in ("bucketize_4", "bucketize_5"):
        a = calls[key]
        sets.append((key, functools.partial(MS.bucket_launches, fields=a[0],
                                            dest=a[1], valid=a[2],
                                            n_shards=a[3], cap=a[4]),
                     functools.partial(MS.bucketize_plain, *a)))
    rec, is_seed, lens, n, cap = calls["seed_route"]
    bad = c._bad_records(rec, lens)
    for tag, r8, n_, cap_ in (("seed_route", rec, n, cap),
                              ("records with ids out of range, n = 8", bad,
                               8, 40),
                              ("records with ids out of range, n = 4096", bad,
                               4096, 10**6)):
        a = (r8, is_seed, lens, n_, cap_)
        sets.append((tag, functools.partial(DS.seed_route_launches, rec=r8,
                                            is_seed=is_seed, lens=lens,
                                            n_shards=n_, cap=cap_),
                     functools.partial(DS.seed_route_plain, *a)))
    for tag, *a in c._route_sets(rng, d):
        if tag.startswith(("n = 8", "n = 4096", "cap = 0", "every row")):
            sets.append((tag, functools.partial(
                MS.bucket_launches, fields=a[0], dest=a[1], valid=a[2],
                n_shards=a[3], cap=a[4]),
                functools.partial(MS.bucketize_plain, *a)))
    for tag, launches_of, plain in sets:
        want = plain()
        for name, lib in libs.items():
            L = c.PreparedRoute(d, launches_of(lib))
            L.scatter()
            c._same_buckets(f"{tag} ({name})", L.buckets(), want)
    log(f"[variants] every copy equal to the plain versions on "
        f"{', '.join(t for t, _, _ in sets)}")
    shapes = {t: launches_of for t, launches_of, _ in sets[:3]}
    launches = {(name, tag): c.PreparedRoute(d, launches_of(lib))
                for name, lib in libs.items()
                for tag, launches_of in shapes.items()}
    times = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for tag in shapes:
                L = launches[(name, tag)]
                times.setdefault((name, tag), []).append(
                    [c._events_ms(f) for f in (L.count, L.scatter, L.both)])
    for name in libs:
        for tag in shapes:
            L = launches[(name, tag)]
            L.both()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    L.both()
                torch.cuda.synchronize()
            dev_ms = {e.key[:32]: round(e.device_time_total / 1e3 / 5, 5)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA}
            log(f"[variants] {name} {tag} (grid {L.tiles} tiles): count / "
                f"scatter / both ms " + " | ".join(
                    " / ".join(f"{x:.4f}" for x in t)
                    for t in times[(name, tag)])
                + f"; device {json.dumps(dev_ms)}")
    for name, lib in libs.items():
        if not hasattr(lib, "ndt_dbg"):
            continue
        for tag in shapes:
            L = launches[(name, tag)]
            for which, go in ((0, L.count), (1, L.scatter)):
                if which == 0 and L.rl.name == "seed_route":
                    continue           # seed_route_count has no stamps
                G = L.tiles
                buf = (ctypes.c_longlong * (16384 * 8))()
                dbg = lambda: lib.ndt_dbg(ctypes.cast(buf, ctypes.c_void_p),
                                          G, which)
                torch.cuda.synchronize()
                rc = dbg()                    # clears the earlier stamps
                go()
                torch.cuda.synchronize()
                if rc != 0 or dbg() != 0:
                    raise RuntimeError("ndt_dbg failed")
                a = np.frombuffer(buf, dtype=np.int64)[: G * 8].reshape(G, 8)
                t0 = a[:, 0].min()
                if which == 0:
                    ph = np.diff(a[:, 1:4], axis=1)
                    last = a[a[:, 6] == 1]
                    scan = int(last[0, 4] - last[0, 3]) if len(last) else -1
                    ends = a[:, 5]
                    b3 = (ctypes.c_longlong * 8)()
                    if lib.ndt_dbg3(ctypes.cast(b3, ctypes.c_void_p)) == 0:
                        st = np.frombuffer(b3, dtype=np.int64)[:6]
                        log(f"[variants] {name} {tag} the last block's scan"
                            f" (cycles; its last chunk): start to loads "
                            f"{int(st[1] - st[0])}, group sums "
                            f"{int(st[2] - st[1])}, column scan "
                            f"{int(st[3] - st[2])}, prefixes "
                            f"{int(st[4] - st[3])}, write-back "
                            f"{int(st[5] - st[4])}")
                else:
                    ph = np.diff(a[:, 1:7], axis=1)
                    ends = a[:, 7]
                names = ROUTE_PHASES[which]
                log(f"[variants] {name} {tag} {'count' if which == 0 else 'scatter'}"
                    f", {G} blocks, cycles a phase (median / max over blocks): "
                    + ", ".join(f"{names[j]} {int(np.median(ph[:, j]))}/"
                                f"{int(ph[:, j].max())}"
                                for j in range(ph.shape[1]))
                    + (f", scan (the last block) {scan}" if which == 0
                       else "")
                    + f"; block starts {(a[:, 0] - t0).max() / 1e3:.2f} us "
                    f"after the first, ends {(ends - t0).min() / 1e3:.2f}-"
                    f"{(ends - t0).max() / 1e3:.2f} us")
    return 0


def route_calls(out) -> int:
    """--route-calls FILE: this checkout's main and mesh paths, and the mesh
    path's routing calls saved to FILE (torch.save, on the host)."""
    import torch
    import chip_smoke as c
    c.phase_env()
    c.phase_build()
    d = torch.device("cuda")
    calls = mesh_route_calls(d)
    torch.save({k: c._moved(v, "cpu") for k, v in calls.items()}, out)
    return 0


def route_turn(tree, calls_file) -> int:
    """--route-turn DIR FILE: the routing of the package in the checkout
    DIR at the three shapes saved in FILE: for each, the launches alone
    (after a device sleep; a tree without seed_route: its seed_symmetrize
    and its route_buckets launch on the views) and the wrapper's whole
    call (seed_symmetrize then bucketize there), the counts and a checksum
    of the buckets.  Prints one JSON line."""
    import chip_smoke as c
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.parallel import dist_sort as DS
    from nextdenovo_tpu_torch.parallel import mesh as MS
    if not MS.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {MS.__file__}, not the package in {tree}")
    c.phase_env()
    _build.build(native=False)
    d = torch.device("cuda")
    calls = {k: c._moved(v, d) for k, v in torch.load(calls_file).items()}
    fused = hasattr(DS, "seed_route")

    def checksum(res):
        buckets, counts = res
        return [[int(f.sum()) for f in b] for b in buckets], \
            [int(x) for x in counts]

    res = {"tree": tree}
    for key in ("bucketize_4", "bucketize_5"):
        fields, dest, valid, n, cap = calls[key]
        call = lambda: MS.bucketize(fields, dest, valid, n, cap)
        if fused:
            launch = c.PreparedRoute(d, MS.bucket_launches(
                _build.kernels(), fields, dest, valid, n, cap)).both
        else:
            launch = lambda: MS._route_launch(fields, dest, valid, n, cap)
        res[key] = dict(launch_ms=c._events_ms(launch),
                        wrapper_ms=c.timed(call, 5)[1],
                        sum=checksum(call()))
    rec, is_seed, lens, n, cap = calls["seed_route"]
    if fused:
        call = lambda: DS.seed_route(rec, is_seed, lens, n, cap)
        launch_ms = {"seed_route_count + seed_route_scatter": c._events_ms(
            c.PreparedRoute(d, DS.seed_route_launches(
                _build.kernels(), rec, is_seed, lens, n, cap)).both)}
    else:
        def call():
            cols, valid, dest = DS.seed_symmetrize(rec, is_seed, lens, n)
            return MS.bucketize(cols.unbind(0), dest, valid, n, cap)
        cols, valid, dest = DS.seed_symmetrize(rec, is_seed, lens, n)
        sym = lambda: DS.seed_symmetrize(rec, is_seed, lens, n)
        rb = lambda: MS._route_launch(cols.unbind(0), dest, valid, n, cap)
        launch_ms = {"seed_symmetrize": c._events_ms(sym),
                     "route_buckets": c._events_ms(rb),
                     "both": c._events_ms(lambda: (sym(), rb()))}
    res["seed_route"] = dict(launch_ms=launch_ms,
                             wrapper_ms=c.timed(call, 5)[1],
                             sum=checksum(call()))
    log(json.dumps({"route_turn": res}))
    return 0


def main_route_turns(parent) -> int:
    """--route-turns PARENT: see the module's docstring."""
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)
    calls = os.path.join(tempfile.mkdtemp(prefix="chip_variants_"),
                         "route_calls.pt")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--route-calls", calls], cwd=here,
                       capture_output=True, text=True)
    sys.stderr.write(r.stderr[-4000:])
    if r.returncode:
        sys.stdout.write(r.stdout[-8000:])
        return r.returncode
    turns = []
    for tree in (parent, here, here, parent):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--route-turn", tree, calls], cwd=here,
                           capture_output=True, text=True)
        sys.stderr.write(r.stderr[-4000:])
        if r.returncode:
            sys.stdout.write(r.stdout[-8000:])
            return r.returncode
        line = [x for x in r.stdout.splitlines() if '"route_turn"' in x][-1]
        turns.append(json.loads(line)["route_turn"])
    for key in ("bucketize_4", "bucketize_5", "seed_route"):
        sums = {json.dumps(t[key]["sum"]) for t in turns}
        if len(sums) != 1:
            raise RuntimeError(f"{key}: the trees' buckets differ")
        log(f"[route-turns] {key}: " + " | ".join(
            ("parent" if t["tree"] == parent else "this") + " launches "
            + (json.dumps({k: round(v, 5) for k, v in
                           t[key]["launch_ms"].items()})
               if isinstance(t[key]["launch_ms"], dict)
               else f"{t[key]['launch_ms']:.4f}")
            + f", wrapper {t[key]['wrapper_ms']:.4f} ms" for t in turns)
            + "; buckets and counts equal in every turn")
    return 0


def sketch_turn(tree) -> int:
    """--sketch-turn DIR: the sketch kernels of the package in the checkout
    DIR at three shapes: the main path's 16-row query batch and a 32-row
    batch of its index build (k = 15, w = 5), and the HiFi batch's 32
    longest chunk rows (k = w = 51), each with its own gates and cap.  For
    each: the kernels' launches alone (CUDA events after a device sleep;
    sketch_select and sketch_emit each and both where the package has
    them, else sketch_minimizers with its memset), the wrapper's whole
    call (host sync included), and the minimizers.  Also the registers,
    spills and SASS instructions of the checkout's csrc/sketch.cu.  Prints
    one JSON line."""
    import chip_smoke as c
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.ops import sketch as S
    from nextdenovo_tpu_torch.overlap.engine import CHUNK_LP
    if not S.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {S.__file__}, not the package in {tree}")
    c.phase_env()
    _build.build(native=False)
    d = torch.device("cuda")
    lib = _build.kernels()
    store = c.main_store()
    rows, _, _ = c.main_query_rows(store)
    hs, hr = c.hifi_sketch_rows()
    shapes = (("main", c._batch_tensors(d, store, rows), 15, 5, 16, False),
              ("index", c._batch_tensors(d, store, c.main_index_rows(store)),
               15, 5, 32, False),
              ("hifi", c._batch_tensors(d, hs, hr), 51, 51, 32, True))
    res = {"tree": tree, "sass": c.sketch_sass(os.path.join(
        tree, "nextdenovo_tpu_torch", "csrc", "sketch.cu"))}
    for name, (codes, lens, lo, hi), k, w, nrows, wide in shapes:
        cap = 2 * nrows * CHUNK_LP // w + 1024
        sb = S._buffers(codes, lens, k, w, cap, lo, hi)
        if hasattr(S, "_minimizers_launch"):
            launches = {"sketch_minimizers":
                        lambda: S._minimizers_launch(lib, sb, k, w)}
        else:
            launches = {"sketch_select": lambda: S._select_launch(lib, sb, k,
                                                                  w),
                        "sketch_emit": lambda: S._emit_launch(lib, sb),
                        "both": lambda: (S._select_launch(lib, sb, k, w),
                                         S._emit_launch(lib, sb))}
        fn = S.sketch_wide if wide else S.sketch
        m, call_ms = c.timed(lambda: fn(codes, lens, k, w, cap, own_lo=lo,
                                        own_hi=hi), 5)
        res[name] = dict(shape=f"{tuple(codes.shape)} k={k} w={w}", n=m.n,
                         launch_ms={n: c._events_ms(f)
                                    for n, f in launches.items()},
                         wrapper_ms=call_ms)
    log(json.dumps({"sketch_turn": res}))
    return 0


def main_sketch_turns(parent) -> int:
    """--sketch-turns PARENT: sketch_turn of the checkout in PARENT and of
    this one, a process each, in turns parent, this, this, parent; the
    minimizer counts must agree.  Prints each turn's line and a summary."""
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)
    turns = []
    for tree in (parent, here, here, parent):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--sketch-turn", tree], cwd=here,
                           capture_output=True, text=True)
        sys.stdout.write(r.stdout)
        sys.stderr.write(r.stderr[-4000:])
        if r.returncode:
            return r.returncode
        line = [x for x in r.stdout.splitlines() if '"sketch_turn"' in x][-1]
        turns.append(json.loads(line)["sketch_turn"])
    for name in ("main", "index", "hifi"):
        ns = {t[name]["n"] for t in turns}
        if len(ns) != 1:
            raise RuntimeError(f"{name}: the trees' minimizer counts differ: "
                               f"{ns}")
        log(f"[sketch-turns] {name} {turns[0][name]['shape']}: " + " | ".join(
            ("parent" if t["tree"] == parent else "this") + " "
            + ", ".join(f"{n} {v:.4f}" for n, v in t[name]["launch_ms"].items())
            + f", wrapper {t[name]['wrapper_ms']:.4f} ms" for t in turns))
    return 0


# the mesh path's spans that --turns reports for each turn
MESH_TURN_SPANS = ("mesh/sketch_route", "mesh/lookup_route",
                   "mesh/sort_route", "mesh/sort")


def main_turns(parent) -> int:
    """--turns PARENT: this checkout against the one in PARENT (an earlier
    tree, unpacked with git archive), in turns parent, this, this, parent:
    engine_anchor_turn of each, then each checkout's own chip_smoke
    main, mesh (use_mesh = 8 on the one card) and HiFi paths (stage walls,
    engine/match) in a workdir of its own.  Every stage file of the first
    parent and the first of this checkout's runs (the files under a stage's
    directory, the .done markers aside, which hold times) must be
    byte-equal."""
    import filecmp
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)
    order = [parent, here, here, parent]
    for tree in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--engine-anchor-turn", tree], cwd=here)
        if r.returncode:
            return r.returncode
    runs = tempfile.mkdtemp(prefix="chip_variants_turns_")
    code = ("import chip_smoke as c, torch, sys, json; "
            "from nextdenovo_tpu_torch.utils import get_tracer; "
            "d = torch.device('cuda'); "
            "c.phase_env(); c.phase_build(); w = sys.argv[1]; "
            "l, f = c.phase_main_path(d, c.GENOME_SIZE, w + '/main'); "
            "ml, mp = c.phase_mesh_path(d, w + '/main', f['sim'], "
            "f['genome']); "
            "sp = {n: [sum(1 for x in get_tracer().spans if x.name == n), "
            "sum(x.wall for x in get_tracer().spans if x.name == n)] "
            f"for n in {MESH_TURN_SPANS!r}}}; "
            "print(json.dumps({'turn_spans': sp}), flush=True); "
            "torch.cuda.device_count() > 1 and c.phase_mesh_cards("
            "d, w + '/main', f['sim'], f['genome'], mp); "
            "c.phase_hifi_path(d, c.HIFI_GENOME_SIZE, w + '/hifi')")
    wds, summary = [], []
    for i, tree in enumerate(order):
        wd = os.path.join(runs, f"turn{i}")
        for sub in ("main", "hifi"):
            os.makedirs(os.path.join(wd, sub))
        log(f"[turns] turn {i}: {'parent' if tree == parent else 'this'}")
        r = subprocess.run([sys.executable, "-c", code, wd], cwd=tree,
                           capture_output=True, text=True)
        sys.stdout.write(r.stdout)
        sys.stderr.write(r.stderr[-4000:])
        if r.returncode:
            return r.returncode
        wds.append(wd)
        walls = dict(re.findall(r"\[(main_path|mesh_path|hifi_path)\] "
                                r"task=all.*? wall ([0-9.]+)s", r.stdout))
        spans = [json.loads(x)["turn_spans"] for x in r.stdout.splitlines()
                 if x.startswith('{"turn_spans"')][-1]
        summary.append(f"[turns] turn {i} "
                       f"({'parent' if tree == parent else 'this'}): walls "
                       + ", ".join(f"{k} {v} s" for k, v in walls.items())
                       + "; " + ", ".join(f"{n} {k} calls {w:.4f} s"
                                          for n, (k, w) in spans.items()))
    n_files = 0
    for dp, _, fs in os.walk(wds[0]):
        for f in fs:
            rel = os.path.relpath(os.path.join(dp, f), wds[0])
            parts = rel.split(os.sep)     # path/wd[_mesh]/<stage>/.../file
            if (f == ".done" or len(parts) < 4
                    or parts[1] not in ("wd", "wd_mesh")
                    or not parts[2][:2].isdigit()):
                continue
            if not filecmp.cmp(os.path.join(wds[0], rel),
                               os.path.join(wds[1], rel), shallow=False):
                raise RuntimeError(f"{rel} differs between the parent and "
                                   "this checkout")
            n_files += 1
    log(f"[turns] {n_files} stage files of the main, mesh and HiFi paths "
        "byte-equal, parent against this checkout")
    for line in summary:
        log(line)
    return 0


def main(argv) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device available", file=sys.stderr)
        return 2
    if argv[:1] == ["--kernel"] and argv[1:2] in (["wave_fwd"],
                                                  ["wave_fast_fwd"]):
        return main_forward(argv[2:], argv[1])
    if argv[:2] == ["--kernel", "wave_fast_tb"]:
        return main_wave_fast_tb(argv[2:])
    if argv[:1] == ["--kernel"] and argv[1:2] in (["vote_corridor"],
                                                  ["chain_emit"]):
        return main_engine(argv[2:], argv[1])
    if argv[:2] == ["--kernel", "engine_anchor"]:
        return main_engine_anchor(argv[2:])
    if argv[:2] == ["--kernel", "sketch_minimizers"]:
        return main_sketch_minimizers(argv[2:])
    if argv[:2] == ["--kernel", "route_buckets"]:
        return main_route_buckets(argv[2:])
    if argv[:1] == ["--route-calls"]:
        return route_calls(argv[1])
    if argv[:1] == ["--route-turn"]:
        return route_turn(argv[1], argv[2])
    if argv[:1] == ["--route-turns"]:
        return main_route_turns(argv[1])
    if argv[:1] == ["--engine-anchor-turn"]:
        return engine_anchor_turn(argv[1])
    if argv[:1] == ["--turns"]:
        return main_turns(argv[1])
    if argv[:1] == ["--sketch-turn"]:
        return sketch_turn(argv[1])
    if argv[:1] == ["--sketch-turns"]:
        return main_sketch_turns(argv[1])
    if argv[:1] == ["--match-turn"]:
        return match_turn(*argv[1:3])
    if argv[:1] == ["--match-turns"]:
        return main_match_turns(argv[1])
    if argv[:1] == ["--mesh-memory-turn"]:
        return mesh_memory_turn(argv[1])
    if argv[:1] == ["--mesh-memory"]:
        return main_mesh_memory(argv[1])
    do_lat = "--latency" in argv
    srcs = [a for a in argv if a != "--latency"]
    import chip_smoke as c
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.ops import align as A
    c.phase_env()
    _build.build(native=False)
    _build.kernels()
    nvcc = _build.find_nvcc()
    tmp = tempfile.mkdtemp(prefix="chip_variants_")
    if do_lat:
        latency(nvcc, _build.NVCC_FLAGS, tmp)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs = build_copies(nvcc, _build.NVCC_FLAGS, tmp, srcs, "ndt_wave_tb",
                        [vp, vp, vp, vp, vp, ci, ci, ci, vp])
    d = torch.device("cuda")

    def run(lib, tb, lo, mn):
        B, nw, _ = tb.shape
        ops = torch.full((B, nw * A.PACK), A.OP_NONE, dtype=torch.uint8,
                         device=d)
        ok = torch.empty(B, dtype=torch.uint8, device=d)
        rc = lib.ndt_wave_tb(tb.data_ptr(), lo.data_ptr(), mn.data_ptr(),
                             ops.data_ptr(), ok.data_ptr(), B, nw, nw * A.PACK,
                             torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: error {rc}")
        return ops, ok.to(torch.bool)

    rng = np.random.default_rng(11)
    qs, ts = c.make_pairs(rng, 640, 11000, 12288)
    wi = c.wave_inputs(qs, ts, d)
    tb, lo, _ = A.wave_fwd(wi["qpad"], wi["rtpad"], wi["mn"], wi["n_words"])
    mn = wi["mn"]
    res = {}
    c.compare_wave_tb(res, "64 pairs", tb[:64], lo[:64], mn[:64])
    log(f"[variants] package wave_tb against wave_tb_plain at 64 pairs: "
        f"exact={res['wave_tb']['exact']}")
    lo_moved = c.shift_lo(lo, mn)
    want = {0: A.wave_tb(tb, lo, mn), 1: A.wave_tb(tb, lo_moved, mn)}
    sizes = (64, 640)
    for name, lib in libs.items():
        for nb in sizes:
            for k, l_ in ((0, lo), (1, lo_moved)):
                got = run(lib, tb[:nb], l_[:nb], mn[:nb])
                if not (torch.equal(got[0], want[k][0][:nb])
                        and torch.equal(got[1], want[k][1][:nb])):
                    raise RuntimeError(f"{name} differs from the package's "
                                       f"wave_tb at {nb} pairs")
    log("[variants] every copy equal to the package's wave_tb")
    times = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for nb in sizes:
                _, ms = c.timed(lambda: run(libs[name], tb[:nb], lo[:nb],
                                            mn[:nb]), 5)
                times.setdefault((name, nb), []).append(ms)
    steps = (want[0][0] != A.OP_NONE).sum(dim=1)
    mhz = c.sm_clock_mhz()
    for nb in sizes:
        longest = int(steps[:nb].max())
        for name in libs:
            t = times[(name, nb)]
            log(f"[variants] {name} {nb} pairs: "
                + " / ".join(f"{x:.3f}" for x in t) + f" ms; "
                f"{min(t) * 1e6 / longest * mhz / 1e3:.0f} cycles a step "
                f"(longest walk {longest} steps, {mhz:.0f} MHz)")
    for name, lib in libs.items():
        if not hasattr(lib, "ndt_dbg"):
            continue
        for nb in sizes:
            run(lib, tb[:nb], lo[:nb], mn[:nb])
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (nb * 6))()
            if lib.ndt_dbg(ctypes.cast(buf, ctypes.c_void_p), nb) != 0:
                raise RuntimeError("ndt_dbg failed")
            arr = np.frombuffer(buf, dtype=np.int64).reshape(nb, 6)
            tl, te, tw, ns, ne = (arr[:, k].astype(float) for k in range(5))
            log(f"[variants] {name} {nb} pairs, counters: "
                f"{np.mean((tl - te) / (ns + ne)):.1f} cycles a step in the "
                f"loop; {np.mean(te / ne):.1f} cycles a word change, of "
                f"which {np.mean(tw / ne):.1f} waiting for copies; "
                f"{np.mean(ns + ne):.0f} steps and {np.mean(ne):.0f} word "
                f"changes a pair")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
