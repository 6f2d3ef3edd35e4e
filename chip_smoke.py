#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (nextdenovo_tpu_torch).

Run with no arguments on a machine with one NVIDIA GPU, nvcc and g++:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

  env        card name and power limit, torch and CUDA versions
  build      the CUDA kernels (csrc/*.cu, nvcc, sm_90a) and the host C++
             library, every compiler process started together
  kernels    each of the seven hand-written kernels against its plain
             PyTorch version on the card, exact equality of every output,
             on degenerate cases, 64 random 1-3 kb pairs and pairs with
             |m-n| > 200 (tails of up to 1024 bases for the extender); the
             two Myers kernels, which share a pair among the lanes of a warp,
             also on batches of 1, 7, 33 and 641 pairs, one batch of text
             lengths 1..13900, walks that give up (EV_FAIL) and carries that
             cross several band words; wave_fwd and wave_tb, one warp a
             pair, also on batches of 1, 3, 5, 33 and 130 pairs; wave_tb
             also on one batch of m + n from 0 to 24.6k, and tb/lo from
             wave_fwd with lo moved by +-300 over a run of anti-diagonals in
             every other pair, so that walks leave the band mid-way (at
             least one pair must end with ok = 0); wave_fast_fwd and
             wave_fast_tb, one warp a pair each, on batches of 1, 3, 5, 33
             and 130 pairs, one batch of m + n from 0 to 24.6k and pairs
             with |m-n| > 200 whose re-centring reaches -8 and 8 and meets
             both clamps; wave_fast_tb also with base moved by +-300 over a
             run of words in every other pair (at least one pair must end
             with ok = 0), and on random decisions whose walks step out of
             the band inside a word
  engine     the minimizer engine's three kernels (engine_anchor,
             vote_corridor, chain_emit) against their plain versions on the
             card, exact equality of every output: engine_anchor on a
             synthetic index (hashes of more than max_occ entries, filter
             rows, self hits, the pair-once gate on and off, a read in three
             rows, max_occ 1, no minimizer), on indexes of hashes over
             [0, 2^32) (bucket edges of its directory, empty buckets, a
             bucket of 3000 entries, 20k filter rows, runs past max_occ and
             one ending at H, at max_occ 16 and 40, negative hashes and
             hashes of 2^32 and more; 100003 minimizers) and on one 16-row
             batch of the main path's stage 01 (the index of its 3720
             reads), each with its directory given and made by the wrapper;
             then the
             two vote kernels on those anchors at top_k 1 and 4; the vote
             kernels also on one anchor, groups of one anchor, tied bins,
             groups whose bins are all blanked after round 1, random sets,
             one group of 300k anchors and one bin of 100k, and at the vote
             tile's edge (groups of tile - 1, tile, tile + 1 and 2 x tile
             runs, one-anchor groups around one past the tile, runs over 32
             anchors on a 32's edges) at top_k 1, 4 and 8; both vote
             kernels on _vote_emit's one set of group starts and on their
             own; each set's whole _vote_emit on the card equal to the
             CPU's (records, n_out, overflow; one set's cap_out must
             truncate); chain_emit also on keys in the second sort's order
             that the vote would not make (engine_chain_sets);
             vote_corridor_kernel and engine_anchor_kernel with no stack
             frame in `nvcc -Xptxas -v`
  sketch     the minimizer sketch's two kernels (sketch_minimizers,
             hpc_compress) against their plain versions on the card, exact
             in every field, n and n_all: edge rows (length 0, shorter than
             w + k - 1, N codes, homopolymer runs, a tandem repeat, (AT)*
             palindromes, lengths past a tile) at k in {1, 15, 17, 31, 32,
             51, 127} x w in {1, 5, 17, 51}, at k = 16, 47, 48, 128 and 143
             and at w = 1101 and 2048 (past a whole tile); column slices of
             a wider buffer with a truncating cap, own gates, and hpc with
             int64 lengths; one 16-row query batch and one 32-row index
             batch of the main path's stage 01; the HiFi batch's 32 longest
             chunk rows at k = w = 51, raw and hpc; a mesh-sized launch of
             128 x 20000 positions through a 32768-column buffer (2560
             tiles); at most one host sync a sketch call
  overlaps   find_overlaps on fixed batches of reads gives identical
             records on the card (the engine kernels launched) and on the
             CPU: ONT reads at k = 17, w = 10; HiFi reads (one longer than
             CHUNK_LP) at k = 51, w = 51, the index's arrays identical too;
             then the HiFi reads homopolymer-compressed (hpc): one sketch
             batch's minimizers (every field), the hpc index's arrays and
             find_overlaps (uncompressed queries) against that index,
             identical card and CPU
  fast_path  band_align(R=1) on a few hundred ~2 kb pairs, the card against
             the CPU, with the launch counters set to 0 just before
  ext_path   input_type = corrected, task = assemble (stages 00, 04-06)
             through the CLI entry on ~1 % error reads of a 300 kb genome
             with 5 kb repeats: reads that share only a repeat copy keep
             unaligned tails on both sides, which stage 04 hands to the
             affine-gap extender (on the repeat-free genome below it gets
             none); launch counters set to 0 just before
  main_path  task = all (stages 00-06) through the package's CLI entry on a
             simulated genome at 30x, with the launch counters set to 0
             just before and read just after; checks the markers, the
             engine and sketch kernels launched in stages 01, 04 and 06
             (stage 01's index build split into its sketch and the rest),
             the
             share of corrected seeds, the identity of corrected reads,
             and the contigs against the simulated genome
  multihost_path
             the main path's reads and config in a fresh workdir through
             `python -m nextdenovo_tpu_torch launch run.cfg --hosts 2
             --submit local`: two host processes on the one card share the
             workdir (stages 01, 03, 04 and 06 split between them); checks
             that both finish, that each wrote its cns/map/pieces parts and
             launched myers_fwd in stage 03 (its trace.h<k>.jsonl), and that
             cns.fasta and nd.asm.fasta are byte for byte main_path's
  mesh_path  the main path's reads and config with use_mesh = 8 in a fresh
             workdir through the CLI entry (stages 01-04 and 06 on the mesh
             path, eight shards on the one card), launch counters at 0 and
             peak memory reset just before; checks the markers, that
             raw.ovl and sorted.ovl equal main_path's and bl.json does once
             parsed, a launch of myers_fwd in each of stages 03, 04 and 06,
             of sketch_minimizers in stage 01,
             and the main path's limits on the corrected reads and contigs;
             prints the stage walls, the launches by stage, the peak memory
             and how many corrected reads are byte-equal to main_path's
             (on a machine of several cards, on the first only)
  route      myers_streams, the routing kernels (route_count and
             route_scatter through mesh.bucketize, seed_route_count and
             seed_route_scatter through dist_sort.seed_route) and the mesh
             lookup's engine_anchor against their plain versions on the
             card, every output bit for bit: build_streams on empty queries
             and targets, m = n, m >> n, off at 16 and W - 16, B = 1, B =
             5120 and the main path's launch shape; bucketize on n = 1, 2,
             8, 512 and 4096, truncating caps, cap = 0, every row outside,
             destinations outside the mesh, N = 0, a launch of 1.3 M rows x
             4 fields and the mesh path's own calls of 4 and 5 fields
             (recorded during mesh_path) and its seed route's views as an
             8-field call; seed_route on the mesh path's records of one
             shard, on records with ids negative, past the reads and equal,
             with a truncating cap and at n = 1, 2 and 4096; the mesh path's
             lookup of one shard's received minimizers with the pair-once
             gate and without it.  One host sync a bucketize call and a
             seed_route call (counted; more fails the run), and the syncs of
             one myers_align sub-batch, counted.  Every path's run launched
             myers_streams as often as myers_fwd; mesh_path (and
             mesh_cards) the routing kernels and engine_anchor.  Then their
             times: myers_streams at the main path's launch shape (alone,
             beside the replaced ops on the pads and their device kernels,
             and the host's row fill against the one copy); bucketize on
             the mesh path's stage-01 sketch route and on its lookup's
             route back, seed_route on the sort's records of one shard:
             the count and scatter launches alone and together, the
             wrapper's call and its device operations, the plain version
             on the card, one stable torch.sort of the destinations, the
             grid and the bound; the mesh lookup by engine_anchor against
             the plain lookup; the recorded calls are then freed
  mesh_groups
             the shards in two groups on the one card (two host threads
             against one device) against one group, on the main path's
             data: stage 01's mesh overlap step, the mesh sort of its
             records and stage 03's first group of ~32.8k alignments, bit
             for bit; each phase ran on both groups; walls and launches
  mesh_cards the main path's reads with use_mesh = 8 through the CLI entry
             in a process that sees min(4, device count) cards, the shards
             spread over them, one host thread a card: raw.ovl and
             sorted.ovl equal main_path's, every stage file equal to
             mesh_path's, each card launched myers_fwd, vote_corridor and
             chain_emit, the main path's limits; prints stage walls,
             launches by stage, each card's name, peak memory (beside
             mesh_path's) and share of the index, the mesh and kernel
             spans by card.  On a machine of one card it prints that it
             did not run
  hifi_path  read_type = hifi, task = all through the CLI entry on 0.4 %
             error reads (30x, 15 kb mean) of a 1 Mb genome, with the launch
             counters at 0 and the peak memory reset just before; checks
             the markers, that stage 01 sketched at k = w = 51, a launch of
             myers_fwd, the identity of corrected reads against the truth
             they cover, the median share of its seed that a corrected
             read kept (at least 0.5), the longest contig (at least 0.3 x
             the genome), and the contigs' 31-mer identity and total; then
             build_index of the same reads at k = w = 51, raw and hpc, on
             the card: wall (ended by a synchronise), entries, peak memory,
             the hpc build's launches (hpc_compress and sketch_minimizers
             each at least once)
  timing     each kernel at its path's shape against its plain version
             (exact equality again), with the least time the card could
             take for the same work; the Myers kernels also at 640, 1280,
             2560 and 5120 pairs and at the main path's longest columns,
             every pair of a launch equal to the same pair in a launch of
             640; wave_fwd at 8, 64, 256 and 640 pairs of 11000-12288
             columns (ms, cycles an anti-diagonal of the longest pair), every
             pair equal to the same pair in the launch of 640; wave_tb at the
             same sizes (ms, steps of the longest walk, ns and cycles a step),
             every pair equal to the same pair in launches of 64;
             wave_fast_fwd at 8, 64, 256 and 640 pairs of 11000-12288
             columns (ms, cycles an anti-diagonal of the longest pair), every
             pair equal to the same pair in launches of 64, and wave_fast_tb
             at the same sizes on tb/base from wave_fast_fwd; the engine
             kernels at the main path's batch, each alone (launches only)
             and as a whole wrapper call, engine_anchor also warm and with
             the L2 flushed before each launch (a 256 MB write), beside its
             directory's build and the plain version's two
             torch.searchsorted calls (a yardstick for the lookup); the
             batch's group sizes; one _match_block call split by CUDA events
             into its steps; one whole _match_block call with the kernels
             against the same call with the plain versions on the card, the
             host syncs of one call (counted) and a host sync's cost; the
             sketch kernel at the main path's query and index batches and
             the HiFi batch, alone (its memset and launch) and as a whole
             wrapper call, beside the plain versions' select, emit and
             whole call on the card, the plain call's device kernels
             (torch.profiler) and torch.nonzero; its registers, spills and
             SASS instructions; and hpc_compress on the HiFi batch's hpc
             rows

The kernel and timing phases run under a watchdog: a kernel that hangs
ends the run with exit code 3 instead of blocking it.

Without a CUDA device it exits non-zero and prints no result.  The last
line of stdout is {"ok": true, "device": {...}}; the line before the card
line holds {"kernels": [...]}: the kernels' launches are read from the
task = all run, the extender's from the task = assemble run, the R = 1
pair's from the band_align(R=1) run, hpc_compress's from the HiFi reads'
hpc index build, the routing kernels' from the use_mesh = 8 run;
`library_ms` is one PyTorch call's time on the same inputs where one
computes the kernel's function, else null (none computes the sketch: its
`nonzero_ms` is torch.nonzero of the selected flags, the compaction's
indices alone; none the routing: its `sort_ms` is one stable torch.sort of
the destinations, a yardstick); `launches_hifi` holds each kernel's
launches on the HiFi run, `launches_multihost` its launches in each host
process of the two-host run, `launches_mesh` its launches on the
use_mesh = 8 run, `launches_mesh_cards` on the use_mesh = 8 run over the
cards (null where the machine has one card).
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

# the largest of 1 Mb / 300 kb / 100 kb whose whole run fits half of the
# script's time limit
GENOME_SIZE = 1_000_000
COVERAGE = 30
MEAN_LEN = 8000
ERROR_RATE = 0.10
# the HiFi path: the coverage and error of SCALE_HIFI_5M_r5.json at the
# main path's genome size
HIFI_GENOME_SIZE = 1_000_000
HIFI_COVERAGE = 30
HIFI_MEAN_LEN = 15000
HIFI_ERROR_RATE = 0.004

# published peaks of one H100 SXM used for the bounds
MEM_BYTES_PER_S = 3.35e12
# int32 ALU operations: 64 lanes per SM against 128 fp32 lanes whose FMA
# rate is quoted as 67 TFLOP/s (2 flops per FMA) -> a quarter of it
INT32_OPS_PER_S = 67e12 / 4

KERNEL_INFO = {
    "myers_fwd": dict(source="nextdenovo_tpu_torch/csrc/myers.cu",
                      replaces="nextdenovo_tpu/ops/myers.py:124"),
    "myers_tb": dict(source="nextdenovo_tpu_torch/csrc/myers.cu",
                     replaces="nextdenovo_tpu/ops/myers.py:250"),
    "wave_fwd": dict(source="nextdenovo_tpu_torch/csrc/wave.cu",
                     replaces="nextdenovo_tpu/ops/align.py:90"),
    "wave_tb": dict(source="nextdenovo_tpu_torch/csrc/wave.cu",
                    replaces="nextdenovo_tpu/ops/align.py:567"),
    "ext_fwd": dict(source="nextdenovo_tpu_torch/csrc/extend.cu",
                    replaces="nextdenovo_tpu/ops/extend.py:77"),
    "wave_fast_fwd": dict(source="nextdenovo_tpu_torch/csrc/wave_fast.cu",
                          replaces="nextdenovo_tpu/ops/align.py:286"),
    "wave_fast_tb": dict(source="nextdenovo_tpu_torch/csrc/wave_fast.cu",
                         replaces="nextdenovo_tpu/ops/align.py:765"),
    "engine_anchor": dict(source="nextdenovo_tpu_torch/csrc/engine.cu",
                          replaces="nextdenovo_tpu/overlap/engine.py:299"),
    "vote_corridor": dict(source="nextdenovo_tpu_torch/csrc/engine.cu",
                          replaces="nextdenovo_tpu/overlap/engine.py:372"),
    "chain_emit": dict(source="nextdenovo_tpu_torch/csrc/engine.cu",
                       replaces="nextdenovo_tpu/overlap/engine.py:372"),
    # sketch (:141) and sketch_wide (:302) share it
    "sketch_minimizers": dict(source="nextdenovo_tpu_torch/csrc/sketch.cu",
                              replaces="nextdenovo_tpu/ops/sketch.py:141"),
    "hpc_compress": dict(source="nextdenovo_tpu_torch/csrc/sketch.cu",
                         replaces="nextdenovo_tpu/ops/sketch.py:281"),
    "myers_streams": dict(source="nextdenovo_tpu_torch/csrc/streams.cu",
                          replaces="nextdenovo_tpu/ops/myers.py:445"),
    # mesh.bucketize: its count and its scatter
    "route_count": dict(source="nextdenovo_tpu_torch/csrc/route.cu",
                        replaces="nextdenovo_tpu/parallel/dist_overlap.py:37"),
    "route_scatter": dict(source="nextdenovo_tpu_torch/csrc/route.cu",
                          replaces="nextdenovo_tpu/parallel/dist_overlap.py:37"),
    # dist_sort.seed_route: the same kernels with the raw records as rows
    "seed_route_count": dict(source="nextdenovo_tpu_torch/csrc/route.cu",
                             replaces="nextdenovo_tpu/parallel/dist_sort.py:34"),
    "seed_route_scatter": dict(
        source="nextdenovo_tpu_torch/csrc/route.cu",
        replaces="nextdenovo_tpu/parallel/dist_sort.py:34"),
}
# the path a kernel's launches are read from, where it is not the task = all
# run
FAST_PATH, EXT_PATH = "band_align(R=1)", "input_type = corrected, task = assemble"
HPC_PATH = "build_index(hpc=True) of the HiFi path's reads"
MESH_PATH = "task = all, use_mesh = 8"
KERNEL_PATH = {"wave_fast_fwd": FAST_PATH, "wave_fast_tb": FAST_PATH,
               "ext_fwd": EXT_PATH, "hpc_compress": HPC_PATH,
               "route_count": MESH_PATH, "route_scatter": MESH_PATH,
               "seed_route_count": MESH_PATH,
               "seed_route_scatter": MESH_PATH}
FAST_PATH_KERNELS = ("wave_fast_fwd", "wave_fast_tb")


def log(*a):
    print(*a, flush=True)


class watchdog:
    """Ends the run with exit code 3 when the block takes longer than
    `seconds`.  A kernel that hangs (a collective some lanes never reach)
    blocks the host in its next synchronise for ever; the timer thread runs
    meanwhile, because a synchronise does not hold the interpreter lock."""

    def __init__(self, seconds, what):
        self.what, self.seconds = what, seconds
        self.timer = threading.Timer(seconds, self._fire)
        self.timer.daemon = True

    def _fire(self):
        print(f"chip_smoke: {self.what} did not finish within "
              f"{self.seconds} s (a hung kernel?)", file=sys.stderr, flush=True)
        os._exit(3)

    def __enter__(self):
        self.timer.start()
        return self

    def __exit__(self, *exc):
        self.timer.cancel()


# --------------------------------------------------------------------------
# inputs


def make_pairs(rng, n, lo, hi, e0=0.10, e1=0.15):
    import numpy as np
    from nextdenovo_tpu_torch.io.simulate import mutate_read
    qs, ts = [], []
    for _ in range(n):
        L = int(rng.integers(lo, hi + 1))
        t = rng.integers(0, 4, L).astype(np.uint8)
        q = mutate_read(t, float(rng.uniform(e0, e1)), rng)
        qs.append(q.astype(np.int8))
        ts.append(t.astype(np.int8))
    return qs, ts


def degenerate_pairs(rng):
    """Empty, length 1, identical, swapped (m < n), band overflow."""
    import numpy as np
    r = lambda n: rng.integers(0, 4, n).astype(np.int8)
    t400, t2000 = r(400), r(2000)
    ins = np.concatenate([t2000[:1000], r(600), t2000[1000:]])
    qs = [np.zeros(0, np.int8), r(10), np.zeros(0, np.int8), np.zeros(1, np.int8),
          np.ones(1, np.int8), r(500), t400[50:300].copy(), r(900), ins, t2000]
    ts = [r(10), np.zeros(0, np.int8), np.zeros(0, np.int8), np.zeros(1, np.int8),
          np.zeros(1, np.int8), None, t400, r(300), t2000, ins]
    ts[5] = qs[5].copy()
    return qs, ts


def skewed_pairs(rng, n=16):
    """|m - n| > 200: outside the Myers band, the wavefront tier's case."""
    import numpy as np
    qs, ts = [], []
    for i in range(n):
        L = int(rng.integers(1000, 3000))
        t = rng.integers(0, 4, L).astype(np.int8)
        cut = int(rng.integers(220, 600))
        a = int(rng.integers(0, cut))
        q = t[a : L - (cut - a)].copy()
        if i % 2:
            q, t = t, q
        qs.append(q)
        ts.append(t)
    return qs, ts


def mixed_length_pairs(rng, n=48, hi=13900):
    """One batch whose text lengths run from 1 to `hi` columns."""
    import numpy as np
    from nextdenovo_tpu_torch.io.simulate import mutate_read
    lens = np.unique(np.geomspace(1, hi, n).astype(int))
    qs, ts = [], []
    for L in lens:
        t = rng.integers(0, 4, int(L)).astype(np.uint8)
        q = mutate_read(t, 0.10, rng) if L > 8 else t.copy()
        if len(q) < len(t):              # keep the text the shorter side
            q = np.concatenate([q, rng.integers(0, 4, len(t) - len(q))])
        qs.append(q.astype(np.int8))
        ts.append(t.astype(np.int8))
    return qs, ts


def band_exit_pairs(rng, n=24):
    """Pairs the Myers tier starts on and gives up half way (event EV_FAIL):
    one side carries a block of 70-120 extra bases of a letter the other
    side does not have, so one column holds the whole run of up-moves, and a
    column's run may be 63 cells at most."""
    import numpy as np
    from nextdenovo_tpu_torch.io.simulate import mutate_read
    qs, ts = [], []
    for i in range(n):
        L = int(rng.integers(1200, 2500))
        t = rng.integers(0, 3, L).astype(np.uint8)
        q = np.minimum(mutate_read(t, 0.02, rng), 2)
        a = int(rng.integers(200, len(q) - 200))
        q = np.concatenate([q[:a], np.full(int(rng.integers(70, 121)), 3),
                            q[a:]]).astype(np.int8)
        t = t.astype(np.int8)
        if i % 2:
            q, t = t, q
        qs.append(q)
        ts.append(t)
    return qs, ts


# the seed of fast_clamp_pairs wherever it runs, so that the CPU tests can
# show what its pairs exercise on the card
CLAMP_SEED = 91


def fast_clamp_pairs(rng, n=8):
    """|m - n| > 200 both ways, at most 2 kb a side and 5 % of differences:
    one side lacks 220-500 bases, split between its two ends, so the R = 1
    band has to move ahead of its cadence at both ends; wave_fast_fwd's
    delta reaches -8 and 8, and its j-side and m-side clamps decide words."""
    import numpy as np
    from nextdenovo_tpu_torch.io.simulate import mutate_read
    qs, ts = [], []
    for i in range(n):
        L = int(rng.integers(800, 2001))
        t = rng.integers(0, 4, L).astype(np.uint8)
        cut = int(rng.integers(220, 501))
        a = int(rng.integers(0, cut + 1))
        q = mutate_read(t[a:L - (cut - a)], 0.05, rng).astype(np.int8)
        t = t.astype(np.int8)
        if i % 2:
            q, t = t, q
        qs.append(q)
        ts.append(t)
    return qs, ts


def shift_lo(lo, mn, by=300):
    """lo with a run of anti-diagonals moved by +by (pairs 1, 5, 9, ...) or
    -by (pairs 3, 7, ...) in every other pair: their walks leave the band
    mid-way, whatever the decisions say."""
    out = lo.clone()
    end = (mn[:, 0] + mn[:, 1]).tolist()
    for b in range(1, lo.shape[0], 2):
        a0 = end[b] // 3
        a1 = a0 + max(16, end[b] // 4)
        out[b, a0:a1] += by if b % 4 == 1 else -by
    return out


def shift_base(base, mn, by=300):
    """base with a run of words moved by +by (pairs 1, 5, 9, ...) or -by
    (pairs 3, 7, ...) in every other pair: at the run's two ends the R = 1
    walk's lane correction (clamped to +-127) throws it out of the band
    mid-way, whatever the decisions say."""
    out = base.clone()
    end = (mn[:, 0] + mn[:, 1]).tolist()
    for b in range(1, base.shape[0], 2):
        w0 = end[b] // 3 // 16
        w1 = w0 + max(1, end[b] // 4 // 16)
        out[b, w0:w1] += by if b % 4 == 1 else -by
    return out


def random_fast_tb(rng, B=64, n_words=64):
    """(tb, base, mn) of the R = 1 tier with decisions drawn at random
    (DIAG 40 %, UP and LEFT 29 % each, NONE 2 %), bases rising by 0-16 a
    word and walks that start near the band's edges as often as inside it:
    walks step out of the band inside a word, stop at NONE, and cross words
    with every correction from -8 to 8."""
    import numpy as np
    import torch
    u = rng.random((B, n_words, 128, 16))
    ops = ((u >= 0.40).astype(np.uint64) + (u >= 0.69) + (u >= 0.98))
    tb = (ops << (2 * np.arange(16, dtype=np.uint64))).sum(axis=-1)
    tb = tb.astype(np.uint32).view(np.int32)
    base = np.cumsum(rng.integers(0, 17, (B, n_words)), axis=1)
    end = rng.integers(0, n_words * 16, B)
    edge = rng.choice([0, 1, 2, 125, 126, 127], B)
    lane0 = np.where(rng.random(B) < 0.5, edge, rng.integers(0, 128, B))
    m = lane0 + base[np.arange(B), end // 16] + (end % 16 + 1) // 2
    mn = np.stack([m, end - m], axis=1).astype(np.int32)
    return (torch.from_numpy(tb), torch.from_numpy(base.astype(np.int32)),
            torch.from_numpy(mn))


def carry_pairs(rng, n=16):
    """Words of all ones under the multiword add: a first text character
    that matches the query once, at the band's centre, sends a carry up
    through every word above it in column 1, and long exact-match and
    one-letter runs after an indel keep whole words of VP set."""
    import numpy as np
    qs, ts = [], []
    for i in range(n):
        run = int(rng.integers(100, 600))
        body = rng.integers(0, 4, int(rng.integers(50, 400))).astype(np.int8)
        c = int(rng.integers(1, 4))
        t = np.concatenate([np.zeros(1, np.int8), np.full(run, c, np.int8),
                            body, np.full(run, (c % 3) + 1, np.int8), body])
        cut = int(rng.integers(1, 40))
        q = t.copy() if i % 4 == 0 else np.concatenate(
            [t[: run // 2], t[run // 2 + cut:], rng.integers(0, 4, cut)])
        qs.append(q.astype(np.int8))
        ts.append(t)
    return qs, ts


def ext_tail_pairs(rng, n, lo=33, hi=1024, full=0.5, err=0.02):
    """Pairs of read tails as the overlap end-extension hands them to the
    extender: equal lengths of lo..hi bases (a share `full` of them exactly
    hi), a few per cent of differences, every fourth pair diverging half
    way (the best endpoint then lies before (m, n))."""
    import numpy as np
    from nextdenovo_tpu_torch.io.simulate import mutate_read
    qs, ts = [], []
    for i in range(n):
        L = hi if rng.random() < full else int(rng.integers(lo, hi + 1))
        t = rng.integers(0, 4, L).astype(np.uint8)
        q = mutate_read(t, err, rng)[:L]
        if i % 4 == 2:
            q = np.concatenate([q[: len(q) // 2],
                                rng.integers(0, 4, L - len(q) // 2)])
        qs.append(q.astype(np.int8))
        ts.append(t.astype(np.int8))
    return qs, ts


def ext_skewed_pairs(rng, n=16):
    """|m - n| > 200: (m, n) lies outside the extender's fixed band."""
    import numpy as np
    qs, ts = [], []
    for i in range(n):
        L = int(rng.integers(500, 1025))
        t = rng.integers(0, 4, L).astype(np.int8)
        q = t[: L - int(rng.integers(220, 400))].copy()
        if i % 2:
            q, t = t, q
        qs.append(q)
        ts.append(t)
    return qs, ts


def ext_degenerate_pairs(rng):
    """m = 1, n = 1, identical, off-band, empty query, two-letter ties."""
    import numpy as np
    r = lambda n, k=4: rng.integers(0, k, n).astype(np.int8)
    t200, t600 = r(200), r(600)
    qs = [r(1), r(50), r(1), t200.copy(), t600[:100].copy(), t600,
          np.zeros(0, np.int8)]
    ts = [r(50), r(1), r(1), t200, t600, t600[:100].copy(), r(20)]
    for _ in range(24):
        qs.append(r(int(rng.integers(4, 40)), 2))
        ts.append(r(int(rng.integers(4, 40)), 2))
    return qs, ts


# --------------------------------------------------------------------------
# kernel <-> plain comparison


def _tensors_equal(a, b):
    import torch
    if a.dtype == torch.bool:
        a, b = a.to(torch.int64), b.to(torch.int64)
    if a.shape != b.shape:
        return False, float("inf")
    if a.numel() == 0:
        return True, 0.0
    d = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
    return d == 0, float(d)


def myers_inputs(qs, ts, dev, nw=8):
    """The tensors myers_align hands its two kernels for these pairs."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch.ops import myers as M
    W = 32 * nw
    sw = [(t, q) if len(q) < len(t) else (q, t) for q, t in zip(qs, ts)]
    m = np.array([len(a) for a, _ in sw], np.int32)
    n = np.array([len(b) for _, b in sw], np.int32)
    off = np.clip((W - (m - n)) // 2, 16, W - 16).astype(np.int32)
    n_pad = max(int(n.max()), 1)
    qpad = np.full((len(sw), int(m.max()) + W + 2), 4, np.int8)
    tpad = np.full((len(sw), n_pad), 4, np.int8)
    for b, (a, c) in enumerate(sw):
        qpad[b, : len(a)] = a
        tpad[b, : len(c)] = c
    to = lambda x: torch.from_numpy(x).to(dev)
    off_d = to(off)
    qtop, tch, win0 = M._build_streams(to(qpad), to(tpad), off_d, nw=nw)
    return dict(win0=win0, qtop=qtop, tch=tch, n=to(n), m=to(m), off=off_d,
                m_np=m, n_np=n)


def wave_inputs(qs, ts, dev):
    """The tensors _band_align_R hands its two kernels for these pairs."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch.ops import align as A
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    n_words = (int((m + n).max()) + 1 + A.PACK - 1) // A.PACK
    qpad = A.pad_for_align(qs, int(m.max()), A.BAND_W)
    rtpad = A.pad_for_align([np.asarray(t)[::-1] for t in ts], int(n.max()),
                            A.BAND_W)
    to = lambda x: torch.from_numpy(x).to(dev)
    return dict(qpad=to(qpad), rtpad=to(rtpad),
                mn=to(np.stack([m, n], axis=1)), n_words=n_words,
                m_np=m, n_np=n)


def timed(fn, reps, warm=True):
    """(result of the last call, ms per call) by CUDA events, after a warm
    call unless warm=False.  A call's result is dropped before the next
    call, so that its buffers are reused and no allocation by the driver
    falls between the events."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = None
    for _ in range(reps):
        out = None
        out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e) / reps


def _record(res, tag, name, outs_k, outs_p, extra=None):
    """Hold a kernel's outputs against its plain version's, exactly."""
    exact, err = True, 0.0
    for a, b in zip(outs_k, outs_p):
        ok, d = _tensors_equal(a, b)
        exact = exact and ok
        err = max(err, d)
    res[name] = dict(exact=exact, max_abs_err=err, **(extra or {}))
    if not exact:
        raise RuntimeError(f"kernel {name} disagrees with its plain "
                           f"version on '{tag}' (max abs err {err})")


def _run(fn_k, fn_p, reps):
    """(kernel outputs, plain outputs, times when reps > 0)."""
    import torch
    if reps:
        ok_, ms = timed(fn_k, reps)
        op_, pms = timed(fn_p, 1, warm=False)
        return ok_, op_, dict(ms=ms, plain_ms=pms)
    ok_ = fn_k()
    torch.cuda.synchronize()
    return ok_, fn_p(), {}


def ext_inputs(qs, ts, dev):
    """The tensors affine_extend_fwd hands its kernel for these pairs."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch.ops import extend as E
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    to = lambda x: torch.from_numpy(x).to(dev)
    return dict(qbuf=to(E.pad_for_extend(qs, int(m.max()))),
                tbuf=to(E.pad_for_extend(ts, int(n.max()))),
                mn=to(np.stack([m, n], axis=1)), m_np=m, n_np=n)


def compare_ext_kernel(qs, ts, dev, tag, reps=0):
    """ext_fwd against ext_fwd_plain on these pairs' tensors."""
    from nextdenovo_tpu_torch.ops import extend as E
    res = {}
    ei = ext_inputs(qs, ts, dev)
    B = len(qs)
    k, p, t = _run(lambda: E.ext_fwd(ei["qbuf"], ei["tbuf"], ei["mn"]),
                   lambda: E.ext_fwd_plain(ei["qbuf"], ei["tbuf"], ei["mn"]),
                   reps)
    diags = int((ei["m_np"] + ei["n_np"] + 1).sum())
    byt = int((ei["m_np"] + ei["n_np"]).sum()) + B * (8 + 3 * E.LANES * 4)
    ops = diags * E.LANES * 30
    _record(res, tag, "ext_fwd", (k,), (p,), dict(
        t, shape=f"B={B} mean m+n={diags / max(1, B) - 1:.0f} "
                 f"max m+n={int((ei['m_np'] + ei['n_np']).max())}",
        **_bound(byt, ops)))
    return res


def fast_inputs(qs, ts, dev):
    """The tensors _band_align_R(R=1) hands its two kernels."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch.ops import align as A
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    n_words = (int((m + n).max()) + 1 + A.PACK - 1) // A.PACK
    qpad = A.pad_for_align(qs, int(m.max()), A.FAST_W)
    rtpad = A.pad_for_align([np.asarray(t)[::-1] for t in ts], int(n.max()),
                            A.FAST_W, front=A.T_FRONT)
    to = lambda x: torch.from_numpy(x).to(dev)
    return dict(qpad=to(qpad), rtpad=to(rtpad),
                mn=to(np.stack([m, n], axis=1)), n_words=n_words,
                m_np=m, n_np=n)


def fwd_defined(fi, out):
    """A forward pass's (tb, lo or base, stats) with tb zeroed on the words
    wave_fwd_defined leaves undefined: what is held against the plain
    version (the other two are defined in full)."""
    import torch
    from nextdenovo_tpu_torch.ops import align as A
    defined = A.wave_fwd_defined(fi["mn"], fi["n_words"])[:, :, None]
    return torch.where(defined, out[0], 0), out[1], out[2]


def compare_fast_kernels(qs, ts, dev, tag, reps=0):
    """wave_fast_fwd / wave_fast_tb against their plain versions."""
    from nextdenovo_tpu_torch.ops import align as A
    res = {}
    fi = fast_inputs(qs, ts, dev)
    B, nwd = len(qs), fi["n_words"]
    diags = int((fi["m_np"] + fi["n_np"] + 1).sum())
    wk, wp, t = _run(
        lambda: A.wave_fast_fwd(fi["qpad"], fi["rtpad"], fi["mn"], nwd),
        lambda: A.wave_fast_fwd_plain(fi["qpad"], fi["rtpad"], fi["mn"], nwd),
        reps)
    byt = diags * (32 + 1) + int((fi["m_np"] + fi["n_np"]).sum()) * 4 + B * 16
    # the same least work of a band cell as wave_fwd's: 8 int32 operations
    ops = diags * A.FAST_W * 8
    _record(res, tag, "wave_fast_fwd", fwd_defined(fi, wk), wp, dict(
        t, shape=f"B={B} anti-diagonals={nwd * A.PACK}", **_bound(byt, ops)))
    compare_wave_fast_tb(res, tag, wk[0], wk[1], fi["mn"], reps)
    return res


def compare_wave_fast_tb(res, tag, tb, base, mn, reps=0):
    """wave_fast_tb against wave_fast_tb_plain on these tensors; returns the
    kernel's (ops, ok)."""
    from nextdenovo_tpu_torch.ops import align as A
    B, nwd = tb.shape[0], tb.shape[1]
    bk, bp, t = _run(lambda: A.wave_fast_tb(tb, base, mn),
                     lambda: A.wave_fast_tb_plain(tb, base, mn), reps)
    steps = int((bk[0] != A.OP_NONE).sum().item())     # walk steps taken
    byt = steps * 8 + B * nwd * A.PACK + B * 9
    ops = steps * 20
    _record(res, tag, "wave_fast_tb", bk, bp, dict(
        t, shape=f"B={B} anti-diagonals={nwd * A.PACK}", **_bound(byt, ops)))
    return bk


def compare_myers_kernels(qs, ts, dev, tag, reps=0, need_fail=False):
    """myers_fwd / myers_tb against their plain versions on the tensors
    these pairs give them: score, final, events, i_final and ok in full,
    the planes on the rows myers_fwd_defined marks."""
    import torch
    from nextdenovo_tpu_torch.ops import myers as M
    res = {}
    nw = 8
    mi = myers_inputs(qs, ts, dev, nw)
    B = len(qs)
    n_steps = mi["qtop"].shape[0]
    cols = int(mi["n_np"].sum())             # columns this data needs
    fk, fp, t = _run(
        lambda: M.myers_fwd(mi["win0"], mi["qtop"], mi["tch"], mi["n"],
                            mi["off"], nw=nw),
        lambda: M.myers_fwd_plain(mi["win0"], mi["qtop"], mi["tch"], mi["n"],
                                  mi["off"], nw=nw), reps)
    defined = M.myers_fwd_defined(mi["n"], n_steps)[:, None, None, :]
    byt = cols * (2 * nw * 4 + 8) + B * (4 * nw * 4 + 8 + 4 + 2 * nw * 4)
    ops = cols * nw * 30
    _record(res, tag, "myers_fwd",
            (fk[0], torch.where(defined, fk[1], 0), fk[2]),
            (fp[0], torch.where(defined, fp[1], 0), fp[2]), dict(
        t, shape=f"B={B} columns={n_steps} nw={nw}", **_bound(byt, ops)))
    planes = fk[1]
    tk, tp, t = _run(
        lambda: M.myers_tb(planes, mi["m"], mi["n"], mi["off"], nw=nw),
        lambda: M.myers_tb_plain(planes, mi["m"], mi["n"], mi["off"], nw=nw),
        reps)
    byt = cols * 2 * nw * 4 + n_steps * B + B * 17
    ops = cols * nw * 12
    _record(res, tag, "myers_tb", tk, tp, dict(
        t, shape=f"B={B} columns={n_steps} nw={nw}", **_bound(byt, ops)))
    if need_fail and not bool((tk[0] == M.EV_FAIL).any()):
        raise RuntimeError(f"'{tag}': no walk left the band (no EV_FAIL)")
    return res


def compare_kernels(qs, ts, dev, tag, reps=0):
    """Run the Myers and wide-band wavefront kernels and their plain
    versions on the tensors these pairs give them.  Returns {kernel:
    dict(exact, max_abs_err[, ms, plain_ms, bound...])}.  reps > 0 also
    times them."""
    from nextdenovo_tpu_torch.ops import align as A
    res = compare_myers_kernels(qs, ts, dev, tag, reps)
    B = len(qs)
    record = lambda *a: _record(res, tag, *a)
    run = lambda fn_k, fn_p: _run(fn_k, fn_p, reps)

    wi = wave_inputs(qs, ts, dev)
    nwd = wi["n_words"]
    diags = int((wi["m_np"] + wi["n_np"] + 1).sum())   # anti-diagonals needed
    wk, wp, t = run(
        lambda: A.wave_fwd(wi["qpad"], wi["rtpad"], wi["mn"], nwd),
        lambda: A.wave_fwd_plain(wi["qpad"], wi["rtpad"], wi["mn"], nwd))
    defined = A.wave_fwd_defined(wi["mn"], nwd)[:, :, None]
    tb_k = wk[0] * defined
    byt = diags * (64 + 4) + int((wi["m_np"] + wi["n_np"]).sum()) * 4 + B * 16
    # the least int32 work of a band cell: compare its two codes, add the
    # result to diag, min(up, left), add the gap cost, min of the two, two
    # compares that pick the decision (DIAG if diag + sub is the least, UP
    # if up <= left) and one insert of its two bits: 8 operations
    ops = diags * A.BAND_W * 8
    record("wave_fwd", (tb_k, wk[1], wk[2]), wp, dict(
        t, shape=f"B={B} anti-diagonals={nwd * A.PACK}", **_bound(byt, ops)))
    compare_wave_tb(res, tag, wk[0], wk[1], wi["mn"], reps)
    return res


def compare_wave_tb(res, tag, tb, lo, mn, reps=0):
    """wave_tb against wave_tb_plain on these tensors; returns the kernel's
    (ops, ok)."""
    from nextdenovo_tpu_torch.ops import align as A
    B, nwd = tb.shape[0], tb.shape[1]
    bk, bp, t = _run(lambda: A.wave_tb(tb, lo, mn),
                     lambda: A.wave_tb_plain(tb, lo, mn), reps)
    steps = int((bk[0] != A.OP_NONE).sum().item())     # walk steps taken
    byt = steps * 8 + B * nwd * A.PACK + B * 9
    ops = steps * 20
    _record(res, tag, "wave_tb", bk, bp, dict(
        t, shape=f"B={B} anti-diagonals={nwd * A.PACK}", **_bound(byt, ops)))
    return bk


def _bound(byt, ops):
    tb = byt / MEM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations")


def compare_results(qs, ts, dev, tag):
    """The wrappers' end results {dist, reached, ok, ops}: card vs the
    plain versions on the CPU, both tiers and the two-tier path."""
    import numpy as np
    from nextdenovo_tpu_torch.ops.align import band_align
    from nextdenovo_tpu_torch.ops.myers import myers_align
    for name, fn in (("myers_align", lambda d: myers_align(qs, ts, device=d)),
                     ("band_align R=2", lambda d: band_align(qs, ts, R=2, device=d)),
                     ("band_align R=1", lambda d: band_align(qs, ts, R=1, device=d)),
                     ("band_align", lambda d: band_align(qs, ts, device=d))):
        a, b = fn(dev), fn("cpu")
        for i, (x, y) in enumerate(zip(a, b)):
            if not (x["dist"] == y["dist"] and x["ok"] == y["ok"]
                    and x["reached"] == y["reached"]
                    and np.array_equal(x["ops"], y["ops"])):
                raise RuntimeError(f"{name} differs between the card and the "
                                   f"plain version on '{tag}' pair {i}")
        log(f"  {tag}: {name}: {len(a)} pairs equal "
            f"({sum(r['ok'] for r in a)} ok)")


def compare_extend_results(qs, ts, dev, tag):
    """affine_extend's end results: card vs the plain version on the CPU."""
    from nextdenovo_tpu_torch.ops.extend import affine_extend
    a, b = affine_extend(qs, ts, device=dev), affine_extend(qs, ts, device="cpu")
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            raise RuntimeError(f"affine_extend differs between the card and "
                               f"the plain version on '{tag}' pair {i}: "
                               f"{x} != {y}")
    log(f"  {tag}: affine_extend: {len(a)} pairs equal "
        f"({sum(r['reached'] for r in a)} reached (m, n))")


# --------------------------------------------------------------------------
# the engine's kernels (csrc/engine.cu)

ENGINE_KERNELS = ("engine_anchor", "vote_corridor", "chain_emit")
# the main path's stage 01 (pipeline/run.py): k, w of read_type = ont, the
# index's max_occ, the queries' max_occ, min_cnt, min_span, top_k; its seed
# cutoff on the 1 Mb / 30x reads (PERF.md section 4)
STAGE01 = dict(k=15, w=5, index_max_occ=64, max_occ=16, min_cnt=4,
               min_span=500, top_k=4)
SEED_CUTOFF = 6027


def anchor_set(rng, n_q, n_t, per, spurious=0.0, spread=300, qlen=20000):
    """Anchors (qr, t_rid, t_pos, rel, qpos), int64 numpy: for each of n_q
    queries and n_t targets one true diagonal on a random strand with `per`
    anchors along it (+-spread of noise), and `spurious` x as many anchors
    at random; in a random order."""
    import numpy as np
    n = n_q * n_t * per
    qr = np.repeat(np.arange(n_q), n_t * per)
    t_rid = np.tile(np.repeat(np.arange(n_q, n_q + n_t), per), n_q)
    rel = np.repeat(rng.integers(0, 2, n_q * n_t), per)
    off = np.repeat(rng.integers(-qlen, qlen, n_q * n_t), per)
    qpos = rng.integers(0, qlen, n)
    t_pos = np.abs(np.where(rel == 0, qpos - off, off - qpos)
                   + rng.integers(-spread, spread + 1, n))
    m = int(n * spurious)
    cols = [np.concatenate([a, b]) for a, b in zip(
        (qr, t_rid, t_pos, rel, qpos),
        (rng.integers(0, n_q, m), rng.integers(n_q, n_q + n_t, m),
         rng.integers(0, qlen, m), rng.integers(0, 2, m),
         rng.integers(0, qlen, m)))]
    p = rng.permutation(len(cols[0]))
    return tuple(c[p].astype(np.int64) for c in cols)


def engine_vote_sets(rng):
    """(tag, anchors, top_k, cap_out): the degenerate cases (one anchor,
    groups of one anchor, tied bin counts, every bin of a group blanked
    after round 1, top_k 1 and 4, a cap_out that truncates), random sets,
    and groups of many bins and of one huge bin."""
    import numpy as np
    one = tuple(np.array([v], np.int64) for v in (0, 1, 5000, 0, 5300))
    # groups of one anchor among groups of eight
    single = anchor_set(rng, 3, 40, 1)
    eight = anchor_set(rng, 3, 10, 8, spread=20)
    singles = tuple(np.concatenate([a, b]) for a, b in zip(single, eight))
    # two bins of 6 anchors each per group, far apart: the first one wins
    qpos = np.concatenate([np.arange(6) * 600, np.arange(6) * 600 + 100])
    t_pos = np.concatenate([qpos[:6] + 1000, qpos[6:] + 9000])
    ties = (np.zeros(12, np.int64), np.ones(12, np.int64), t_pos,
            np.zeros(12, np.int64), qpos)
    # every anchor of a group within 2 bins of the best: rounds 2-4 find -1
    qpos = np.arange(40, dtype=np.int64) * 250
    blank = (np.zeros(40, np.int64), np.full(40, 3, np.int64),
             qpos + 700 + (np.arange(40) % 3) * 256, np.zeros(40, np.int64),
             qpos)
    sets = [("one anchor", one, 4, 64), ("one-anchor groups", singles, 4, 64),
            ("tied bins", ties, 1, 64), ("tied bins", ties, 4, 64),
            ("all blanked", blank, 4, 64)]
    rnd = anchor_set(rng, 16, 200, 12, spurious=1.0)
    sets += [("random 16 x 200", rnd, 1, 4352), ("random 16 x 200", rnd, 4, 4352),
             ("random, cap_out truncates", rnd, 4, 100)]
    # one (query, target) group of 300k anchors over ~5000 bins, and one of
    # 100k anchors in a single bin
    n = 300_000
    qpos = rng.integers(0, 1_000_000, n)
    wide = (np.zeros(n, np.int64), np.ones(n, np.int64),
            rng.integers(0, 1_000_000, n), np.zeros(n, np.int64), qpos)
    qpos = rng.integers(0, 1_000_000, 100_000)
    deep = (np.zeros(len(qpos), np.int64), np.ones(len(qpos), np.int64),
            qpos + 40, np.zeros(len(qpos), np.int64), qpos)
    sets += [("one group of 300k anchors", wide, 4, 64),
             ("one bin of 100k anchors", deep, 4, 64)]
    return sets


def runs_group(rng, lens, q=0, t=1, spacing=(1, 2, 3, 5)):
    """Anchors of one forward (query q, target t) group whose diagonal bins
    are len(lens) runs of lens[j] anchors, bins spaced by a random choice of
    `spacing` (the +-2 blanking takes some neighbours); negative diagonals."""
    import numpy as np
    lens = np.asarray(lens)
    bins = np.cumsum(rng.choice(spacing, len(lens)))
    n = int(lens.sum())
    diag = (np.repeat(bins, lens) * 256 + rng.integers(0, 256, n)) - (1 << 20)
    # run j's anchors at query positions [2000 j, 2000 j + 2000)
    qpos = (np.repeat(np.arange(len(lens)), lens) * 2000
            + rng.integers(0, 2000, n))
    return tuple(np.asarray(c, np.int64) for c in (
        np.full(n, q), np.full(n, t), qpos - diag, np.zeros(n), qpos))


def engine_tile_sets(rng):
    """(tag, anchors, top_k, cap_out) at the vote kernel's tile edge
    (VOTE_TILE runs a group): groups of tile - 1, tile and tile + 1 runs,
    one of 2 x tile runs, many one-anchor groups around one group past the
    tile, runs of more than 32 anchors that start and end on a 32's edges;
    each at top_k 1, 4 and 8."""
    import numpy as np
    from nextdenovo_tpu_torch.overlap.engine import VOTE_TILE as T
    cat = lambda *sets: tuple(np.concatenate(c) for c in zip(*sets))
    # runs of 1-3 anchors, a few of 6-11 that win the rounds
    few = lambda n: np.where(rng.random(n) < 0.03, rng.integers(6, 12, n),
                             rng.integers(1, 4, n))
    sets = {
        f"groups of {T - 1}, {T}, {T + 1} runs": cat(*(
            runs_group(rng, few(n), t=t)
            for t, n in ((1, T - 1), (2, T), (3, T + 1)))),
        f"a group of {2 * T} runs": runs_group(rng, few(2 * T), t=4),
        "one-anchor groups around one past the tile": cat(
            *(runs_group(rng, [1], t=t) for t in range(5, 2000) if t != 900),
            runs_group(rng, few(T + 7), t=900)),
        "runs over 32 anchors on a 32's edges": cat(
            runs_group(rng, [33, 31, 32, 64, 1, 70, 2, 32, 40], t=7,
                       spacing=(3,)),
            runs_group(rng, [5, 27, 64, 33], q=1, t=7, spacing=(4,)))}
    return [(tag, a, top_k, 4352) for tag, a in sets.items()
            for top_k in (1, 4, 8)]


def engine_chain_sets(rng):
    """(tag, chain_emit's four inputs as numpy, top_k): keys in the second
    sort's order that the vote would not make, at top_k 1, 4 and 8: every
    corridor digit, anchors without a corridor (I32MAX) among them, targets
    that follow the queries closely across corridor boundaries (a link there
    would score), one group of 40k anchors (there the odd corridors only
    hold anchors without one, so that the even ones make records)."""
    import numpy as np
    out = []
    for top_k in (1, 4, 8):
        kc = top_k + 1
        for n, n_q, n_t in ((3000, 4, 30), (40_000, 1, 1)):
            kq2 = rng.integers(0, n_q, n)
            corr = rng.integers(0, kc, n)
            kt2 = rng.integers(0, n_t, n) * kc + corr
            none = (rng.random(n) < 0.1 if n_t > 1
                    else (corr % 2 == 1) & (rng.random(n) < 0.1))
            qp2 = np.where(none, 2**31 - 1, rng.integers(0, 20000, n) * (
                1 + n // 3000))
            tp2 = np.abs(qp2 % (2**31 - 1) + 1000 + rng.integers(-40, 41, n))
            order = np.lexsort((tp2, qp2, kt2, kq2))
            out.append((f"sorted keys, {n_q * n_t} groups of {n} anchors",
                        tuple(np.asarray(x[order], np.int64)
                              for x in (kq2, kt2, qp2, tp2)), top_k))
    return out


def engine_anchor_sets(rng):
    """(tag, args of engine_anchor as numpy, max_occ): a synthetic index
    with hashes of more than max_occ entries, filter rows (0xFFFFFFFF, rid
    -1) at the end, self hits, the pair-once gate on half the reads, a
    minimizer of hash 0xFFFFFFFF and absent hashes; two rows of one read
    (halo chunks); no minimizer at all; then the full-range sets."""
    import numpy as np
    n_reads, H = 50, 4000
    h = np.sort(rng.integers(0, 600, H - 40)).astype(np.int64) * 7
    h = np.concatenate([h, np.full(40, 0xFFFFFFFF, np.int64)])
    irid = np.concatenate([rng.integers(0, n_reads, H - 40),
                           np.full(40, -1)]).astype(np.int32)
    ipos = (rng.integers(0, 20000, H) | (rng.integers(0, 2, H) << 30)
            ).astype(np.int32)
    M, R = 3000, 6
    qh = rng.integers(0, 650, M).astype(np.int64) * 7 + (rng.random(M) < 0.1)
    qh[:5] = 0xFFFFFFFF
    rid_base = np.array([3, 3, 17, 20, 41, 3], np.int64)   # read 3 thrice
    pos_base = np.array([0, 15000, 0, 0, 0, 30000], np.int64)
    qmask = (rng.random(n_reads) < 0.5).astype(np.int8)
    args = (rng.integers(0, R, M).astype(np.int64),
            rng.integers(0, 16384, M).astype(np.int64), qh,
            rng.integers(0, 2, M).astype(np.int64), rid_base, pos_base,
            qmask, h, irid, ipos)
    empty = tuple(np.zeros(0, np.int64) for _ in range(4)) + args[4:]
    return [("synthetic index, max_occ 16", args, 16),
            ("synthetic index, max_occ 1", args, 1),
            ("synthetic index, no pair-once gate",
             args[:6] + (np.zeros(n_reads, np.int8),) + args[7:], 16),
            ("no minimizer", empty, 16)] + engine_anchor_full_range_sets(rng)


def engine_anchor_full_range_sets(rng, H=400_000, M=100_003):
    """(tag, args of engine_anchor as numpy, max_occ): indexes of about H
    hashes over [0, 2^32), queried by M minimizers (not a multiple of the
    kernel's block): hashes at the directory's bucket edges (i << s - 1,
    i << s, i << s + 1) queried at the edges +-2; entries in 50 buckets only
    (the others empty); one bucket of 3000 entries; 20k filter rows with
    entries just below 0xFFFFFFFF in the last bucket; runs of 20-40 entries
    and the largest hash's run ending at H, at max_occ 16 and 40 (past the
    kernel's mask of 32 occurrences); negative hashes and hashes of 2^32 and
    more, in the index and queried."""
    import numpy as np
    from nextdenovo_tpu_torch.overlap.engine import directory_bits
    FULL, n_reads = 0xFFFFFFFF, 5000
    uni = lambda n: rng.integers(0, 1 << 32, n)
    pick = lambda a, n: rng.choice(np.asarray(a, np.int64), n)
    s = 32 - directory_bits(H)

    def args(hashes, qh):
        h = np.sort(np.asarray(hashes, np.int64))
        irid = np.where(h == FULL, -1, rng.integers(0, n_reads, len(h)))
        ipos = rng.integers(0, 20000, len(h)) | (
            rng.integers(0, 2, len(h)) << 30)
        rows = 16
        return (rng.integers(0, rows, len(qh)).astype(np.int64),
                rng.integers(0, 16384, len(qh)).astype(np.int64),
                np.asarray(qh, np.int64),
                rng.integers(0, 2, len(qh)).astype(np.int64),
                rng.integers(0, n_reads, rows).astype(np.int64),
                rng.integers(0, 4, rows).astype(np.int64) * 15000,
                (rng.random(n_reads) < 0.5).astype(np.int8), h,
                irid.astype(np.int32), ipos.astype(np.int32))

    ed = rng.choice(np.arange(1, 1 << (32 - s)), 5000, replace=False)
    edge = ((ed[:, None] << s) + np.array([-1, 0, 1])).ravel()
    edge = np.repeat(edge, rng.integers(1, 4, edge.size))
    near = ((np.concatenate([ed, rng.integers(1, 1 << (32 - s), 2000)])
             [:, None] << s) + np.arange(-2, 3)).ravel()
    few = ((rng.choice(1 << (32 - s), 50, replace=False)[:, None] << s)
           + rng.integers(0, 1 << s, (50, H // 50))).ravel()
    big = (77 << s) + np.repeat(rng.choice(1 << s, 2000, replace=False),
                                rng.integers(1, 3, 2000))[:3000]
    top = FULL - rng.integers(1, 400, 3000)
    runs = np.repeat(uni(H // 30), rng.integers(20, 41, H // 30))
    last = np.full(25, runs.max() + 3)
    odd = np.array([-(1 << 40), -7, -1, 1 << 32, (1 << 32) + 5, 1 << 45],
                   np.int64)
    odd_h = np.concatenate([np.repeat(odd, 3), uni(H - 20_000),
                            np.full(2000, FULL)])
    runs_args = args(np.concatenate([runs, last]), np.concatenate(
        [pick(runs, 20_000), last[:1].repeat(2000), uni(M - 22_000)]))
    return [
        ("full range: bucket edges",
         args(np.concatenate([edge, uni(H - len(edge))]), pick(near, M)), 16),
        ("full range: 50 buckets of entries, the others empty",
         args(few, np.concatenate([uni(M // 2), pick(few, M - M // 2)])), 16),
        ("full range: a bucket of 3000 entries",
         args(np.concatenate([big, uni(H - len(big))]), np.concatenate(
             [pick(big, M // 3), pick(big, M // 3) + 1,
              uni(M - 2 * (M // 3))])), 16),
        ("full range: 20k filter rows, 3000 entries just below them",
         args(np.concatenate([np.full(20_000, FULL), top, uni(H - 23_000)]),
              np.concatenate([np.full(1000, FULL), pick(top, 40_000),
                              FULL - rng.integers(0, 500, 20_000),
                              uni(M - 61_000)])), 16),
        ("full range: runs past max_occ, one ending at H", runs_args, 16),
        ("full range: runs past 32 at max_occ 40", runs_args, 40),
        ("full range: negative hashes and hashes of 2^32 and more",
         args(odd_h, np.concatenate([pick(odd, M // 4), odd + 1, -odd[3:],
                                     pick(odd_h, M - M // 4 - 9)])), 16)]


def main_store():
    """The main path's reads (simulate_genome(GENOME_SIZE, seed=1), 30x of
    8 kb reads at 10 % error, seed 2) as a SeqStore."""
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    from nextdenovo_tpu_torch.io.simulate import simulate_genome, simulate_reads
    genome = simulate_genome(GENOME_SIZE, seed=1)
    sim = simulate_reads(genome, coverage=COVERAGE, mean_len=MEAN_LEN,
                         error_rate=ERROR_RATE, seed=2)
    return SeqStore.from_codes(sim.reads)


def main_query_rows(store):
    """(chunk rows, seeds) of one 16-row query batch of stage 01: 16 seeds
    from the middle of the seeds' length order."""
    import numpy as np
    from nextdenovo_tpu_torch.overlap import engine as E
    s1 = STAGE01
    lens = np.asarray(store.length, np.int64)
    seeds = np.nonzero(lens >= SEED_CUTOFF)[0]
    order = seeds[np.argsort(lens[seeds], kind="stable")]
    mid = len(order) // 2
    return E._chunk_rows(order[mid : mid + 16], lens, s1["k"], s1["w"]), \
        seeds, order[mid : mid + 16]


def main_index_rows(store, n=32):
    """The last n chunk rows of the main path's index build in
    build_index's order (every read by length, chunked): a full batch of
    the longest reads, rows of up to CHUNK_LP columns."""
    import numpy as np
    from nextdenovo_tpu_torch.overlap import engine as E
    lens = np.asarray(store.length, np.int64)
    rows = E._chunk_rows(np.argsort(lens, kind="stable"), lens,
                         STAGE01["k"], STAGE01["w"])
    return rows[-n:]


def main_batch(dev):
    """_match_block's inputs for one 16-row batch of stage 01 on the main
    path's reads: the index of all 3720 reads at k = 15, w = 5 on the card,
    16 seeds from the middle of the seeds' length order, the seeds as the
    query mask."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch.overlap import engine as E
    s1 = STAGE01
    store = main_store()
    lens = np.asarray(store.length, np.int64)
    idx = E.build_index(store, np.arange(len(store)), k=s1["k"], w=s1["w"],
                        max_occ=s1["index_max_occ"], device=dev)
    rows, seeds, picked = main_query_rows(store)
    m = E._sketch_rows(store, rows, s1["k"], s1["w"],
                       2 * 16 * E.CHUNK_LP // s1["w"] + 1024, dev)
    qmask = np.zeros(len(lens), np.int8)
    qmask[seeds] = 1
    to = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    args = (m.rid, m.pos, m.hash, m.strand, to([r[0] for r in rows]),
            to([r[1] for r in rows]), to(qmask), idx.h, idx.rid, idx.pos)
    return dict(args=args, idx=idx, rows=len(rows), read_lens=lens[picked],
                store=store, chunk_rows=rows)


def _engine_bounds(name, ins, outs, top_k):
    """(bytes, int32-rate operations) the kernel's work needs on these
    tensors: each input read once and each output written once, engine_anchor
    counting the index entries its occurrences examine (lo_cnt's count) and
    ~2 log2(H) probes of 8 B a minimizer no further."""
    import math
    if name == "engine_anchor":
        M, R, H = ins[0].shape[0], ins[4].shape[0], ins[7].shape[0]
        A = outs[0].shape[0]
        occ = ins[-1]                     # occurrences examined
        probes = 2 * max(1, math.ceil(math.log2(max(H, 2))))
        byt = M * 32 + R * 16 + occ * 9 + A * 40
        ops = M * probes * 4 + occ * 12
    elif name == "vote_corridor":
        A = ins[0].shape[0]
        byt = A * (32 + 16)
        ops = A * (top_k * 14 + 8)
    else:
        A = ins[0].shape[0]
        byt = A * (32 + 65)
        ops = A * 40
    return byt, ops


def compare_engine_kernels(dev, tag, anchors=None, batch=None, max_occ=16,
                           top_k=4, reps=0, diag_shift=8):
    """engine_anchor (given a batch: its tensors as numpy or on the card),
    vote_corridor and chain_emit against their plain versions on the card,
    each on the tensors _match_block hands it; every output exactly equal.
    Returns {kernel: dict(exact, max_abs_err[, ms, plain_ms, bound...])}
    and the kernels' anchors."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch.overlap import engine as E
    s1 = STAGE01
    res = {}
    to = lambda a: a if torch.is_tensor(a) else torch.from_numpy(a).to(dev)
    if batch is not None:
        args = tuple(to(a) for a in batch)
        # the directory made once, as find_overlaps makes it
        bucket = E.anchor_directory(args[7])
        ak, ap, t = _run(lambda: E.engine_anchor(*args, max_occ=max_occ,
                                                 bucket=bucket),
                         lambda: E.engine_anchor_plain(*args, max_occ=max_occ),
                         reps)
        # called alone, the wrapper makes its own directory: the same anchors
        if not all(_tensors_equal(x, y)[0] for x, y in zip(
                E.engine_anchor(*args, max_occ=max_occ), ak)):
            raise RuntimeError("engine_anchor on its own directory differs "
                               f"from engine_anchor on a given one on '{tag}'")
        lo = torch.searchsorted(args[7], args[2])
        occ = int(torch.clamp(torch.searchsorted(args[7], args[2], right=True)
                              - lo, max=max_occ).sum())
        byt, ops = _engine_bounds("engine_anchor", args + (occ,), ak, top_k)
        _record(res, tag, "engine_anchor", ak, ap, dict(
            t, shape=f"M={args[0].shape[0]} rows={args[4].shape[0]} "
                     f"H={args[7].shape[0]} A={ak[0].shape[0]}",
            **_bound(byt, ops)))
        anchors = ak
    anchors = tuple(to(a) for a in anchors)
    A = anchors[0].shape[0]
    if A == 0:
        return res, anchors
    vi = E._vote_inputs(*anchors, diag_shift=diag_shift)
    # both kernels on the one set of group starts, as _vote_emit hands them
    gstart = E.group_starts(vi[0], vi[1])
    vk, vp, t = _run(
        lambda: E.vote_corridor(*vi[:5], diag_shift=diag_shift, top_k=top_k,
                                gstart=gstart),
        lambda: E.vote_corridor_plain(*vi[:5], diag_shift=diag_shift,
                                      top_k=top_k), reps)
    G = int((E.segment_starts(vi[0]) | E.segment_starts(vi[1])).sum())
    byt, ops = _engine_bounds("vote_corridor", vi, vk, top_k)
    _record(res, tag, "vote_corridor", vk, vp, dict(
        t, shape=f"A={A} groups={G} top_k={top_k}", **_bound(byt, ops)))
    ci = E._chain_inputs(vi[0], vk[0], vk[1], vi[5])
    kw = dict(k=s1["k"], top_k=top_k, min_cnt=s1["min_cnt"],
              min_span=s1["min_span"])
    ck, cp, t = _run(lambda: E.chain_emit(*ci, **kw, gstart=gstart),
                     lambda: E.chain_emit_plain(*ci, **kw), reps)
    byt, ops = _engine_bounds("chain_emit", ci, ck, top_k)
    _record(res, tag, "chain_emit", ck, cp, dict(
        t, shape=f"A={A} top_k={top_k} emitted={int(ck[0].sum())}",
        **_bound(byt, ops)))
    # called alone, each wrapper makes its own starts: the same tensors
    for name, got, want in (
            ("vote_corridor", E.vote_corridor(*vi[:5], diag_shift=diag_shift,
                                              top_k=top_k), vk),
            ("chain_emit", E.chain_emit(*ci, **kw), ck)):
        if not all(_tensors_equal(a, b)[0] for a, b in zip(got, want)):
            raise RuntimeError(f"{name} on its own group starts differs "
                               f"from {name} on _vote_emit's on '{tag}'")
    return res, anchors


def _same_vote_emit(a, b, tag):
    """Two _vote_emit results: the same n_out, overflow and records."""
    import torch
    (ra, na, oa), (rb, nb, ob) = a, b
    if (na, oa) != (nb, ob):
        raise RuntimeError(f"_vote_emit on '{tag}': n_out, overflow "
                           f"{(na, oa)} on the card, {(nb, ob)} on the CPU")
    for f in ra:
        if not torch.equal(ra[f].cpu(), rb[f].cpu()):
            raise RuntimeError(f"_vote_emit on '{tag}': field {f} differs "
                               "between the card and the CPU")


def phase_engine(dev):
    """The engine's three kernels against their plain versions on the card
    (exact equality of every output), on engine_anchor_sets and the main
    path's batch (then vote_corridor and chain_emit on their anchors) and
    on engine_vote_sets at top_k 1 and 4 and engine_tile_sets at top_k 1, 4
    and 8; for each set also the whole
    _vote_emit, card (kernels) against CPU (plain versions): the same
    records, n_out and overflow.  Returns the main path's batch."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch.overlap import engine as E
    s1 = STAGE01
    rng = np.random.default_rng(19)
    kw = dict(k=s1["k"], diag_shift=8, min_cnt=s1["min_cnt"],
              min_span=s1["min_span"])

    def vote_both(tag, anchors, top_k, cap_out):
        card = E._vote_emit(*anchors, cap_out=cap_out, top_k=top_k, **kw)
        cpu = E._vote_emit(*(a.cpu() for a in anchors), cap_out=cap_out,
                           top_k=top_k, **kw)
        _same_vote_emit(card, cpu, tag)
        return card[1], card[2]

    engine_ptxas()
    t0 = time.time()
    mb = main_batch(dev)
    log(f"[engine] the main path's batch: {mb['rows']} rows, reads of "
        f"{int(mb['read_lens'].min())}-{int(mb['read_lens'].max())} bases, "
        f"index {mb['idx'].h.shape[0]} entries ({time.time() - t0:.1f}s)")
    for tag, args, max_occ in engine_anchor_sets(rng) + [
            ("main-path batch", mb["args"], s1["max_occ"])]:
        for top_k in (1, 4):
            r, anchors = compare_engine_kernels(dev, tag, batch=args,
                                                max_occ=max_occ, top_k=top_k)
            n, over = vote_both(tag, anchors, top_k, 256 * 16 + 256)
            log(f"[engine] {tag}, top_k {top_k}: " + ", ".join(
                f"{k_} exact={v['exact']} ({v['shape']})"
                for k_, v in r.items()) + f"; _vote_emit card == cpu, "
                f"{n} records, overflow {over}")
    for tag, anchors, top_k, cap_out in (engine_vote_sets(rng)
                                         + engine_tile_sets(rng)):
        r, anchors = compare_engine_kernels(dev, tag, anchors=anchors,
                                            top_k=top_k)
        n, over = vote_both(tag, anchors, top_k, cap_out)
        log(f"[engine] {tag}, top_k {top_k}: " + ", ".join(
            f"{k_} exact={v['exact']}" for k_, v in r.items())
            + f"; _vote_emit card == cpu, {n} records, overflow {over}")
        if "truncates" in tag and over == 0:
            raise RuntimeError(f"'{tag}': cap_out {cap_out} left no "
                               "overflow")
    for tag, ci, top_k in engine_chain_sets(rng):
        ci = tuple(torch.from_numpy(x).to(dev) for x in ci)
        ckw = dict(k=s1["k"], top_k=top_k, min_cnt=s1["min_cnt"],
                   min_span=s1["min_span"])
        want = E.chain_emit_plain(*ci, **ckw)
        gs = E.group_starts(ci[0], ci[1] // (top_k + 1))
        res = {}
        for how, got in (("own starts", E.chain_emit(*ci, **ckw)),
                         ("starts given", E.chain_emit(*ci, **ckw,
                                                       gstart=gs))):
            _record(res, f"{tag}, {how}", "chain_emit", got, want)
        log(f"[engine] {tag}, top_k {top_k}: chain_emit exact=True on its "
            f"own starts and on given ones, {int(want[0].sum())} emitted")
    return mb


class plain_engine:
    """Inside the block _match_block and _vote_emit call the kernels' plain
    versions, also on CUDA tensors (for timing the two against each other
    on the card)."""

    def __enter__(self):
        from nextdenovo_tpu_torch.overlap import engine as E
        self.saved = {n: getattr(E, n) for n in ENGINE_KERNELS}
        for n in ENGINE_KERNELS:
            plain = getattr(E, n + "_plain")
            # _vote_emit hands the kernels' wrappers its group starts,
            # _match_block engine_anchor's directory
            setattr(E, n, lambda *a, _f=plain, gstart=None, bucket=None,
                    **k: _f(*a, **k))

    def __exit__(self, *exc):
        from nextdenovo_tpu_torch.overlap import engine as E
        for n, f in self.saved.items():
            setattr(E, n, f)


def engine_ptxas():
    """{kernel: (registers, stack frame bytes, spill bytes)} of csrc/engine.cu
    as `nvcc -Xptxas -v` reports them for sm_90a; printed."""
    import re
    from nextdenovo_tpu_torch import _build
    src = os.path.join(_build.CSRC_DIR, "engine.cu")
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                            "-Xptxas", "-v", "-c", "-o",
                            os.path.join(tmp, "e.o"), src],
                           capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc engine.cu failed:\n{r.stdout}{r.stderr}")
    out, cur = {}, None
    for line in (r.stdout + r.stderr).splitlines():
        m = re.search(r"Function properties for \S*?"
                      r"((?:engine_anchor|vote_corridor|chain_emit)_kernel)",
                      line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and cur:
            out[cur] = [None, int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur in out:
            out[cur][0] = int(m.group(1))
            cur = None
    log("[engine] -Xptxas -v: " + "; ".join(
        f"{k}: {v[0]} registers, {v[1]} B stack frame, {v[2]} B spills"
        for k, v in out.items()))
    for k, why in (("vote_corridor_kernel", "its rounds' bins"),
                   ("engine_anchor_kernel", "a chunk's rids and positions")):
        if out.get(k, [0, 1])[1] != 0:
            raise RuntimeError(f"{k} keeps a stack frame ({why} belong in "
                               "registers)")
    return out


def engine_groups(vi):
    """The (key_q, key_t) groups of vote_corridor's input: anchors and runs
    of one diagonal bin a group (median, p99, max), and the share of groups
    and of anchors in groups of more runs than the vote kernel's tile."""
    import torch
    from nextdenovo_tpu_torch.overlap import engine as E
    T = E.VOTE_TILE
    key_q, key_t, key_b = vi[:3]
    gs = E.segment_starts(key_q) | E.segment_starts(key_t)
    gid = torch.cumsum(gs.to(torch.int64), 0) - 1
    G = int(gid[-1]) + 1
    size = torch.bincount(gid, minlength=G)
    runs = torch.bincount(gid[gs | E.segment_starts(key_b >> 10)],
                          minlength=G)

    def q(x):
        xf = x.to(torch.float64)
        return (f"median {float(torch.quantile(xf, 0.5)):.0f}, p99 "
                f"{float(torch.quantile(xf, 0.99)):.0f}, max {int(x.max())}")
    past = runs > T
    log(f"[engine] groups of the main path's batch: {G} groups of "
        f"{int(size.sum())} anchors; anchors a group {q(size)}; runs a group "
        f"{q(runs)}; past the vote tile of {T} runs: "
        f"{100 * float(past.double().mean()):.2f} % of groups, "
        f"{100 * float(size[past].sum() / size.sum()):.2f} % of anchors")


def count_syncs(fn):
    """(fn's result, the host syncs it made, where: for each the innermost
    line of this repository's code on the stack): PyTorch's sync debug mode
    warns at each synchronising CUDA operation, and the warnings are
    counted."""
    import traceback
    import warnings
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    at = []

    def seen(message, *a, **k):
        if "synchroniz" not in str(message):
            return
        mine = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(here)]
        f = mine[-1] if mine else traceback.extract_stack()[-2]
        at.append(f"{os.path.relpath(f.filename, here)}:{f.lineno}")

    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        at.clear()                        # the switch itself warns
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, len(at), at


def _events_ms(fn, reps=5):
    """ms a call of fn by CUDA events around reps calls, after a warm one:
    fn launches only, its inputs made before.  The device first sleeps
    ~1 ms, so that the launches are all queued before the start event and
    the host's time to make them is not measured."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


L2_FLUSH_BYTES = 256 << 20   # written between launches timed cold (L2: 50 MB)


def _each_ms(fn, flush=None, reps=5):
    """ms a call of fn (launches only) by CUDA events around each call, after
    a warm one; with flush (a tensor of more than the L2), flush.zero_()
    before each call, outside its events, so that the call finds its inputs
    in device memory and not in L2.  The device first sleeps ~2 ms, so that
    every call is queued before it runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(4_000_000)
    for s, e in ev:
        if flush is not None:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def engine_alone(dev, mb, top_k, reps=5):
    """The three engine kernels' launches alone at the main path's batch
    (CUDA events around the launches only; the wrapper's inputs, directory,
    group starts and buffers made before): one launch of each, vote_corridor
    and chain_emit on the group starts _vote_emit makes.  engine_anchor also
    with events around each launch, warm and with the L2 flushed before
    each; its directory's build, and the plain version's two
    torch.searchsorted calls on the batch (a yardstick for the lookup
    alone), both warm and flushed.
    Returns ({name: ms}, the vote's inputs)."""
    import torch
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.overlap import engine as E
    s1 = STAGE01
    lib = _build.kernels()
    args = mb["args"]
    M, H, idx_h, qh = args[0].shape[0], args[7].shape[0], args[7], args[2]
    bucket = E.anchor_directory(idx_h)
    ins = [t.data_ptr() for t in args + (bucket,)]
    shift = 32 - E.directory_bits(H)
    stat, nb = E._anchor_stat(M, dev)
    mo = s1["max_occ"]
    cap = M * mo                          # as the wrapper: the bound of A
    out = torch.empty((5, cap), dtype=torch.int64, device=dev)
    launch = functools.partial(
        E._anchor_launch, lib, ins, stat, out.data_ptr(), M, H, cap, shift,
        mo, torch.cuda.current_stream(dev).cuda_stream)
    launch()
    A = int(stat[nb])
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    direc = lambda: E.anchor_directory(idx_h)
    search = lambda: (torch.searchsorted(idx_h, qh),
                      torch.searchsorted(idx_h, qh, right=True))
    ms = {"engine_anchor": _events_ms(launch, reps),
          "engine_anchor, each warm": _each_ms(launch, None, reps),
          "engine_anchor, each L2 flushed": _each_ms(launch, flush, reps),
          "directory": _each_ms(direc, None, reps),
          "directory, L2 flushed": _each_ms(direc, flush, reps),
          "searchsorted x2 (yardstick)": _each_ms(search, None, reps),
          "searchsorted x2 (yardstick), L2 flushed":
              _each_ms(search, flush, reps)}
    del flush
    vi = E._vote_inputs(*out[:, :A], diag_shift=8)
    gstart = E.group_starts(vi[0], vi[1])
    key_t2, qp2 = torch.empty_like(vi[1]), torch.empty_like(vi[4])
    ms["vote_corridor"] = _events_ms(lambda: E._vote_launch(
        lib, *vi[1:5], gstart, key_t2, qp2, A, 8, top_k), reps)
    ci = E._chain_inputs(vi[0], key_t2, qp2, vi[5])
    emit = torch.empty(A, dtype=torch.bool, device=dev)
    rec = torch.empty((8, A), dtype=torch.int64, device=dev)
    ms["chain_emit"] = _events_ms(lambda: E._chain_launch(
        lib, *ci, gstart, emit, rec, A, k=s1["k"], top_k=top_k,
        min_cnt=s1["min_cnt"], min_span=s1["min_span"]), reps)
    ms["group_starts"] = _events_ms(lambda: E.group_starts(vi[0], vi[1]),
                                    reps)
    _, ms["group_starts call"] = timed(lambda: E.group_starts(vi[0], vi[1]),
                                       reps)
    log("[timing] engine kernels alone (launches only, CUDA events, "
        f"{reps} after a warm one; M={M}, H={H}, directory of "
        f"{bucket.shape[0]} starts, A={A}, top_k={top_k}): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items()))
    return ms, vi


def match_block_split(dev, mb, reps=5):
    """One _match_block call at the main path's batch cut into its steps by
    CUDA events (host-paced: the call syncs twice), as find_overlaps makes
    it: engine_anchor on find_overlaps' directory, _vote_inputs (three
    stable sort passes and the gathers), group_starts, vote_corridor,
    _chain_inputs (four passes and the gathers), chain_emit, and the hits'
    nonzero with the records' copy to the host.  The steps are _vote_emit's
    own, in its order; the records must equal _match_block's.  Returns
    {step: mean ms over reps calls after a warm one}."""
    import torch
    from nextdenovo_tpu_torch.overlap import engine as E
    s1 = STAGE01
    a, cap_out, top_k = mb["args"], 256 * 16 + 256, s1["top_k"]
    bucket = E.anchor_directory(mb["idx"].h)
    ckw = dict(k=s1["k"], top_k=top_k, min_cnt=s1["min_cnt"],
               min_span=s1["min_span"])
    steps = ("engine_anchor", "_vote_inputs", "group_starts",
             "vote_corridor", "_chain_inputs", "chain_emit",
             "hits and records' copy")

    def once():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        ev[0].record()
        an = E.engine_anchor(*a, max_occ=s1["max_occ"], bucket=bucket)
        ev[1].record()
        vi = E._vote_inputs(*an, diag_shift=8)
        ev[2].record()
        gs = E.group_starts(vi[0], vi[1])
        ev[3].record()
        k2, q2 = E.vote_corridor(*vi[:5], diag_shift=8, top_k=top_k,
                                 gstart=gs)
        ev[4].record()
        ci = E._chain_inputs(vi[0], k2, q2, vi[5])
        ev[5].record()
        emit, rec = E.chain_emit(*ci, **ckw, gstart=gs)
        ev[6].record()
        hits = torch.nonzero(emit)[:, 0]
        recs = rec[:, hits[:cap_out]].to(torch.int32).cpu()
        ev[7].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(7)], recs

    once()
    runs = [once() for _ in range(reps)]
    want, n, _ = E._match_block(
        *a[:7], mb["idx"], k=s1["k"], max_occ=s1["max_occ"], diag_shift=8,
        min_cnt=s1["min_cnt"], min_span=s1["min_span"], cap_out=cap_out,
        top_k=top_k, bucket=bucket)
    want = torch.stack([want[f] for f in E.REC_FIELDS]).to(torch.int32).cpu()
    if not torch.equal(runs[-1][1], want):
        raise RuntimeError("the split _match_block's records differ from "
                           "_match_block's")
    ms = {st: sum(r[0][i] for r in runs) / reps for i, st in enumerate(steps)}
    log(f"[timing] _match_block split (CUDA events, host-paced, mean of "
        f"{reps}; {n} records): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items())
        + f"; sum {sum(ms.values()):.4f} ms")
    return ms


def engine_timing(dev, mb):
    """The three kernels at the main path's batch shape (top_k 4) against
    their plain versions: each wrapper's whole call and its launches alone;
    the batch's group sizes; then one whole _match_block call with the
    kernels against the same call with the plain versions on the card (host
    clock, in turns plain, kernels, kernels, plain, 5 calls each), the host
    syncs one call makes, counted, and what a host sync costs."""
    import torch
    from nextdenovo_tpu_torch.overlap import engine as E
    s1 = STAGE01
    r, _ = compare_engine_kernels(dev, "main-path batch (timing)",
                                  batch=mb["args"], max_occ=s1["max_occ"],
                                  top_k=s1["top_k"], reps=5)
    alone, vi = engine_alone(dev, mb, s1["top_k"])
    for name, v in r.items():
        v["wrapper_ms"], v["ms"] = v["ms"], alone[name]
        log(f"[timing] {name}: kernel alone {v['ms']:.4f} ms, whole call "
            f"{v['wrapper_ms']:.4f} ms (plain {v['plain_ms']:.3f} ms), bound "
            f"{v['bound_ms']:.4f} ms by {v['bound_by']}, {v['shape']}")
    r["engine_anchor"].update(
        ms_l2_flushed=alone["engine_anchor, each L2 flushed"],
        ms_each_warm=alone["engine_anchor, each warm"],
        directory_ms=alone["directory"],
        searchsorted_ms=alone["searchsorted x2 (yardstick)"],
        searchsorted_ms_l2_flushed=alone[
            "searchsorted x2 (yardstick), L2 flushed"])
    engine_groups(vi)
    match_block_split(dev, mb)
    a = mb["args"]
    bucket = E.anchor_directory(mb["idx"].h)
    call = lambda: E._match_block(
        *a[:7], mb["idx"], k=s1["k"], max_occ=s1["max_occ"], diag_shift=8,
        min_cnt=s1["min_cnt"], min_span=s1["min_span"], cap_out=256 * 16 + 256,
        top_k=s1["top_k"], bucket=bucket)

    def wall(n=5):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n, out

    times = {"kernels": [], "plain": []}
    outs = {}
    for which in ("plain", "kernels", "kernels", "plain"):
        if which == "plain":
            with plain_engine():
                ms, outs[which] = wall()
        else:
            ms, outs[which] = wall()
        times[which].append(ms)
    _same_vote_emit(outs["kernels"], outs["plain"], "main-path batch")
    _, n_sync, sync_at = count_syncs(call)
    # a sync's round trip on an idle device; find_overlaps adds one to a
    # _match_block call's (the records' copy to the host)
    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        int(x[0])
    sync_us = (time.perf_counter() - t0) * 1e6 / 200
    km, pm = min(times["kernels"]), min(times["plain"])
    log(f"[timing] _match_block, the main path's batch ({outs['kernels'][1]} "
        f"records): kernels {km:.3f} ms ({times['kernels']}), plain versions "
        f"on the card {pm:.3f} ms ({times['plain']}); x{pm / km:.1f}")
    log(f"[timing] host syncs: {n_sync} a _match_block call (counted in "
        f"PyTorch's sync debug mode, at {', '.join(sync_at)}), "
        f"{n_sync + 1} a batch with the records' "
        f"copy; {sync_us:.1f} us each on an idle device: "
        f"{(n_sync + 1) * sync_us * 367 / 1e3:.1f} ms over the main path's "
        f"367 batches")
    return r, dict(match_block_ms=km, match_block_plain_ms=pm,
                   sync_us=sync_us, syncs=n_sync)


# --------------------------------------------------------------------------
# phases


def phase_env():
    import torch
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[env] card: {card}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return card


def phase_build():
    from nextdenovo_tpu_torch import _build
    t0 = time.time()
    secs = _build.build()
    _build.kernels()
    from nextdenovo_tpu_torch import native
    native.lib()
    log(f"[build] {json.dumps(secs)} total {time.time() - t0:.1f}s")


def phase_kernels(dev):
    import numpy as np
    rng = np.random.default_rng(7)
    sets = [("degenerate", degenerate_pairs(rng)),
            ("random 64 x 1-3 kb", make_pairs(rng, 64, 1000, 3000)),
            ("|m-n| > 200", skewed_pairs(rng))]
    for tag, (qs, ts) in sets:
        r = compare_kernels(qs, ts, dev, tag)
        r.update(compare_fast_kernels(qs, ts, dev, tag))
        log(f"[kernels] {tag}: " + ", ".join(
            f"{k} exact={v['exact']}" for k, v in r.items()))
        compare_results(qs, ts, dev, tag)
    # the Myers kernels share a pair among the lanes of a warp: batches
    # that do not fill their last warp, ends that diverge inside a warp,
    # walks that fail, carries that cross words
    myers_sets = [(f"ragged B={b}", make_pairs(rng, b, 200, 1500), False)
                  for b in (1, 7, 33, 641)]
    # up to the longest columns the main path launches (about 13.8k)
    myers_sets += [("mixed n 1..13900", mixed_length_pairs(rng), False),
                   ("band exits", band_exit_pairs(rng), True),
                   ("multi-word carry", carry_pairs(rng), False)]
    for tag, (qs, ts), need_fail in myers_sets:
        r = compare_myers_kernels(qs, ts, dev, tag, need_fail=need_fail)
        log(f"[kernels] {tag}: " + ", ".join(
            f"{k} exact={v['exact']}" for k, v in r.items()))
    wave_tb_sets(dev, rng)
    wave_fast_tb_sets(dev, rng)
    ext_sets = [("extender degenerate", ext_degenerate_pairs(rng)),
                ("extender 256 tails <= 1024", ext_tail_pairs(rng, 256)),
                ("extender |m-n| > 200", ext_skewed_pairs(rng))]
    for tag, (qs, ts) in ext_sets:
        r = compare_ext_kernel(qs, ts, dev, tag)
        log(f"[kernels] {tag}: " + ", ".join(
            f"{k} exact={v['exact']}" for k, v in r.items()))
        compare_extend_results(qs, ts, dev, tag)


def wave_tb_sets(dev, rng):
    """wave_tb, one warp a pair and four pairs a block, against wave_tb_plain
    on tb/lo from wave_fwd: batches that do not fill their last block, walks
    of 0 to 24.6k anti-diagonals in one launch, and walks that leave the band
    mid-way (lo shifted; at least one pair must end with ok = 0).  On the
    ragged batches wave_fwd too is held against wave_fwd_plain."""
    import numpy as np
    from nextdenovo_tpu_torch.ops import align as A
    sets = [(f"wave ragged B={b}", make_pairs(rng, b, 200, 1500), 0)
            for b in (1, 3, 5, 33, 130)]
    # an empty pair, then m + n from 2 to about 24.6k
    qs, ts = mixed_length_pairs(rng, n=40, hi=12300)
    empty = np.zeros(0, np.int8)
    sets += [("wave mixed m+n 0..24.6k", ([empty] + qs, [empty] + ts), 0),
             ("wave band exits (lo +-300)", make_pairs(rng, 64, 1000, 3000),
              300)]
    for tag, (qs, ts), by in sets:
        wi = wave_inputs(qs, ts, dev)
        fwd = A.wave_fwd(wi["qpad"], wi["rtpad"], wi["mn"], wi["n_words"])
        tb, lo, _ = fwd
        if tag.startswith("wave ragged"):
            # the forward pass, one warp a pair, on the same ragged batches
            defined = A.wave_fwd_defined(wi["mn"], wi["n_words"])[:, :, None]
            res = {}
            _record(res, tag, "wave_fwd", (fwd[0] * defined, *fwd[1:]),
                    A.wave_fwd_plain(wi["qpad"], wi["rtpad"], wi["mn"],
                                     wi["n_words"]))
            log(f"[kernels] {tag}: wave_fwd exact={res['wave_fwd']['exact']}")
        if by:
            lo = shift_lo(lo, wi["mn"], by)
        res = {}
        _, ok = compare_wave_tb(res, tag, tb, lo, wi["mn"])
        n_ok = int(ok.sum().item())
        log(f"[kernels] {tag}: wave_tb exact={res['wave_tb']['exact']}, "
            f"{n_ok} of {len(qs)} pairs ok, max m+n "
            f"{int((wi['m_np'] + wi['n_np']).max())}")
        if by and n_ok == len(qs):
            raise RuntimeError(f"'{tag}': no walk left the band (all ok)")


def wave_fast_tb_sets(dev, rng):
    """wave_fast_fwd and wave_fast_tb, one warp a pair each, against their
    plain versions: ragged batches, walks of 0 to 24.6k anti-diagonals in one
    launch, pairs with |m - n| > 200 whose re-centring reaches -8 and 8 and
    meets both clamps (fast_clamp_pairs), and walks that leave the band
    mid-way (base shifted; at least one pair must end with ok = 0); then
    wave_fast_tb on decisions drawn at random (random_fast_tb)."""
    import numpy as np
    from nextdenovo_tpu_torch.ops import align as A
    sets = [(f"fast ragged B={b}", make_pairs(rng, b, 200, 1500), 0)
            for b in (1, 3, 5, 33, 130)]
    qs, ts = mixed_length_pairs(rng, n=40, hi=12300)
    empty = np.zeros(0, np.int8)
    sets += [("fast mixed m+n 0..24.6k", ([empty] + qs, [empty] + ts), 0),
             ("fast |m-n| > 200 (clamps)",
              fast_clamp_pairs(np.random.default_rng(CLAMP_SEED)), 0),
             ("fast band exits (base +-300)", make_pairs(rng, 64, 1000, 3000),
              300)]
    for tag, (qs, ts), by in sets:
        fi = fast_inputs(qs, ts, dev)
        fwd = A.wave_fast_fwd(fi["qpad"], fi["rtpad"], fi["mn"],
                              fi["n_words"])
        tb, base, _ = fwd
        res = {}
        _record(res, tag, "wave_fast_fwd", fwd_defined(fi, fwd),
                A.wave_fast_fwd_plain(fi["qpad"], fi["rtpad"], fi["mn"],
                                      fi["n_words"]))
        log(f"[kernels] {tag}: wave_fast_fwd exact="
            f"{res['wave_fast_fwd']['exact']}, " + recentring(
                fi, base, tag if "clamps" in tag else None))
        if by:
            base = shift_base(base, fi["mn"], by)
        res = {}
        _, ok = compare_wave_fast_tb(res, tag, tb, base, fi["mn"])
        n_ok = int(ok.sum().item())
        log(f"[kernels] {tag}: wave_fast_tb exact="
            f"{res['wave_fast_tb']['exact']}, {n_ok} of {len(qs)} pairs ok, "
            f"max m+n {int((fi['m_np'] + fi['n_np']).max())}")
        if by and n_ok == len(qs):
            raise RuntimeError(f"'{tag}': no walk left the band (all ok)")
    # walks that step out of the band inside a word and stop at the ring's
    # sentinel lanes, which the decisions of wave_fast_fwd seldom give
    tb, base, mn = (x.to(dev) for x in random_fast_tb(rng))
    res = {}
    _, ok = compare_wave_fast_tb(res, "fast random decisions", tb, base, mn)
    log(f"[kernels] fast random decisions: wave_fast_tb exact="
        f"{res['wave_fast_tb']['exact']}, {int(ok.sum().item())} of "
        f"{len(ok)} pairs ok")


def recentring(fi, base, tag=None):
    """wave_fast_fwd's re-centring read back from its bases: delta =
    base[w] - base[w - 1] - 8 on the defined words w >= 1, and the words
    with delta != 0 that sit at the j-side bound (base = a0 + 7 - n) or at
    the m-side bound (base = m - 8).  Returns a line for the log; given the
    set's tag, raises unless delta reaches -8 and 8 and words sit at both
    bounds."""
    import numpy as np
    from nextdenovo_tpu_torch.ops import align as A
    b = base.cpu().numpy().astype(np.int64)
    words = A.wave_fwd_defined(fi["mn"], fi["n_words"]).cpu().numpy()[:, 1:]
    m, n = fi["m_np"][:, None], fi["n_np"][:, None]
    a0 = A.PACK * np.arange(1, b.shape[1])[None, :]
    d = np.diff(b, axis=1) - 8
    moved = words & (d != 0)
    j_words = int((moved & (b[:, 1:] == a0 + 7 - n)).sum())
    m_words = int((moved & (b[:, 1:] == m - 8)).sum())
    d = d[words]
    line = (f"delta {int(d.min(initial=0))}..{int(d.max(initial=0))} over "
            f"{len(d)} words, {j_words} at the j-side bound, {m_words} at "
            f"the m-side bound")
    if tag and not (len(d) and d.min() == -8 and d.max() == 8 and j_words
                    and m_words):
        raise RuntimeError(f"'{tag}': wave_fast_fwd's re-centring did not "
                           f"reach -8 and 8 and both bounds ({line})")
    return line


def _same_records(a, b, what, allow_empty=False):
    """Two OvlBlocks hold the same records, field by field."""
    import numpy as np
    if len(a) == 0 and not allow_empty:
        raise RuntimeError(f"find_overlaps gave no records on {what}")
    if sorted(a.data) != sorted(b.data) or len(a) != len(b):
        raise RuntimeError(f"find_overlaps on {what}: {len(a)} records on "
                           f"the card, {len(b)} on the CPU")
    for k in sorted(a.data):
        x, y = np.asarray(a.data[k]), np.asarray(b.data[k])
        if not np.array_equal(x, y):
            i = int(np.nonzero(x != y)[0][0])
            raise RuntimeError(
                f"find_overlaps differs between the card and the CPU on "
                f"{what}: field {k} record {i}: {x[i]} != {y[i]}")


def _same_index(a, b, what):
    """Two MiniIndexes hold the same arrays."""
    if a.n != b.n:
        raise RuntimeError(f"index on {what}: {a.n} entries on the card, "
                           f"{b.n} on the CPU")
    for f in ("h", "rid", "pos", "lens"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        if x.shape != y.shape or not bool((x == y).all()):
            raise RuntimeError(f"index on {what}: field {f} differs between "
                               "the card and the CPU")


def _same_minimizers(a, b, what):
    """Two sketches (Minimizers) hold the same minimizers, every field."""
    if (a.n, a.n_all) != (b.n, b.n_all):
        raise RuntimeError(f"sketch of {what}: {a.n} ({a.n_all}) minimizers "
                           f"on the card, {b.n} ({b.n_all}) on the CPU")
    for f in ("rid", "pos", "hash", "strand"):
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        if x.shape != y.shape or not bool((x == y).all()):
            raise RuntimeError(f"sketch of {what}: field {f} differs between "
                               "the card and the CPU")


def hifi_batch():
    """A fixed HiFi batch: 0.4 % error reads of a 60 kb genome plus one read
    of 20 kb, longer than CHUNK_LP, so that it is halo-chunked."""
    import numpy as np
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    from nextdenovo_tpu_torch.io.simulate import (mutate_read,
                                                  simulate_genome,
                                                  simulate_reads)
    g = simulate_genome(60_000, seed=23)
    sim = simulate_reads(g, coverage=10, mean_len=6000, error_rate=0.004,
                         seed=24, min_len=2000)
    rng = np.random.default_rng(25)
    reads = list(sim.reads) + [mutate_read(g[10_000:30_000], 0.004, rng)]
    return SeqStore.from_codes(reads)


def phase_overlaps(dev):
    """find_overlaps on fixed batches of reads: the card's records against
    the CPU's, every field (the vote scoring takes a float32 log2).  The
    ONT batch at k = 17, w = 10; the HiFi batch at k = 51, w = 51, whose
    index arrays are held card against CPU too."""
    import numpy as np
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    from nextdenovo_tpu_torch.io.simulate import simulate_genome, simulate_reads
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.overlap.engine import (CHUNK_LP, build_index,
                                                     find_overlaps)
    g = simulate_genome(60_000, seed=21)
    sim = simulate_reads(g, coverage=20, mean_len=6000, error_rate=0.10,
                         seed=22)
    store = SeqStore.from_codes(sim.reads)
    rids = np.arange(len(store))
    blocks = {}
    _build.reset_launches()
    for d in (dev, "cpu"):
        t0 = time.time()
        idx = build_index(store, rids, k=17, w=10, max_occ=64, device=d)
        blocks[str(d)] = find_overlaps(
            store, rids, idx, k=17, w=10, max_occ=16, min_cnt=4, min_span=500,
            top_k=4, query_mask=np.ones(len(store), bool), device=d)
        log(f"[overlaps] {d}: {len(blocks[str(d)])} records from "
            f"{len(store)} reads in {time.time() - t0:.1f}s")
    a = blocks[str(dev)]
    _same_records(a, blocks["cpu"], "the ONT batch (genome seed 21, reads "
                  "seed 22)")
    launched = {k_: _build.LAUNCHES[k_] for k_ in ENGINE_KERNELS}
    log(f"[overlaps] the card's engine kernels: {json.dumps(launched)}")
    if not all(launched.values()):
        raise RuntimeError("find_overlaps on the card launched not every "
                           f"engine kernel: {launched}")
    log(f"[overlaps] card == cpu: {len(a)} records, fields "
        f"{sorted(a.data)} identical")

    store = hifi_batch()
    rids = np.arange(len(store))
    assert int(np.max(store.length)) > CHUNK_LP
    out = {}
    for d in (dev, "cpu"):
        t0 = time.time()
        out[str(d), "index"] = build_index(store, rids, k=51, w=51,
                                           max_occ=64, device=d)
        out[str(d)] = find_overlaps(
            store, rids, out[str(d), "index"], k=51, w=51, max_occ=16,
            min_cnt=4, min_span=500, top_k=4,
            query_mask=np.ones(len(store), bool), device=d)
        log(f"[overlaps] HiFi k=51 w=51 {d}: index {out[str(d), 'index'].n} "
            f"entries, {len(out[str(d)])} records from {len(store)} reads (longest "
            f"{int(np.max(store.length))}) in {time.time() - t0:.1f}s")
    _same_index(out[str(dev), "index"], out["cpu", "index"], "the HiFi batch")
    a = out[str(dev)]
    _same_records(a, out["cpu"], "the HiFi batch at k = 51")
    log(f"[overlaps] HiFi card == cpu: the index's arrays and {len(a)} "
        f"records identical")
    hpc_overlaps(dev, store)


def hpc_overlaps(dev, store):
    """The HiFi batch homopolymer-compressed (hpc) at k = w = 51, the card
    against the CPU: the sketch of the last 32 chunk rows in build_index's
    order (the longest reads, the 20 kb read's chunks among them), the hpc
    index's arrays, and find_overlaps against it.  Its queries are sketched
    uncompressed, as in the reference, so few records are expected."""
    import numpy as np
    from nextdenovo_tpu_torch.overlap.engine import (
        CHUNK_LP, _chunk_rows, _sketch_rows, build_index, find_overlaps)
    lens = np.asarray(store.length, np.int64)
    rids = np.arange(len(store))
    rows = _chunk_rows(rids[np.argsort(lens, kind="stable")], lens, 51, 51,
                       hpc=True)
    sub = rows[-32:]
    if sub[-1][0] != sub[-2][0]:
        raise RuntimeError("the hpc batch holds no chunked read")
    cap = 2 * 32 * CHUNK_LP // 51 + 1024
    out = {}
    for d in (dev, "cpu"):
        t0 = time.time()
        out[str(d), "batch"] = _sketch_rows(store, sub, 51, 51, cap, d,
                                            hpc=True)
        out[str(d), "index"] = build_index(store, rids, k=51, w=51,
                                           max_occ=64, hpc=True, device=d)
        out[str(d)] = find_overlaps(
            store, rids, out[str(d), "index"], k=51, w=51, max_occ=16,
            min_cnt=4, min_span=500, top_k=4,
            query_mask=np.ones(len(store), bool), device=d)
        log(f"[overlaps] HiFi hpc k=51 w=51 {d}: batch of {len(sub)} rows "
            f"{out[str(d), 'batch'].n} minimizers, index "
            f"{out[str(d), 'index'].n} entries, {len(out[str(d)])} records "
            f"in {time.time() - t0:.1f}s")
    _same_minimizers(out[str(dev), "batch"], out["cpu", "batch"],
                     "the HiFi batch's last 32 hpc rows")
    _same_index(out[str(dev), "index"], out["cpu", "index"],
                "the HiFi batch, hpc")
    _same_records(out[str(dev)], out["cpu"], "the HiFi batch's hpc index",
                  allow_empty=True)
    log(f"[overlaps] HiFi hpc card == cpu: one batch's minimizers, the "
        f"index's arrays and {len(out[str(dev)])} records identical")


# --------------------------------------------------------------------------
# the sketch kernels

SKETCH_KERNELS = ("sketch_minimizers",)
SKETCH_KS = (1, 15, 17, 31, 32, 51, 127)
SKETCH_WS = (1, 5, 17, 51)


def sketch_edge_batch(rng, k, w, B=8, L=2100, pad=0):
    """Rows of the edge cases in a (B, L + pad) int8 buffer, as
    tests/test_torch_sketch_kernel.py makes them (the columns past L and
    past each row's length hold random codes, N included): a row of length
    0, one a base shorter than w + k - 1, N codes, homopolymer runs, a
    tandem repeat of period 3 (tied hashes), an (AT)* run (every even k-mer
    a palindrome), random rows of length L and just past the kernel's tile
    at w."""
    import numpy as np
    from nextdenovo_tpu_torch.ops.sketch import sketch_tile
    buf = rng.integers(0, 5, (B, L + pad)).astype(np.int8)
    lens = np.minimum([0, max(w + k - 2, 0), L, L, 1500, 1200, L,
                       sketch_tile(w)[1] + 3], L)[:B].astype(np.int32)
    buf[2, :L:7] = 4
    buf[3, :L] = np.repeat(rng.integers(0, 4, L),
                           rng.integers(1, 40, L))[:L]
    buf[3, L // 4 : L // 2] = 1
    n4, n5 = lens[4], lens[5]
    buf[4, :n4] = np.tile([0, 1, 2], n4 // 3 + 1)[:n4]
    buf[5, :n5] = np.tile([0, 3], n5 // 2 + 1)[:n5]
    buf[5, 300:310] = 2
    return buf, lens


def _sketch_record(res, tag, got, want):
    """Hold a sketch on the card (the kernel) against the plain version on
    the same tensors: every field, n and n_all."""
    if (got.n, got.n_all) != (want.n, want.n_all):
        raise RuntimeError(f"sketch kernel on '{tag}': {got.n} ({got.n_all})"
                           f" minimizers, the plain version {want.n} "
                           f"({want.n_all})")
    _record(res, tag, "sketch_minimizers",
            [getattr(got, f) for f in ("rid", "pos", "hash", "strand")],
            [getattr(want, f) for f in ("rid", "pos", "hash", "strand")])


def compare_sketch(tag, codes, lens, k, w, cap, own=(None, None),
                   hpc=False):
    """sketch_wide (and sketch, at k <= 31 and no hpc) with the kernels
    against their plain versions on the same CUDA tensors, exactly; with
    hpc also hpc_compress against hpc_compress_plain.  Returns the kernels'
    results {name: exact, max_abs_err} and the sketch."""
    from nextdenovo_tpu_torch.ops import sketch as S
    res = {}
    kw = dict(own_lo=own[0], own_hi=own[1])
    got = S.sketch_wide(codes, lens, k, w, cap, hpc=hpc, **kw)
    _sketch_record(res, tag, got, S.sketch_wide_plain(codes, lens, k, w, cap,
                                                      hpc=hpc, **kw))
    if k <= 31 and not hpc:
        _sketch_record(res, tag, S.sketch(codes, lens, k, w, cap, **kw),
                       S.sketch_plain(codes, lens, k, w, cap, **kw))
    if hpc:
        _record(res, tag, "hpc_compress", S.hpc_compress(codes, lens),
                S.hpc_compress_plain(codes, lens))
    return res, got


def sketch_sets(dev, rng, ks=SKETCH_KS, ws=SKETCH_WS,
                slices=((15, 5), (17, 17), (51, 51), (32, 1)),
                extra=((16, 17), (47, 5), (48, 51), (128, 1), (143, 17),
                       (15, 1101), (51, 2048))):
    """The kernels on the edge rows at every (k, w) of ks x ws and of extra
    (k at the lanes' edges and at the kernel's largest, w past a whole
    tile, with rows long enough for such windows); at each (k, w) of slices
    a column-sliced view of a wider buffer, with a truncating cap, with own
    gates, and hpc with own gates and int64 lengths.  Returns {name:
    result}."""
    import numpy as np
    import torch
    res = {}
    to = lambda a: torch.from_numpy(a).to(dev)
    grid = [(k, w) for k in ks for w in ws] + list(extra)
    for k, w in grid:
        buf, lens = sketch_edge_batch(rng, k, w, L=max(2100, 2 * w + 1500))
        B, L = buf.shape
        r, got = compare_sketch(f"edge rows k={k} w={w}", to(buf),
                                to(lens), k, w, B * L)
        res.update(r)
        if got.n_all == 0:
            raise RuntimeError(f"edge rows k={k} w={w}: no minimizer")
    for k, w in slices:
        buf, lens = sketch_edge_batch(rng, k, w, pad=333)
        B, L = buf.shape[0], buf.shape[1] - 333
        view = to(buf)[:, :L]
        lo = rng.integers(-5, 900, B).astype(np.int32)
        hi = (lo + rng.integers(0, 1500, B)).astype(np.int32)
        r, full = compare_sketch(f"column slice k={k} w={w}", view,
                                 to(lens), k, w, B * L)
        cap = full.n_all // 2
        r, got = compare_sketch(f"column slice, cap {cap}, k={k} w={w}",
                                view, to(lens), k, w, cap)
        if not got.n == cap < got.n_all:
            raise RuntimeError(f"cap {cap} did not truncate: {got.n} of "
                               f"{got.n_all}")
        r, _ = compare_sketch(f"column slice, own gates, k={k} w={w}", view,
                              to(lens), k, w, cap, own=(to(lo), to(hi)))
        r, _ = compare_sketch(f"hpc, own gates, int64 lengths, k={k} w={w}",
                              view, to(lens.astype(np.int64)), k, w, B * L,
                              own=(to(lo), to(hi)), hpc=True)
        res.update(r)
    return res


def mesh_sized_codes(dev, rng, B=128, L_buf=32768, top=20000):
    """A mesh-sized sketch launch: B rows of a (B, L_buf) int8 buffer (a
    power of two, as _pow2_rows makes it) sketched through the column slice
    [:, :top], top > CHUNK_LP; lengths up to top.  Returns (view, lengths)
    on dev."""
    import numpy as np
    import torch
    buf = rng.integers(0, 4, (B, L_buf)).astype(np.int8)
    lens = rng.integers(top // 2, top + 1, B).astype(np.int32)
    lens[0] = top
    return torch.from_numpy(buf).to(dev)[:, :top], \
        torch.from_numpy(lens).to(dev)


def hifi_sketch_rows(hpc=False, n=32):
    """The last n chunk rows of the HiFi batch (hifi_batch) in build_index's
    order at k = w = 51: the longest reads, the 20 kb read's chunks among
    them."""
    import numpy as np
    from nextdenovo_tpu_torch.overlap.engine import _chunk_rows
    store = hifi_batch()
    lens = np.asarray(store.length, np.int64)
    rows = _chunk_rows(np.argsort(lens, kind="stable"), lens, 51, 51,
                       hpc=hpc)
    return store, rows[-n:]


def _batch_tensors(dev, store, rows):
    import torch
    from nextdenovo_tpu_torch.overlap.engine import sketch_inputs
    return tuple(torch.from_numpy(a).to(dev)
                 for a in sketch_inputs(store, rows))


def phase_sketch(dev, mb):
    """The sketch kernels against their plain versions on the card, exact
    in every field, n and n_all: sketch_sets; one 16-row batch of the main
    path's stage 01 (mb, k = 15, w = 5, with its own gates and cap) and one
    32-row batch of its index build; the HiFi batch's 32 longest chunk rows
    at k = w = 51, raw and hpc; a mesh-sized launch of 128 rows through a
    20000-column slice of a 32768-column buffer (2560 tiles: look-backs
    past whole windows of status words); the host syncs of one sketch call
    (at most one).  Returns the main path's query and index batches as
    tensors on dev: {"main": ..., "index": ...}."""
    import numpy as np
    from nextdenovo_tpu_torch.ops import sketch as S
    from nextdenovo_tpu_torch.overlap.engine import CHUNK_LP
    rng = np.random.default_rng(29)
    t0 = time.time()
    r = sketch_sets(dev, rng)
    log(f"[sketch] edge rows at k in {SKETCH_KS}, w in {SKETCH_WS} and at "
        f"the lanes' edges and w past a tile, column slices, own gates, a "
        f"truncating cap and hpc: " + ", ".join(
            f"{k_} exact={v['exact']}" for k_, v in r.items())
        + f" ({time.time() - t0:.1f}s)")
    s1 = STAGE01
    main = _batch_tensors(dev, mb["store"], mb["chunk_rows"])
    codes, lens, lo, hi = main
    cap = 2 * 16 * CHUNK_LP // s1["w"] + 1024
    _, got = compare_sketch("the main path's batch", codes, lens, s1["k"],
                            s1["w"], cap, own=(lo, hi))
    _, n_sync, at = count_syncs(lambda: S.sketch(
        codes, lens, s1["k"], s1["w"], cap, own_lo=lo, own_hi=hi))
    log(f"[sketch] the main path's batch {tuple(codes.shape)}: {got.n} "
        f"minimizers, kernels == plain; host syncs of one call {n_sync} "
        f"{at}")
    if n_sync > 1:
        raise RuntimeError(f"a sketch call made {n_sync} host syncs: {at}")
    index = _batch_tensors(dev, mb["store"], main_index_rows(mb["store"]))
    c, l_, o1, o2 = index
    _, got = compare_sketch("the main path's index batch", c, l_, s1["k"],
                            s1["w"], 2 * 32 * CHUNK_LP // s1["w"] + 1024,
                            own=(o1, o2))
    log(f"[sketch] the main path's index batch {tuple(c.shape)}: {got.n} "
        f"minimizers, kernels == plain")
    for hpc in (False, True):
        store, rows = hifi_sketch_rows(hpc)
        c, l_, o1, o2 = _batch_tensors(dev, store, rows)
        _, got = compare_sketch(f"the HiFi batch, hpc={hpc}", c, l_, 51, 51,
                                2 * 32 * CHUNK_LP // 51 + 1024, own=(o1, o2),
                                hpc=hpc)
        log(f"[sketch] the HiFi batch {tuple(c.shape)} at k = w = 51, "
            f"hpc={hpc}: {got.n} minimizers, kernels == plain")
    view, ml = mesh_sized_codes(dev, rng)
    B, top = view.shape
    _, got = compare_sketch("a mesh-sized launch", view, ml, s1["k"],
                            s1["w"], B * top)
    log(f"[sketch] a mesh-sized launch {B} x {top} (> {CHUNK_LP} columns, "
        f"pitch {view.stride(0)}): {got.n} minimizers, kernels == plain "
        f"({time.time() - t0:.1f}s in all)")
    return dict(main=main, index=index)


def _sketch_bounds(name, B, L, n, nvalid, k=15, hpc=False, own=True):
    """(bytes, int32 operations) the kernel's work needs: each input read
    once, each output written once; nvalid positions lie inside their
    rows' lengths, the rest is padding that needs no work.
    sketch_minimizers: a code byte read a valid position, the rows' lengths
    and gates, 32 B written a minimizer (and 8 B of pos_map read under
    hpc), n_all; per valid position the least work of a canonical hash
    over the ceil(k / 16) lanes that carry bases (a leading empty lane's
    hash is a constant): rolling fwd and rc k-mers (3 instructions a lane
    each), the lane compare, mix32 a lane (9), then the window minimum and
    the selection (~8).  hpc_compress: a byte read a valid position and 9 B
    written a position."""
    lanes = -(-k // 16)
    if name == "sketch_minimizers":
        byt = nvalid + B * (4 + (8 if own else 0)) \
            + n * (32 + (8 if hpc else 0)) + 8
        ops = nvalid * (16 * lanes + 8)
    else:
        byt = nvalid + B * L * 9 + B * 8
        ops = nvalid * 4
    return byt, ops


def _valid_positions(lens, L):
    """Positions inside their rows' lengths: the sum of min(len_b, L)."""
    return int(lens.clamp(0, L).sum())


def plain_launches(fn):
    """Device kernels one call of fn launches, by torch.profiler (None
    where the profiler saw no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def sketch_sass(src):
    """{kernel: dict(registers, spill_bytes, stack_bytes, sass)} of a CUDA
    source of csrc/ (sketch.cu, route.cu) for sm_90a: `nvcc -Xptxas -v` to a
    cubin, and the SASS instructions of each kernel (a template instance
    named with its int or bool argument) counted in `cuobjdump -sass`."""
    import re
    from nextdenovo_tpu_torch import _build
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "s.cubin")
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v",
                            "-cubin", "-o", cubin, src],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc {src} failed:\n{r.stdout}{r.stderr}")
        d = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                            "-sass", cubin], capture_output=True, text=True,
                           check=True).stdout

    def short(mangled):
        m = re.search(r"(\w+?_kernel)(?:IL[ib](\d+)E)?", mangled)
        return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")

    out, cur = {}, None
    for line in (r.stdout + r.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = short(m.group(1))
            out[cur] = dict(registers=None, spill_bytes=None,
                            stack_bytes=None, sass=0)
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and cur:
            out[cur]["stack_bytes"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            out[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    cur = None
    for line in d.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = short(m.group(1))
            out.setdefault(cur, dict(registers=None, spill_bytes=None,
                                     sass=0))
        elif cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            out[cur]["sass"] += 1
    return out


def _sketch_shape_timing(dev, tag, codes, lens, lo, hi, k, w, cap,
                         wide=False):
    """One shape: sketch_minimizers alone (its memset and launch only, CUDA
    events after a device sleep), the whole wrapper call (host sync
    included) and the device operations of one call (torch.profiler), the
    plain versions' select and emit steps and whole call on the card, the
    plain call's device kernels, and torch.nonzero of the selected flags
    (the compaction's indices only)."""
    import torch
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.ops import sketch as S
    lib = _build.kernels()
    sb = S._buffers(codes, lens, k, w, cap, lo, hi)
    ms = _events_ms(lambda: S._minimizers_launch(lib, sb, k, w))
    call = (lambda: S.sketch_wide(codes, lens, k, w, cap, own_lo=lo,
                                  own_hi=hi)) if wide else \
        (lambda: S.sketch(codes, lens, k, w, cap, own_lo=lo, own_hi=hi))
    plain = (S.sketch_wide_plain if wide else S.sketch_plain)
    pcall = lambda: plain(codes, lens, k, w, cap, own_lo=lo, own_hi=hi)
    m, call_ms = timed(call, 5)
    _, pcall_ms = timed(pcall, 3)
    hsp, stp, selp = S.select_plain(codes, lens, k, w, lo, hi, wide=wide)
    _, psel_ms = timed(lambda: S.select_plain(codes, lens, k, w, lo, hi,
                                              wide=wide), 3)
    _, pemit_ms = timed(lambda: S.emit_plain(hsp, stp, selp, cap), 3)
    flat = selp.reshape(-1)
    nonzero_ms = _events_ms(lambda: torch.nonzero(flat))
    n_pl = plain_launches(pcall)
    n_ops = plain_launches(call)
    B, L = codes.shape
    np_ = lib.ndt_sketch_layout(B, L, k, w)
    out = {}
    _sketch_record(out, tag, m, pcall())
    nvalid = _valid_positions(lens, L)
    out["sketch_minimizers"].update(
        ms=ms, plain_ms=pcall_ms, library_ms=None, nonzero_ms=nonzero_ms,
        wrapper_ms=call_ms, call_device_ops=n_ops, plain_select_ms=psel_ms,
        plain_emit_ms=pemit_ms, plain_call_launches=n_pl,
        shape=f"{B} x {L}, k={k}, w={w}, {m.n} minimizers, tiles of "
              f"{np_ - 2 * (w - 1)} ({np_ // S.SKETCH_THREADS} positions a "
              f"thread)",
        valid_positions=nvalid,
        **_bound(*_sketch_bounds("sketch_minimizers", B, L, m.n, nvalid, k)))
    r = out["sketch_minimizers"]
    log(f"[timing] sketch at {tag} ({r['shape']}): sketch_minimizers alone "
        f"{ms:.4f} ms (its memset and launch; bound {r['bound_ms']:.5f}, "
        f"{r['bound_by']}); the wrapper's call {call_ms:.4f} ms in {n_ops} "
        f"device operations; torch.nonzero of the selected flags "
        f"{nonzero_ms:.4f} ms; plain on the card: select {psel_ms:.3f} ms, "
        f"emit {pemit_ms:.3f} ms, call {pcall_ms:.3f} ms in {n_pl} device "
        f"kernels")
    return out


SKETCH_SHAPE_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "wrapper_ms",
                     "nonzero_ms", "call_device_ops", "plain_call_launches",
                     "shape")


def sketch_timing(dev, batches):
    """The sketch kernel at its paths' shapes: the main path's 16-row
    stage-01 query batch (k = 15, w = 5; the kernels line's figures), a
    32-row batch of its index build (index_*) and the HiFi batch's 32
    longest chunk rows at k = w = 51 (hifi_*); the kernels' registers,
    spills and SASS instructions; hpc_compress alone on the HiFi batch's
    hpc rows, against hpc_compress_plain.  Returns {name: result}."""
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.ops import sketch as S
    from nextdenovo_tpu_torch.overlap.engine import CHUNK_LP
    s1 = STAGE01
    codes, lens, lo, hi = batches["main"]
    out = _sketch_shape_timing(dev, "the main path's batch", codes, lens, lo,
                               hi, s1["k"], s1["w"],
                               2 * 16 * CHUNK_LP // s1["w"] + 1024)
    codes, lens, lo, hi = batches["index"]
    idx = _sketch_shape_timing(dev, "the main path's index batch", codes,
                               lens, lo, hi, s1["k"], s1["w"],
                               2 * 32 * CHUNK_LP // s1["w"] + 1024)
    store, rows = hifi_sketch_rows()
    c, l_, o1, o2 = _batch_tensors(dev, store, rows)
    hifi = _sketch_shape_timing(dev, "the HiFi batch", c, l_, o1, o2, 51, 51,
                                2 * 32 * CHUNK_LP // 51 + 1024, wide=True)
    for pre, r in (("index", idx), ("hifi", hifi)):
        out["sketch_minimizers"].update(
            {f"{pre}_{k_}": r["sketch_minimizers"][k_]
             for k_ in SKETCH_SHAPE_KEYS})
    sass = sketch_sass(os.path.join(_build.CSRC_DIR, "sketch.cu"))
    out["sketch_minimizers"]["sass"] = sass
    log("[timing] sketch.cu for sm_90a: " + "; ".join(
        f"{k_}: {v['registers']} registers, {v['spill_bytes']} B spills, "
        f"{v['sass']} SASS instructions" for k_, v in sass.items()))
    store, rows = hifi_sketch_rows(hpc=True)
    c, l_, _, _ = _batch_tensors(dev, store, rows)
    B, L = c.shape
    ms = _events_ms(lambda: S._hpc_launch(c, l_))
    _, pms = timed(lambda: S.hpc_compress_plain(c, l_), 3)
    res = {}
    _record(res, "the HiFi batch's hpc rows", "hpc_compress",
            S.hpc_compress(c, l_), S.hpc_compress_plain(c, l_))
    out["hpc_compress"] = dict(
        res["hpc_compress"], ms=ms, plain_ms=pms,
        plain_call_launches=plain_launches(
            lambda: S.hpc_compress_plain(c, l_)),
        shape=f"{B} x {L} (the HiFi batch's hpc rows)",
        **_bound(*_sketch_bounds("hpc_compress", B, L, 0,
                                 _valid_positions(l_, L))))
    log(f"[timing] hpc_compress at {out['hpc_compress']['shape']}: "
        f"{ms:.4f} ms (bound {out['hpc_compress']['bound_ms']:.4f}, "
        f"{out['hpc_compress']['bound_by']}); plain on the card {pms:.3f} ms "
        f"in {out['hpc_compress']['plain_call_launches']} device kernels")
    return out


def phase_fast_path(dev):
    """band_align(R=1) through the package's entry on a few hundred ~2 kb
    pairs: the card against the CPU.  Returns the launch counts of the
    card's call."""
    import numpy as np
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.ops.align import band_align
    rng = np.random.default_rng(13)
    qs, ts = make_pairs(rng, 256, 1500, 2500)
    _build.reset_launches()
    t0 = time.time()
    a = band_align(qs, ts, R=1, device=dev)
    wall = time.time() - t0
    launches = dict(_build.LAUNCHES)
    b = band_align(qs, ts, R=1, device="cpu")
    for i, (x, y) in enumerate(zip(a, b)):
        if not (x["dist"] == y["dist"] and x["ok"] == y["ok"]
                and x["reached"] == y["reached"]
                and np.array_equal(x["ops"], y["ops"])):
            raise RuntimeError(f"band_align(R=1) differs between the card "
                               f"and the CPU on pair {i}")
    n_ok = sum(r["ok"] and r["reached"] for r in a)
    log(f"[fast_path] band_align(R=1): {len(a)} pairs equal on card and "
        f"CPU, {n_ok} ok, card call {wall:.2f}s, launches "
        f"{json.dumps({k: launches[k] for k in FAST_PATH_KERNELS})}")
    for k in FAST_PATH_KERNELS:
        if launches[k] == 0:
            raise RuntimeError(f"kernel {k} was not launched by "
                               "band_align(R=1)")
    if n_ok < 0.9 * len(a):
        raise RuntimeError(f"band_align(R=1): only {n_ok}/{len(a)} pairs ok")
    return launches


def _write_run(workdir, reads, cfg_text):
    """reads.fa, input.fofn and run.cfg under workdir; returns the cfg path."""
    from nextdenovo_tpu_torch.io.fastx import write_fasta
    write_fasta(os.path.join(workdir, "reads.fa"),
                [(f"r{i}", r) for i, r in enumerate(reads)])
    with open(os.path.join(workdir, "input.fofn"), "w") as fh:
        fh.write("reads.fa\n")
    cfg_p = os.path.join(workdir, "run.cfg")
    with open(cfg_p, "w") as fh:
        fh.write(cfg_text)
    return cfg_p


def _extender_work(tracer):
    """(tail pairs, mean m + n) that the run handed to affine_extend."""
    spans = [s_ for s_ in tracer.spans if s_.name == "kernel/affine_extend"]
    pairs = int(sum(s_.attrs["pairs"] for s_ in spans))
    cells = int(sum(s_.attrs["band_cells"] for s_ in spans))
    return pairs, (cells / 128 / pairs - 1 if pairs else 0.0)


def phase_ext_path(dev, workdir, genome_size=300_000):
    """input_type = corrected, task = assemble through the CLI entry on
    reads of a genome with repeats.  Returns (launch counts, tail pairs,
    their mean m + n)."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.__main__ import main as cli_main
    from nextdenovo_tpu_torch.io.fastx import read_fastx
    from nextdenovo_tpu_torch.io.simulate import simulate_genome, simulate_reads
    from nextdenovo_tpu_torch.utils import get_tracer
    from nextdenovo_tpu_torch.utils.asm_metrics import (kmer_identity,
                                                         misassembly_count)
    genome = simulate_genome(genome_size, seed=5, repeat_frac=0.1,
                             repeat_len=5000)
    sim = simulate_reads(genome, coverage=15, mean_len=MEAN_LEN,
                         error_rate=0.01, seed=6)
    cfg_p = _write_run(
        workdir, sim.reads,
        "[General]\ntask = assemble\ninput_type = corrected\n"
        "read_type = ont\ninput_fofn = input.fofn\nworkdir = wd\n"
        f"[correct_option]\ngenome_size = {genome_size}\n")
    tracer = get_tracer()
    tracer.reset()
    _build.reset_launches()
    t0 = time.time()
    rc = cli_main(["run", cfg_p])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_build.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"CLI entry returned {rc}")
    wd = os.path.join(workdir, "wd")
    for st in ("00.db", "04.cns_align", "05.ctg_graph", "06.ctg_cns"):
        if not os.path.exists(os.path.join(wd, st, ".done")):
            raise RuntimeError(f"stage {st} left no .done marker")
    pairs, mean_mn = _extender_work(tracer)
    log(f"[ext_path] task=assemble on {len(sim.reads)} corrected reads of a "
        f"{genome_size} bp genome with repeats: wall {wall:.1f}s, launches "
        f"{json.dumps(launches)}; stage 04 handed the extender {pairs} tail "
        f"pairs, mean m+n {mean_mn:.0f}")
    if launches["ext_fwd"] < 1 or pairs < 1:
        raise RuntimeError("kernel ext_fwd was not launched by stage 04")
    contigs = [c for _, c in read_fastx(os.path.join(wd, "06.ctg_cns",
                                                     "nd.asm.fasta"))]
    if not contigs:
        raise RuntimeError("task = assemble produced no contig")
    lens_c = np.array([len(c) for c in contigs])
    kid = kmer_identity(contigs, [genome])
    log(f"[ext_path] contigs {len(contigs)}, total {int(lens_c.sum())}, "
        f"longest {int(lens_c.max())}; 31-mer identity {kid:.4f}; "
        f"misassemblies {json.dumps(misassembly_count(contigs, genome))}")
    if kid < 0.9:
        raise RuntimeError(f"contig 31-mer identity {kid:.4f} below 0.9")
    if not 0.5 * genome_size < lens_c.sum() < 1.6 * genome_size:
        raise RuntimeError(f"contig total {int(lens_c.sum())} outside "
                           f"0.5-1.6 x genome")
    return launches, pairs, mean_mn


def phase_main_path(dev, genome_size, workdir):
    """Simulate reads, run task = all through the CLI entry, check the
    corrected reads and the contigs.  Returns (launch counts, facts for the
    report)."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.__main__ import main as cli_main
    from nextdenovo_tpu_torch.io.simulate import simulate_genome, simulate_reads
    from nextdenovo_tpu_torch.utils import get_tracer

    t0 = time.time()
    genome = simulate_genome(genome_size, seed=1)
    sim = simulate_reads(genome, coverage=COVERAGE, mean_len=MEAN_LEN,
                         error_rate=ERROR_RATE, seed=2)
    cfg_p = _write_run(
        workdir, sim.reads,
        "[General]\ntask = all\ninput_type = raw\n"
        "read_type = ont\ninput_fofn = input.fofn\nworkdir = wd\n"
        f"[correct_option]\ngenome_size = {genome_size}\n")
    log(f"[main_path] simulated {len(sim.reads)} reads, "
        f"{sum(len(r) for r in sim.reads)} bases in {time.time() - t0:.1f}s")

    tracer = get_tracer()
    tracer.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.time()
    rc = cli_main(["run", cfg_p])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"CLI entry returned {rc}")
    log(f"[main_path] task=all wall {wall:.1f}s, peak device memory "
        f"{peak / 2**20:.0f} MiB, launches {json.dumps(launches)}")
    log("[main_path] spans:\n" + tracer.summary())
    retry_pairs = [int(s.attrs.get("pairs", 0)) for s in tracer.spans
                   if s.name == "kernel/band_retry"]
    myers_pairs = [int(s.attrs.get("pairs", 0)) for s in tracer.spans
                   if s.name == "kernel/myers_tier"]
    log(f"[main_path] Myers tier: {sum(myers_pairs)} pairs in "
        f"{len(myers_pairs)} calls; retry tier: {sum(retry_pairs)} pairs in "
        f"{len(retry_pairs)} calls"
        + ("" if retry_pairs else " (the retry tier saw zero pairs at this "
           "workload)"))

    batches = [(int(s_.attrs["pairs"]), int(s_.attrs["columns"]))
               for s_ in tracer.spans if s_.name == "kernel/myers_batch"]
    if len(batches) != launches["myers_fwd"]:
        raise RuntimeError(f"{len(batches)} Myers sub-batches recorded for "
                           f"{launches['myers_fwd']} myers_fwd launches")
    dist = lambda v: (f"min {int(np.min(v))} / median {int(np.median(v))} / "
                      f"max {int(np.max(v))}")
    log(f"[main_path] myers_fwd / myers_tb launches: {len(batches)}; pairs "
        f"a launch {dist([b for b, _ in batches])}; columns a launch "
        f"{dist([c for _, c in batches])}")

    wd = os.path.join(workdir, "wd")
    marks = _stage_report("main_path", tracer, t0, wd)
    at = lambda st, k: int(marks[st].attrs[k])
    by_name = {}
    for s_ in tracer.spans:
        by_name.setdefault(s_.name, []).append(s_)
    _engine_report("main_path", marks, by_name)
    _stage01_split("main_path", marks, by_name)
    for name in ("cns_align", "ctg_graph", "ctg_align", "ctg_cns"):
        if name not in by_name:
            raise RuntimeError(f"span {name} was not recorded")
        log(f"[main_path] span {name}: {by_name[name][0].wall:.1f}s "
            f"{json.dumps(by_name[name][0].attrs)}")
    # on this repeat-free genome every realigned overlap ends within 32
    # bases of a read end, so stage 04 has no tail pair for the extender
    # (phase_ext_path drives it)
    ext_pairs, _ = _extender_work(tracer)
    log(f"[main_path] stage 04 handed the extender {ext_pairs} tail pairs, "
        f"{launches['ext_fwd']} launch(es)")
    if (ext_pairs > 0) != (launches["ext_fwd"] > 0):
        raise RuntimeError("extender calls and ext_fwd launches disagree")
    for name in ("myers_fwd", "myers_tb"):
        if at("06.ctg_cns", name) <= at("05.ctg_graph", name):
            raise RuntimeError(f"stage 06 did not launch {name}")
        if at("04.cns_align", name) <= at("03.seed_cns", name):
            raise RuntimeError(f"stage 04 did not launch {name}")
    t06 = marks["05.ctg_graph"].t0
    retry06 = [s_ for s_ in by_name.get("kernel/band_retry", [])
               if s_.t0 >= t06]
    log(f"[main_path] stage 06 retry tier: "
        f"{sum(int(s_.attrs['pairs']) for s_ in retry06)} pairs in "
        f"{len(retry06)} calls")
    for name in ("wave_fwd", "wave_tb"):
        if retry06 and at("06.ctg_cns", name) <= at("05.ctg_graph", name):
            raise RuntimeError(f"stage 06 retried pairs without launching "
                               f"{name}")
    for name in ("myers_fwd", "myers_tb"):
        if launches[name] == 0:
            raise RuntimeError(f"kernel {name} was not launched on the main path")
    if retry_pairs and (launches["wave_fwd"] == 0 or launches["wave_tb"] == 0):
        raise RuntimeError("retry tier ran without launching the wave kernels")
    _check_result("main_path", dev, wd, sim, genome)
    return launches, dict(wall_s=wall, peak_bytes=peak,
                          retry_pairs=max(retry_pairs, default=0),
                          sim=sim, genome=genome)


def _check_result(tag, dev, wd, sim, genome):
    """The limits of PERF.md section 2 on a task = all run of the simulated
    reads: at least 80 % of the seeds that stage 02 did not blacklist come
    back corrected, at identity >= 0.98 against their truth; the longest
    contig > 0.6 x and the total < 1.6 x the genome, 31-mer identity
    >= 0.9."""
    import numpy as np
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    if not os.path.exists(os.path.join(wd, "03.seed_cns", "cns.fasta")):
        raise RuntimeError("cns.fasta missing")
    meta = json.load(open(os.path.join(wd, "00.db", "meta.json")))
    n_seeds = int(np.sum(meta["seed_mask"]))
    n_black = len(json.load(open(os.path.join(wd, "02.sort_align", "bl.json"))))
    cns = SeqStore.load(os.path.join(wd, "03.seed_cns", "cns"))
    # stage 02 blacklists contained / chimeric seeds on purpose; of the
    # seeds it lets through, at least 80 % must come back corrected
    frac = len(cns) / max(1, n_seeds - n_black)
    log(f"[{tag}] seeds {n_seeds} (cutoff {meta['seed_cutoff']}), "
        f"blacklisted by sort_align {n_black}, corrected {len(cns)} "
        f"= {frac:.3f} of the seeds that were not blacklisted "
        f"({len(cns) / max(1, n_seeds):.3f} of all seeds)")
    if frac < 0.8:
        raise RuntimeError(f"only {frac:.3f} of the eligible seeds came "
                           "back corrected")
    _check_identity(tag, dev, wd, cns, sim, genome, 0.98)
    # the assembly against the simulated genome
    longest, total, kid = _contig_report(tag, wd, genome)
    if longest <= 0.6 * len(genome):
        raise RuntimeError(f"longest contig {longest} <= 0.6 x genome")
    if total >= 1.6 * len(genome):
        raise RuntimeError(f"contig total {total} >= 1.6 x genome")
    if kid < 0.9:
        raise RuntimeError(f"contig 31-mer identity {kid:.4f} below 0.9")


STAGES = ("00.db", "01.raw_align", "02.sort_align", "03.seed_cns",
          "04.cns_align", "05.ctg_graph", "06.ctg_cns")


def _stage_report(tag, tracer, t0, wd):
    """Every stage of task = all left its .done marker; print each stage's
    wall (the time between two markers' spans) and the launch counts at its
    end (run.py records them as spans).  Returns the marker spans."""
    for st in STAGES:
        if not os.path.exists(os.path.join(wd, st, ".done")):
            raise RuntimeError(f"stage {st} left no .done marker")
    marks = {s_.name[len("launches/"):]: s_ for s_ in tracer.spans
             if s_.name.startswith("launches/")}
    prev_t = t0
    for st in STAGES:
        log(f"[{tag}] stage {st}: wall {marks[st].t0 - prev_t:.1f}s, "
            f"launches so far {json.dumps(marks[st].attrs)}")
        prev_t = marks[st].t0
    return marks


def _engine_report(tag, marks, by_name):
    """The engine's and the sketch's kernels launched in each stage that
    runs the engine (01, 04 and 06; build_index's and find_overlaps'
    batches), and engine/match's wall in each; fails where a kernel was
    launched no time."""
    prev = {"01.raw_align": "00.db", "04.cns_align": "03.seed_cns",
            "06.ctg_cns": "05.ctg_graph"}
    rows = []
    for st, before in prev.items():
        n = {k_: int(marks[st].attrs[k_]) - int(marks[before].attrs[k_])
             for k_ in ENGINE_KERNELS + SKETCH_KERNELS}
        t_a, t_b = marks[before].t0, marks[st].t0
        em = [s_ for s_ in by_name.get("engine/match", [])
              if t_a <= s_.t0 < t_b]
        rows.append(f"{st}: {json.dumps(n)}, engine/match "
                    f"{sum(s_.wall for s_ in em):.2f}s over {len(em)} batches")
        for k_, v in n.items():
            if v < 1:
                raise RuntimeError(f"{tag}: stage {st} launched no {k_}")
    log(f"[{tag}] engine kernels by stage: " + "; ".join(rows))


def _stage01_split(tag, marks, by_name):
    """Stage 01's index build split into its sketch batches
    (engine/index_sketch: the kernels and the read back of each batch's
    count) and the rest (copies to the host, the host sort, the index's
    upload), and engine/host_fill (the queries' sketch batches)."""
    t01 = marks["01.raw_align"].t0
    in01 = lambda n: [s_ for s_ in by_name.get(n, []) if s_.t0 < t01]
    bi = sum(s_.wall for s_ in in01("raw_align/build_index"))
    sk, hf = in01("engine/index_sketch"), in01("engine/host_fill")
    sk_s = sum(s_.wall for s_ in sk)
    log(f"[{tag}] stage 01: raw_align/build_index {bi:.3f}s, of which its "
        f"sketch (engine/index_sketch) {sk_s:.3f}s over {len(sk)} batches "
        f"and the rest {bi - sk_s:.3f}s; engine/host_fill (the queries' "
        f"sketch) {sum(s_.wall for s_ in hf):.3f}s over {len(hf)} batches")


def _check_identity(tag, dev, wd, cns, sim, genome, limit, window=None):
    """Identity of up to 200 corrected reads (and 50 raw ones) against their
    true genome interval, aligned on the card; fails below `limit` or when
    under 90 % of the corrected reads align.  window(c, g), when given, cuts
    the interval g to the part that corrected read c covers (None: c counts
    as not aligned).  Prints how much of its seed each corrected read kept.
    Returns (mean identity, each read's kept share, each read's seed)."""
    import numpy as np
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    from nextdenovo_tpu_torch.ops.align import band_align
    rng = np.random.default_rng(3)
    pick = rng.choice(len(cns), size=min(200, len(cns)), replace=False)

    def truth(rid):
        g = genome[int(sim.start[rid]) : int(sim.end[rid])]
        return (g[::-1] ^ 3) if int(sim.strand[rid]) else g

    def identities(seqs, targets):
        pairs = [(s, t) for s, t in zip(seqs, targets) if t is not None]
        res = band_align([s.astype(np.int8) for s, _ in pairs],
                         [np.ascontiguousarray(t).astype(np.int8)
                          for _, t in pairs], device=dev)
        return [1.0 - r["dist"] / max(1, len(s))
                for (s, _), r in zip(pairs, res) if r["ok"]]

    # a corrected read is named by its seed's id in the stage-00 store,
    # whose reads carry the simulated reads' names r<index>
    reads = SeqStore.load(os.path.join(wd, "00.db", "reads"))
    seeds = np.array([int(cns.names[int(i)]) for i in pick])
    rids = [int(reads.names[s][1:]) for s in seeds]
    cs = [cns.get(int(i)) for i in pick]
    kept = np.array([len(c) / int(reads.length[s]) for c, s in zip(cs, seeds)])
    cut = window or (lambda c, g: g)
    ide_c = identities(cs, [cut(c, truth(r)) for c, r in zip(cs, rids)])
    ide_r = identities([sim.reads[r] for r in rids[:50]],
                       [truth(r) for r in rids[:50]])
    mc = float(np.mean(ide_c)) if ide_c else 0.0
    mr = float(np.mean(ide_r))
    w = int(np.argmin(kept))
    log(f"[{tag}] identity vs truth{' they cover' if window else ''}: "
        f"corrected {mc:.4f} over {len(ide_c)}/{len(pick)} aligned reads; "
        f"raw {mr:.4f} over {len(ide_r)} reads; length kept of the seed: "
        f"median {np.median(kept):.3f}, {int((kept < 0.9).sum())} of "
        f"{len(kept)} below 0.9, least {kept[w]:.3f} (seed {seeds[w]}, "
        f"{int(reads.length[seeds[w]])} -> {len(cs[w])} bases)")
    if len(ide_c) < 0.9 * len(pick) or mc < limit:
        raise RuntimeError(f"corrected-read identity {mc:.4f} over "
                           f"{len(ide_c)}/{len(pick)} reads, below {limit}")
    return mc, kept, seeds


def _contig_report(tag, wd, genome):
    """Print the contigs of nd.asm.fasta against the simulated genome
    (N50, total, longest, 31-mer identity before and after polishing,
    misassemblies).  Returns (longest, total, 31-mer identity)."""
    import numpy as np
    from nextdenovo_tpu_torch.io.fastx import read_fastx
    from nextdenovo_tpu_torch.io.seqstore import SeqStore, stat_n50
    from nextdenovo_tpu_torch.utils.asm_metrics import (kmer_identity,
                                                         misassembly_count)
    contigs = [c for _, c in read_fastx(os.path.join(wd, "06.ctg_cns",
                                                     "nd.asm.fasta"))]
    if not contigs:
        raise RuntimeError("task = all produced no contig")
    lens_c = np.array([len(c) for c in contigs])
    st_c = stat_n50(lens_c)
    total, longest = int(lens_c.sum()), int(lens_c.max())
    kid = kmer_identity(contigs, [genome])
    mis = misassembly_count(contigs, genome)
    draft = SeqStore.load(os.path.join(wd, "05.ctg_graph", "draft"))
    kid_draft = kmer_identity([draft.get(i) for i in range(len(draft))],
                              [genome])
    log(f"[{tag}] contigs {len(contigs)}, N50 {st_c['N50'][0]}, total "
        f"{total}, longest {longest} of a {len(genome)} bp genome; 31-mer "
        f"identity {kid:.4f} (draft before polish {kid_draft:.4f}); "
        f"misassemblies {json.dumps(mis)}")
    return longest, total, kid


def phase_hifi_path(dev, genome_size, workdir):
    """read_type = hifi, task = all through the CLI entry: the k = 51,
    w = 51 long-kmer raw sketch (reads over CHUNK_LP halo-chunked), the
    kmer/phasing consensus, then stages 04-06 as for ONT.  Launch counters
    at 0 and peak memory reset just before.  Returns the launch counts."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.__main__ import main as cli_main
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    from nextdenovo_tpu_torch.io.simulate import simulate_genome, simulate_reads
    from nextdenovo_tpu_torch.overlap.engine import CHUNK_LP
    from nextdenovo_tpu_torch.utils import get_tracer

    t0 = time.time()
    genome = simulate_genome(genome_size, seed=3)
    sim = simulate_reads(genome, coverage=HIFI_COVERAGE,
                         mean_len=HIFI_MEAN_LEN, error_rate=HIFI_ERROR_RATE,
                         seed=4, min_len=4000)
    cfg_p = _write_run(
        workdir, sim.reads,
        "[General]\ntask = all\ninput_type = raw\n"
        "read_type = hifi\ninput_fofn = input.fofn\nworkdir = wd\n"
        f"[correct_option]\ngenome_size = {genome_size}\n")
    lens = np.array([len(r) for r in sim.reads])
    log(f"[hifi_path] simulated {len(sim.reads)} reads, {int(lens.sum())} "
        f"bases ({int((lens > CHUNK_LP).sum())} longer than {CHUNK_LP}) in "
        f"{time.time() - t0:.1f}s")

    tracer = get_tracer()
    tracer.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.time()
    rc = cli_main(["run", cfg_p])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"CLI entry returned {rc}")
    log(f"[hifi_path] task=all read_type=hifi wall {wall:.1f}s, peak device "
        f"memory {peak / 2**20:.0f} MiB, launches {json.dumps(launches)}")
    log("[hifi_path] spans:\n" + tracer.summary())
    wd = os.path.join(workdir, "wd")
    marks = _stage_report("hifi_path", tracer, t0, wd)
    by_name = {}
    for s_ in tracer.spans:
        by_name.setdefault(s_.name, []).append(s_)
    _engine_report("hifi_path", marks, by_name)
    _stage01_split("hifi_path", marks, by_name)
    bi = by_name["raw_align/build_index"][0]
    kw = (int(bi.attrs["k"]), int(bi.attrs["w"]))
    # spans of stage 01 only: the engine also runs in stages 04 and 06
    t01 = marks["01.raw_align"].t0
    in01 = lambda n: sum(s_.wall for s_ in by_name.get(n, []) if s_.t0 < t01)
    log(f"[hifi_path] stage 01 at k={kw[0]} w={kw[1]}: raw_align "
        f"{in01('raw_align'):.1f}s, of which build_index (sketch of every "
        f"read, host sort) {bi.wall:.1f}s, engine/host_fill (the queries' "
        f"sketch) {in01('engine/host_fill'):.1f}s, engine/match "
        f"{in01('engine/match'):.1f}s")
    if kw != (51, 51):
        raise RuntimeError(f"the HiFi run sketched at k, w = {kw}, not 51, 51")
    if launches["myers_fwd"] == 0:
        raise RuntimeError("kernel myers_fwd was not launched on the HiFi path")
    pairs = lambda n: sum(int(s_.attrs["pairs"]) for s_ in by_name.get(n, []))
    ext_pairs, _ = _extender_work(tracer)
    log(f"[hifi_path] Myers tier {pairs('kernel/myers_tier')} pairs; retry "
        f"tier {pairs('kernel/band_retry')} pairs in "
        f"{len(by_name.get('kernel/band_retry', []))} calls; stage 04 handed "
        f"the extender {ext_pairs} tail pairs")
    meta = json.load(open(os.path.join(wd, "00.db", "meta.json")))
    n_black = len(json.load(open(os.path.join(wd, "02.sort_align",
                                              "bl.json"))))
    cns = SeqStore.load(os.path.join(wd, "03.seed_cns", "cns"))
    log(f"[hifi_path] seeds {int(np.sum(meta['seed_mask']))} (cutoff "
        f"{meta['seed_cutoff']}), blacklisted by sort_align {n_black}, "
        f"corrected {len(cns)}")
    # a corrected HiFi read can be much shorter than its seed (the native
    # HiFi consensus keeps part of it: PERF.md, tests/hifi_witness.py), so
    # each read is held against the part of its truth it covers, and what
    # the reads kept and the contigs' lengths are held as regression limits
    # under the shares measured on the card (median kept 0.660, longest
    # contig 0.418 x genome)
    _, kept, _ = _check_identity("hifi_path", dev, wd, cns, sim, genome, 0.98,
                                 window=_anchor)
    if np.median(kept) < 0.5:
        raise RuntimeError(f"corrected reads kept a median "
                           f"{np.median(kept):.3f} of their seed, below 0.5")
    longest, total, kid = _contig_report("hifi_path", wd, genome)
    log(f"[hifi_path] longest contig {longest / len(genome):.3f} x genome")
    if longest < 0.3 * len(genome):
        raise RuntimeError(f"longest contig {longest} below 0.3 x genome")
    if kid <= 0.95:
        raise RuntimeError(f"contig 31-mer identity {kid:.4f} not above 0.95")
    if not 0.5 * len(genome) < total < 1.6 * len(genome):
        raise RuntimeError(f"contig total {total} outside 0.5-1.6 x genome")
    return launches, hpc_index_scale(dev, sim.reads)


def hpc_index_scale(dev, reads):
    """build_index of the HiFi path's whole read set at k = w = 51 on the
    card, raw and then homopolymer-compressed (hpc; no stage calls it):
    each build's wall ended by a synchronise, its entries and its peak
    device memory above what was allocated before it.  Returns the launch
    counts of the hpc build (counters at 0 just before); fails where it
    launched no hpc_compress or sketch_minimizers."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    from nextdenovo_tpu_torch.overlap.engine import build_index
    store = SeqStore.from_codes(reads)
    rids = np.arange(len(store))
    n = {}
    for hpc in (False, True):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.time()
        idx = build_index(store, rids, k=51, w=51, max_occ=64, hpc=hpc,
                          device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - base
        n[hpc] = idx.n
        log(f"[hpc_index] {len(store)} reads, {int(store.total_bases)} bases,"
            f" k=51 w=51 hpc={hpc}: build_index wall {wall:.3f}s, "
            f"{idx.n} entries ({idx.h.shape[0]} rows), peak device memory "
            f"{peak / 2**20:.1f} MiB above {base / 2**20:.1f} MiB")
        del idx
    if not 0 < n[True] < n[False]:
        raise RuntimeError(f"the hpc index holds {n[True]} entries, the raw "
                           f"one {n[False]}")
    log(f"[hpc_index] the hpc build's launches {json.dumps(launches)}")
    for name in ("hpc_compress",) + SKETCH_KERNELS:
        if launches[name] < 1:
            raise RuntimeError(f"the hpc build launched no {name}")
    return launches


def _host_rows(wd, k):
    """Host k's `launches/<stage>` rows from its trace.h<k>.jsonl (the
    launch counts of its own process at each stage's end)."""
    p = os.path.join(wd, f"trace.h{k}.jsonl")
    if not os.path.exists(p):
        raise RuntimeError(f"host {k} left no trace.h{k}.jsonl (it did not "
                           "finish)")
    rows = {}
    for line in open(p):
        r = json.loads(line)
        if r["name"].startswith("launches/"):
            rows[r["name"][len("launches/"):]] = r
    missing = [st for st in STAGES if st not in rows]
    if missing:
        raise RuntimeError(f"host {k} recorded no launch row for {missing}")
    return rows


def phase_multihost_path(workdir, n_hosts=2, timeout_s=420):
    """The main path's reads and config in a fresh workdir, run as
    `python -m nextdenovo_tpu_torch launch run.cfg --hosts 2 --submit
    local`: two host processes on the one card share the workdir.  Each
    host process starts with its launch counters at 0; its trace.h<k>.jsonl
    holds them at every stage's end.  Checks that both hosts finished,
    wrote their parts, launched myers_fwd in stage 03, and that cns.fasta
    and nd.asm.fasta are byte for byte the main path's.  Returns each
    host's launches over the run."""
    import signal
    names = tuple(KERNEL_INFO)
    cfg_p = os.path.join(workdir, "run_mh.cfg")
    with open(cfg_p, "w") as fh:
        fh.write("[General]\ntask = all\ninput_type = raw\n"
                 "read_type = ont\ninput_fofn = input.fofn\nworkdir = wd_mh\n"
                 f"[correct_option]\ngenome_size = {GENOME_SIZE}\n")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    log_p = os.path.join(workdir, "launch.log")
    t0 = time.time()
    with open(log_p, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "nextdenovo_tpu_torch", "launch", cfg_p,
             "--hosts", str(n_hosts), "--submit", "local"],
            cwd=workdir, env=env, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            # the launcher and the hosts share its process group
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    wall = time.time() - t0
    tail = "".join(open(log_p).readlines()[-40:])
    if rc != 0:
        raise RuntimeError(f"launch --hosts {n_hosts} "
                           + ("timed out" if rc is None else f"returned {rc}")
                           + f" after {wall:.1f}s; its log ends:\n{tail}")
    wd, wd_main = os.path.join(workdir, "wd_mh"), os.path.join(workdir, "wd")
    for k in range(n_hosts):
        for rel in (f"03.seed_cns/cns.h{k}.npz", f"06.ctg_cns/map.h{k}.npz",
                    f"06.ctg_cns/pieces.h{k}.npz"):
            if not os.path.exists(os.path.join(wd, rel)):
                raise RuntimeError(f"host {k} wrote no {rel}")
    for rel in ("03.seed_cns/cns.fasta", "06.ctg_cns/nd.asm.fasta"):
        a = open(os.path.join(wd_main, rel), "rb").read()
        if not a or a != open(os.path.join(wd, rel), "rb").read():
            raise RuntimeError(f"{rel} of the {n_hosts}-host run differs "
                               "from the main path's")
    log(f"[multihost_path] launch --hosts {n_hosts} --submit local: wall "
        f"{wall:.1f}s (both host processes, from the launcher's start); "
        "cns.fasta and nd.asm.fasta byte-identical to main_path's")
    per_host, stage_rows = [], []
    for k in range(n_hosts):
        rows = _host_rows(wd, k)
        prev_t, prev = t0, dict.fromkeys(names, 0)
        walls, in_stage = [], {}
        for st in STAGES:
            walls.append(f"{st} {rows[st]['t0'] - prev_t:.1f}")
            in_stage[st] = {n: rows[st][n] - prev[n] for n in names
                            if rows[st][n] - prev[n]}
            prev_t, prev = rows[st]["t0"], rows[st]
        log(f"[multihost_path] host {k} stage walls s (00.db from the "
            f"launcher's start): {', '.join(walls)}")
        log(f"[multihost_path] host {k} launches by stage: "
            f"{json.dumps(in_stage)}")
        if in_stage["03.seed_cns"].get("myers_fwd", 0) < 1:
            raise RuntimeError(f"host {k} launched no myers_fwd in stage 03")
        for n in ENGINE_KERNELS + SKETCH_KERNELS:
            if in_stage["01.raw_align"].get(n, 0) < 1:
                raise RuntimeError(f"host {k} launched no {n} in stage 01")
        per_host.append({n: rows["06.ctg_cns"][n] for n in names})
        stage_rows.append(in_stage)
    for st in ("04.cns_align", "06.ctg_cns"):
        for n in ENGINE_KERNELS + SKETCH_KERNELS:
            if sum(r[st].get(n, 0) for r in stage_rows) < 1:
                raise RuntimeError(f"no host launched {n} in {st}")
    log(f"[multihost_path] launches per host: {json.dumps(per_host)}")
    return per_host


MESH_SHARDS = 8


def _first_diff(a_p, b_p):
    """Where two OvlBlock .npz files first differ, as text ("" if equal)."""
    import numpy as np
    a, b = dict(np.load(a_p)), dict(np.load(b_p))
    if sorted(a) != sorted(b):
        return f"fields {sorted(a)} against {sorted(b)}"
    fs = sorted(a)
    n_a, n_b = len(a[fs[0]]), len(b[fs[0]])
    n = min(n_a, n_b)
    bad = np.zeros(n, bool)
    for f in fs:
        bad |= a[f][:n] != b[f][:n]
    if bad.any():
        i = int(np.argmax(bad))
        return (f"record {i}: {({f: int(a[f][i]) for f in fs})} against "
                f"{({f: int(b[f][i]) for f in fs})}")
    return "" if n_a == n_b else f"{n_a} records against {n_b}"


def phase_mesh_path(dev, workdir, sim, genome, n_shards=MESH_SHARDS,
                    capture=False):
    """The main path's reads and config with use_mesh = 8 in a fresh
    workdir through the CLI entry: stages 01, 02, 03, 04 and 06 run the
    mesh path, eight shards on one card (the first: on a machine of several
    the CLI is given it as --device).  Launch counters at 0 and the
    peak memory reset just before.  Checks the markers, that raw.ovl and
    sorted.ovl equal the main path's and bl.json does once parsed (its
    seeds come in shard order), a launch of myers_fwd in each of stages 03,
    04 and 06, and the limits of PERF.md section 2; prints the stage walls,
    the launches by stage, the peak device memory and how many corrected
    reads are byte-equal to the main path's (the mesh path aligns long
    supports whole, so not all need be).  With capture, the run's first
    lookups, bucketings and seed route go into MESH_CALLS for phase_route
    and route_timing, and the peak device memory of each Mesh.for_each_card
    phase is printed (a synchronise and a reset of the peak around each;
    the run's peak is the largest over them and the gaps between).
    Returns the launch counts and the peak device memory."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.__main__ import main as cli_main
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    from nextdenovo_tpu_torch.utils import get_tracer

    # the main path's run.cfg with another workdir and use_mesh
    text = open(os.path.join(workdir, "run.cfg")).read()
    cfg_p = os.path.join(workdir, "run_mesh.cfg")
    with open(cfg_p, "w") as fh:
        fh.write(text.replace("workdir = wd\n", "workdir = wd_mesh\nuse_mesh = "
                              f"{n_shards}\n"))
    tracer = get_tracer()
    tracer.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    # one card: on a machine of several the CLI would spread the shards
    # over all of them (phase_mesh_cards runs that)
    one = (["--device", f"cuda:{torch.cuda.current_device()}"]
           if torch.cuda.device_count() > 1 else [])
    t0 = time.time()
    with (capture_mesh_calls() if capture else contextlib.nullcontext()), \
            (phase_memory() if capture else contextlib.nullcontext()) as mem:
        rc = cli_main(["run", cfg_p] + one)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if mem is not None:
        peak = max(peak, mem.top)
        log("[mesh_path] peak device memory by phase (MiB; calls, then "
            "before, peak, after of the call with the highest peak): "
            + "; ".join(f"{name} {k}: {b / 2**20:.1f}, {pk / 2**20:.1f}, "
                        f"{a / 2**20:.1f}"
                        for name, (k, b, pk, a) in mem.phases.items()))
    if rc != 0:
        raise RuntimeError(f"CLI entry returned {rc}")
    log(f"[mesh_path] task=all use_mesh={n_shards} wall {wall:.1f}s, peak "
        f"device memory {peak / 2**20:.0f} MiB, launches "
        f"{json.dumps(launches)}")
    log("[mesh_path] spans:\n" + tracer.summary())
    wd, wd_main = os.path.join(workdir, "wd_mesh"), os.path.join(workdir, "wd")
    marks = _stage_report("mesh_path", tracer, t0, wd)
    prev, in_stage = dict.fromkeys(launches, 0), {}
    for st in STAGES:
        now = {n: int(marks[st].attrs[n]) for n in launches}
        in_stage[st] = {n: now[n] - prev[n] for n in now if now[n] - prev[n]}
        prev = now
    log(f"[mesh_path] launches by stage: {json.dumps(in_stage)}")
    # spans of stage 01 only: the mesh overlap step also runs in 04 and 06
    t01 = marks["01.raw_align"].t0
    in01 = {n: sum(s_.wall for s_ in tracer.spans if s_.name == n
                   and s_.t0 < t01)
            for n in ("raw_align", "mesh/build_index", "mesh/sketch_route",
                      "mesh/lookup_route", "mesh/vote_emit")}
    log("[mesh_path] stage 01 spans: " + ", ".join(
        f"{n} {v:.2f}s" for n, v in in01.items()))
    for st in ("03.seed_cns", "04.cns_align", "06.ctg_cns"):
        if in_stage[st].get("myers_fwd", 0) < 1:
            raise RuntimeError(f"the mesh run launched no myers_fwd in {st}")
    # the mesh overlap step routes with route_count and route_scatter,
    # looks up with engine_anchor and votes with _vote_emit; the sort routes
    # its raw records by seed
    for st in ("01.raw_align", "04.cns_align", "06.ctg_cns"):
        for n in ("vote_corridor", "chain_emit", "engine_anchor",
                  *BUCKET_KERNELS):
            if in_stage[st].get(n, 0) < 1:
                raise RuntimeError(f"the mesh run launched no {n} in {st}")
    for n in SEED_ROUTE_KERNELS:
        if in_stage["02.sort_align"].get(n, 0) < 1:
            raise RuntimeError(f"the mesh run launched no {n} in "
                               f"02.sort_align")
    # stage 01 sketches each shard's rows (dist_overlap._sketch_shard)
    for n in SKETCH_KERNELS:
        if in_stage["01.raw_align"].get(n, 0) < 1:
            raise RuntimeError(f"the mesh run launched no {n} in 01.raw_align")
    for rel in ("01.raw_align/raw.ovl.npz", "02.sort_align/sorted.ovl.npz"):
        diff = _first_diff(os.path.join(wd_main, rel), os.path.join(wd, rel))
        if diff:
            raise RuntimeError(f"{rel} of the mesh run differs from the main "
                               f"path's: {diff}")
    bl_p = os.path.join("02.sort_align", "bl.json")
    bl_main = json.load(open(os.path.join(wd_main, bl_p)))
    bl_mesh = json.load(open(os.path.join(wd, bl_p)))
    if bl_main != bl_mesh:
        raise RuntimeError("bl.json of the mesh run differs from the main "
                           "path's")
    log(f"[mesh_path] raw.ovl and sorted.ovl equal to main_path's, bl.json "
        f"equal once parsed ({len(bl_mesh)} seeds; in the same key order: "
        f"{list(bl_main) == list(bl_mesh)})")
    main_cns = SeqStore.load(os.path.join(wd_main, "03.seed_cns", "cns"))
    mesh_cns = SeqStore.load(os.path.join(wd, "03.seed_cns", "cns"))
    by_name = {nm: main_cns.get(i).tobytes()
               for i, nm in enumerate(main_cns.names)}
    same = sum(by_name.get(nm) == mesh_cns.get(i).tobytes()
               for i, nm in enumerate(mesh_cns.names))
    asm = [open(os.path.join(w, "06.ctg_cns", "nd.asm.fasta"), "rb").read()
           for w in (wd_main, wd)]
    log(f"[mesh_path] corrected reads {len(mesh_cns)} (main path "
        f"{len(main_cns)}), {same} byte-equal to the main path's; "
        f"nd.asm.fasta byte-equal: {asm[0] == asm[1]}")
    _check_result("mesh_path", dev, wd, sim, genome)
    _mesh_cns_witness(wd, cfg_p, mesh_cns, n_shards)
    return launches, peak


class phase_memory:
    """Within the block, each Mesh.for_each_card phase on the current card
    runs between two synchronises with the peak memory reset before it:
    `phases` {name: (calls, before, peak, after)} keeps the call of the
    highest peak, `top` the highest peak read before any reset (the gaps
    between phases included)."""

    def __enter__(self):
        import torch
        from nextdenovo_tpu_torch.parallel import mesh as MS
        self.phases, self.top, self.each = {}, 0, MS.Mesh.for_each_card
        each = self.each

        def measured(mesh, name, fn):
            torch.cuda.synchronize()
            self.top = max(self.top, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out = each(mesh, name, fn)
            torch.cuda.synchronize()
            pk = torch.cuda.max_memory_allocated()
            self.top = max(self.top, pk)
            k, *was = self.phases.get(name, (0, 0, -1, 0))
            self.phases[name] = (k + 1, before, pk,
                                 torch.cuda.memory_allocated()) \
                if pk > was[1] else (k + 1, *was)
            return out

        MS.Mesh.for_each_card = measured
        return self

    def __exit__(self, *exc):
        from nextdenovo_tpu_torch.parallel import mesh as MS
        MS.Mesh.for_each_card = self.each


def _mesh_cns_witness(wd, cfg_p, mesh_cns, n_shards, n_long=2):
    """A few of the mesh run's seeds corrected again on the CPU:
    mesh_correction with device "cpu" (the plain versions, which
    tests/test_torch_mesh.py holds equal to the JAX package's mesh path) on
    the run's own store, sorted.ovl and bl.json cut to those seeds.  The
    seeds: the n_long with a (support, segment) pair over CORR_CHUNK_T whose
    longest pair is the shortest (the plain aligner's time grows with it),
    and of the two jobs on either side of distributed_correct's first group
    boundary (the job that filled the group, and the next) the one with
    the shorter longest pair.  Their corrected reads must be the card's,
    name for name and base for base."""
    import numpy as np
    from nextdenovo_tpu_torch.correct.driver import (CORR_CHUNK_T,
                                                     iter_seed_jobs)
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    from nextdenovo_tpu_torch.overlap.records import OvlBlock
    from nextdenovo_tpu_torch.parallel.dist_correct import GROUP_PAIRS
    from nextdenovo_tpu_torch.parallel.dist_pipeline import mesh_correction
    from nextdenovo_tpu_torch.parallel.mesh import make_mesh
    from nextdenovo_tpu_torch.pipeline.config import load_config
    from nextdenovo_tpu_torch.pipeline.run import correct_kw
    kw = correct_kw(load_config(cfg_p))
    store = SeqStore.load(os.path.join(wd, "00.db", "reads"))
    srt = OvlBlock.load(os.path.join(wd, "02.sort_align", "sorted.ovl"))
    bl = {int(k): v for k, v in json.load(open(
        os.path.join(wd, "02.sort_align", "bl.json"))).items()}
    jobs = list(iter_seed_jobs(
        srt, bl, np.asarray(store.length), min_len_seed=kw["min_len_seed"],
        min_len_aln=kw["min_len_aln"], min_cov_seed=kw["min_cov_seed"],
        max_cov_aln=kw["max_cov_aln"]))
    longest = {j.seed: max(max(se - ss, sqe - sqs) + 1
                           for (_, _, ss, se, sqs, sqe) in j.sups)
               for j in jobs}
    long_ = sorted((s_ for s_ in longest if longest[s_] > CORR_CHUNK_T),
                   key=longest.get)[:n_long]
    if len(long_) < n_long:
        raise RuntimeError(f"only {len(long_)} seeds of the mesh run have a "
                           f"pair over {CORR_CHUNK_T} bases")
    # distributed_correct's order: by owner shard, then job order
    owned = sorted(jobs, key=lambda j: j.seed % n_shards)
    cum = np.cumsum([len(j.sups) for j in owned])
    if cum[-1] <= GROUP_PAIRS:
        raise RuntimeError(f"the mesh run's {cum[-1]} pairs fill no group "
                           f"of {GROUP_PAIRS}")
    b = int(np.argmax(cum >= GROUP_PAIRS))
    edge = min(owned[b].seed, owned[b + 1].seed, key=longest.get)
    pick = sorted(set(long_ + [edge]))
    sub = srt.take(np.nonzero(np.isin(np.asarray(srt.qname), pick))[0])
    n_pairs = sum(len(j.sups) for j in jobs if j.seed in pick)
    t0 = time.time()
    cpu = mesh_correction(store, sub, bl, make_mesh(n_shards, "cpu"), **kw)
    cpu_s = time.time() - t0
    mine = {str(s_) for s_ in pick}
    card = [(nm, mesh_cns.get(i).tobytes())
            for i, nm in enumerate(mesh_cns.names)
            if nm.split("_")[0] in mine]
    plain = [(nm, cpu.get(i).tobytes()) for i, nm in enumerate(cpu.names)]
    if card != plain or not card:
        first = next((a[0] for a, b in zip(card, plain) if a != b), None)
        raise RuntimeError(
            f"mesh_path: seeds {pick} corrected on the CPU give "
            f"{[(nm, len(x)) for nm, x in plain]}, the card's run "
            f"{[(nm, len(x)) for nm, x in card]} (names, lengths); first "
            f"read that differs: {first}")
    log(f"[mesh_path] card == cpu: seeds {pick} (longest pairs "
        f"{[longest[s_] for s_ in pick]} bases, {n_pairs} pairs) give the "
        f"same {len(card)} corrected reads, base for base; CPU "
        f"{cpu_s:.1f}s")


def _same_results(a, b):
    """Two band_align result lists are equal pair for pair."""
    import numpy as np
    return len(a) == len(b) and all(
        x["dist"] == y["dist"] and bool(x["reached"]) == bool(y["reached"])
        and bool(x["ok"]) == bool(y["ok"])
        and np.array_equal(np.asarray(x["ops"]), np.asarray(y["ops"]))
        for x, y in zip(a, b))


def phase_mesh_groups(card, workdir, n_shards=MESH_SHARDS):
    """The mesh's shards in two groups on one card (make_mesh(8,
    devices=[card, card]): two host threads against one device) against
    one group (make_mesh(8, card)) on the main path's data, bit for
    bit: the stage-01 mesh overlap step (mesh_raw_align), then
    distributed_sort_filter on its records, then distributed_band_align on
    the first group of stage 03's pairs (distributed_correct's first
    GROUP_PAIRS).  Checks that the two-group calls ran each phase on both
    groups (their `<phase>/card` spans); prints each call's wall (ended by
    a synchronise) and launches."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.correct.driver import iter_seed_jobs
    from nextdenovo_tpu_torch.io.seqstore import SeqStore
    from nextdenovo_tpu_torch.parallel.dist_correct import (
        GROUP_PAIRS, distributed_band_align, group_pairs)
    from nextdenovo_tpu_torch.parallel.dist_pipeline import mesh_raw_align
    from nextdenovo_tpu_torch.parallel.dist_sort import \
        distributed_sort_filter
    from nextdenovo_tpu_torch.parallel.mesh import make_mesh
    from nextdenovo_tpu_torch.pipeline.config import load_config
    from nextdenovo_tpu_torch.pipeline.run import correct_kw
    from nextdenovo_tpu_torch.utils import get_tracer

    cfg = load_config(os.path.join(workdir, "run.cfg"))
    kw = correct_kw(cfg)
    wd = os.path.join(workdir, "wd")
    store = SeqStore.load(os.path.join(wd, "00.db", "reads"))
    meta = json.load(open(os.path.join(wd, "00.db", "meta.json")))
    seed_mask = np.asarray(meta["seed_mask"], bool)
    lens = np.asarray(store.length)
    meshes = (("one group", make_mesh(n_shards, card)),
              ("two groups", make_mesh(n_shards, devices=[card, card])))
    tracer = get_tracer()

    def run(what, tag, mesh, fn):
        n0 = len(tracer.spans)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.time()
        out = fn(mesh)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        groups = {s_.attrs["card"] for s_ in tracer.spans[n0:]
                  if s_.name.endswith("/card")}
        log(f"[mesh_groups] {what}, {tag}: wall {wall:.2f}s, launches "
            f"{json.dumps(launched)}, groups {sorted(groups)}")
        if len(groups) != len(mesh.devices):
            raise RuntimeError(f"mesh_groups: {what} on {tag} ran on "
                               f"{sorted(groups)}")
        return out

    raw = [run("mesh_raw_align", tag, m, lambda m: mesh_raw_align(
        store, seed_mask, m, k=cfg.raw_k, w=cfg.raw_w)) for tag, m in meshes]
    _same_blocks_or_fail(raw[0], raw[1], "mesh_groups: raw records")
    srt = [run("distributed_sort_filter", tag, m,
               lambda m: distributed_sort_filter(
                   raw[0], seed_mask, lens, m,
                   max_bin_cov=meta["sort_max_depth"]))
           for tag, m in meshes]
    _same_blocks_or_fail(srt[0].block, srt[1].block,
                         "mesh_groups: sorted records")
    if list(srt[0].blacklist.items()) != list(srt[1].blacklist.items()):
        raise RuntimeError("mesh_groups: the blacklists differ")
    jobs = list(iter_seed_jobs(
        srt[0].block, srt[0].blacklist, lens,
        min_len_seed=kw["min_len_seed"], min_len_aln=kw["min_len_aln"],
        min_cov_seed=kw["min_cov_seed"], max_cov_aln=kw["max_cov_aln"]))
    owned = sorted(jobs, key=lambda j: j.seed % n_shards)
    cum = np.cumsum([len(j.sups) for j in owned])
    group = owned[: int(np.argmax(cum >= GROUP_PAIRS)) + 1] \
        if cum[-1] >= GROUP_PAIRS else owned
    pairs, segs = group_pairs(store, group)
    res = [run(f"distributed_band_align of {len(pairs)} pairs", tag, m,
               lambda m: distributed_band_align([p[1] for p in pairs], segs,
                                                m)) for tag, m in meshes]
    if not _same_results(res[0], res[1]):
        raise RuntimeError("mesh_groups: distributed_band_align differs "
                           "between one and two groups")
    log(f"[mesh_groups] two groups on {card} equal one group bit for bit: "
        f"{len(raw[0])} raw records, {len(srt[0].block)} sorted records and "
        f"a blacklist of {len(srt[0].blacklist)} seeds, {len(pairs)} "
        f"alignments of {len(group)} seed jobs")


def _same_blocks_or_fail(a, b, what):
    import numpy as np
    if list(a.data) != list(b.data) or not all(
            np.array_equal(np.asarray(a.data[k]), np.asarray(b.data[k]))
            for k in a.data):
        raise RuntimeError(f"{what} differ")


def _same_stage_files(wd_a, wd_b):
    """Every file of stages 01-06 (the markers aside) of two workdirs is
    the same: .npz files array for array, the others byte for byte.
    Returns the number of files compared."""
    import numpy as np
    n = 0
    for st in STAGES[1:]:
        names = [sorted(f for f in os.listdir(os.path.join(w, st))
                        if not f.startswith(".")) for w in (wd_a, wd_b)]
        if names[0] != names[1]:
            raise RuntimeError(f"{st}: files {names[0]} against {names[1]}")
        for f in names[0]:
            a, b = (os.path.join(w, st, f) for w in (wd_a, wd_b))
            if f.endswith(".npz"):
                za, zb = (np.load(x, allow_pickle=True) for x in (a, b))
                same = sorted(za.files) == sorted(zb.files) and all(
                    np.array_equal(za[k], zb[k]) for k in za.files)
            else:
                same = open(a, "rb").read() == open(b, "rb").read()
            if not same:
                raise RuntimeError(f"{st}/{f} differs")
            n += 1
    return n


def phase_mesh_cards(dev, workdir, sim, genome, one_card_peak,
                     n_shards=MESH_SHARDS, timeout_s=420, wd_name="wd_cards",
                     n_cards=None):
    """The main path's reads and config with use_mesh = 8 through the CLI
    entry, in a process of its own that sees n_cards cards (default
    min(4, device_count()); CUDA_VISIBLE_DEVICES): the eight shards spread
    over them, one host thread a card.  Checks the markers, that raw.ovl
    and sorted.ovl equal the main path's, that every stage file equals the
    one-card mesh_path run's, that the run used every card and each card
    launched myers_fwd, vote_corridor and chain_emit, and the limits of
    PERF.md section 2.  Prints the stage walls, the launches by stage, each
    card's name, peak memory (against the one-card mesh run's: the Myers
    tier bounds its planes at 4 GiB a launch on every card, so a card's
    peak need not fall below it) and share of the index's entries, and the
    mesh/* and kernel/* spans by card.  Returns the launches over the run,
    or None on a machine of one card, where it does not run.  wd_name: the
    run's workdir under `workdir` (a second run needs another)."""
    import signal
    import torch
    count = torch.cuda.device_count()
    if count < 2:
        log(f"[mesh_cards] not run: this machine has {count} CUDA device, "
            "the phase needs a second card")
        return None
    n_cards = n_cards or min(4, count)
    text = open(os.path.join(workdir, "run.cfg")).read()
    cfg_p = os.path.join(workdir, f"run_{wd_name}.cfg")
    with open(cfg_p, "w") as fh:
        fh.write(text.replace("workdir = wd\n", f"workdir = {wd_name}\n"
                              f"use_mesh = {n_shards}\n"))
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    visible = (visible.split(",") if visible
               else [str(i) for i in range(count)])[:n_cards]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=",".join(visible),
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    log_p = os.path.join(workdir, f"{wd_name}.log")
    t0 = time.time()
    with open(log_p, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "nextdenovo_tpu_torch", "run", cfg_p],
            cwd=workdir, env=env, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    wall = time.time() - t0
    lines = open(log_p).readlines()
    if rc != 0:
        raise RuntimeError(
            "the CLI entry over the cards "
            + ("timed out" if rc is None else f"returned {rc}")
            + f" after {wall:.1f}s; its log ends:\n{''.join(lines[-40:])}")
    log(f"[mesh_cards] task=all use_mesh={n_shards} over {n_cards} cards "
        f"(CUDA_VISIBLE_DEVICES={env['CUDA_VISIBLE_DEVICES']}): wall "
        f"{wall:.1f}s from the process's start")
    for line in lines:
        if "use_mesh=" in line or "mesh: " in line:
            log("[mesh_cards] log: " + line.rstrip())
    wd = os.path.join(workdir, wd_name)
    for st in STAGES:
        if not os.path.exists(os.path.join(wd, st, ".done")):
            raise RuntimeError(f"stage {st} left no .done marker")
    rows = [json.loads(l) for l in open(os.path.join(wd, "trace.jsonl"))]
    marks = {r["name"][len("launches/"):]: r for r in rows
             if r["name"].startswith("launches/")}
    names = list(KERNEL_INFO)
    prev_t, prev, walls, in_stage = t0, dict.fromkeys(names, 0), [], {}
    for st in STAGES:
        walls.append(f"{st} {marks[st]['t0'] - prev_t:.1f}")
        in_stage[st] = {n: marks[st][n] - prev[n] for n in names
                        if marks[st][n] - prev[n]}
        prev_t, prev = marks[st]["t0"], marks[st]
    log(f"[mesh_cards] stage walls s (00.db from the process's start): "
        f"{', '.join(walls)}")
    log(f"[mesh_cards] launches by stage: {json.dumps(in_stage)}")
    cards = next(r["cards"] for r in rows if r["name"] == "mesh/cards")
    if len(cards) != n_cards:
        raise RuntimeError(f"the run reported {len(cards)} cards, not "
                           f"{n_cards}")
    entries = [r["card_entries"] for r in rows
               if r["name"] == "mesh/build_index"]
    for i, (idx, c) in enumerate(sorted(cards.items())):
        share = [e[i] / max(1, sum(e)) for e in entries]
        below = c["peak_mib"] * 2**20 < one_card_peak
        log(f"[mesh_cards] card {idx} ({c['name']}): peak device memory "
            f"{c['peak_mib']:.1f} MiB ({'below' if below else 'not below'} "
            f"the one-card mesh run's {one_card_peak / 2**20:.1f} MiB), "
            f"share of the index's entries "
            f"in stages 01/04/06 {', '.join(f'{x:.4f}' for x in share)}, "
            "launches " + json.dumps({k: v for k, v in c["launches"].items()
                                      if v}))
        for n in ("myers_fwd", "vote_corridor", "chain_emit"):
            if c["launches"].get(n, 0) < 1:
                raise RuntimeError(f"card {idx} launched no {n}")
    for n in ("engine_anchor",) + ROUTE_KERNELS:
        if marks["06.ctg_cns"][n] < 1:
            raise RuntimeError(f"the run over the cards launched no {n}")
    by = {}
    for r in rows:
        if r["name"].startswith(("mesh/", "kernel/")) \
                and r["name"] != "mesh/cards":
            key = (r["name"], r.get("card", ""))
            n_, w_ = by.get(key, (0, 0.0))
            by[key] = (n_ + 1, w_ + r["wall"])
    log("[mesh_cards] spans (name, card: calls, wall s): " + "; ".join(
        f"{n} {c}: {k_}, {w_:.3f}" for (n, c), (k_, w_) in sorted(by.items())))
    wd_main, wd_mesh = (os.path.join(workdir, w) for w in ("wd", "wd_mesh"))
    for rel in ("01.raw_align/raw.ovl.npz", "02.sort_align/sorted.ovl.npz"):
        diff = _first_diff(os.path.join(wd_main, rel), os.path.join(wd, rel))
        if diff:
            raise RuntimeError(f"{rel} over the cards differs from the main "
                               f"path's: {diff}")
    n_files = _same_stage_files(wd_mesh, wd)
    log(f"[mesh_cards] raw.ovl and sorted.ovl equal to main_path's; all "
        f"{n_files} files of stages 01-06 equal to the one-card mesh run's")
    _check_result("mesh_cards", dev, wd, sim, genome)
    return {n: marks["06.ctg_cns"][n] for n in names}


def _anchor(c, g, k=25, tries=20):
    """The window of g that corrected read c covers: c's first and last
    k-mers found exactly in g (each tried at up to `tries` offsets 50 bases
    apart, so that an error in one k-mer does not lose the read).  None
    when no k-mer of either end is found."""
    import numpy as np
    gb = g.astype(np.uint8).tobytes()
    cb = c.astype(np.uint8).tobytes()
    a = b = None
    for o in range(0, min(tries * 50, len(cb) - k), 50):
        x = gb.find(cb[o : o + k])
        if x >= o:
            a = x - o
            break
    for o in range(0, min(tries * 50, len(cb) - k), 50):
        e = len(cb) - o
        x = gb.rfind(cb[e - k : e])
        if x >= 0 and x + k + o <= len(gb):
            b = x + k + o
            break
    if a is None or b is None or b <= a:
        return None
    return g[a:b]


# ---------------------------------------------------------------------------
# the Myers streams and the mesh path's routing (myers_streams, the routing
# kernels of csrc/route.cu, engine_anchor on the mesh lookup)

# the launches of mesh.bucketize and of dist_sort.seed_route
BUCKET_KERNELS = ("route_count", "route_scatter")
SEED_ROUTE_KERNELS = ("seed_route_count", "seed_route_scatter")
ROUTE_KERNELS = BUCKET_KERNELS + SEED_ROUTE_KERNELS
# the calls of the mesh path's run that phase_route and route_timing replay
# on the card: dist_overlap's lookups (one with the pair-once gate, one
# without, where the run made them), the first bucketing of each kind
# (sketch_route: 4 fields, lookup_route: 5) and the sort's first seed route
MESH_CALLS = {}


def _moved(x, dev):
    """x with every tensor in it (through tuples and named tuples) on dev."""
    import torch
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, tuple):
        items = [_moved(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def mesh_call(key, dev):
    """A call MESH_CALLS recorded, its tensors back on dev."""
    return _moved(MESH_CALLS[key], dev)


class capture_mesh_calls:
    """Within the block, the mesh path's first calls of dist_overlap._lookup
    (gate on, gate off), of dist_overlap's bucketize by field count and of
    dist_sort.seed_route are recorded into MESH_CALLS (their arguments,
    copied to the host, so that the run's peak device memory stays its own)
    and run as they would."""

    def __enter__(self):
        from nextdenovo_tpu_torch.parallel import dist_overlap as DO
        from nextdenovo_tpu_torch.parallel import dist_sort as DS
        MESH_CALLS.clear()
        self.saved = [(DO, "_lookup", DO._lookup),
                      (DO, "bucketize", DO.bucketize),
                      (DS, "seed_route", DS.seed_route)]

        def record(key, args):
            if key not in MESH_CALLS:
                MESH_CALLS[key] = _moved(args, "cpu")

        def lookup(recv, ix, qm, amask, max_occ, _f=DO._lookup):
            record("lookup_gate" if qm is not None else "lookup_nogate",
                   (recv, ix, qm, amask, max_occ))
            return _f(recv, ix, qm, amask, max_occ)

        def bucketize(fields, dest, valid, n, cap, _f=DO.bucketize):
            record(f"bucketize_{len(fields)}",
                   (tuple(fields), dest, valid, n, cap))
            return _f(fields, dest, valid, n, cap)

        def seed_route(rec, is_seed, lens, n, cap, _f=DS.seed_route):
            record("seed_route", (rec, is_seed, lens, n, cap))
            return _f(rec, is_seed, lens, n, cap)

        DO._lookup, DO.bucketize = lookup, bucketize
        DS.seed_route = seed_route
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def streams_inputs(qs, ts, dev, off=None, nw=8):
    """The tensors myers_align hands build_streams for these pairs (off as
    given, or as myers_align sets it)."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch.ops import myers as M
    W = 32 * nw
    sw = [(t, q) if len(q) < len(t) else (q, t) for q, t in zip(qs, ts)]
    qs = [np.asarray(a, np.uint8) for a, _ in sw]
    ts = [np.asarray(b, np.uint8) for _, b in sw]
    m = np.array([len(a) for a in qs], np.int32)
    n = np.array([len(b) for b in ts], np.int32)
    if off is None:
        off = np.clip((W - (m - n)) // 2, 16, W - 16)
    off = np.asarray(off, np.int32)
    flat, starts = M.flat_pairs(qs, ts)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    fl, st = to(flat), to(starts)
    args = (fl, fl, st[0], st[1], to(m), to(n), to(off))
    return dict(args=args, n_pad=max(int(n.max()), 1), m=m, n=n, off=off,
                qs=qs, ts=ts)


def streams_sets(rng):
    """(tag, queries, targets, off or None) of phase_route's myers_streams
    sets."""
    import numpy as np
    e = np.zeros(0, np.int8)
    one = lambda L: rng.integers(0, 4, L).astype(np.int8)
    x = one(3000)
    yield "empty queries and targets", [e, e, one(7)], [e, one(5), e], None
    yield "m = n", [x, one(2000)], [x.copy(), one(2000)], None
    yield "m >> n (off clamped at 16)", [one(9000), one(600)], \
        [one(2000), one(100)], None
    yield "off at 16 and W - 16", [one(4000), one(4000), one(50)], \
        [one(3900), one(3500), one(50)], [16, 240, 240]
    yield "B = 1", [one(12000)], [one(11800)], None
    qs, ts = make_pairs(rng, 5120, 200, 1200)
    yield "B = 5120", qs, ts, None
    qs, ts = make_pairs(rng, 640, 11000, 12288)
    yield "the main path's launch shape (640 x 11000-12288)", qs, ts, None


def _seed_views(rec, is_seed, lens, n, cap):
    """The seed route's call as bucketize's: the views of
    seed_symmetrize_plain (on the records' device) and their bucketing."""
    from nextdenovo_tpu_torch.parallel import dist_sort as DS
    cols, valid, dest = DS.seed_symmetrize_plain(rec, is_seed, lens, n)
    return tuple(cols.unbind(0)), dest, valid, n, cap


def _route_sets(rng, dev):
    """(tag, fields, dest, valid, n, cap) of phase_route's bucketize sets:
    synthetic ones, and the mesh path's recorded calls (4 fields: stage 01's
    sketch route; 5: the lookup's route back; 8: the seed route's views)."""
    import torch
    i64 = torch.int64

    def case(N, n, F, outside=0.0, valid_p=None):
        fields = tuple(torch.randint(-2**40, 2**40, (N,), dtype=i64,
                                     device=dev) for _ in range(F))
        dest = torch.randint(0, n, (N,), dtype=i64, device=dev)
        if outside:
            far = torch.rand(N, device=dev) < outside
            dest = torch.where(far, torch.where(dest % 2 == 0, -1 - dest,
                                                n + dest), dest)
        valid = None if valid_p is None else \
            torch.rand(N, device=dev) < valid_p
        return fields, dest, valid

    yield ("n = 1", *case(5000, 1, 4), 1, 10**6)
    yield ("n = 2, a cap that truncates", *case(20000, 2, 5, 0.0, 0.8), 2,
           6000)
    yield ("n = 8, destinations outside the mesh, a truncating cap",
           *case(50000, 8, 8, 0.05, 0.7), 8, 4000)
    yield ("N = 0", *case(0, 8, 4), 8, 100)
    yield ("cap = 0", *case(9000, 8, 3, 0.05), 8, 0)
    yield ("every row outside", *case(7000, 4, 2, 1.0), 4, 100)
    yield ("n = 512", *case(300000, 512, 2, 0.01, 0.9), 512, 10**6)
    yield ("n = 4096", *case(400000, 4096, 3, 0.01, 0.9), 4096, 10**6)
    yield ("n = 4096, a cap of 20", *case(200000, 4096, 1), 4096, 20)
    yield ("a mesh-sized launch (1.3 M rows x 4 fields, n = 8)",
           *case(1_300_000, 8, 4), 8, 10**7)
    for key in ("bucketize_4", "bucketize_5"):
        if key in MESH_CALLS:
            yield (f"the mesh path's {key[-1]}-field call",
                   *mesh_call(key, dev))
    if "seed_route" in MESH_CALLS:
        yield ("the mesh path's seed route as an 8-field call",
               *_seed_views(*mesh_call("seed_route", dev)))


def _same_buckets(tag, got, want, name="bucketize"):
    """A routing call's (buckets, counts) on the card against its plain
    version's on the card, exactly."""
    import numpy as np
    (gb, gc), (wb, wc) = got, want
    if not np.array_equal(gc, wc):
        raise RuntimeError(f"{name}: counts differ on '{tag}': {gc} "
                           f"against {wc}")
    err = 0.0
    for d, (a, b) in enumerate(zip(gb, wb)):
        if len(a) != len(b):
            raise RuntimeError(f"{name}: bucket {d} has {len(a)} fields on "
                               f"'{tag}', not {len(b)}")
        for f, (x, y) in enumerate(zip(a, b)):
            ok, e = _tensors_equal(x, y)
            err = max(err, e)
            if not ok:
                raise RuntimeError(f"{name}: bucket {d}, field {f} "
                                   f"differs on '{tag}'")
    return err


def _bad_records(rec, lens):
    """The records with ids negative, past the reads, and equal."""
    import torch
    bad = rec.clone()
    R, dev = bad.shape[0], rec.device
    bad[: R // 8, 0] = -torch.arange(1, R // 8 + 1, device=dev)
    bad[R // 8 : R // 4, 4] = lens.shape[0] + torch.arange(R // 8,
                                                           device=dev)
    bad[R // 4 : R // 3, 4] = bad[R // 4 : R // 3, 0]
    return bad


def phase_route(dev):
    """myers_streams, the routing kernels (route_count and route_scatter
    through mesh.bucketize; seed_route_count and seed_route_scatter through
    dist_sort.seed_route) and the mesh lookup's engine_anchor against their
    plain versions on the card, every output exact: build_streams on the
    sets of streams_sets; bucketize on n = 1, 2, 8, 512 and 4096,
    truncating caps, cap = 0, every row outside, destinations outside the
    mesh, N = 0, a mesh-sized launch and the mesh path's recorded calls of
    4 and 5 fields and its seed route's views as an 8-field call;
    seed_route on the mesh path's raw records of one shard, on records with
    ids out of range, negative or equal, with a truncating cap and at
    n = 1, 2 and 4096; the mesh path's lookups (engine_anchor against
    _lookup_plain) with the pair-once gate and without it.  The host syncs
    of one bucketize call and of one seed_route call (each must be one) and
    of one myers_align sub-batch, counted.  Returns {name: exact,
    max_abs_err} for the kernels line."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch.ops import myers as M
    from nextdenovo_tpu_torch.parallel import dist_overlap as DO
    from nextdenovo_tpu_torch.parallel import dist_sort as DS
    from nextdenovo_tpu_torch.parallel import mesh as MS
    rng = np.random.default_rng(19)
    res = {k: dict(exact=True, max_abs_err=0.0)
           for k in ("myers_streams",) + ROUTE_KERNELS}
    for tag, qs, ts, off in streams_sets(rng):
        si = streams_inputs(qs, ts, dev, off)
        got = M.build_streams(*si["args"], nw=8, n_pad=si["n_pad"])
        want = M.build_streams_plain(*si["args"], nw=8)
        r = {}
        _record(r, tag, "myers_streams", got, want)
        res["myers_streams"]["max_abs_err"] = max(
            res["myers_streams"]["max_abs_err"], r["myers_streams"]
            ["max_abs_err"])
        log(f"[route] myers_streams = plain on '{tag}' ({len(qs)} pairs, "
            f"{si['n_pad']} columns)")
        del got, want, si
    torch.cuda.empty_cache()
    qs, ts = make_pairs(rng, 640, 11000, 12288)
    _, n_sync, at = count_syncs(lambda: M.myers_align(qs, ts, device=dev))
    log(f"[route] host syncs of one myers_align sub-batch (640 pairs): "
        f"{n_sync} at {at}")

    def held(name, tag, got, want):
        err = _same_buckets(tag, got, want, name)
        for k in (BUCKET_KERNELS if name == "bucketize"
                  else SEED_ROUTE_KERNELS):
            res[k]["max_abs_err"] = max(res[k]["max_abs_err"], err)

    for tag, fields, dest, valid, n, cap in _route_sets(rng, dev):
        got = MS.bucketize(fields, dest, valid, n, cap)
        held("bucketize", tag, got,
             MS.bucketize_plain(fields, dest, valid, n, cap))
        log(f"[route] bucketize (route_count, route_scatter) = plain on "
            f"'{tag}' ({dest.shape[0]} rows, {len(fields)} fields, counts "
            f"{got[1].tolist()[:9]}{' ...' if n > 8 else ''}, cap {cap})")
        if tag.startswith("n = 8"):
            sync_case = (fields, dest, valid, n, cap)
    _, n_sync, at = count_syncs(lambda: MS.bucketize(*sync_case))
    log(f"[route] host syncs of one bucketize call: {n_sync} at {at}")
    if n_sync != 1:
        raise RuntimeError(f"one bucketize call made {n_sync} host syncs "
                           f"(one expected)")
    res["route_count"]["host_syncs"] = n_sync

    if "seed_route" not in MESH_CALLS:
        raise RuntimeError("the mesh path's run made no seed route")
    rec, is_seed, lens, n, cap = mesh_call("seed_route", dev)
    bad = _bad_records(rec, lens)
    R = rec.shape[0]
    sets = [("the mesh path's raw records of one shard", rec, n, cap),
            ("ids negative, past the reads, equal", bad, n, cap),
            ("a truncating cap", rec, n, max(1, R // (4 * n))),
            ("n = 1", bad, 1, 2 * R), ("n = 2", rec, 2, 2 * R),
            ("n = 4096", bad, 4096, 2 * R)]
    for tag, r8, n_, cap_ in sets:
        got = DS.seed_route(r8, is_seed, lens, n_, cap_)
        want = DS.seed_route_plain(r8, is_seed, lens, n_, cap_)
        held("seed_route", tag, got, want)
        log(f"[route] seed_route (seed_route_count, seed_route_scatter) = "
            f"plain on '{tag}' ({R} records, {int(want[1].sum())} views "
            f"kept, n = {n_}, cap {cap_})")
    _, n_sync, at = count_syncs(lambda: DS.seed_route(rec, is_seed, lens, n,
                                                      cap))
    log(f"[route] host syncs of one seed_route call: {n_sync} at {at}")
    if n_sync != 1:
        raise RuntimeError(f"one seed_route call made {n_sync} host syncs "
                           f"(one expected)")
    res["seed_route_count"]["host_syncs"] = n_sync

    lookups = [(k, v) for k, v in MESH_CALLS.items()
               if k.startswith("lookup")]
    if not lookups:
        raise RuntimeError("the mesh path's run made no lookup to replay")
    recv, ix, qm, amask, max_occ = mesh_call(lookups[0][0], dev)
    for tag, q in (("with the pair-once gate", qm), ("without it", None)):
        if tag.startswith("with ") and q is None:
            continue
        am = DO.anchor_mask(q, int(ix.rid.max()) + 1, dev)
        got = DO._lookup_anchor(recv, ix, am, max_occ)
        want = DO._lookup_plain(recv, *ix.unpacked(), q,
                                max_occ)
        r = {}
        _record(r, tag, "engine_anchor", got, want)
        log(f"[route] the mesh lookup by engine_anchor = _lookup_plain "
            f"{tag} ({recv[0].shape[0]} received minimizers of a shard, "
            f"{got[0].shape[0]} anchors)")
    return res


class PreparedRoute:
    """A routing call's two launches with their inputs made once, so that
    each can be timed alone: `count()` (route_count, or seed_route_count),
    then `scatter()` (route_scatter, or seed_route_scatter; past 64
    destinations the pointer table's copy first) into buckets allocated
    from the first count's totals.  rl: the launches, mesh.bucket_launches
    or dist_sort.seed_route_launches of any library."""

    def __init__(self, dev, rl):
        import torch
        from nextdenovo_tpu_torch.parallel import mesh as MS
        self.rl, self.n, self.tiles = rl, rl.n, rl.tiles
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.sc = MS.route_scratch(dev, rl.rows, rl.tiles, rl.n)
        self.ticket = MS.route_ticket(dev)
        self.count()
        self.counts = self.sc.counts.cpu().numpy()
        self.out, self.dst = MS.route_buckets(self.counts, rl.n, rl.cap,
                                              rl.F, dev)

    def count(self):
        rc = self.rl.count(self.sc, self.ticket, self.stream)
        if rc:
            raise RuntimeError(f"{self.rl.name}_count failed: error {rc}")

    def scatter(self):
        rc = self.rl.scatter(self.sc, self.dst, self.stream)
        if rc:
            raise RuntimeError(f"{self.rl.name}_scatter failed: error {rc}")

    def both(self):
        self.count()
        self.scatter()

    def buckets(self):
        """(buckets, counts) as the wrapper returns them, after a
        scatter."""
        return [o.unbind(0) for o in self.out], self.counts


def _route_shape_timing(tag, call, plain, launches, sort_keys, byt,
                        count_byt, reps):
    """One routing shape's times: each launch alone and both (after a
    device sleep), the wrapper's whole call and its device operations, the
    plain version on the card and its device kernels, one stable
    torch.sort of the destinations (the yardstick), the bounds."""
    import torch
    from nextdenovo_tpu_torch import _build
    count_ms = _events_ms(launches.count, reps)
    scatter_ms = _events_ms(launches.scatter, reps)
    both_ms = _events_ms(launches.both, reps)
    _, call_ms = timed(call, reps)
    _, plain_ms = timed(plain, 3)
    sort_ms = _events_ms(lambda: torch.sort(sort_keys, stable=True), reps)
    got, want = call(), plain()
    err = _same_buckets(tag, got, want)
    resident = _build.kernels().ndt_route_resident(launches.n)
    return dict(
        exact=True, max_abs_err=err, count_ms=count_ms,
        scatter_ms=scatter_ms, launches_ms=both_ms, wrapper_ms=call_ms,
        plain_ms=plain_ms, sort_ms=sort_ms,
        call_device_ops=plain_launches(call),
        plain_call_launches=plain_launches(plain),
        tiles=launches.tiles, resident_blocks_an_sm=resident,
        **_bound(byt, 0), count_bound_ms=_bound(count_byt, 0)["bound_ms"],
        scatter_bound_ms=_bound(byt - count_byt, 0)["bound_ms"])


def route_timing(dev, reps=5):
    """myers_streams at the main path's launch shape (640 pairs of
    11000-12288 columns); the routing kernels at the mesh path's three
    recorded shapes: bucketize on stage 01's sketch route (4 fields; a
    mesh-sized synthetic launch where the run made none) and on the
    lookup's route back (5 fields), seed_route on the sort's records of one
    shard.  For each routing shape: the count launch alone, the scatter
    launch alone and both (each after a device sleep), the wrapper's whole
    call and its device operations, the plain version on the card, one
    stable torch.sort of the destinations as a yardstick, the grid (tiles;
    blocks an SM holds) and the bound (bytes: each row's destination and
    flag read once, the kept rows' fields read once and written once; for
    the seed route each record read once and each kept view written once).
    Also the host side of a Myers sub-batch's inputs, the old row fill
    against the flat array; the seven-key sort; the mesh lookup by
    engine_anchor (launch alone) against the plain lookup.  Returns {name:
    result}."""
    import numpy as np
    import torch
    from nextdenovo_tpu_torch import _build
    from nextdenovo_tpu_torch.ops import myers as M
    from nextdenovo_tpu_torch.overlap import engine as E
    from nextdenovo_tpu_torch.parallel import dist_overlap as DO
    from nextdenovo_tpu_torch.parallel import dist_sort as DS
    from nextdenovo_tpu_torch.parallel import mesh as MS
    out = {}
    rng = np.random.default_rng(23)
    qs, ts = make_pairs(rng, 640, 11000, 12288)
    si = streams_inputs(qs, ts, dev)
    a = si["args"]
    B, n_pad, W = len(qs), si["n_pad"], 256
    ms = _events_ms(lambda: M.build_streams(*a, nw=8, n_pad=n_pad), reps)
    _, plain_ms = timed(lambda: M.build_streams_plain(*a, nw=8), 3)
    # the old path: pads filled row by row on the host, two copies in, the
    # jitted program's ops on the card; the new: one buffer, one copy in
    t0 = time.perf_counter()
    qpad = np.full((B, int(si["m"].max()) + W + 2), 4, np.int8)
    tpad = np.full((B, n_pad), 4, np.int8)
    for b in range(B):
        qpad[b, : si["m"][b]] = si["qs"][b]
        tpad[b, : si["n"][b]] = si["ts"][b]
    qpad_d, tpad_d = torch.from_numpy(qpad).to(dev), \
        torch.from_numpy(tpad).to(dev)
    torch.cuda.synchronize()
    old_host_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fl = M.upload_pairs(si["qs"], si["ts"], si["m"], si["n"], si["off"], dev)
    torch.cuda.synchronize()
    new_host_ms = (time.perf_counter() - t0) * 1e3
    old_dev = lambda: M._build_streams(qpad_d, tpad_d, a[6], nw=8)
    _, old_ms = timed(old_dev, 3)
    old_kernels = plain_launches(old_dev)
    r = {}
    _record(r, "the main path's launch shape", "myers_streams",
            M.build_streams(*a, nw=8, n_pad=n_pad), old_dev())
    qbytes = int(np.minimum(si["m"], n_pad + W - si["off"]).sum())
    byt = 2 * n_pad * B * 4 + 4 * 8 * B * 4 + B * 28 + qbytes \
        + int(si["n"].sum())
    out["myers_streams"] = dict(
        r["myers_streams"], ms=ms, plain_ms=plain_ms,
        jitted_ops_ms=old_ms, jitted_ops_kernels=old_kernels,
        host_row_fill_ms=old_host_ms, host_flat_ms=new_host_ms,
        shape=f"B={B} columns={n_pad}", **_bound(byt, 0))
    log(f"[timing] myers_streams at {B} pairs x {n_pad} columns: alone "
        f"{ms:.4f} ms (bound {out['myers_streams']['bound_ms']:.4f}, bytes); "
        f"build_streams_plain on the card {plain_ms:.3f} ms; the replaced "
        f"ops on the pads (_build_streams) {old_ms:.3f} ms in {old_kernels} "
        f"device kernels; host: pads filled row by row and copied "
        f"{old_host_ms:.1f} ms, the flat array and its copy {new_host_ms:.1f}"
        f" ms")
    del si, a, qpad_d, tpad_d, fl
    torch.cuda.empty_cache()

    shapes = {}
    for key, where in (("bucketize_4", "the mesh path's stage-01 sketch "
                        "route of one shard"),
                       ("bucketize_5", "the mesh path's route back of one "
                        "shard's anchors")):
        if key in MESH_CALLS:
            shapes[key] = (where, mesh_call(key, dev))
    if "bucketize_4" not in shapes:
        shapes["bucketize_4"] = ("a mesh-sized synthetic launch", next(
            s[1:] for s in _route_sets(rng, dev) if s[0].startswith("a mesh")))
    route = {}
    for key, (where, (fields, dest, valid, n, cap)) in shapes.items():
        N, F = dest.shape[0], len(fields)
        launches = PreparedRoute(dev, MS.bucket_launches(
            _build.kernels(), fields, dest, valid, n, cap))
        kept = int(np.minimum(launches.counts[:n], cap).sum())
        count_byt = N * (8 + (0 if valid is None else 1)) + (n + 1) * 8
        route[key] = dict(_route_shape_timing(
            where, lambda: MS.bucketize(fields, dest, valid, n, cap),
            lambda: MS.bucketize_plain(fields, dest, valid, n, cap),
            launches, dest, count_byt + kept * F * 16, count_byt, reps),
            shape=f"{N} rows x {F} fields, n={n}, {kept} kept ({where})")
        del launches
    rec, is_seed, lens, n, cap = mesh_call("seed_route", dev)
    R = rec.shape[0]
    launches = PreparedRoute(dev, DS.seed_route_launches(
        _build.kernels(), rec, is_seed, lens, n, cap))
    kept = int(np.minimum(launches.counts[:n], cap).sum())
    count_byt = R * 64 + (n + 1) * 8
    views_dest = DS.seed_symmetrize_plain(rec, is_seed, lens, n)[2]
    route["seed_route"] = dict(_route_shape_timing(
        "the mesh path's records",
        lambda: DS.seed_route(rec, is_seed, lens, n, cap),
        lambda: DS.seed_route_plain(rec, is_seed, lens, n, cap), launches,
        views_dest, count_byt + kept * 64, count_byt, reps),
        shape=f"{R} records of one shard, n={n}, {kept} views kept")
    del launches
    for key, t in route.items():
        log(f"[timing] {'bucketize' if key != 'seed_route' else key} on "
            f"{t['shape']}: launches alone {t['launches_ms']:.4f} ms (count "
            f"{t['count_ms']:.4f}, scatter {t['scatter_ms']:.4f}; bound "
            f"{t['bound_ms']:.4f}, bytes, {100 * t['bound_ms'] / t['launches_ms']:.1f} "
            f"%; count's {t['count_bound_ms']:.4f}, scatter's "
            f"{t['scatter_bound_ms']:.4f}); the wrapper's call (one host "
            f"sync) {t['wrapper_ms']:.4f} ms in {t['call_device_ops']} "
            f"device operations; plain on the card {t['plain_ms']:.3f} ms in "
            f"{t['plain_call_launches']} device kernels; one stable "
            f"torch.sort of the destinations {t['sort_ms']:.4f} ms; grid "
            f"{t['tiles']} tiles, {t['resident_blocks_an_sm']} blocks an SM")
    out["route_timing"] = route
    # the kernels line: each launch alone at its path's first shape
    for names, key in ((BUCKET_KERNELS, "bucketize_4"),
                       (SEED_ROUTE_KERNELS, "seed_route")):
        t = route[key]
        for name, part in zip(names, ("count", "scatter")):
            out[name] = dict(
                exact=True, max_abs_err=t["max_abs_err"],
                ms=t[f"{part}_ms"], plain_ms=t["plain_ms"],
                bound_ms=t[f"{part}_bound_ms"], bound_by="bytes",
                wrapper_ms=t["wrapper_ms"], launches_ms=t["launches_ms"],
                pair_bound_ms=t["bound_ms"], sort_ms=t["sort_ms"],
                call_device_ops=t["call_device_ops"],
                plain_call_launches=t["plain_call_launches"],
                shape=t["shape"])

    # the seven-key sort (a library sort, not ported) on as many rows as
    # this shard's valid views, the rows a shard receives on average: its
    # bound is seven stable passes, each key read once, the permutation
    # written once
    cols, valid, _ = DS.seed_symmetrize_plain(rec, is_seed, lens, n)
    qn, rv, s_, e_, tn, ts2, _, mt = cols[:, valid].unbind(0)
    keys = [qn, -mt, e_ - s_, tn, ts2, s_, rv]
    V = int(qn.shape[0])
    ms = _events_ms(lambda: E._stable_lexsort(keys), reps)
    out["seven_key_sort"] = dict(ms=ms, rows=V,
                                 **_bound(7 * V * 8 + V * 8, 0))
    log(f"[timing] the seed sort's seven-key sort (_stable_lexsort, seven "
        f"stable torch.sort passes) on {V} rows: {ms:.4f} ms (bound "
        f"{out['seven_key_sort']['bound_ms']:.5f}, bytes)")

    key = next(k for k in ("lookup_gate", "lookup_nogate")
               if k in MESH_CALLS)
    recv, ix, qm, _, max_occ = mesh_call(key, dev)
    amask = DO.anchor_mask(qm, int(ix.rid.max()) + 1, dev)
    M_ = min(recv[0].shape[0], DO.LOOKUP_ROWS)
    h, pos, st_, qid = (x[:M_] for x in recv)
    rows = torch.arange(M_, device=dev, dtype=torch.int64)
    zeros = torch.zeros_like(rows)
    lib = _build.kernels()
    H = ix.h.shape[0]
    ins = [t.data_ptr() for t in (rows, pos, h, st_, qid, zeros, amask,
                                  ix.h, ix.rid, ix.posst, ix.bucket)]
    stat, nb = E._anchor_stat(M_, dev)
    cap = M_ * max_occ
    buf = torch.empty((5, cap), dtype=torch.int64, device=dev)
    launch = functools.partial(
        E._anchor_launch, lib, ins, stat, buf.data_ptr(), M_, H, cap,
        32 - E.directory_bits(H), max_occ,
        torch.cuda.current_stream(dev).cuda_stream)
    a_ms = _events_ms(launch, reps)
    _, call_ms = timed(lambda: DO._lookup_anchor(recv, ix, amask, max_occ), 3)
    _, plain_ms = timed(lambda: DO._lookup_plain(
        recv, *ix.unpacked(), qm, max_occ), 3)
    log(f"[timing] the mesh lookup ({key}, {recv[0].shape[0]} received "
        f"minimizers, an index shard of {H} entries, max_occ {max_occ}): "
        f"engine_anchor alone on {M_} of them {a_ms:.4f} ms; the lookup by "
        f"engine_anchor {call_ms:.3f} ms; the plain lookup on the card "
        f"{plain_ms:.3f} ms")
    out["mesh_lookup"] = dict(engine_anchor_ms=a_ms, call_ms=call_ms,
                              plain_ms=plain_ms)
    return out


def check_streams_launches(tag, launches):
    """myers_align builds each sub-batch's streams with one myers_streams
    launch, so a run launches it exactly as often as myers_fwd."""
    if launches["myers_streams"] != launches["myers_fwd"]:
        raise RuntimeError(f"{tag}: {launches['myers_streams']} myers_streams "
                           f"launches for {launches['myers_fwd']} myers_fwd")
    log(f"[route] {tag}: myers_streams launched {launches['myers_streams']} "
        f"times, as myers_fwd")


def myers_sweep(dev, rng, qs, ts, sizes=(640, 1280, 2560, 5120), chunk=640):
    """Both Myers kernels at growing launches of 11000-12288 columns, then
    at 1280 pairs of the main path's longest columns (about 13.8k): ms a
    launch and ns a pair-column.  A launch of `chunk` pairs is what the
    kernels were just held against their plain versions on; every pair of a
    larger launch must come out as it does when the same pairs run in
    launches of `chunk`, whatever block and plane address it falls on."""
    import torch
    from nextdenovo_tpu_torch.ops import myers as M
    nw = 8
    more_q, more_t = make_pairs(rng, max(sizes) - len(qs), 11000, 12288)
    qs, ts = qs + more_q, ts + more_t
    sets = [(qs[:nb], ts[:nb]) for nb in sizes]
    sets.append(make_pairs(rng, 2 * chunk, 13400, 13900))

    def run(mi):
        f = M.myers_fwd(mi["win0"], mi["qtop"], mi["tch"], mi["n"], mi["off"],
                        nw=nw)
        return f, M.myers_tb(f[1], mi["m"], mi["n"], mi["off"], nw=nw)

    for q, t in sets:
        nb = len(q)
        mi = myers_inputs(q, t, dev, nw)
        cols = int(mi["n_np"].sum())
        n_max = mi["qtop"].shape[0]
        fk, f_ms = timed(lambda: M.myers_fwd(
            mi["win0"], mi["qtop"], mi["tch"], mi["n"], mi["off"], nw=nw), 3)
        tk, t_ms = timed(lambda: M.myers_tb(
            fk[1], mi["m"], mi["n"], mi["off"], nw=nw), 3)
        log(f"[timing] myers sweep: {nb} pairs x {n_max} columns (planes "
            f"{n_max * 8 * nw * nb / 2**30:.2f} GiB): myers_fwd {f_ms:.3f} ms "
            f"= {f_ms * 1e6 / cols:.3f} ns a pair-column, myers_tb "
            f"{t_ms:.3f} ms = {t_ms * 1e6 / cols:.3f} ns a pair-column")
        for s in range(0, nb, chunk):
            e = min(s + chunk, nb)
            cf, ct = run(myers_inputs(q[s:e], t[s:e], dev, nw))
            nc = cf[1].shape[0]              # the chunk's own longest pair
            defined = M.myers_fwd_defined(mi["n"][s:e], nc)[:, None, None]
            got = (fk[0][s:e], fk[2][:, :, s:e],
                   torch.where(defined, fk[1][:nc, :, :, s:e], 0),
                   tk[0][n_max - nc:, s:e], tk[1][s:e], tk[2][s:e],
                   tk[0][: n_max - nc, s:e])
            want = (cf[0], cf[2], torch.where(defined, cf[1], 0), *ct,
                    torch.full_like(got[-1], M.EV_IDLE))
            for name, a, b in zip(("score", "final", "planes", "events",
                                   "i_final", "ok", "idle events"), got, want):
                if not _tensors_equal(a, b)[0]:
                    raise RuntimeError(
                        f"myers sweep: {name} of pairs {s}..{e - 1} differ "
                        f"between a launch of {nb} pairs and one of {e - s}")
        log(f"[timing] myers sweep: all {nb} pairs equal to launches of "
            f"{chunk}")
        del mi, fk, tk
        torch.cuda.empty_cache()


def sm_clock_mhz():
    """The SM clock of card 0 in MHz, as nvidia-smi reports it now."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0])


def wave_fwd_sweep(dev, qs, ts, sizes):
    """wave_fwd at growing launches (the first nb pairs): ms a launch and
    cycles an anti-diagonal of the launch's longest pair.  Every pair of a
    launch must come out as it does in the largest launch."""
    import torch
    from nextdenovo_tpu_torch.ops import align as A
    wi = wave_inputs(qs[:max(sizes)], ts[:max(sizes)], dev)
    big = A.wave_fwd(wi["qpad"], wi["rtpad"], wi["mn"], wi["n_words"])
    words = A.wave_fwd_defined(wi["mn"], wi["n_words"])[:, :, None]
    for nb in sizes:
        w = wave_inputs(qs[:nb], ts[:nb], dev)
        nw = w["n_words"]
        out, ms = timed(lambda: A.wave_fwd(w["qpad"], w["rtpad"], w["mn"],
                                           nw), 3)
        mhz = sm_clock_mhz()
        diags = int((w["m_np"] + w["n_np"]).max()) + 1
        log(f"[timing] wave_fwd sweep: {nb} pairs x {nw * A.PACK} "
            f"anti-diagonals: wave_fwd {ms:.3f} ms; longest pair {diags} "
            f"anti-diagonals = {ms * 1e6 / diags * mhz / 1e3:.0f} cycles an "
            f"anti-diagonal at {mhz:.0f} MHz")
        d = words[:nb, :nw]
        if not (torch.equal(out[0] * d, big[0][:nb, :nw] * d)
                and torch.equal(out[1], big[1][:nb, :nw * A.PACK])
                and torch.equal(out[2], big[2][:nb])):
            raise RuntimeError(f"wave_fwd sweep: a launch of {nb} pairs "
                               f"differs from the launch of {max(sizes)}")
    log(f"[timing] wave_fwd sweep: every pair of every launch equal to the "
        f"launch of {max(sizes)}")
    return wi, big


def wave_sweep(dev, rng, qs, ts, sizes=(8, 64, 256, 640), chunk=64):
    """wave_fwd_sweep at these sizes, then wave_tb at growing launches of
    11000-12288 columns, on tb/lo that wave_fwd produced for the largest
    launch (smaller launches take its first pairs): ms a launch, the longest
    walk's steps, ns and cycles a step of that walk.  Every pair of every
    launch must come out as it does in launches of `chunk` pairs; the first
    `chunk` pairs were just held against wave_tb_plain."""
    import torch
    from nextdenovo_tpu_torch.ops import align as A
    more_q, more_t = make_pairs(rng, max(sizes) - len(qs), 11000, 12288)
    wi, (tb, lo, _) = wave_fwd_sweep(dev, qs + more_q, ts + more_t, sizes)
    mn = wi["mn"]
    want = [A.wave_tb(tb[s:s + chunk], lo[s:s + chunk], mn[s:s + chunk])
            for s in range(0, max(sizes), chunk)]
    want_ops = torch.cat([w[0] for w in want])
    want_ok = torch.cat([w[1] for w in want])
    steps = (want_ops != A.OP_NONE).sum(dim=1)
    for nb in sizes:
        (ops, ok), ms = timed(lambda: A.wave_tb(tb[:nb], lo[:nb], mn[:nb]), 5)
        mhz = sm_clock_mhz()
        longest = int(steps[:nb].max().item())
        ns = ms * 1e6 / longest
        log(f"[timing] wave sweep: {nb} pairs x {wi['n_words'] * A.PACK} "
            f"anti-diagonals: wave_tb {ms:.3f} ms; longest walk {longest} "
            f"steps ({int(steps[:nb].sum().item())} in all) = {ns:.1f} ns a "
            f"step = {ns * mhz / 1e3:.0f} cycles a step at {mhz:.0f} MHz")
        if not (torch.equal(ops, want_ops[:nb])
                and torch.equal(ok, want_ok[:nb])):
            raise RuntimeError(f"wave sweep: a launch of {nb} pairs differs "
                               f"from launches of {chunk}")
    log(f"[timing] wave sweep: every pair of every launch equal to launches "
        f"of {chunk}")
    del tb, lo, want, want_ops
    torch.cuda.empty_cache()


def _pad_words(x, n_words):
    """x (B, words, ...) with zero words appended up to n_words."""
    import torch
    pad = torch.zeros((x.shape[0], n_words - x.shape[1], *x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def wave_fast_fwd_sweep(dev, qs, ts, sizes, chunk=64):
    """wave_fast_fwd at growing launches (the first nb pairs): ms a launch
    and cycles an anti-diagonal of the launch's longest pair.  Every pair of
    every launch must come out as it does in launches of `chunk` pairs (tb
    on the defined words, base, stats).  Returns the inputs and outputs of
    the largest launch."""
    import torch
    from nextdenovo_tpu_torch.ops import align as A
    want = []
    for s in range(0, max(sizes), chunk):
        f = fast_inputs(qs[s:s + chunk], ts[s:s + chunk], dev)
        want.append(fwd_defined(f, A.wave_fast_fwd(
            f["qpad"], f["rtpad"], f["mn"], f["n_words"])))
    for nb in sizes:
        fi = fast_inputs(qs[:nb], ts[:nb], dev)
        nw = fi["n_words"]
        out, ms = timed(lambda: A.wave_fast_fwd(fi["qpad"], fi["rtpad"],
                                                fi["mn"], nw), 3)
        mhz = sm_clock_mhz()
        diags = int((fi["m_np"] + fi["n_np"]).max()) + 1
        log(f"[timing] wave_fast_fwd sweep: {nb} pairs x {nw * A.PACK} "
            f"anti-diagonals: wave_fast_fwd {ms:.3f} ms; longest pair "
            f"{diags} anti-diagonals = {ms * 1e6 / diags * mhz / 1e3:.0f} "
            f"cycles an anti-diagonal at {mhz:.0f} MHz")
        got = fwd_defined(fi, out)
        for c, w in enumerate(want[:(nb + chunk - 1) // chunk]):
            s, e = c * chunk, min((c + 1) * chunk, nb)
            words = max(nw, w[0].shape[1])
            if not (torch.equal(_pad_words(got[0][s:e], words),
                                _pad_words(w[0][:e - s], words))
                    and torch.equal(_pad_words(got[1][s:e], words),
                                    _pad_words(w[1][:e - s], words))
                    and torch.equal(got[2][s:e], w[2][:e - s])):
                raise RuntimeError(f"wave_fast_fwd sweep: pairs {s}..{e - 1} "
                                   f"of a launch of {nb} differ from a "
                                   f"launch of {chunk}")
    log(f"[timing] wave_fast_fwd sweep: every pair of every launch equal to "
        f"launches of {chunk}")
    return fi, out


def wave_fast_sweep(dev, rng, qs, ts, sizes=(8, 64, 256, 640), chunk=64):
    """wave_fast_fwd_sweep at these sizes, then wave_fast_tb at growing
    launches of 11000-12288 columns, on tb/base that wave_fast_fwd produced
    for the largest launch (smaller launches take its first pairs): ms a
    launch, the longest walk's steps, ns and cycles a step of that walk.
    Every pair of every launch must come out as it does in launches of
    `chunk` pairs; the first `chunk` pairs were just held against
    wave_fast_tb_plain."""
    import torch
    from nextdenovo_tpu_torch.ops import align as A
    more_q, more_t = make_pairs(rng, max(sizes) - len(qs), 11000, 12288)
    fi, (tb, base, _) = wave_fast_fwd_sweep(dev, qs + more_q, ts + more_t,
                                            sizes, chunk)
    mn = fi["mn"]
    want = [A.wave_fast_tb(tb[s:s + chunk], base[s:s + chunk],
                           mn[s:s + chunk])
            for s in range(0, max(sizes), chunk)]
    want_ops = torch.cat([w[0] for w in want])
    want_ok = torch.cat([w[1] for w in want])
    steps = (want_ops != A.OP_NONE).sum(dim=1)
    for nb in sizes:
        (ops, ok), ms = timed(
            lambda: A.wave_fast_tb(tb[:nb], base[:nb], mn[:nb]), 5)
        mhz = sm_clock_mhz()
        longest = int(steps[:nb].max().item())
        ns = ms * 1e6 / longest
        log(f"[timing] wave_fast sweep: {nb} pairs x "
            f"{fi['n_words'] * A.PACK} anti-diagonals: wave_fast_tb "
            f"{ms:.3f} ms; longest walk {longest} steps "
            f"({int(steps[:nb].sum().item())} in all) = {ns:.1f} ns a step = "
            f"{ns * mhz / 1e3:.0f} cycles a step at {mhz:.0f} MHz")
        if not (torch.equal(ops, want_ops[:nb])
                and torch.equal(ok, want_ok[:nb])):
            raise RuntimeError(f"wave_fast sweep: a launch of {nb} pairs "
                               f"differs from launches of {chunk}")
    log(f"[timing] wave_fast sweep: every pair of every launch equal to "
        f"launches of {chunk}")
    del tb, base, want, want_ops
    torch.cuda.empty_cache()


def phase_timing(dev, retry_pairs, ext_pairs, ext_mean_mn, batch,
                 sketch_batch):
    """Kernels at their path's shape: a Myers launch of 640 pairs of up to
    12288 columns (the small end of the main path's launches; myers_sweep
    covers the large end), the two wavefront pairs on a retry batch, the
    extender on as many tail pairs, of the same mean length, as stage 04
    handed it."""
    import numpy as np
    from nextdenovo_tpu_torch.native import affine_extend_cpu
    rng = np.random.default_rng(11)
    qs, ts = make_pairs(rng, 640, 11000, 12288)
    r = compare_kernels(qs, ts, dev, "main-path shape (Myers)", reps=3)
    out = {k: r[k] for k in ("myers_fwd", "myers_tb")}
    myers_sweep(dev, rng, qs, ts)
    nb = min(max(retry_pairs, 8), 64)
    qs, ts = make_pairs(rng, nb, 11000, 12288)
    r = compare_kernels(qs, ts, dev, "main-path shape (wave)", reps=3)
    out.update({k: r[k] for k in ("wave_fwd", "wave_tb")})
    wave_sweep(dev, rng, qs, ts)
    # the R = 1 pair at 64 pairs of up to 12288 columns, like wave_*
    qs, ts = make_pairs(rng, 64, 11000, 12288)
    out.update(compare_fast_kernels(qs, ts, dev, "R=1 shape (wave_fast)",
                                    reps=3))
    wave_fast_sweep(dev, rng, qs, ts)
    # the extender: tails are min(1024, hang) long on both sides, so a
    # pair's m + n is 2048 for the share `full` of full-length tails
    lo, hi = 33, 1024
    full = min(1.0, max(0.0, (ext_mean_mn / 2 - (lo + hi) / 2)
                        / (hi - (lo + hi) / 2)))
    qs, ts = ext_tail_pairs(rng, max(ext_pairs, 8), lo, hi, full=full)
    r = compare_ext_kernel(qs, ts, dev, "stage-04 shape (extender)", reps=3)
    n_host = min(len(qs), 2000)
    t0 = time.time()
    for q, t in zip(qs[:n_host], ts[:n_host]):
        affine_extend_cpu(q.astype(np.uint8), t.astype(np.uint8))
    host_ms = (time.time() - t0) * 1e3 * len(qs) / n_host
    r["ext_fwd"]["host_native_ms"] = host_ms
    log(f"[timing] ext_fwd: {len(qs)} pairs (stage 04 handed {ext_pairs}, "
        f"mean m+n {ext_mean_mn:.0f}; here {r['ext_fwd']['shape']}); the "
        f"native host loop takes {host_ms:.0f} ms for them (timed on "
        f"{n_host} pairs, one core)")
    out.update(r)
    r, _ = engine_timing(dev, batch)
    out.update(r)
    out.update(sketch_timing(dev, sketch_batch))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.time()
    dev = torch.device("cuda")
    card = phase_env()
    phase_build()
    with watchdog(420, "the kernel phase"):
        phase_kernels(dev)
    with watchdog(300, "the engine phase"):
        batch = phase_engine(dev)
    with watchdog(300, "the sketch phase"):
        sketch_batch = phase_sketch(dev, batch)
    phase_overlaps(dev)
    fast_launches = phase_fast_path(dev)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ext_")
    try:
        ext_launches, ext_pairs, ext_mean_mn = phase_ext_path(dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, facts = phase_main_path(dev, GENOME_SIZE, workdir)
        mh_launches = phase_multihost_path(workdir)
        with watchdog(480, "the mesh phase"):
            mesh_launches, mesh_peak = phase_mesh_path(
                dev, workdir, facts["sim"], facts["genome"], capture=True)
        with watchdog(300, "the route phase"):
            phase_route(dev)
            route_times = route_timing(dev)
        # the recorded calls are replayed: let them go
        MESH_CALLS.clear()
        torch.cuda.empty_cache()
        with watchdog(300, "the mesh_groups phase"):
            card0 = torch.device("cuda", torch.cuda.current_device())
            phase_mesh_groups(card0, workdir)
        with watchdog(480, "the mesh_cards phase"):
            cards_launches = phase_mesh_cards(
                dev, workdir, facts["sim"], facts["genome"], mesh_peak)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_hifi_")
    try:
        hifi_launches, hpc_launches = phase_hifi_path(dev, HIFI_GENOME_SIZE,
                                                      workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    path_launches = {FAST_PATH: fast_launches, EXT_PATH: ext_launches,
                     HPC_PATH: hpc_launches, MESH_PATH: mesh_launches}
    for tag, ls in (("main_path", launches), ("ext_path", ext_launches),
                    ("hifi_path", hifi_launches), ("mesh_path", mesh_launches),
                    *((f"multihost_path host {k}", h)
                      for k, h in enumerate(mh_launches)),
                    *((("mesh_cards", cards_launches),)
                      if cards_launches is not None else ())):
        check_streams_launches(tag, ls)
    for k, path in KERNEL_PATH.items():
        launches[k] = path_launches[path][k]
    with watchdog(420, "the timing phase"):
        timing = phase_timing(dev, facts["retry_pairs"], ext_pairs,
                              ext_mean_mn, batch, sketch_batch)
    timing.update(route_times)
    kernels = []
    for name, info in KERNEL_INFO.items():
        t = timing[name]
        kernels.append(dict(
            name=name, route="cuda", source=info["source"],
            replaces=info["replaces"], launches=launches[name],
            max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t.get("library_ms"),
            exact=t["exact"], kernel_ms=t["ms"], shape=t["shape"],
            path=KERNEL_PATH.get(name, "task = all"),
            launches_hifi=hifi_launches[name],
            launches_multihost=[h[name] for h in mh_launches],
            launches_mesh=mesh_launches[name],
            launches_mesh_cards=(None if cards_launches is None
                                 else cards_launches[name]),
            **{k: t[k] for k in ("host_native_ms", "wrapper_ms",
                                 "ms_l2_flushed", "ms_each_warm",
                                 "directory_ms", "searchsorted_ms",
                                 "searchsorted_ms_l2_flushed",
                                 "plain_call_ms", "plain_call_launches",
                                 "nonzero_ms", "call_device_ops",
                                 "launches_ms", "pair_bound_ms", "sort_ms",
                                 "plain_select_ms", "plain_emit_ms",
                                 *(f"{p}_{k_}" for p in ("index", "hifi")
                                   for k_ in SKETCH_SHAPE_KEYS))
               if k in t}))
    log(f"[done] genome {GENOME_SIZE} bp, total {time.time() - t_start:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
