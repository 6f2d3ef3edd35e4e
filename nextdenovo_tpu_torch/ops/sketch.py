"""Minimizer sketching: hand-written CUDA kernels and their plain PyTorch
versions.

Counterpart of nextdenovo_tpu/ops/sketch.py.  Selection rule: position i
is a minimizer iff it is the leftmost-tie argmin of some w-window, matching
minimap2's density guarantee; the hash is a murmur-style finalizer over
32-bit lanes of the canonical k-mer.

k <= 31 packs into two (hi, lo) lanes (`sketch`); k <= 128 uses the generic
multi-lane path (`sketch_wide`, the HiFi -k51 -w51 raw sketch).
`sketch_wide(hpc=True)` sketches the homopolymer-compressed reads
(`hpc_compress`) and reports positions in original coordinates; no
pipeline stage sets it.

`sketch`, `sketch_wide` and `hpc_compress` run their plain versions for CPU
tensors.  For CUDA tensors they launch the kernels of csrc/sketch.cu:
`sketch_minimizers` (hashes, window minima, selection and compaction in
(row, position) order in one launch, a block a tile of a row) and
`hpc_compress`; a sketch reads its selected count back once, its one host
sync.  The plain versions build k-mers by log2(k) shift-or doubling and
window minima by log2(w) min-shift doubling, and hold 32-bit unsigned
values in int64 tensors in [0, 2^32): wrap-around multiply, logical shifts
and unsigned comparison then follow from ordinary int64 arithmetic with a
mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from ..device import check_tensor

_M32 = 0xFFFFFFFF
UMAX = 0xFFFFFFFF


class Minimizers(NamedTuple):
    """Selected minimizers, compacted: every array has length n."""
    rid: torch.Tensor     # int64 read id (within batch; caller rebases)
    pos: torch.Tensor     # int64 k-mer start position (fwd strand coords)
    hash: torch.Tensor    # int64 canonical hash in [0, 2^32)
    strand: torch.Tensor  # int64 0 = canonical is fwd, 1 = rc
    n: int                # number of entries (<= cap)
    n_all: int            # TRUE selected count before the cap (n_all > n
                          # means the cap truncated)


def _shift_or(hi_a, lo_a, hi_b, lo_b, bits_b: int):
    """(a << bits_b) | b on 64-bit values split into 32-bit (hi, lo)."""
    if bits_b == 0:
        return hi_a, lo_a
    if bits_b >= 32:
        sh = bits_b - 32
        if sh == 0:
            return lo_a | hi_b, lo_b
        return (((lo_a << sh) & _M32) | hi_b), lo_b
    return (((hi_a << bits_b) & _M32) | (lo_a >> (32 - bits_b)) | hi_b,
            ((lo_a << bits_b) & _M32) | lo_b)


def _shift_right(x, s: int):
    """Shift a (..., L) array towards lower indices: out[i] = x[i + s]."""
    if s == 0:
        return x
    pad = torch.zeros_like(x[..., :s])
    return torch.cat([x[..., s:], pad], dim=-1)


def kmer_pack(codes: torch.Tensor, k: int):
    """codes (..., L) integer in 0..3 -> ((hi, lo), (rhi, rlo)) int64
    tensors holding 32-bit lanes, where position i holds the fwd k-mer
    codes[i..i+k) and its revcomp."""
    assert 1 <= k <= 31
    c = codes.to(torch.int64) & 3
    rc = c ^ 3
    # binary decomposition: blocks of power-of-two base counts
    fwd_blocks = {1: (torch.zeros_like(c), c)}
    rev_blocks = {1: (torch.zeros_like(c), rc)}
    s = 1
    while s * 2 <= k:
        hi, lo = fwd_blocks[s]
        hi2, lo2 = _shift_right(hi, s), _shift_right(lo, s)
        fwd_blocks[2 * s] = _shift_or(hi, lo, hi2, lo2, 2 * s)
        rhi, rlo = rev_blocks[s]
        rhi2, rlo2 = _shift_right(rhi, s), _shift_right(rlo, s)
        # rc: second half occupies the HIGH bits
        rev_blocks[2 * s] = _shift_or(rhi2, rlo2, rhi, rlo, 2 * s)
        s *= 2
    # compose remaining bits from largest to smallest block
    rem = k
    fhi = flo = rhi = rlo = None
    off = 0
    for s in sorted(fwd_blocks, reverse=True):
        if s > rem:
            continue
        bh, bl = fwd_blocks[s]
        bh, bl = _shift_right(bh, off), _shift_right(bl, off)
        ch, cl = rev_blocks[s]
        ch, cl = _shift_right(ch, off), _shift_right(cl, off)
        if fhi is None:
            fhi, flo, rhi, rlo = bh, bl, ch, cl
        else:
            fhi, flo = _shift_or(fhi, flo, bh, bl, 2 * s)
            # rc: later (higher-index) block goes to HIGH bits
            rhi, rlo = _shift_or(ch, cl, rhi, rlo, 2 * off)
        off += s
        rem -= s
    return (fhi, flo), (rhi, rlo)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) without overflowing int64."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x):
    x = _mul32(x ^ (x >> 16), 0x7feb352d)
    x = _mul32(x ^ (x >> 15), 0x846ca68b)
    return x ^ (x >> 16)


def hash_kmer(hi, lo):
    return _mix32(lo ^ _mix32(hi ^ 0x9e3779b9))


def sliding_min_pair(val, idx, w: int):
    """Per position i: (min value, its leftmost index) over [i, i+w)."""
    s = 1
    spans = {1: (val, idx)}
    while s * 2 <= w:
        v, x = spans[s]
        v2, x2 = _shift_right(v, s), _shift_right(x, s)
        take2 = v2 < v
        spans[2 * s] = (torch.where(take2, v2, v), torch.where(take2, x2, x))
        s *= 2
    rem = w
    cv = cx = None
    off = 0
    for s in sorted(spans, reverse=True):
        if s > rem:
            continue
        v, x = spans[s]
        v, x = _shift_right(v, off), _shift_right(x, off)
        if cv is None:
            cv, cx = v, x
        else:
            take2 = v < cv
            cv, cx = torch.where(take2, v, cv), torch.where(take2, x, cx)
        off += s
        rem -= s
    return cv, cx


def sketch_plain(codes: torch.Tensor, lengths: torch.Tensor, k: int, w: int,
                 cap: int, own_lo=None, own_hi=None) -> Minimizers:
    """Plain version of sketch (any device): minimizers of a read batch.

    codes: (B, L) integer base codes (padded); lengths: (B,) integer.
    cap: max number of emitted minimizers (flat across batch); the first
    `cap` in (row, position) order are kept.
    own_lo/own_hi: optional (B,) — emit only minimizers whose position
    falls in [own_lo, own_hi).  Used by halo-chunked sketching of long
    reads: each chunk owns a disjoint slice, the halos make the window
    minima around the slice identical to a full-read computation.
    """
    return emit_plain(*select_plain(codes, lengths, k, w, own_lo, own_hi),
                      cap)


def _hashes(codes, lengths, k: int):
    """sketch's canonical hashes (UMAX where no k-mer counts) and strands,
    two lanes (k <= 31); with the positions and their k-mer validity."""
    dev = codes.device
    B, L = codes.shape
    (fhi, flo), (rhi, rlo) = kmer_pack(codes, k)
    pos = torch.arange(L, device=dev, dtype=torch.int64)[None, :].expand(B, L)
    valid_k = pos + k <= lengths[:, None]

    fwd_less = (fhi < rhi) | ((fhi == rhi) & (flo < rlo))
    equal = (fhi == rhi) & (flo == rlo)
    strand = torch.where(fwd_less, 0, 1)
    chi = torch.where(fwd_less, fhi, rhi)
    clo = torch.where(fwd_less, flo, rlo)
    h = hash_kmer(chi, clo)
    h = torch.where(valid_k & ~equal, h, UMAX)
    return h, strand, pos, valid_k


def select_plain(codes, lengths, k: int, w: int, own_lo=None, own_hi=None,
                 pos_map=None, wide: bool = False):
    """Plain version of the selection (any device): (h, strand, sel), each
    (B, L): the canonical hashes (UMAX where no k-mer counts), strands and
    the selected positions, window selection shared by sketch and
    sketch_wide (wide: sketch_wide's lanes, k <= 128).  pos_map: optional
    (B, L) original position of each (compressed) column; ownership is
    gated on it."""
    lengths = lengths.to(torch.int64)
    h, strand, pos, valid_k = (_hashes_wide if wide else _hashes)(
        codes, lengths, k)
    dev = h.device
    B, L = h.shape
    _, warg = sliding_min_pair(h, pos, w)
    # i is selected iff some window starting in [i-w+1, i] has argmin == i
    sel = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for d in range(w):
        # window starting at i-d
        if d:
            shifted = torch.cat(
                [torch.zeros((B, d), dtype=torch.int64, device=dev),
                 warg[:, : max(L - d, 0)]], dim=1)[:, :L]
        else:
            shifted = warg
        wvalid = (pos - d >= 0) & (pos - d + w + k - 1 <= lengths[:, None])
        sel = sel | (torch.where(wvalid, shifted, -1) == pos)
    sel = sel & valid_k & (h != UMAX)
    if own_lo is not None:
        opos = pos if pos_map is None else pos_map
        sel = sel & (opos >= own_lo.to(torch.int64)[:, None]) & \
            (opos < own_hi.to(torch.int64)[:, None])
    return h, strand, sel


def emit_plain(h, strand, sel, cap: int, pos_map=None) -> Minimizers:
    """Plain version of the compaction (any device): the selected positions
    compacted in (row, position) order, the first `cap` kept; `pos` reports
    pos_map's entry where it is given."""
    L = h.shape[1]
    flat = sel.reshape(-1)
    hits = torch.nonzero(flat)[:, 0]
    n_all = int(hits.shape[0])
    hits = hits[:cap]
    return Minimizers(
        rid=hits // L,
        pos=hits % L if pos_map is None else pos_map.reshape(-1)[hits],
        hash=h.reshape(-1)[hits],
        strand=strand.reshape(-1)[hits],
        n=int(hits.shape[0]),
        n_all=n_all,
    )


# --------------------------------------------------------------------------
# generic multi-lane packing for k <= 128 (32-bit lanes, MSB-first)

def _lanes_shl(lanes, s: int):
    """Shift a multi-lane value left by s bits (within 32*len(lanes))."""
    if s == 0:
        return list(lanes)
    n = len(lanes)
    word, bit = s // 32, s % 32
    zero = torch.zeros_like(lanes[0])
    out = []
    for i in range(n):
        j = i + word
        v = lanes[j] if j < n else zero
        if bit:
            lo = (lanes[j + 1] >> (32 - bit)) if j + 1 < n else zero
            v = ((v << bit) & _M32) | lo
        out.append(v)
    return out


def _lanes_or(a, b):
    return [x | y for x, y in zip(a, b)]


def kmer_pack_wide(codes: torch.Tensor, k: int, n_lanes: int = 4):
    """codes (..., L) -> (fwd_lanes, rev_lanes): position i holds the fwd
    k-mer codes[i..i+k) and its revcomp as n_lanes 32-bit lanes (int64
    tensors), MSB-first.  Same shift-or doubling as kmer_pack, generalized
    to any lane count."""
    assert 1 <= k <= 16 * n_lanes - 1
    c = codes.to(torch.int64) & 3
    rc = c ^ 3
    zero = torch.zeros_like(c)

    def mk(v):
        return [zero] * (n_lanes - 1) + [v]

    fwd_blocks = {1: mk(c)}
    rev_blocks = {1: mk(rc)}
    s = 1
    while s * 2 <= k:
        a = fwd_blocks[s]
        b = [_shift_right(x, s) for x in a]
        fwd_blocks[2 * s] = _lanes_or(_lanes_shl(a, 2 * s), b)
        ra = rev_blocks[s]
        rb = [_shift_right(x, s) for x in ra]
        # rc: second half occupies the HIGH bits
        rev_blocks[2 * s] = _lanes_or(_lanes_shl(rb, 2 * s), ra)
        s *= 2
    rem, off = k, 0
    fl = rl = None
    for s in sorted(fwd_blocks, reverse=True):
        if s > rem:
            continue
        b = [_shift_right(x, off) for x in fwd_blocks[s]]
        rb = [_shift_right(x, off) for x in rev_blocks[s]]
        if fl is None:
            fl, rl = b, rb
        else:
            fl = _lanes_or(_lanes_shl(fl, 2 * s), b)
            # rc: later (higher-index) block goes to HIGH bits
            rl = _lanes_or(_lanes_shl(rb, 2 * off), rl)
        off += s
        rem -= s
    return fl, rl


def _lanes_less(a, b):
    """Lexicographic a < b over MSB-first 32-bit lanes."""
    lt = a[-1] < b[-1]
    for i in range(len(a) - 2, -1, -1):
        lt = (a[i] < b[i]) | ((a[i] == b[i]) & lt)
    return lt


def _lanes_eq(a, b):
    eq = a[0] == b[0]
    for i in range(1, len(a)):
        eq = eq & (a[i] == b[i])
    return eq


def hash_lanes(lanes):
    h = 0x9e3779b9
    for x in lanes:
        h = _mix32(x ^ h)
    return h


def hpc_compress_plain(codes: torch.Tensor, lengths: torch.Tensor):
    """Plain version of hpc_compress (any device).  Homopolymer-compress a
    padded batch: returns (codes_hpc, pos_map,
    lengths_hpc), all over the whole (B, L) buffer, where codes_hpc[b, j]
    is the j-th run base (padded with 4) and pos_map[b, j] the ORIGINAL
    position of that run's first base (padded with 0).  Runs are of the
    raw codes, so N (code 4) forms runs of its own; positions at or past
    `lengths` are never kept."""
    dev = codes.device
    B, L = codes.shape
    pos = torch.arange(L, device=dev, dtype=torch.int64)[None, :].expand(B, L)
    in_read = pos < lengths.to(torch.int64)[:, None]
    keep = in_read & ((pos == 0) | (codes != torch.roll(codes, 1, dims=1)))
    # parked (non-kept) writes land in column L, which is sliced away, so
    # they can never clobber a real run
    tgt = torch.where(keep, torch.cumsum(keep, dim=1) - 1, L)
    codes_hpc = torch.full((B, L + 1), 4, dtype=codes.dtype, device=dev)
    pos_map = torch.zeros((B, L + 1), dtype=torch.int64, device=dev)
    codes_hpc.scatter_(1, tgt, codes)
    pos_map.scatter_(1, tgt, pos)
    lengths_hpc = keep.sum(dim=1).to(lengths.dtype)
    return codes_hpc[:, :L], pos_map[:, :L], lengths_hpc


def _hashes_wide(codes, lengths, k: int):
    """sketch_wide's canonical hashes and strands (as _hashes) over
    max(2, k // 16 + 1) lanes."""
    dev = codes.device
    B, L = codes.shape
    # minimal lane count: k // 16 + 1 covers the 16 * n - 1 packing bound;
    # for k <= 31 (2 lanes) hashes match sketch() exactly
    n_lanes = max(2, k // 16 + 1)
    fl, rl = kmer_pack_wide(codes, k, n_lanes=n_lanes)
    pos = torch.arange(L, device=dev, dtype=torch.int64)[None, :].expand(B, L)
    valid_k = pos + k <= lengths[:, None]
    fwd_less = _lanes_less(fl, rl)
    equal = _lanes_eq(fl, rl)
    strand = torch.where(fwd_less, 0, 1)
    h = hash_lanes([torch.where(fwd_less, f, r) for f, r in zip(fl, rl)])
    h = torch.where(valid_k & ~equal, h, UMAX)
    return h, strand, pos, valid_k


def sketch_wide_plain(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                      w: int, cap: int, hpc: bool = False, own_lo=None,
                      own_hi=None) -> Minimizers:
    """Plain version of sketch_wide (any device).  Long-k (k <= 128)
    minimizer sketch, optionally homopolymer-compressed (hpc).  Positions
    are reported in original read coordinates.  own_lo/own_hi (optional,
    (B,)): emit only minimizers whose ORIGINAL-coordinate position falls in
    [own_lo, own_hi) — the halo-chunking hook (see sketch())."""
    pos_map = None
    if hpc:
        codes, pos_map, lengths = hpc_compress_plain(codes, lengths)
    return emit_plain(*select_plain(codes, lengths, k, w, own_lo, own_hi,
                                    pos_map, wide=True), cap, pos_map)


# --------------------------------------------------------------------------
# The device program: two hand-written CUDA kernels (csrc/sketch.cu).  The
# wrappers take the plain versions above for CPU tensors only.

SKETCH_THREADS = 256      # threads a block of sketch_minimizers
SKETCH_W_MAX = 2048       # windows the kernels take at most
SKETCH_K_MAX = 143        # 9 lanes of 32 bits: k <= 16 * 9 - 1


def sketch_tile(w: int, per: int = 0):
    """(np, tile) of a sketch_minimizers block at window w: it hashes np =
    SKETCH_THREADS * per positions and owns the tile = np - 2 (w - 1) of
    them between its halos.  The least per (per = 0) is 2 up to w = 129,
    then as many as keep the tile at SKETCH_THREADS or more; the kernel
    takes 4 instead of 2 where a launch of 2 a thread would not fit on the
    card at once (ndt_sketch_layout)."""
    least = max(2, -(-(2 * (w - 1) + SKETCH_THREADS) // SKETCH_THREADS))
    n = SKETCH_THREADS * max(per, least)
    return n, n - 2 * (w - 1)


def _codes_pitch(codes: torch.Tensor) -> int:
    """Bytes between two rows of an int8 (B, L) codes tensor on a CUDA
    device: contiguous, or a column slice codes[:, :L] of a wider one (the
    mesh's shard buffers); the kernels read it a byte at a time, so no
    alignment is asked."""
    ok = (codes.dtype == torch.int8 and codes.dim() == 2
          and (codes.shape[1] <= 1 or codes.stride(1) == 1)
          and (codes.shape[0] <= 1 or codes.stride(0) >= codes.shape[1]))
    if not ok:
        raise ValueError(
            f"codes: expected int8 (B, L) with unit stride along L, got "
            f"{codes.dtype} {tuple(codes.shape)} strides "
            f"{tuple(codes.stride())}")
    return max(codes.stride(0), codes.shape[1])


def _rows_i32(name: str, t: torch.Tensor, B: int, dev, lo: int, hi: int):
    """A (B,) int32 tensor of t for the kernels: int32 as given, a wider
    integer type clamped to [lo, hi] first, which keeps every comparison
    the kernels make against positions in [0, L)."""
    if t.dtype != torch.int32:
        t = t.to(dev).clamp(lo, hi).to(torch.int32)
    t = t.contiguous()
    check_tensor(name, t, (B,), torch.int32, dev)
    return t


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _hpc_launch(codes, lengths):
    """hpc_compress's kernel: (codes_hpc, pos_map, lengths_hpc int32)."""
    dev = codes.device
    B, L = codes.shape
    pitch = _codes_pitch(codes)
    lens = _rows_i32("lengths", lengths, B, dev, 0, L)
    codes_hpc = torch.empty((B, L), dtype=torch.int8, device=dev)
    pos_map = torch.empty((B, L), dtype=torch.int64, device=dev)
    lens_hpc = torch.empty(B, dtype=torch.int32, device=dev)
    if B and L:
        lib = _build.kernels()
        with torch.cuda.device(dev):
            rc = lib.ndt_hpc_compress(
                codes.data_ptr(), pitch, lens.data_ptr(),
                codes_hpc.data_ptr(), pos_map.data_ptr(),
                lens_hpc.data_ptr(), B, L, _stream(dev))
        _build.check_launch("hpc_compress", rc)
        _build.count_launch("hpc_compress", dev)
    else:
        lens_hpc.zero_()
    return codes_hpc, pos_map, lens_hpc


class _Buffers(NamedTuple):
    """One sketch launch's inputs as the kernel takes them and its
    buffers: out (4, stride) int64, n_all (1,) int64, status (G + 1,)
    int64 (a status word a tile of the look-back, then the ticket)."""
    codes: torch.Tensor
    pitch: int
    lens: torch.Tensor
    own_lo: object
    own_hi: object
    pos_map: object
    out: torch.Tensor
    n_all: torch.Tensor
    status: torch.Tensor


def _buffers(codes, lengths, k: int, w: int, cap: int, own_lo=None,
             own_hi=None, pos_map=None) -> _Buffers:
    """Check a CUDA sketch's inputs and allocate its buffers."""
    dev = codes.device
    B, L = codes.shape
    pitch = _codes_pitch(codes)
    if not (1 <= k <= SKETCH_K_MAX and 1 <= w <= SKETCH_W_MAX):
        raise ValueError(f"sketch kernels take 1 <= k <= {SKETCH_K_MAX} and "
                         f"1 <= w <= {SKETCH_W_MAX}, got k={k}, w={w}")
    lens = _rows_i32("lengths", lengths, B, dev, 0, L)
    if own_lo is not None:
        own_lo = _rows_i32("own_lo", own_lo, B, dev, -1, L + 1)
        own_hi = _rows_i32("own_hi", own_hi, B, dev, -1, L + 1)
    if pos_map is not None:
        check_tensor("pos_map", pos_map, (B, L), torch.int64, dev)
    e = lambda *s, dt: torch.empty(s, dtype=dt, device=dev)
    tile = sketch_tile(w)[1]
    return _Buffers(
        codes, pitch, lens, own_lo, own_hi, pos_map,
        out=e(4, max(0, min(cap, B * L)), dt=torch.int64),
        n_all=e(1, dt=torch.int64),
        status=e(B * -(-L // tile) + 1, dt=torch.int64))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _minimizers_launch(lib, sb: _Buffers, k: int, w: int) -> None:
    """One launch of sketch_minimizers_kernel on the current device (its
    status words zeroed first on the same stream)."""
    B, L = sb.codes.shape
    rc = lib.ndt_sketch_minimizers(
        sb.codes.data_ptr(), sb.pitch, sb.lens.data_ptr(), _ptr(sb.own_lo),
        _ptr(sb.own_hi), _ptr(sb.pos_map), sb.out.data_ptr(),
        sb.out.shape[1], sb.n_all.data_ptr(), sb.status.data_ptr(),
        sb.status.shape[0], B, L, k, w, _stream(sb.codes.device))
    _build.check_launch("sketch_minimizers", rc)


def _sketch_launch(codes, lengths, k: int, w: int, cap: int, own_lo, own_hi,
                   pos_map=None) -> Minimizers:
    """sketch_minimizers on codes' device, then n_all read back: the call's
    one host sync."""
    dev = codes.device
    sb = _buffers(codes, lengths, k, w, cap, own_lo, own_hi, pos_map)
    n_all = 0
    if codes.numel():
        lib = _build.kernels()
        with torch.cuda.device(dev):
            _minimizers_launch(lib, sb, k, w)
            _build.count_launch("sketch_minimizers", dev)
        n_all = int(sb.n_all)
    n = min(n_all, sb.out.shape[1])
    rid, pos, h, strand = sb.out[:, :n].unbind(0)
    return Minimizers(rid=rid, pos=pos, hash=h, strand=strand, n=n,
                      n_all=n_all)


def sketch(codes: torch.Tensor, lengths: torch.Tensor, k: int, w: int,
           cap: int, own_lo=None, own_hi=None) -> Minimizers:
    """Minimizers of a read batch (k <= 31).

    codes: (B, L) integer base codes (padded; int8 on a CUDA device, where
    a column slice of a wider buffer is taken as it is); lengths: (B,)
    integer, each at most L.  cap: max number of emitted minimizers (flat
    across batch); the first `cap` in (row, position) order are kept.
    own_lo/own_hi: optional (B,) — emit only minimizers whose position
    falls in [own_lo, own_hi).  Used by halo-chunked sketching of long
    reads: each chunk owns a disjoint slice, the halos make the window
    minima around the slice identical to a full-read computation.

    CPU tensors run sketch_plain; CUDA tensors launch sketch_minimizers,
    then read the selected count: one host sync."""
    if codes.device.type == "cpu":
        return sketch_plain(codes, lengths, k, w, cap, own_lo, own_hi)
    assert 1 <= k <= 31
    return _sketch_launch(codes, lengths, k, w, cap, own_lo, own_hi)


def sketch_wide(codes: torch.Tensor, lengths: torch.Tensor, k: int, w: int,
                cap: int, hpc: bool = False, own_lo=None,
                own_hi=None) -> Minimizers:
    """Long-k (k <= 128) minimizer sketch, optionally homopolymer-
    compressed (hpc).  Positions are reported in original read
    coordinates.  own_lo/own_hi (optional, (B,)): emit only minimizers
    whose ORIGINAL-coordinate position falls in [own_lo, own_hi) — the
    halo-chunking hook (see sketch()).

    CPU tensors run sketch_wide_plain; CUDA tensors launch hpc_compress
    (under hpc) and sketch_minimizers: one host sync."""
    if codes.device.type == "cpu":
        return sketch_wide_plain(codes, lengths, k, w, cap, hpc, own_lo,
                                 own_hi)
    pos_map = None
    if hpc:
        codes, pos_map, lengths = _hpc_launch(codes, lengths)
    return _sketch_launch(codes, lengths, k, w, cap, own_lo, own_hi, pos_map)


def hpc_compress(codes: torch.Tensor, lengths: torch.Tensor):
    """Homopolymer-compress a padded batch: (codes_hpc, pos_map,
    lengths_hpc), as hpc_compress_plain gives them.  CPU tensors run
    hpc_compress_plain; CUDA tensors (int8 codes, lengths at most L) launch
    the kernel, no host sync."""
    if codes.device.type == "cpu":
        return hpc_compress_plain(codes, lengths)
    codes_hpc, pos_map, lens = _hpc_launch(codes, lengths)
    return codes_hpc, pos_map, lens.to(lengths.dtype)
