"""Readers/writers for the reference NextDenovo on-disk formats (PyTorch/CUDA
port: a copy of nextdenovo_tpu/io/refformats.py; numpy only).

Interop layer for golden cross-validation and migration: a user with
reference-produced artifacts (2bit read DBs, binary .ovl overlap streams)
can load them here, and our artifacts can be written back in the reference
encoding for its tools to consume.

Formats (studied from the reference sources, re-implemented from scratch):

2bit sequence DB (lib/bseq.c:93-139 init_seq_mode/seq2bit):
  2-byte magic {0, 254}; per read: uint32 LE name, uint32 LE length, then
  ceil(len/16) uint32 LE words, 16 bases each, FIRST base in the TOP two
  bits (buffer = buffer<<2 | code), final partial word left-aligned.

binary .ovl (lib/ovl.c:109-253 encode_ovl/decode_ovl/encode_ovl_i):
  a stream of big-endian base-128 varints (7 data bits per byte, high bit
  set on every byte except the last).  Mode 8 (raw, no header) records are
  8 values [d_qname, rev, qs, qe-qs, d_tname, ts, |alnlen_q - alnlen_t|,
  match]; mode 10 (cns, 2-byte magic {0, 255}) records are 10 values
  [d_qname, rev, qs, qe-qs, d_tname, ts, |d_alnlen|, qlen, tlen,
  identity*10000] with qlen/tlen written as 0 when the name repeats the
  previous record's.  Name deltas are vs the previous record (prev starts
  at 0); delta signs ride bits 1-3 of `rev` (0b10 qname, 0b100 tname,
  0b1000 alnlen diff); te is reconstructed as ts + (qe-qs) -/+ diff.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..overlap.records import OvlBlock

MAGIC_2BIT = b"\x00\xfe"
MAGIC_OVL10 = b"\x00\xff"


# ---------------------------------------------------------------------------
# 2bit


def write_2bit(path: str, seqs: List[np.ndarray],
               names: Optional[List[int]] = None) -> None:
    """seqs: base-code arrays (0..3); names: integer read names (the
    reference assigns dense integers at dump time, seq_dump.c:59-118)."""
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    with open(path, "wb") as fh:
        fh.write(MAGIC_2BIT)
        for i, s in enumerate(seqs):
            name = np.uint32(names[i] if names is not None else i)
            s = np.asarray(s, np.uint32) & 3
            nw = (len(s) + 15) // 16
            pad = np.zeros(nw * 16, np.uint32)
            pad[: len(s)] = s
            words = (pad.reshape(nw, 16) << shifts[None, :]).sum(
                axis=1, dtype=np.uint32)
            fh.write(np.uint32(name).tobytes())
            fh.write(np.uint32(len(s)).tobytes())
            fh.write(words.astype("<u4").tobytes())


def read_2bit(path: str) -> Tuple[List[np.ndarray], List[int]]:
    """Returns (codes list, integer names)."""
    data = open(path, "rb").read()
    if data[:2] != MAGIC_2BIT and data[:1] != b"\x00" and data[:1] != b"\xfe":
        raise ValueError(f"{path}: not a 2bit DB (magic {data[:2]!r})")
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    seqs, names = [], []
    off = 2
    n = len(data)
    while off + 8 <= n:
        name, ln = np.frombuffer(data, "<u4", 2, off)
        off += 8
        nw = (int(ln) + 15) // 16
        words = np.frombuffer(data, "<u4", nw, off)
        off += 4 * nw
        codes = ((words[:, None] >> shifts[None, :]) & 3).astype(np.uint8)
        seqs.append(codes.reshape(-1)[: int(ln)])
        names.append(int(name))
    return seqs, names


# ---------------------------------------------------------------------------
# varint .ovl


def _encode_varints(vals: np.ndarray) -> bytes:
    """Big-endian base-128 with continuation on all but the last byte."""
    vals = np.asarray(vals, np.uint64)
    nb = np.ones(len(vals), np.int64)
    for k in range(1, 5):
        nb += (vals >= (1 << (7 * k))).astype(np.int64)
    ends = np.cumsum(nb)
    starts = ends - nb
    # byte j of value i (0-based from the value start) holds group
    # (nb[i]-1-j), i.e. most-significant first
    pos = np.arange(int(ends[-1]) if len(ends) else 0, dtype=np.int64)
    vid = np.searchsorted(ends, pos, side="right")
    j = pos - starts[vid]
    group = nb[vid] - 1 - j
    out = ((vals[vid] >> (7 * group).astype(np.uint64)) & 127).astype(
        np.uint8)
    out[j < nb[vid] - 1] |= 128
    return out.tobytes()


def _decode_varints(data: np.ndarray) -> np.ndarray:
    """Decode a whole byte stream of varints to a uint64 array."""
    b = np.asarray(data, np.uint8)
    if len(b) == 0:
        return np.zeros(0, np.uint64)
    term = b < 128
    if not term[-1]:
        raise ValueError("truncated varint stream (ends mid-value)")
    nv = int(term.sum())
    vid = np.concatenate([[0], np.cumsum(term)[:-1]]).astype(np.int64)
    term_pos = np.nonzero(term)[0]
    shift = 7 * (term_pos[vid] - np.arange(len(b)))
    contrib = (b & 127).astype(np.float64) * np.exp2(shift.astype(np.float64))
    return np.bincount(vid, weights=contrib, minlength=nv).astype(np.uint64)


def write_ovl(path: str, blk: OvlBlock, mode: Optional[int] = None,
              qlen: Optional[np.ndarray] = None,
              tlen: Optional[np.ndarray] = None) -> None:
    """Write records in the reference binary encoding.  mode defaults to
    10 when the block carries `ide` (and per-record qlen/tlen are given),
    else 8.  Ends are EXCLUSIVE here (our convention); the reference's
    qe/te are exclusive too at this layer (qe-qs = alignment length)."""
    if mode is None:
        mode = 10 if "ide" in blk.data else 8
    n = len(blk)
    g = lambda k: np.asarray(blk.data[k], np.int64)
    qn, rev, qs, qe = g("qname"), g("rev"), g("qs"), g("qe")
    tn, ts, te = g("tname"), g("ts"), g("te")
    alq = qe - qs
    alt = te - ts
    prev_q = np.concatenate([[0], qn[:-1]])
    prev_t = np.concatenate([[0], tn[:-1]])
    dq = qn - prev_q
    dt = tn - prev_t
    dd = alq - alt
    flags = (rev & 1) | ((dq < 0) << 1) | ((dt < 0) << 2) | ((dd < 0) << 3)
    cols = [np.abs(dq), flags, qs, alq, np.abs(dt), ts, np.abs(dd)]
    if mode == 8:
        cols.append(g("match"))
    else:
        if qlen is None or tlen is None:
            raise ValueError("mode 10 needs per-record qlen/tlen")
        ql = np.where(qn == prev_q, 0, np.asarray(qlen, np.int64))
        tl = np.where(tn == prev_t, 0, np.asarray(tlen, np.int64))
        cols += [ql, tl, g("ide")]
    vals = np.stack(cols, axis=1).reshape(-1) if n else np.zeros(0, np.int64)
    with open(path, "wb") as fh:
        if mode == 10:
            fh.write(MAGIC_OVL10)
        fh.write(_encode_varints(vals))


def read_ovl(path: str):
    """Read a reference binary .ovl.  Returns (OvlBlock, extras) where
    extras has mode and, for mode 10, per-record qlen/tlen arrays (zeros
    carried forward like the reference's consumers do)."""
    raw = np.fromfile(path, np.uint8)
    mode = 8
    if len(raw) >= 2 and raw[0] == 0 and raw[1] == 255:
        mode = 10
        raw = raw[2:]
    vals = _decode_varints(raw).astype(np.int64)
    nf = mode
    if len(vals) % nf:
        raise ValueError(f"{path}: truncated record "
                         f"({len(vals)} values, {nf} per record)")
    v = vals.reshape(-1, nf)
    flags = v[:, 1]
    sq = np.where(flags & 0b10, -1, 1)
    st = np.where(flags & 0b100, -1, 1)
    sd = np.where(flags & 0b1000, -1, 1)
    qn = np.cumsum(v[:, 0] * sq)
    tn = np.cumsum(v[:, 4] * st)
    qs = v[:, 2]
    qe = qs + v[:, 3]
    ts = v[:, 5]
    te = ts + v[:, 3] - sd * v[:, 6]
    rev = flags & 1
    cols = dict(qname=qn, rev=rev, qs=qs, qe=qe, tname=tn, ts=ts, te=te)
    extras = dict(mode=mode)
    if mode == 8:
        cols["match"] = v[:, 7]
    else:
        cols["match"] = np.minimum(qe - qs, te - ts)
        cols["ide"] = v[:, 9]
        extras["qlen"] = _ffill_zeros(v[:, 7], qn)
        extras["tlen"] = _ffill_zeros(v[:, 8], tn)
    return OvlBlock({k: c.astype(np.int32) for k, c in cols.items()}), extras


def _ffill_zeros(x: np.ndarray, _names: np.ndarray) -> np.ndarray:
    """Carry the last nonzero value forward (reference consumers keep the
    previous qlen/tlen when a repeat writes 0, ovl_cvt.c decode)."""
    idx = np.arange(len(x))
    has = np.where(x != 0, idx, -1)
    last = np.maximum.accumulate(has)
    return np.where(last >= 0, x[np.maximum(last, 0)], 0)


# ---------------------------------------------------------------------------
# .bl sidecar + indexed single-line fasta (nextgraph's two other inputs)

EDGEBACKLEN = 10   # lib/ovl.h:12
MAX_CON = 2        # lib/ovl.h:70


def write_bl(path: str, st: np.ndarray, touched: np.ndarray,
             alns: np.ndarray, lens: np.ndarray, name_off: int = 0) -> None:
    """Write the reference `.bl` sidecar (out_bl, lib/ovl.c:339-362) from
    CnsInfo-layout arrays (overlap.cns.filter_cns_overlaps):

      st (n,9) int32 [con, lc, rc, lim, rim, llm, rlm, alnl_s, alnl_e]
      touched (n,) bool — read appeared in some record (kh_exist)
      alns (m,3) int32 (rid, s, e) covered intervals, already in the
        +EDGEBACKLEN domain (fill_aln, lib/ovl.c:324-330)
      lens (n,) read lengths

    Per touched read: `name\\tcon` when contained (con >= MAX_CON), else the
    full stat line followed by the MERGED intervals printed back in raw
    coordinates (s-EDGEBACKLEN, e+EDGEBACKLEN).  `name_off` shifts names
    (export uses +1: a first record named 0 is ambiguous in the varint
    .ovl delta encoding, see write_ovl)."""
    st = np.asarray(st)
    per_read: dict = {}
    if len(alns):
        a = np.asarray(alns)
        o = np.lexsort((a[:, 1], a[:, 0]))
        a = a[o]
        for rid, s, e in a:
            ivs = per_read.setdefault(int(rid), [])
            # merge_aln (lib/ovl.c:290-318): touching intervals coalesce
            if ivs and s <= ivs[-1][1]:
                ivs[-1][1] = max(ivs[-1][1], int(e))
            else:
                ivs.append([int(s), int(e)])
    with open(path, "w") as fh:
        for r in np.nonzero(np.asarray(touched, bool))[0]:
            r = int(r)
            name = r + name_off
            con = int(st[r, 0])
            if con >= MAX_CON:
                fh.write(f"{name}\t{con}\n")
                continue
            cols = [name, con] + [int(st[r, c]) for c in range(1, 7)] + \
                [int(lens[r]), int(st[r, 7]), int(st[r, 8])]
            for s, e in per_read.get(r, []):
                cols += [s - EDGEBACKLEN, e + EDGEBACKLEN]
            fh.write("\t".join(map(str, cols)) + "\n")


def write_seqs_fasta_idx(path: str, seqs: List[np.ndarray],
                         names: Optional[List[int]] = None) -> None:
    """Single-line fasta with integer names + `.idx` sidecar
    (`name\\toffset\\tlength`, offset = byte position of the first base) —
    the layout nextgraph's init_index/subfa contig extraction expects
    (lib/index.c:70-106, lib/bseq.c:205-222)."""
    b2c = np.frombuffer(b"ACGT", np.uint8)
    off = 0
    with open(path, "wb") as fa, open(path + ".idx", "w") as ix:
        for i, s in enumerate(seqs):
            name = int(names[i]) if names is not None else i
            hdr = f">{name}\n".encode()
            fa.write(hdr)
            off += len(hdr)
            body = b2c[np.asarray(s, np.uint8) & 3].tobytes()
            fa.write(body + b"\n")
            ix.write(f"{name}\t{off}\t{len(body)}\n")
            off += len(body) + 1
