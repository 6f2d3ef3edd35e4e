"""Assembly output formats (nextgraph -a 0..5 parity).

Replaces util/ng/out.c: fasta with typed headers
(out_ctg_fasta:469-519), GFA2 (out_ctg_gfa:132+), GraphML
(out_graph_graphml:535+), contig paths (out_ctg_path:100+), and the N-stat
table (stat_ctg:40-58).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from ..io.fastx import codes_to_str

CTG_TYPES = ("unknown", "linear", "loop", "breakpoint", "junction")  # ctg.h:18-20


def classify_path(sg, path) -> int:
    """Type per ctg.h:18-20 semantics: 1 linear, 2 loop, 3 dead end (od==0),
    4 junction node."""
    if len(path) == 1:
        v = path[0][0]
        ind, outd = sg.degree(v)
        if outd == 0:
            return 3
        if ind > 1 and outd > 1:
            return 4
        return 0
    first, last = path[0][0], path[-1][0]
    for e in sg.out_edges(last):
        if e.v == first:
            return 2
    return 1


def pack_node_qv(meta: List[dict]) -> str:
    """Pack per-node quality into the reference's header tag: qv:i:<hex>:...
    with each value off<<32 | ide<<20 | ort<<10 | irt (out.c:487-499)."""
    parts = []
    for m in meta:
        v = (m["off"] << 32) | (m["ide"] << 20) | (m["ort"] << 10) | m["irt"]
        parts.append(f"{v:x}")
    return "qv:i:" + ":".join(parts)


def parse_ctg_header(header: str) -> dict:
    """Decode a contig header back into fields (set_ref_qv parity,
    lib/ctg_cns.c:2233-2268): returns dict with type/length/node and a qv
    list of dicts(p, ide, ort, irt)."""
    out = {"qv": []}
    for token in header.split():
        if token.startswith("type:s:"):
            out["type"] = token[7:]
        elif token.startswith("length:i:"):
            out["length"] = int(token[9:])
        elif token.startswith("node:i:"):
            out["node"] = int(token[7:])
        elif token.startswith("qv:i:"):
            for h in token[5:].split(":"):
                t = int(h, 16)
                out["qv"].append(dict(p=t >> 32, ide=(t >> 20) & 0x3FF,
                                      ort=(t >> 10) & 0x3FF, irt=t & 0x3FF))
    return out


def write_ctg_fasta(path: str, sg, seqs: List[np.ndarray], paths=None,
                    min_len: int = 1000, node_meta=None):
    """FASTA with the reference's typed headers:
    >ctg%06d type:s:<t> length:i:<L> node:i:<n> qv:i:<hex-per-node>
    (out.c:487); lq node segments are emitted lowercase (out.c:508-510)."""
    tmp = path + ".tmp"
    paths = paths if paths is not None else [None] * len(seqs)
    with open(tmp, "w") as fh:
        for i, s in enumerate(seqs):
            if len(s) < min_len:
                continue
            t = classify_path(sg, paths[i]) if paths[i] is not None else 0
            nn = len(paths[i]) if paths[i] is not None else 0
            hdr = (f">ctg{i:06d} type:s:{CTG_TYPES[t]} length:i:{len(s)} "
                   f"node:i:{nn}")
            seq = codes_to_str(s)
            if node_meta is not None and i < len(node_meta) and node_meta[i]:
                meta = node_meta[i]
                hdr += " " + pack_node_qv(meta)
                chars = list(seq)
                for m in meta:
                    if m["lq"]:
                        a, b = m["off"], m["off"] + m["seg"]
                        chars[a:b] = [c.lower() for c in chars[a:b]]
                seq = "".join(chars)
            fh.write(f"{hdr}\n{seq}\n")
    os.replace(tmp, path)


def write_ctg_gfa(path: str, sg, seqs: List[np.ndarray], paths) -> None:
    """GFA2 (out_ctg_gfa analogue): S-lines per contig, E-lines between
    contigs whose terminal reads still share graph edges."""
    end_read = {}
    for i, p in enumerate(paths):
        if p:
            end_read[p[0][0] // 2] = (i, "head")
            end_read[p[-1][0] // 2] = (i, "tail")
    with open(path + ".tmp", "w") as fh:
        fh.write("H\tVN:Z:2.0\n")
        for i, s in enumerate(seqs):
            fh.write(f"S\tctg{i:06d}\t{len(s)}\t{codes_to_str(s)}\n")
        eid = 0
        for e in sg.edges:
            if e.deleted or e.reduced:
                continue
            a = end_read.get(e.u // 2)
            b = end_read.get(e.v // 2)
            if a and b and a[0] != b[0]:
                sa = "+" if (e.u & 1) == 0 else "-"
                sb = "+" if (e.v & 1) == 0 else "-"
                fh.write(f"E\teg{eid:06d}\tctg{a[0]:06d}{sa}\t"
                         f"ctg{b[0]:06d}{sb}\t*\t*\t*\t*\t*\n")
                eid += 1
    os.replace(path + ".tmp", path)


def write_graphml(path: str, sg) -> None:
    """GraphML dump of the cleaned string graph (out_graph_graphml)."""
    with open(path + ".tmp", "w") as fh:
        fh.write('<?xml version="1.0" encoding="UTF-8"?>\n'
                 '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">\n'
                 '<key id="len" for="edge" attr.name="length" attr.type="int"/>\n'
                 '<key id="ide" for="edge" attr.name="identity" attr.type="int"/>\n'
                 '<graph id="G" edgedefault="directed">\n')
        verts = set()
        for e in sg.edges:
            if not (e.deleted or e.reduced):
                verts.add(e.u)
                verts.add(e.v)
        for v in sorted(verts):
            fh.write(f'<node id="n{v}"/>\n')
        for e in sg.edges:
            if e.deleted or e.reduced:
                continue
            fh.write(f'<edge source="n{e.u}" target="n{e.v}">'
                     f'<data key="len">{e.hang}</data>'
                     f'<data key="ide">{e.ide}</data></edge>\n')
        fh.write("</graph>\n</graphml>\n")
    os.replace(path + ".tmp", path)


def write_ctg_paths(path: str, sg, paths) -> None:
    """Per-contig node paths (out_ctg_path): read name, strand per node."""
    with open(path + ".tmp", "w") as fh:
        for i, p in enumerate(paths):
            nodes = " ".join(f"{v // 2}{'-' if v & 1 else '+'}" for v, _ in p)
            fh.write(f"ctg{i:06d}\t{len(p)}\t{nodes}\n")
    os.replace(path + ".tmp", path)


def stat_table(seqs: List[np.ndarray], genome_size: int | None = None) -> str:
    """N-stat table text in the reference's layout (out.c stat_ctg)."""
    lens = sorted((len(s) for s in seqs), reverse=True)
    if not lens:
        return "empty assembly\n"
    total = sum(lens)
    gs = genome_size or total
    lines = [f"{'Type':<5} {'Length (bp)':>20} {'Count (#)':>20}"]
    cum = 0
    j = 1
    for i, L in enumerate(lens):
        cum += L
        while cum >= gs * 0.1 * j and j < 10:
            lines.append(f"N{j}0   {L:>20} {i + 1:>20}")
            j += 1
    lines.append("")
    lines.append(f"{'Min.':<5} {lens[-1]:>18} {'-':>20}")
    lines.append(f"{'Max.':<5} {lens[0]:>18} {'-':>20}")
    lines.append(f"{'Ave.':<5} {int(total / len(lens) + 0.5):>18} {'-':>20}")
    lines.append(f"{'Total':<5} {total:>18} {len(lens):>20}")
    return "\n".join(lines) + "\n"
