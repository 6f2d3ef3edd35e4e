"""Bidirected string-graph assembly (nextgraph equivalent, host side).

Re-implements the reference's string-graph assembler (util/ng/)
pipeline: per-read trimmed extents + containment from the cns-overlap
blacklist info, dovetail edge construction with identity/score-ratio voting
(asg.c:1468-1683 update_graph), Myers-style transitive reduction with fuzz
(asg.c mark_edge_tr), tip/short-branch clipping, low-score branch removal,
simple bubble popping, and unambiguous-path contig extraction
(ctg.c:67-295 generate_ctg).

The full pass set runs in the reference's order (ng/main.c:191-279): chimeric
-node marking (bounded BFS, asg.c:1040-1206), transitive reduction, tip/spur
clipping (incl. the short-isolated-chain noise floor, rm_sht_brh :697),
identity/score-ratio branch cuts, z-branch clipping by label and by the two
score passes (rm_z_clip_score3 :2681 per-branch score+triangle-count ratios,
rm_z_clip_score2 :3016 global progressive weakest-first clipping with
endpoint re-discovery), superbubble / compound-path resolution
(clean_complex_* asg.c:2177+, rm_long_bubble :3403), short/end loop breaking
(:941,:1008), and triangle-count chimeric-edge sweeps
(calc_edge_tc/rm_edge_chim/rm_edge_ltc :1207-1347).  The whole pipeline is
golden-cross-validated against the reference's own nextgraph binary on
identical exported inputs (tests/test_golden_graph.py).

Vertex encoding: v = rid*2 + dir (dir 0 = read forward).  Every edge has a
complement (t^1 -> q^1); all mutations keep the pair symmetric.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# defaults mirror ng/opt.c:48-89
DEFAULTS = dict(
    fuzz_len=1000, min_ide=0.001, min_ide_ratio=0.7, min_sco_ratio=0.4,
    max_sco_ratio=0.5, min_mat_ratio=0.9, max_hang_len=500, min_node_count=2,
    min_con_count=2,
    sbranch_len=15, bubble_len=500, out_ctg_len=1000, min_edge_cov=3,
    end_loop_len=50, bfs_depth=2, sloop_len=5,
    zbranch_len=8, out_spath_len=0, min_depth_ratio=0.6,
)


@dataclass
class ReadInfo:
    """Per-read info distilled from the cns-align .bl data
    (lib/ovl.c:339-361 out_bl fields)."""
    length: int
    s: int = 0            # trimmed extent start (le)
    e: int = 0            # trimmed extent end (length - re)
    con: int = 0          # containment count
    lim: int = 0          # best identity (x10000) at left end
    rim: int = 0
    llm: int = 0          # best aln len at left end
    rlm: int = 0
    lc: int = 0           # 5' dovetail depth (ovlinfo.lc)
    rc: int = 0           # 3' dovetail depth

    def __post_init__(self):
        if self.e == 0:
            self.e = self.length


# MFLAG bits carried per edge (ng/edge.h:7-21); IL/OL are not stored — in
# our vertex encoding they equal the endpoint direction bits (u&1 / v&1)
M_REP1, M_LS, M_HS, M_BS = 0x2, 0x10, 0x20, 0x40
M_CN, M_CC, M_LQ, M_TT = 0x80, 0x100, 0x200, 0x8000


@dataclass
class Edge:
    u: int
    v: int
    hang: int        # bases of v's read appended when traversing (ng len)
    sco: int         # aln length
    ide: int         # identity x10000
    ie: int = -1     # junction cut on u's read, fwd frame (ng edge.ie)
    oe: int = -1     # junction cut on v's read, fwd frame (ng edge.oe)
    deleted: bool = False
    reduced: bool = False
    mfl: int = 0     # MFLAG bitfield (REP1/LS/HS/BS/CN/CC/LQ/TT)
    tc: int = 0      # triangle count (ng edge.tc, cached by calc_edge_tc)

    @property
    def chim(self) -> bool:
        """MFLAG_CN: touches a chimeric-marked node."""
        return bool(self.mfl & M_CN)

    @property
    def rep(self) -> bool:
        """MFLAG_REP1: touches a repeat-depth node."""
        return bool(self.mfl & M_REP1)


class StringGraph:
    def __init__(self, reads: Dict[int, ReadInfo], **params):
        self.p = dict(DEFAULTS)
        self.p.update(params)
        self.reads = reads
        self.edges: List[Edge] = []
        self.out: Dict[int, List[int]] = {}   # vertex -> out-edge indices
        self.inn: Dict[int, List[int]] = {}   # vertex -> in-edge indices
        self.einfo: Dict[Tuple[int, int], int] = {}
        # vertex ids in the reference's node-creation order (update_graph
        # add_node: rid then lid at a read's first accepted overlap,
        # ng/asg.c:1547-1553) — every order-dependent cleaning pass iterates
        # nodes in this order like the reference's `for (i=1; i<g->ni; i++)`
        self.node_order: List[int] = []
        self._known_nodes: set = set()

    # ---------- construction ----------
    @staticmethod
    def _cut(vtx: int, span) -> int:
        """Junction cut coordinate for read `vtx//2` traversed in direction
        `vtx&1`, given its alignment span [s, e) in forward-frame coords:
        the fwd-frame position where the traversal leaves the overlap.
        Matches the reference's per-edge ie/oe fields (ng/asg.c:1574-1676
        add_edge args: qe-1/te-1 when exiting forward, qs/ts when exiting
        reverse)."""
        if span is None:
            return -1
        s, e = span
        return s if (vtx & 1) else e - 1

    def _add_pair(self, u, v, hang_uv, hang_vu, sco, ide,
                  span_u=None, span_v=None):
        """Add edge u->v and its complement v^1 -> u^1.  span_u/span_v are
        the alignment spans [s, e) on u's / v's read (fwd frame) used to
        derive the reference's ie/oe junction-cut coordinates."""
        ie_uv, oe_uv = self._cut(u, span_u), self._cut(v, span_v)
        ie_vu, oe_vu = self._cut(v ^ 1, span_v), self._cut(u ^ 1, span_u)
        for r in (u // 2, v // 2):
            if r not in self._known_nodes:
                self._known_nodes.add(r)
                self.node_order.append(r * 2)      # rid (3'/fwd vertex)
                self.node_order.append(r * 2 + 1)  # lid
        for (a, b, h, iec, oec) in ((u, v, hang_uv, ie_uv, oe_uv),
                                    (v ^ 1, u ^ 1, hang_vu, ie_vu, oe_vu)):
            key = (a, b)
            if key in self.einfo:
                ei = self.einfo[key]
                if self.edges[ei].sco < sco:
                    self.edges[ei] = Edge(a, b, h, sco, ide, iec, oec)
                continue
            self.edges.append(Edge(a, b, h, sco, ide, iec, oec))
            self.einfo[key] = len(self.edges) - 1
            self.out.setdefault(a, []).append(len(self.edges) - 1)
            self.inn.setdefault(b, []).append(len(self.edges) - 1)

    def build_records(self, ovl) -> np.ndarray:
        """Vectorized pre-gate + match-descending ordering shared by the
        Python accept loop and the native port (native/graph.cpp): records
        that are neither contained nor in any dovetail case have NO side
        effects on the order-dependent accept loop, so they are dropped
        here; the survivors are returned ordered as (n, 8) int32 columns
        (q, t, rev, qs, qe, ts, te, ide)."""
        H = self.p["max_hang_len"]
        R = self.reads
        n = len(ovl.qname)
        qn_a = np.asarray(ovl.qname, np.int64)
        tn_a = np.asarray(ovl.tname, np.int64)
        qs_a = np.asarray(ovl.qs, np.int64)
        qe_a = np.asarray(ovl.qe, np.int64)
        ts_a = np.asarray(ovl.ts, np.int64)
        te_a = np.asarray(ovl.te, np.int64)
        rev_a = np.asarray(ovl.rev, np.int64)
        ide_a = np.asarray(ovl.data["ide"], np.int64) if "ide" in ovl.data \
            else np.full(n, 9000, np.int64)
        order = np.argsort(-(np.asarray(ovl.match, np.int64)))
        if n:
            max_rid = int(max(qn_a.max(), tn_a.max())) + 1
            in_r = np.zeros(max_rid, bool)
            rs_v = np.zeros(max_rid, np.int64)
            re_v = np.zeros(max_rid, np.int64)
            for rid, r in R.items():
                if 0 <= rid < max_rid:
                    in_r[rid] = True
                    rs_v[rid] = r.s
                    re_v[rid] = r.e
            ql_f = qs_a <= rs_v[qn_a] + H
            qr_f = qe_a >= re_v[qn_a] - H
            tl_f = ts_a <= rs_v[tn_a] + H
            tr_f = te_a >= re_v[tn_a] - H
            rev_b = rev_a != 0
            case = np.where(rev_b, (ql_f & tl_f) | (qr_f & tr_f),
                            (qr_f & tl_f) | (ql_f & tr_f))
            cand = in_r[qn_a] & in_r[tn_a] & \
                ((ql_f & qr_f) | (tl_f & tr_f) | case)
            order = order[cand[order]]
        return np.stack([qn_a[order], tn_a[order], rev_a[order],
                         qs_a[order], qe_a[order], ts_a[order],
                         te_a[order], ide_a[order]],
                        axis=1).astype(np.int32) if len(order) \
            else np.zeros((0, 8), np.int32)

    def build(self, ovl) -> None:
        """ovl: OvlBlock-like with qname/rev/qs/qe/tname/ts/te/match/ide
        (exclusive ends, fwd coords).  Mirrors update_graph gating.

        The accept loop is order-dependent (containment bumps and per-end
        vote updates feed later decisions); candidates come pre-gated and
        pre-ordered from build_records, fields pre-extracted to plain int
        lists (>10x over per-record np scalar access at graph-input
        scale)."""
        H = self.p["max_hang_len"]
        min_ide = int(self.p["min_ide"] * 10000)
        R = self.reads
        recs = self.build_records(ovl)
        it = zip(*(recs[:, i].astype(np.int64).tolist() for i in range(8)))
        for q, t, rev, qs, qe, ts, te, ide in it:
            rq, rt = R[q], R[t]
            if rq.con >= self.p["min_con_count"] or rt.con >= self.p["min_con_count"]:
                continue
            alnlen = max(qe - qs, te - ts)
            # containment re-check on trimmed extents (asg.c:1496-1504)
            if qs <= rq.s + H and qe >= rq.e - H:
                rq.con += 1
                continue
            if ts <= rt.s + H and te >= rt.e - H:
                rt.con += 1
                continue

            ql, qr = qs <= rq.s + H, qe >= rq.e - H
            tl, tr = ts <= rt.s + H, te >= rt.e - H

            def vote(best_im, best_lm):
                """Per-end support vote (asg.c:1513-1531)."""
                if alnlen >= best_lm:
                    return 2
                if best_im >= min_ide:
                    return 1 if ide >= best_im * self.p["min_ide_ratio"] else 0
                return 1 if alnlen >= best_lm * self.p["min_sco_ratio"] else 0

            def upd(r, left):
                if left:
                    r.llm = max(r.llm, alnlen)
                    r.lim = max(r.lim, ide)
                else:
                    r.rlm = max(r.rlm, alnlen)
                    r.rim = max(r.rim, ide)

            def gate(va, vb):
                v = 2 if (va == 2 or vb == 2) else va + vb
                return v >= self.p["min_node_count"]

            Q, T = q * 2, t * 2
            if not rev:
                if qr and tl:      # q-suffix ~ t-prefix: q+ -> t+
                    if not gate(vote(rq.rim, rq.rlm), vote(rt.lim, rt.llm)):
                        continue
                    upd(rq, False); upd(rt, True)
                    self._add_pair(Q, T, rt.e - te, qs - rq.s, alnlen, ide,
                                   span_u=(qs, qe), span_v=(ts, te))
                elif ql and tr:    # t+ -> q+
                    if not gate(vote(rq.lim, rq.llm), vote(rt.rim, rt.rlm)):
                        continue
                    upd(rq, True); upd(rt, False)
                    self._add_pair(T, Q, rq.e - qe, ts - rt.s, alnlen, ide,
                                   span_u=(ts, te), span_v=(qs, qe))
            else:
                if ql and tl:      # rc left-left: q- -> t+
                    if not gate(vote(rq.lim, rq.llm), vote(rt.lim, rt.llm)):
                        continue
                    upd(rq, True); upd(rt, True)
                    self._add_pair(Q ^ 1, T, rt.e - te, rq.e - qe, alnlen, ide,
                                   span_u=(qs, qe), span_v=(ts, te))
                elif qr and tr:    # rc right-right: q+ -> t-
                    if not gate(vote(rq.rim, rq.rlm), vote(rt.rim, rt.rlm)):
                        continue
                    upd(rq, False); upd(rt, False)
                    self._add_pair(Q, T ^ 1, ts - rt.s, qs - rq.s, alnlen, ide,
                                   span_u=(qs, qe), span_v=(ts, te))
        # drop edges touching contained reads discovered late
        for e in self.edges:
            if (self.reads[e.u // 2].con >= self.p["min_con_count"] or
                    self.reads[e.v // 2].con >= self.p["min_con_count"]):
                e.deleted = True

    # ---------- helpers ----------
    def out_edges(self, v) -> List[Edge]:
        return [self.edges[i] for i in self.out.get(v, [])
                if not (self.edges[i].deleted or self.edges[i].reduced)]

    def in_edges(self, v) -> List[Edge]:
        # creation order, like the reference's per-node ie arrays (add_ie);
        # out arrays get re-sorted by sort_stat_oe but in arrays never do
        return [self.edges[i] for i in self.inn.get(v, [])
                if not (self.edges[i].deleted or self.edges[i].reduced)]

    def degree(self, v) -> Tuple[int, int]:
        return len(self.in_edges(v)), len(self.out_edges(v))

    def _del_edge(self, e: Edge):
        e.deleted = True
        ci = self.einfo.get((e.v ^ 1, e.u ^ 1))
        if ci is not None:
            self.edges[ci].deleted = True

    # ---------- cleaning passes (exact ports of util/ng/asg.c) ----------
    # Pass bodies mirror the reference implementation line for line where
    # order or tie-breaking is observable: node iteration uses the
    # reference's creation order (self.node_order), out-edge arrays are
    # re-sorted once by sort_stat_oe and then iterated in array order, and
    # every removal drops the complement edge too (rm_edge pairs).

    def _live_e(self, e) -> bool:
        return not (e.deleted or e.reduced)

    def _comp_e(self, e):
        ci = self.einfo.get((e.v ^ 1, e.u ^ 1))
        return self.edges[ci] if ci is not None else None

    def _out_all(self, v) -> List[Edge]:
        """Out-edge ARRAY including removed entries (the reference's odm
        loops skip MFLAG_FIT inline; some passes deliberately do not)."""
        return [self.edges[i] for i in self.out.get(v, [])]

    def _in_all(self, v) -> List[Edge]:
        return [self.edges[i] for i in self.inn.get(v, [])]

    def _mark_node(self, v: int, fl: int):
        """mark_node_lable (asg.c:1031-1039): flag EVERY edge touching v,
        including removed ones."""
        for e in self._out_all(v):
            e.mfl |= fl
        for e in self._in_all(v):
            e.mfl |= fl

    def _check_node_flag(self, v: int, fl: int) -> bool:
        """check_node_lable (node.c:133-146): every LIVE edge at v has fl."""
        for e in self._in_all(v):
            if self._live_e(e) and not (e.mfl & fl):
                return False
        for e in self._out_all(v):
            if self._live_e(e) and not (e.mfl & fl):
                return False
        return True

    def _rm_node(self, v: int):
        """rm_node: remove every live edge at v (complements cover v^1)."""
        for e in self._out_all(v):
            if self._live_e(e):
                self._del_edge(e)
        for e in self._in_all(v):
            if self._live_e(e):
                self._del_edge(e)

    def rm_edge_lq(self):
        """rm_edge_lq (asg.c:299-313): re-apply the build-time support vote
        (check_valid_edge, edge.c:11-41) against the FINAL per-end best
        identity/score — edges accepted early, before a stronger sibling
        raised the bar, are re-tested and dropped."""
        min_ide = int(self.p["min_ide"] * 10000)
        ide_r, sco_r = self.p["min_ide_ratio"], self.p["min_sco_ratio"]
        mnc = self.p["min_node_count"]

        def cve1(e, mide, msco):
            if e.sco == msco:
                return 2
            if mide >= min_ide:
                return 1 if e.ide > mide * ide_r else 0
            return 1 if e.sco >= msco * sco_r else 0

        n_cut = 0
        for e in self.edges:
            if not self._live_e(e):
                continue
            lo, ro = self.reads[e.u // 2], self.reads[e.v // 2]
            # MFLAG_IL == u&1 (in-read traversed from its 5' end);
            # MFLAG_OL == v&1
            mide, msco = (lo.lim, lo.llm) if (e.u & 1) else (lo.rim, lo.rlm)
            v = cve1(e, mide, msco)
            if v < mnc:
                mide, msco = (ro.rim, ro.rlm) if (e.v & 1)                     else (ro.lim, ro.llm)
                v += cve1(e, mide, msco)
            if v < mnc:
                self._del_edge(e)
                n_cut += 1
        return n_cut

    def sort_stat_oe(self):
        """sort_stat_oe (asg.c:266-298): insertion-sort every node's
        out-edge array by (len asc, sco desc) — this order feeds every
        subsequent first-live-out-edge walk (get_validly_oe) — and compute
        the median out-degree over all created nodes (quick_select n/2)."""
        for v, idxs in self.out.items():
            idxs.sort(key=lambda i: (self.edges[i].hang, -self.edges[i].sco))
        ods = [sum(1 for e in self._out_all(v) if self._live_e(e))
               for v in self.node_order]
        self.median_outdegree = sorted(ods)[len(ods) // 2] if ods else 0
        depths = []
        for r in self.reads.values():
            depths.append(r.lc)
            depths.append(r.rc)
        self.median_aln_depth = sorted(depths)[len(depths) // 2]             if depths else 0
        return 0

    def mark_repeat_edges(self, min_depth_multi: float = 1.5,
                          max_depth_multi: float = 2000.0):
        """mark_edge_rep (asg.c:341-416): nodes whose out-degree or per-end
        aligned depth (ovlinfo lc/rc) exceeds max_depth_multi x the median
        are removed; above min_depth_multi x the median every edge at the
        node pair gets MFLAG_REP1 (protected by mark_edge_bs); out-degrees
        over 10x the median out-degree keep only the best-scoring 10x."""
        if not hasattr(self, "median_outdegree"):
            self.sort_stat_oe()
        d0 = float(self.median_aln_depth)
        d1 = float(self.median_outdegree)
        maxd11, maxd12 = d0 * min_depth_multi, d0 * max_depth_multi
        maxd21, maxd22 = d1 * min_depth_multi, d1 * max_depth_multi
        maxd23 = int(d1) * 10
        # degenerate-median guard: a zero median (no .bl depth stats, or a
        # graph dominated by isolated nodes) would turn every >= threshold
        # into "remove all"; the reference never sees this because init_os
        # only loads reads with real per-end depths (ng/main.c:13-79)
        use_d0, use_d1 = d0 > 0, d1 > 0
        n_rep = 0
        for v in self.node_order:
            oes = [e for e in self._out_all(v) if self._live_e(e)]
            od = len(oes)
            mark = 0
            if use_d1 and od >= maxd22:
                self._rm_node(v)
                self._rm_node(v ^ 1)
                continue
            elif use_d1 and od >= maxd21:
                mark = 1
            elif od and use_d0:
                r = self.reads[v // 2]
                dp = r.lc if (v & 1) else r.rc
                if dp >= maxd12:
                    self._rm_node(v)
                    self._rm_node(v ^ 1)
                    continue
                elif dp >= maxd11:
                    mark = 1
            if use_d1 and od >= maxd23 > 0:
                st = sorted(self._out_all(v),
                            key=lambda e: (-e.sco, -e.ide))
                t = 0
                for e in st:
                    if not self._live_e(e):
                        continue
                    if t >= maxd23:
                        self._del_edge(e)
                    t += 1
            if mark:
                n_rep += 1
                # node's out-edges + reversed node's in-edges (= their
                # complements), asg.c:408-412
                for e in self._out_all(v):
                    e.mfl |= M_REP1
                for e in self._in_all(v ^ 1):
                    e.mfl |= M_REP1
        return n_rep

    def mark_chimeric_nodes(self, bfs_depth: Optional[int] = None,
                            max_deg: Optional[int] = None):
        """find_candnode_chim + mark_node_chim (asg.c:1040-1206): candidate
        nodes (in- and out-side both entangled with branches, no triangle
        bypass) get MFLAG_LQ / MFLAG_CC labels; a bounded BFS then checks
        whether the in-side reaches the out-side without crossing the node —
        unreachable candidates are labelled MFLAG_CN (chimeric)."""
        if bfs_depth is None:
            bfs_depth = self.p.get("bfs_depth", 2)
        if not hasattr(self, "median_outdegree"):
            self.sort_stat_oe()
        maxd = (max_deg if max_deg is not None
                else self.median_outdegree * self.p.get("bfs_depth_multi", 2))
        # ---- find_candnode_chim ----
        cands = []
        for v in self.node_order:
            if v & 1:
                continue   # i > reversed(i) skip: process even vertex only
            ins = self.in_edges(v)
            outs = self.out_edges(v)
            if not ins or not outs:
                continue
            n = 0
            marked = set()
            for e in outs:
                if len(self.in_edges(e.v)) >= 2:
                    n = 1
                marked.add(e.v)
            l = 0
            for e in ins:
                if l or not n:
                    break
                if len(self.out_edges(e.u)) >= 2:
                    n = 2
                for e2 in self.out_edges(e.u):
                    if e2.v in marked:
                        l += 1
                        break
            if not l:
                self._mark_node(v, M_LQ)
                self._mark_node(v ^ 1, M_LQ)
            if n == 2 and not l:
                cands.append(v)
                self._mark_node(v, M_CC)
                self._mark_node(v ^ 1, M_CC)
        # ---- mark_node_chim BFS (LIFO over candidates) ----
        n_chim = 0
        for v in reversed(cands):
            set1 = set()
            frontier = []
            for e in self.in_edges(v):
                frontier.append(e.u)
                set1.add(e.u)
            for _ in range(bfs_depth):
                nxt = []
                for u in reversed(frontier):
                    for e in self.out_edges(u):
                        if e.v == v:
                            continue
                        if len(self.out_edges(e.v)) >= maxd:
                            continue
                        if e.v not in set1:
                            set1.add(e.v)
                            nxt.append(e.v)
                frontier = nxt
            hit = False
            set2 = set()
            frontier = []
            for e in self.out_edges(v):
                frontier.append(e.v)
                if e.v in set1:
                    hit = True
                    break
                set2.add(e.v)
            steps = 0
            while steps < bfs_depth and not hit:
                steps += 1
                nxt = []
                for u in reversed(frontier):
                    if hit:
                        break
                    for e in self.in_edges(u):
                        if e.u == v:
                            continue
                        if e.u in set1:
                            hit = True
                            break
                        if len(self.in_edges(e.u)) >= maxd:
                            continue
                        if e.u not in set2:
                            set2.add(e.u)
                            nxt.append(e.u)
                frontier = nxt
            if not hit:
                n_chim += 1
                self._mark_node(v, M_CN)
                self._mark_node(v ^ 1, M_CN)
        return n_chim

    def transitive_reduction(self):
        """mark_edge_tr (asg.c:417-467), Myers 2005 with fuzz: direct
        successors reachable through another successor within the longest
        out-length + fuzz are reduced; additionally every successor's FIRST
        live out-target and sub-fuzz out-targets are reduced."""
        fuzz = self.p["fuzz_len"]
        for v in self.node_order:
            oes = [e for e in self._out_all(v) if self._live_e(e)]
            if not oes:
                continue
            mark: Dict[int, int] = {}
            mlen = max(e.hang for e in oes) + fuzz
            for e in oes:
                mark[e.v] = 1
            for e in oes:
                if mark.get(e.v):
                    for e2 in self.out_edges(e.v):
                        if e.hang + e2.hang <= mlen and e2.v in mark:
                            mark[e2.v] = 0
            for e in oes:
                first = True
                for e2 in self.out_edges(e.v):
                    if (first or e2.hang < fuzz) and e2.v in mark:
                        mark[e2.v] = 0
                    elif first and e2.hang >= fuzz:
                        pass
                    if first:
                        first = False
            for e in oes:
                if mark.get(e.v) == 0:
                    e.reduced = True
                    c = self._comp_e(e)
                    if c is not None:
                        c.reduced = True

    def rm_edge_spur(self):
        """rm_edge_spur (asg.c:468-485): at branch nodes, drop out-edges to
        dead ends (successor out-degree 0)."""
        n_cut = 0
        for v in self.node_order:
            if len(self.out_edges(v)) > 1:
                for e in self.out_edges(v):
                    if len(self.out_edges(v)) > 1 and                             not self.out_edges(e.v):
                        self._del_edge(e)
                        n_cut += 1
        return n_cut

    def mark_edge_hls_rm_ls(self):
        """mark_edge_hls + rm_edge_ls (asg.c:567-654): per node end, edges
        scoring >= max_sco_ratio x the best sibling get MFLAG_HS, the rest
        MFLAG_LS; edges with no HS from either end are removed outright;
        then branch nodes shed their LS out-edges weakest-first while the
        branch and the target's in-merge persist.  LS marks persist (used
        by clean_complex_path and rm_edge_chim)."""
        ratio = self.p["max_sco_ratio"]
        for v in self.node_order:
            oes = self.out_edges(v)
            if oes:
                ms = max(e.sco for e in oes) * ratio
                for e in oes:
                    e.mfl |= M_HS if e.sco >= ms else M_LS
            ies = self.in_edges(v)
            if ies:
                ms = max(e.sco for e in ies) * ratio
                for e in ies:
                    e.mfl |= M_HS if e.sco >= ms else M_LS
        n_cut = 0
        for e in self.edges:
            if self._live_e(e) and not (e.mfl & M_HS):
                self._del_edge(e)
                n_cut += 1
        # rm_edge_ls
        for v in self.node_order:
            if len(self.out_edges(v)) <= 1:
                continue
            st = sorted(self._out_all(v), key=lambda e: (-e.sco, -e.ide))
            for e in reversed(st):
                if len(self.out_edges(v)) <= 1:
                    break
                if not self._live_e(e):
                    continue
                if (e.mfl & M_LS) and len(self.in_edges(e.v)) > 1:
                    self._del_edge(e)
                    n_cut += 1
        return n_cut

    def keep_best_edges(self):
        """mark_edge_bs + sweep (asg.c:655-696): each node's best-scoring
        out-edge and in-edge (strict (sco, ide) comparison, first in array
        order wins ties) and every REP1 edge get MFLAG_BS; all other live
        edges are removed."""
        for v in self.node_order:
            bs = bide = 0
            k = None
            for e in self.out_edges(v):
                if e.mfl & M_REP1:
                    e.mfl |= M_BS
                if e.sco > bs or (e.sco == bs and e.ide > bide):
                    k, bs, bide = e, e.sco, e.ide
            if bs and k is not None:
                k.mfl |= M_BS
            bs = bide = 0
            k = None
            for e in self.in_edges(v):
                if e.mfl & M_REP1:
                    e.mfl |= M_BS
                if e.sco > bs or (e.sco == bs and e.ide > bide):
                    k, bs, bide = e, e.sco, e.ide
            if bs and k is not None:
                k.mfl |= M_BS
        n_cut = 0
        for e in self.edges:
            if self._live_e(e) and not (e.mfl & M_BS):
                self._del_edge(e)
                n_cut += 1
        return n_cut

    def clip_tips(self, max_tip: Optional[int] = None,
                  spath: Optional[int] = None):
        """rm_sht_brh (asg.c:697-730): from every SOURCE vertex (in-deg 0,
        out-deg 1) walk the unambiguous chain up to max_tip edges; if it
        ends at a merge node (in-deg > 1) OR at a dead end, remove the whole
        chain — so isolated components shorter than sbranch_len reads are
        dropped outright, the reference's noise floor.  When spath > 0
        (nextgraph -q) a chain of >= spath edges only loses its final edge,
        and only when it ends at a merge.  Single pass in ascending vertex
        order, like the reference (it is invoked at several points of
        clean() rather than run to fixpoint)."""
        max_tip = max_tip or self.p["sbranch_len"]
        if spath is None:
            spath = self.p["out_spath_len"]
        for v in self.node_order:
            ind, outd = self.degree(v)
            if ind != 0 or outd != 1:
                continue
            path = [self.out_edges(v)[0]]
            n = path[0].v
            while len(path) < max_tip:
                i2, o2 = self.degree(n)
                if i2 != 1 or o2 != 1:
                    break
                nxt = self.out_edges(n)[0]
                path.append(nxt)
                n = nxt.v
            i2, o2 = self.degree(n)
            if i2 > 1 or o2 == 0:
                if spath and len(path) >= spath:
                    if o2:
                        self._del_edge(path[-1])
                else:
                    for e in path:
                        self._del_edge(e)

    def clip_z_labeled(self, flag: int = M_CN,
                       zbranch: Optional[int] = None,
                       spath: Optional[int] = None):
        """rm_z_clip_lable (asg.c:772-829): per branch node collect out-arms
        (simple chains of <= zbranch+1 edges ending at a merge) carrying at
        least one `flag`-labelled edge; arms sort by (flag fraction desc,
        then identity asc when >25%% apart, else score asc) and are removed
        while their branch/merge endpoints persist.  spath > 0 trims only
        the arm's first+last edges for arms of >= spath edges."""
        if zbranch is None:
            zbranch = self.p["zbranch_len"]
        if spath is None:
            spath = self.p["out_spath_len"]
        n_cut = 0
        for v in self.node_order:
            arms = []
            if len(self.out_edges(v)) > 1:
                for e in self.out_edges(v):
                    path = [e]
                    perc = 1 if (e.mfl & flag) else 0
                    cur = e.v
                    while len(path) <= zbranch:
                        ind, outd = self.degree(cur)
                        if ind != 1 or outd != 1:
                            break
                        nxt = self.out_edges(cur)[0]
                        path.append(nxt)
                        if nxt.mfl & flag:
                            perc += 1
                        cur = nxt.v
                    if self.degree(cur)[0] > 1 and perc:
                        arms.append((perc * 10000 // len(path),
                                     path[0].ide, path[0].sco, path))
            if not arms:
                continue

            import functools

            def cmp(a, b):
                if a[0] != b[0]:
                    return b[0] - a[0]
                if a[1] > b[1] * 5 // 4 or a[1] < b[1] * 4 // 5:
                    return a[1] - b[1]
                return (a[2] > b[2]) - (a[2] < b[2])

            arms.sort(key=functools.cmp_to_key(cmp))
            for _, _, _, path in arms:
                if len(self.out_edges(path[0].u)) < 2 or                         len(self.in_edges(path[-1].v)) < 2:
                    continue
                if spath and len(path) >= spath:
                    self._del_edge(path[-1])
                    self._del_edge(path[0])
                else:
                    for e in path:
                        self._del_edge(e)
                n_cut += 1
        return n_cut

    # ---------- compound-path machinery (bfs_nodes_compound*) -------------
    def _bfs_compound(self, starts, exclude, depth, max_child,
                      stop_at_merged, callback, perc):
        """bfs_nodes_compound_orig (asg.c:1745-1856): converging BFS from
        `starts`; a node is expanded only once every live in-edge has been
        relaxed; with stop_at_merged the walk halts once a single active
        frontier remains (the merge point).  `callback` relaxes the
        per-start DP with the relative edge weight
        sco*ide - perc * best-sibling (callback1/callback3,
        asg.c:1969-2035, 2217-2263; callback 3 additionally opens a new
        path record at every interior branch node).  Returns
        (info dict, visited edge list, queue-leftover list)."""
        F_N, F_P1, F_P2, F_LP, F_U = 1, 2, 4, 8, 16
        exclude = exclude or set()
        info: Dict[int, dict] = {}
        visited: List[Edge] = []
        queue: List[int] = []
        for u in starts:
            queue.append(u)
            info[u] = dict(l=F_N, depth=0, unvisited=0, recs={})
        qi = 0

        def count_p2():
            return sum(1 for d in info.values() if d["l"] & F_P2)

        def relax(v, w):
            """callback1/3 shared body."""
            iv, iw = info[v], info[w]
            curr = mx = 0
            for e in self.out_edges(v):
                t = e.sco * e.ide
                if t > mx:
                    mx = t
                if e.v == w:
                    curr = t
            curr = int(curr - mx * perc)
            if callback == 3 and len(self.out_edges(v)) > 1:
                iw["recs"][v] = dict(pred=v, prop=curr, n=1)
            if callback == 1 and (iv["l"] & F_N):
                iw["recs"][v] = dict(pred=v, prop=curr, n=1)
            for st, rec in list(iv["recs"].items()):
                if st == v or rec["n"] == 0:
                    continue
                temp = curr + rec["prop"]
                wrec = iw["recs"].get(st)
                if wrec is None or wrec["n"] == 0 or temp > wrec["prop"]:
                    iw["recs"][st] = dict(pred=v, prop=temp,
                                          n=rec["n"] + 1)

        while qi < len(queue) and (
                not stop_at_merged
                or any(info[u]["l"] & F_N for u in queue[qi:])
                or (len(queue) - qi + count_p2()) > 1):
            v = queue[qi]
            qi += 1
            iv = info[v]
            for e in self.out_edges(v):
                w = e.v
                if w in exclude:
                    continue
                visited.append(e)
                iw = info.get(w)
                if iw is None or (iw["l"] & F_N and not (iw["l"] & F_LP)):
                    indeg = sum(1 for e2 in self.in_edges(w)
                                if e2.u not in exclude)
                    if iw is None:
                        iw = info[w] = dict(l=0, depth=0, unvisited=0,
                                            recs={})
                    iw["depth"] = iv["depth"] + 1
                    iw["unvisited"] = indeg
                    if iw["l"] & F_N:
                        iw["l"] |= F_LP
                else:
                    if iw["l"] & F_N:
                        iw["l"] |= F_LP
                    iw["depth"] = iv["depth"] + 1   # lastest=1
                relax(v, w)
                iw["unvisited"] -= 1
                outdeg = sum(1 for e2 in self.out_edges(w)
                             if e2.v not in exclude)
                if iw["unvisited"] == 0 and outdeg and                         (max_child < 0 or outdeg < max_child) and                         not (iw["l"] & F_N) and                         (depth < 0 or iw["depth"] < depth):
                    queue.append(w)
                    if iw["l"] & F_P2:
                        iw["l"] ^= F_P2
                elif iw["unvisited"] == 0 and outdeg == 0:
                    iw["l"] |= F_P1
                else:
                    iw["l"] |= F_P2
        for u in queue[qi:]:
            info[u]["l"] |= F_U
        return info, visited

    @staticmethod
    def _bfs_flagged(info):
        """Nodes flagged P1|P2|U (get_pending_nodes, asg.c:2340-2359).
        Sorted: the reference iterates khash order, which is arbitrary —
        a fixed order keeps Python and the native port bit-identical."""
        return sorted(v for v, d in info.items() if d["l"] & (2 | 4 | 16))

    @staticmethod
    def _bfs_path(info, start, w):
        """Backtrack w -> start via start's DP record chain
        (bfs_nodes_compound_common_get_path, asg.c:2326-2345); returns the
        node path start..w or None if a record is missing."""
        path = [w]
        v = w
        while v != start:
            rec = info.get(v, {}).get("recs", {}).get(start)
            if rec is None or rec["n"] == 0:
                return None
            v = rec["pred"]
            path.append(v)
            if len(path) > len(info) + 2:
                return None
        return path[::-1]

    def _rm_visited_edges(self, node_paths, visited, m):
        """rm_visited_edges (asg.c:2110-2176, m==0 branch): TT-mark every
        edge on the kept paths, then remove every visited edge (and its
        complement) that is not TT-marked from either direction."""
        for path in node_paths:
            for a, b in zip(path, path[1:]):
                for e in self._out_all(a):
                    if e.v == b:
                        e.mfl |= M_TT
                        break
        n_cut = 0
        for e in visited:
            c = self._comp_e(e)
            if (e.mfl & M_TT) or (c is not None and c.mfl & M_TT):
                continue
            if self._live_e(e):
                self._del_edge(e)
                n_cut += 1
        for e in visited:
            if e.mfl & M_TT:
                e.mfl ^= M_TT
        return n_cut

    def clean_complex_single_path(self, s: Optional[int] = None,
                                  m: int = 0, perc: Optional[float] = None):
        """clean_complex_single_path (asg.c:2177-2216): per branch node run
        the converging BFS; when exactly ONE (endpoint, start) best path
        exists, remove every other visited edge."""
        if s is None:
            s = self.p["bubble_len"]
        if perc is None:
            perc = self.p.get("min_mat_ratio", 0.9)
        n_cut = 0
        for v in self.node_order:
            if len(self.out_edges(v)) < 2:
                continue
            info, visited = self._bfs_compound(
                [v], None, s, -1, True, 1, perc)
            paths = []
            for w in self._bfs_flagged(info):
                for st, rec in info[w]["recs"].items():
                    if rec["n"] == 0:
                        continue
                    pth = self._bfs_path(info, st, w)
                    if pth is not None:
                        paths.append(pth)
            if len(paths) != 1:
                continue
            n_cut += self._rm_visited_edges(paths, visited, m)
        return n_cut

    def clean_complex_multi_path(self, s: Optional[int] = None,
                                 m: int = 0, perc: Optional[float] = None):
        """clean_complex_multi_path via bfs_nodes_compound_common
        (asg.c:2373-2511, 2607-2641): BFS with interior branch nodes
        opening their own path records (callback3, max_child 30); find the
        deepest interior node common to every pending endpoint's record set
        (ties by summed prop score) and keep source->common->endpoint best
        paths, removing all other visited edges."""
        if s is None:
            s = self.p["bubble_len"]
        if perc is None:
            perc = self.p.get("min_mat_ratio", 0.9)
        n_cut = 0
        for src in self.node_order:
            if len(self.out_edges(src)) < 2:
                continue
            info, visited = self._bfs_compound(
                [src], None, s, 30, True, 3, perc)
            pending = self._bfs_flagged(info)
            if not pending:
                continue
            common = sorted(st for st, rec in info[pending[0]]["recs"].items()
                            if rec["n"] > 0)
            for w in pending[1:]:
                have = {st for st, rec in info[w]["recs"].items()
                        if rec["n"] > 0}
                common = [st for st in common if st in have]
            common_node = src
            if len(common) > 1:
                max_depth, tie = -(1 << 30), 0
                for v in common:
                    if v == src:
                        continue
                    d = info[v]["depth"]
                    if d > max_depth:
                        max_depth, common_node, tie = d, v, 1
                    elif d == max_depth:
                        tie += 1
                if tie > 1:
                    best = None
                    for v in common:
                        if v == src or info[v]["depth"] != max_depth:
                            continue
                        rec = info[v]["recs"].get(src)
                        if rec is None:
                            continue
                        pv = rec["prop"]
                        ok = True
                        for w in pending:
                            r2 = info[w]["recs"].get(v)
                            if r2 is None:
                                ok = False
                                break
                            pv += r2["prop"]
                        if ok and (best is None or pv > best[0]):
                            best = (pv, v)
                    if best is not None:
                        common_node = best[1]
            paths = []
            ok = True
            if common_node == src:
                for w in pending:
                    pth = self._bfs_path(info, src, w)
                    if pth is None:
                        ok = False
                        break
                    paths.append(pth)
            else:
                head = self._bfs_path(info, src, common_node)
                if head is None:
                    ok = False
                else:
                    for w in pending:
                        tail = self._bfs_path(info, common_node, w)
                        if tail is None:
                            ok = False
                            break
                        paths.append(head[:-1] + tail)
            if not ok:
                continue
            n_cut += self._rm_visited_edges(paths, visited, m)
        return n_cut

    def clean_complex_graph(self, s: int = 8, m: int = 0,
                            perc: Optional[float] = None):
        """clean_complex_graph (asg.c:3082-3289): cluster each dense spot
        (branchy neighbourhood within `s` simple steps), find its pure
        entry/exit nodes, and when no node is both, run the converging BFS
        from every entry (excluding outside context) keeping only best
        paths (solve_spot_by_finding_paths_hete)."""
        if perc is None:
            perc = self.p.get("min_mat_ratio", 0.9)
        n_cut = 0
        seen_spot = set()
        for v0 in self.node_order:
            if v0 in seen_spot:
                continue
            if len(self.out_edges(v0)) <= 1 and len(self.in_edges(v0)) <= 1:
                continue
            spot = self._dense_spot(v0, s)
            seen_spot.update(spot)
            k = sum(1 for v in spot
                    if len(self.out_edges(v)) > 1
                    or len(self.in_edges(v)) > 1)
            if not (k // 2 < s * 200 and len(spot) // 2 < s * 500):
                continue
            n_cut += self._solve_spot(spot, m, perc)
        return n_cut

    def _dense_spot(self, n: int, depth: int):
        """get_dense_spot (asg.c:3082-3156): bidirectional BFS, pausing at
        pure chain nodes after `depth` steps, always expanding through
        branch nodes."""
        seen = {n}
        h = [n]
        while h:
            h2 = []
            dp = 0
            while dp < depth and h:
                dp += 1
                h3 = []
                while h:
                    v = h.pop()
                    for e in self.out_edges(v):
                        if e.v in seen:
                            continue
                        seen.add(e.v)
                        if len(self.in_edges(e.v)) > 1 or                                 len(self.out_edges(e.v)) > 1:
                            h2.append(e.v)
                        else:
                            h3.append(e.v)
                    for e in self.in_edges(v):
                        if e.u in seen:
                            continue
                        seen.add(e.u)
                        if len(self.in_edges(e.u)) > 1 or                                 len(self.out_edges(e.u)) > 1:
                            h2.append(e.u)
                        else:
                            h3.append(e.u)
                h = h3
            h = h2
        return seen

    def _solve_spot(self, spot, m, perc):
        """solve_spot_by_finding_paths_hete (asg.c:3230-3263)."""
        starts, ends, outside = [], [], set()
        for v in sorted(spot):
            ins = self.in_edges(v)
            if not ins:
                starts.append(v)
            else:
                ext = [e.u for e in ins if e.u not in spot]
                if ext:
                    starts.append(v)
                    outside.update(ext)
            outs = self.out_edges(v)
            if not outs:
                ends.append(v)
            else:
                ext = [e.v for e in outs if e.v not in spot]
                if ext:
                    ends.append(v)
                    outside.update(ext)
        if not starts or not ends or set(starts) & set(ends):
            return 0
        info, visited = self._bfs_compound(
            starts, outside, -1, -1, False, 1, perc)
        paths = []
        for w in self._bfs_flagged(info):
            for st, rec in info[w]["recs"].items():
                if rec["n"] == 0:
                    continue
                pth = self._bfs_path(info, st, w)
                if pth is not None:
                    paths.append(pth)
        if not paths:
            return 0
        return self._rm_visited_edges(paths, visited, m)

    def rm_long_bubble(self, s: Optional[int] = None, m: int = 0,
                       perc: Optional[float] = None):
        """rm_long_bubble (asg.c:3403-3500): per branch node collect simple
        out-arms reaching a merge; score each with the relative weight
        (first edge vs best sibling, interior edges x (1-perc)); among arms
        sharing an endpoint prefer the one whose first/last edge identities
        are jointly best, then cut the weaker arms' end edges."""
        if s is None:
            s = self.p["bubble_len"]
        if perc is None:
            perc = self.p.get("min_mat_ratio", 0.9)
        n_cut = 0
        for v in self.node_order:
            if len(self.out_edges(v)) < 2:
                continue
            max_sco = max((e.sco * e.ide for e in self.out_edges(v)),
                          default=0)
            arms = []
            for e in self.out_edges(v):
                path = [e]
                cur = e.v
                while len(path) < s:
                    ind, outd = self.degree(cur)
                    if ind != 1 or outd != 1:
                        break
                    nxt = self.out_edges(cur)[0]
                    path.append(nxt)
                    cur = nxt.v
                if self.degree(cur)[0] > 1:
                    sco = int(path[0].sco * path[0].ide - max_sco * perc)
                    for e2 in path[1:]:
                        sco += int(e2.sco * e2.ide * (1 - perc))
                    arms.append([sco, path])
            if len(arms) < 2:
                continue
            # joint best-identity endpoint pre-pass (asg.c:3436-3472)
            for j, (sco_j, pj) in enumerate(arms):
                if sco_j == 0:
                    continue
                end = pj[-1].v
                if any(arms[k][1][-1].v == end for k in range(j)):
                    continue
                s_best, e_best = j, j
                s_ide, e_ide = pj[0].ide, pj[-1].ide
                for k in range(j + 1, len(arms)):
                    qk = arms[k][1]
                    if qk[-1].v != end:
                        continue
                    if qk[0].ide > s_ide:
                        s_best, s_ide = k, qk[0].ide
                    if qk[-1].ide > e_ide:
                        e_best, e_ide = k, qk[-1].ide
                if s_best == e_best:
                    for k in range(j, len(arms)):
                        if k != s_best and arms[k][1][-1].v == end:
                            arms[k][0] = 0
            arms.sort(key=lambda a: a[0])   # msort_phs: score ascending
            for j, (sco_j, pj) in enumerate(arms):
                end = pj[-1].v
                for k in range(j + 1, len(arms)):
                    if arms[k][1][-1].v == end:
                        self._del_edge(pj[-1])
                        self._del_edge(pj[0])
                        n_cut += 1
                        break
        return n_cut

    def break_short_loops(self, max_loop: Optional[int] = None):
        """rm_sht_loop (asg.c:941-967): a pure cycle of < max_loop edges
        through simple nodes is removed whole."""
        if max_loop is None:
            max_loop = self.p["sloop_len"]
        n_cut = 0
        for v in self.node_order:
            ind, outd = self.degree(v)
            if ind != 1 or outd != 1:
                continue
            path = [self.out_edges(v)[0]]
            n = path[0].v
            while True:
                ind, outd = self.degree(n)
                if ind != 1 or outd != 1 or len(path) >= max_loop or n == v:
                    break
                nxt = self.out_edges(n)[0]
                path.append(nxt)
                n = nxt.v
            if n == v:
                for e in path:
                    self._del_edge(e)
                n_cut += 1
        return n_cut

    def pop_bubbles(self, max_nodes: Optional[int] = None):
        """rm_sht_bubble (asg.c:968-1007, alt-contig path): a two-arm
        bubble at an out-degree-2 node loses its SHORTER arm."""
        if max_nodes is None:
            max_nodes = self.p["bubble_len"]
        n_cut = 0
        for v in self.node_order:
            oes = self.out_edges(v)
            if len(oes) != 2:
                continue

            def walk(e):
                path = [e]
                n = e.v
                while len(path) < max_nodes:
                    ind, outd = self.degree(n)
                    if ind != 1 or outd != 1:
                        break
                    nxt = self.out_edges(n)[0]
                    path.append(nxt)
                    n = nxt.v
                return path, n

            p1, n1 = walk(oes[0])
            p2, n2 = walk(oes[1])
            if n1 == n2:
                for e in (p2 if len(p1) > len(p2) else p1):
                    self._del_edge(e)
                n_cut += 1
        return n_cut

    def break_end_loops(self, max_loop: Optional[int] = None):
        """rm_end_loop (asg.c:1008-1027): a chain looping back to an
        in-degree-2 node is cut at its returning edge."""
        if max_loop is None:
            max_loop = self.p["end_loop_len"]
        n_cut = 0
        for v in self.node_order:
            ind, outd = self.degree(v)
            if ind != 2 or outd != 1:
                continue
            e = self.out_edges(v)[0]
            last = e
            n = e.v
            k = 1
            while True:
                ind, outd = self.degree(n)
                if ind != 1 or outd != 1 or k > max_loop or n == v:
                    break
                k += 1
                last = self.out_edges(n)[0]
                n = last.v
            if n == v:
                self._del_edge(last)
                n_cut += 1
        return n_cut

    def clean_complex_path(self, s: Optional[int] = None, r: int = 1,
                           flag: int = 0):
        """clean_complex_path (asg.c:1349-1467): from each branch node run
        a converging BFS (flag-labelled edges are fenced off); when the
        whole tangle reconverges within `s` steps to a single node with no
        loop back, walk the last-predecessor chain as the kept path;
        r(keep_comp_path)=1 trims the off-path edges along it, r=0 removes
        every visited edge off the kept node set."""
        if s is None:
            s = self.p.get("cpath_len", 20)
        n_cut = 0
        for src in self.node_order:
            if len(self.out_edges(src)) <= 1:
                continue
            visited: List[Edge] = []
            state = {src: dict(pnode=-1, id=0, len=0)}
            queue = [src]
            qi = 0
            loop = exclen = False
            pending = 0
            while True:
                v = queue[qi]
                qi += 1
                d = state[v]["len"]
                for e in self.out_edges(v):
                    if flag and (e.mfl & flag):
                        visited.append(e)
                        continue
                    w = e.v
                    if w == src:
                        loop = True
                        break
                    if d + 1 >= s:
                        exclen = True
                        break
                    visited.append(e)
                    sw = state.get(w)
                    if sw is None:
                        nid = sum(1 for e2 in self.in_edges(w)
                                  if not (flag and (e2.mfl & flag)))
                        sw = state[w] = dict(pnode=-1, id=nid, len=0)
                        pending += 1
                    sw["pnode"] = v
                    sw["id"] -= 1
                    sw["len"] = d + 1
                    if sw["id"] == 0:
                        if self.out_edges(w):
                            queue.append(w)
                        pending -= 1
                if loop or exclen or qi == len(queue):
                    break
                if qi + 1 == len(queue) and pending == 0:
                    break
            if loop or exclen or qi == len(queue):
                continue
            v = queue[qi]
            on_path = set()
            while True:
                on_path.add(v)
                w = state[v]["pnode"]
                if r:
                    for e in self.in_edges(v):
                        if e.u != w:
                            self._del_edge(e)
                            n_cut += 1
                    for e in self.out_edges(w):
                        if e.v != v:
                            self._del_edge(e)
                            n_cut += 1
                v = w
                if v == src:
                    on_path.add(v)
                    break
            if not r:
                for e in reversed(visited):
                    if e.u in on_path:
                        continue
                    if self._live_e(e):
                        self._del_edge(e)
                        n_cut += 1
        return n_cut

    # ---------- triangle counts (calc_edge_tc + consumers) -----------------
    def calc_edge_tc(self, cap: int = 255):
        """calc_edge_tc (asg.c:1207-1231): per live edge count shared
        neighbours of its endpoints over the FULL original adjacency
        (removed edges included, as the reference's array scans do); cached
        in e.tc, recomputed only when 0."""
        for e in self.edges:
            if e.tc or not self._live_e(e):
                continue
            mark: Dict[int, int] = {}
            for x in self._in_all(e.u):
                mark[x.u] = 1
            for x in self._out_all(e.u):
                mark[x.v] = 2
            t = 0
            for x in self._in_all(e.v):
                if t > cap:
                    break
                if mark.get(x.u):
                    t += 1
            for x in self._out_all(e.v):
                if t > cap:
                    break
                if mark.get(x.v) == 2:
                    t += 1
            e.tc = t
        return 0

    def edge_triangle_counts(self, cap: int = 255) -> Dict[int, int]:
        """Edge-index -> triangle count view over calc_edge_tc."""
        self.calc_edge_tc(cap)
        return {ei: e.tc for ei, e in enumerate(self.edges)
                if self._live_e(e)}

    def rm_edge_chim(self, s: int = 50, sco: float = 0.5,
                     ide: int = 8500, flag: int = M_CC):
        """rm_edge_chim (asg.c:1233-1291): at nodes wholly labelled `flag`
        that are not deep inside a long chain, collect weak edges (low
        identity or LS, short relative to the reads) and un-triangled
        edges; batch-remove at the end."""
        doomed = []
        for v in self.node_order:
            if not self.out_edges(v):
                continue
            if not self._check_node_flag(v, flag):
                continue
            j = 0
            n = v
            while True:
                ind, outd = self.degree(n)
                if ind != 1 or outd != 1:
                    break
                j += 1
                if j >= s:
                    break
                n = self.out_edges(n)[0].v
            if j >= s:
                continue
            for e in self.out_edges(v) + self.in_edges(v):
                c = self._comp_e(e)
                rlen = min(e.hang + e.sco,
                           (c.hang + c.sco) if c is not None else 1 << 30)
                if ((e.ide < ide or (e.mfl & M_LS)) and
                        e.sco < sco * rlen) or not e.tc:
                    doomed.append(e)
        for e in doomed:
            if self._live_e(e):
                self._del_edge(e)
        return len(doomed)

    def drop_untriangled_edges(self, min_tc: Optional[int] = None,
                               s: int = 20, sco_frac: float = 0.33,
                               ratio: float = 0.85):
        """rm_edge_ltc (asg.c:1293-1347): low-triangle-count edges off long
        chains are removed when short relative to their reads or jointly
        weaker than the best alternatives at both ends (FULL adjacency for
        the maxima, like the reference's unfiltered array scans)."""
        if min_tc is None:
            min_tc = self.p["min_edge_cov"]
        doomed = []
        for ei, e in enumerate(self.edges):
            if e.tc > min_tc or not self._live_e(e):
                continue
            j = 0
            n = e.u
            while True:
                ind, outd = self.degree(n)
                if ind != 1 or outd != 1:
                    break
                j += 1
                if j >= s:
                    break
                n = self.out_edges(n)[0].v
            if j >= s:
                continue
            c = self._comp_e(e)
            rlen = min(e.hang + e.sco,
                       (c.hang + c.sco) if c is not None else 1 << 30)
            if e.sco < sco_frac * rlen:
                doomed.append(e)
                continue
            mide = max((x.ide for x in self._out_all(e.u)), default=0)
            msco = max((x.sco for x in self._out_all(e.u)), default=0)
            mide_ = max((x.ide for x in self._in_all(e.v)), default=0)
            msco_ = max((x.sco for x in self._in_all(e.v)), default=0)
            mide, msco = min(mide, mide_), min(msco, msco_)
            if e.ide < mide * ratio and e.sco < msco * ratio:
                doomed.append(e)
        for e in doomed:
            if self._live_e(e):
                self._del_edge(e)
        return len(doomed)

    def clip_z_edges(self):
        """rm_z_clip_score (asg.c:857-940, alt-contig path): per branch
        node, rank its simple out-arms by relative end-edge score (arm end
        edges vs the node's best alternatives, cal_node_io_bstsc) minus an
        in-degree penalty, and clip all but the best while endpoints keep
        other support."""
        s = self.p["zbranch_len"]
        m = self.p["out_spath_len"]
        n_cut = 0
        for v in self.node_order:
            if len(self.out_edges(v)) < 2:
                continue
            arms = []
            for e in self.out_edges(v):
                path, end = self._z_walk_fwd(e, s)
                if self.degree(end)[0] > 1:
                    arms.append(path)
            if len(arms) > 1:
                scored = []
                for path in arms:
                    scored.append((self._z_score(path)
                                   - self.degree(path[-1].v)[0] * 5, path))
                scored.sort(key=lambda x: x[0])
                arms = [p for _, p in scored]
            for path in arms:
                if len(self.out_edges(path[0].u)) < 2 or \
                        len(self.in_edges(path[-1].v)) < 2:
                    continue
                self._z_rm_path(path, m)
                n_cut += 1
        return n_cut

    def _z_walk_fwd(self, e, max_edges: int):
        """Follow e through PURE simple nodes (in-deg==out-deg==1); returns
        the edge path (<= max_edges) and the final vertex."""
        path = [e]
        n = e.v
        while len(path) < max_edges:
            ind, outd = self.degree(n)
            if ind != 1 or outd != 1:
                break
            nxt = self.out_edges(n)[0]
            path.append(nxt)
            n = nxt.v
        return path, n

    def _z_score(self, path) -> int:
        """cal_z_path_score (asg.c:2800-2807): relative end-edge weight,
        sco*ide*10000 / best sibling at each endpoint, summed."""
        mo = max((x.sco * x.ide for x in self.out_edges(path[0].u)),
                 default=0)
        sc = path[0].sco * path[0].ide * 10000 // mo if mo else 0
        mi = max((x.sco * x.ide for x in self.in_edges(path[-1].v)),
                 default=0)
        sc += path[-1].sco * path[-1].ide * 10000 // mi if mi else 0
        return sc

    def _z_rm_path(self, path, m: int):
        """Path removal policy shared by the score passes (asg.c:2755-2769):
        long paths (>= m edges, m>0) lose only their END edges; short paths
        are removed whole.  Complements go with them (_del_edge)."""
        if m and len(path) >= m:
            self._del_edge(path[-1])
            self._del_edge(path[0])
        else:
            for e in path:
                self._del_edge(e)

    def clip_z_by_score_tc(self, s: int = 8, m: int = 0, perc: int = 60):
        """rm_z_clip_score3 (asg.c:2681-2775): per branch vertex, walk each
        out-arm through pure simple nodes (<= s edges) to a merge node; rank
        arms by a packed (end-edge score ratio << 8 | triangle-count ratio)
        key — each component is the arm's end edges relative to the best
        sibling at that endpoint, x50 per end, capped at `perc` — and remove
        arms ascending until one clears BOTH ratios."""
        tc = self.edge_triangle_counts()

        def _tc(e):
            return tc.get(self.einfo.get((e.u, e.v)), 0)

        n_cut = 0
        for v in self.node_order:
            oes = self.out_edges(v)
            if len(oes) < 2:
                continue
            cands = []
            for e in oes:
                path, end = self._z_walk_fwd(e, s)
                if self.degree(end)[0] > 1:
                    cands.append(path)
            if not cands:
                continue
            max_sco_ou = max((x.sco * x.ide for x in self.out_edges(v)),
                             default=0)
            max_tc_ou = max((_tc(x) for x in self.out_edges(v)), default=0)
            scored = []
            for path in cands:
                ins = self.in_edges(path[-1].v)
                max_sco_in = max((x.sco * x.ide for x in ins), default=0)
                sc = path[0].sco * path[0].ide * 50 // max_sco_ou \
                    if max_sco_ou else 0
                sc += path[-1].sco * path[-1].ide * 50 // max_sco_in \
                    if max_sco_in else 0
                sc = min(sc, perc)
                max_tc_in = max((_tc(x) for x in ins), default=0)
                t = _tc(path[0]) * 50 // max_tc_ou if max_tc_ou else 0
                t += _tc(path[-1]) * 50 // max_tc_in if max_tc_in else 0
                t = min(t, perc)
                scored.append(((sc << 8) | t, path))
            scored.sort(key=lambda x: x[0])
            for key, path in scored:
                if len(self.out_edges(path[0].u)) < 2 or \
                        len(self.in_edges(path[-1].v)) < 2:
                    continue
                if (key >> 8) >= perc and (key & 255) >= perc:
                    break
                self._z_rm_path(path, m)
                n_cut += 1
        return n_cut

    def _z_find_from(self, node: int, s: int):
        """find_z_path_from (asg.c:2833-2873): if `node` sits on a pure
        simple chain, reconstruct the full z-path through it (walk forward
        to the merge node, backward to the branch node); returns the edge
        path or None."""
        fwd = []
        n = node
        while len(fwd) < s:
            ind, outd = self.degree(n)
            if ind != 1 or outd != 1:
                break
            e = self.out_edges(n)[0]
            fwd.append(e)
            n = e.v
        if not fwd or self.degree(n)[0] <= 1:
            return None
        back = []
        n = node
        while len(fwd) + len(back) <= s + 1:
            ind, outd = self.degree(n)
            if ind != 1 or outd != 1:
                break
            e = self.in_edges(n)[0]
            back.append(e)
            n = e.u
        if self.degree(n)[1] > 1 and len(fwd) + len(back) <= s:
            return back[::-1] + fwd
        return None

    def clip_z_progressive(self, s: int = 16, m: int = 0, perc: int = -1):
        """rm_z_clip_score2 (asg.c:3016-3080 + z_clipping_by_updating):
        collect EVERY z-path in the graph (branch -> pure simple chain ->
        merge, <= s-1 edges), order globally by relative end-edge score
        ascending, and clip from the weakest up — after each removal,
        z-paths newly formed at the affected endpoints are re-discovered
        and merged into the worklist.  Progressive thresholds (every
        1000th score) bound re-sorting at scale like the reference."""
        from bisect import insort

        paths = []
        for v in self.node_order:
            if len(self.out_edges(v)) < 2:
                continue
            for e in self.out_edges(v):
                path, end = self._z_walk_fwd(e, s - 1)
                if self.degree(end)[0] > 1:
                    paths.append((self._z_score(path), path))
        paths.sort(key=lambda x: x[0])
        each = 1000
        thresholds = []
        for i in range(1, len(paths) // each):
            sco = paths[i * each][0]
            if perc >= 0 and sco > perc:
                break
            thresholds.append(sco)
        thresholds.append(perc)

        n_cut = 0
        seq = 0
        ps = [(sco, i, path) for i, (sco, path) in enumerate(paths)]
        seq = len(ps)
        for thres in thresholds:
            left = []
            new = []
            ci = 0
            while ci < len(ps) or new:
                if ci >= len(ps):
                    ent = new.pop(0)
                    from_new = True
                elif not new:
                    ent = ps[ci]
                    from_new = False
                elif ps[ci][0] <= new[0][0]:
                    ent = ps[ci]
                    from_new = False
                else:
                    ent = new.pop(0)
                    from_new = True
                sco, _, path = ent
                if thres >= 0 and sco >= thres:
                    if from_new:
                        new.insert(0, ent)
                    break
                if not from_new:
                    ci += 1
                start, end = path[0].u, path[-1].v
                if len(self.out_edges(start)) < 2 or \
                        len(self.in_edges(end)) < 2 or \
                        any(e.deleted or e.reduced for e in path):
                    continue
                self._z_rm_path(path, m)
                n_cut += 1
                for node in (start, end, start ^ 1, end ^ 1):
                    np_ = self._z_find_from(node, s)
                    if np_ is None:
                        continue
                    nsco = self._z_score(np_)
                    ent2 = (nsco, seq, np_)
                    seq += 1
                    if thres >= 0 and nsco >= thres:
                        insort(left, ent2)
                    else:
                        insort(new, ent2)
            # leftovers + untouched tail feed the next threshold round
            # ascending (merge_z_paths, asg.c:2880-2912)
            rest = ps[ci:] + new
            rest.extend(left)
            rest.sort(key=lambda x: x[0])
            ps = rest
        return n_cut

    # ---------- repeat-depth marking (mark_edge_rep, asg.c:341-416) --------
    def clean(self, alt_ctg: bool = False, stop_after: int | None = None):
        """Cleaning pipeline in the reference's exact pass order
        (ng/main.c:191-279).  alt_ctg mirrors nextgraph -A
        (ng/main.c:231-247, bubble_len 40 per main.c:153): z-clip by score
        replaces the compound-path passes and rm_sht_bubble replaces
        rm_long_bubble.

        stop_after: run only the first N passes (parity testing against the
        native port, tests/test_native_graph.py).

        After clean(), self.pass_stats holds (name, edges_removed) per pass
        (live-edge delta) — the observability hook mirroring the
        reference's per-pass -d stat_graph lines."""
        if alt_ctg and self.p["bubble_len"] == 500:
            self.p["bubble_len"] = 40
        zb = self.p["zbranch_len"]
        sp = self.p["out_spath_len"]
        sb = self.p["sbranch_len"]
        cp = self.p.get("cpath_len", 20)
        kc = self.p.get("keep_comp_path", 1)
        passes = [
            ("rm_edge_lq", self.rm_edge_lq),
            ("sort_stat_oe", self.sort_stat_oe),
            ("mark_edge_rep", lambda: self.mark_repeat_edges(
                self.p.get("min_depth_multi", 1.5),
                self.p.get("max_depth_multi", 2000.0))),
            ("mark_node_chim", self.mark_chimeric_nodes),
            ("mark_edge_tr", self.transitive_reduction),
            ("rm_edge_spur", self.rm_edge_spur),
            ("mark_edge_hls", self.mark_edge_hls_rm_ls),
            ("mark_edge_bs", self.keep_best_edges),
            ("rm_sht_brh1", lambda: self.clip_tips(sb, sp)),
            ("rm_z_clip_lable1", lambda: self.clip_z_labeled(M_CN, zb, sp)),
            ("rm_z_clip_lable2", lambda: self.clip_z_labeled(M_CN, zb, sp)),
            ("rm_z_clip_lable3", lambda: self.clip_z_labeled(M_CC, zb, sp)),
        ]
        if alt_ctg:
            passes += [
                ("rm_z_clip_score1", lambda: self.clip_z_edges()),
                ("rm_z_clip_score2a", lambda: self.clip_z_edges()),
            ]
        else:
            passes += [
                ("clean_complex_single_path",
                 lambda: self.clean_complex_single_path(
                     self.p["bubble_len"], 0)),
                ("clean_complex_multi_path",
                 lambda: self.clean_complex_multi_path(
                     self.p["bubble_len"], sp)),
                ("calc_edge_tc", lambda: self.calc_edge_tc(255)),
                ("rm_z_clip_score3", lambda: self.clip_z_by_score_tc(
                    zb, sp, int(self.p["min_depth_ratio"] * 100))),
                ("clean_complex_graph",
                 lambda: self.clean_complex_graph(8, sp)),
                ("rm_z_clip_score2",
                 lambda: self.clip_z_progressive(2 * zb, sp, -1)),
            ]
        passes += [
            ("rm_sht_brh2", lambda: self.clip_tips(sb, sp)),
            ("rm_sht_loop", self.break_short_loops),
        ]
        if alt_ctg:
            passes.append(("rm_sht_bubble", self.pop_bubbles))
        else:
            passes.append(
                ("rm_long_bubble",
                 lambda: self.rm_long_bubble(self.p["bubble_len"], sp)))
        passes += [
            ("rm_end_loop", self.break_end_loops),
            ("clean_complex_path1",
             lambda: self.clean_complex_path(int(cp * 1.5), kc, 0)),
            ("clean_complex_path2",
             lambda: self.clean_complex_path(cp, kc, M_CN)),
            ("clean_complex_path3",
             lambda: self.clean_complex_path(cp, kc, M_LS)),
            ("rm_sht_brh3", lambda: self.clip_tips(sb, sp)),
        ]
        if alt_ctg:
            passes.append(("calc_edge_tc_alt", lambda: self.calc_edge_tc(
                self.p["min_edge_cov"])))
        passes += [
            ("rm_edge_chim", lambda: self.rm_edge_chim(
                10 if self.p.get("keep_chimera_edge") else 50,
                0.5, 8500, M_CC)),
            ("rm_edge_ltc", lambda: self.drop_untriangled_edges(
                self.p["min_edge_cov"])),
            ("rm_sht_brh4", lambda: self.clip_tips(5, sp)),
        ]

        def n_live():
            return sum(1 for e in self.edges
                       if not (e.deleted or e.reduced))

        self.pass_stats = []
        for i, (name, fn) in enumerate(passes):
            if stop_after is not None and i >= stop_after:
                break
            before = n_live()
            fn()
            self.pass_stats.append((name, before - n_live()))

    # ---------- contig extraction ----------
    def contigs(self):
        """Contig walk — exact port of generate_ctg (ng/ctg.c:67-295).

        Candidate start nodes (branch/terminal, not mid-chain) are pushed
        in creation order and popped LIFO, with junction successors pushed
        as the walk discovers them, so the surviving orientation of each
        contig is the one the reference picks (both orientations exist in
        the bidirected graph and their junction cuts differ textually —
        starting from the other end yields a slightly different sequence).
        Returns a list of (path, dangling_out_edge_or_None, type) where
        path = [(vertex, in_edge)], type indexes CTG_TYPES
        (unknown/linear/loop/breakpoint/junction), and dangling is the edge
        into the excluded junction when a linear walk ends at one
        (ctg.c:206-210: the junction node itself joins no contig but its
        alignment endpoint bounds the last emitted node)."""
        visited = set()
        results = []
        stack = []
        for v in self.node_order:
            ind, outd = self.degree(v)
            if ind + outd == 0 or (ind == 1 and outd <= 1):
                continue
            stack.append(v)
        while stack:
            v = stack.pop()
            if v in visited:
                continue
            ind, outd = self.degree(v)
            if ind + outd == 0:
                continue
            if outd == 0:
                # single node, full read (type 3, ctg.c:88-106)
                results.append(([(v, None)], None, 3))
                visited.add(v)
                visited.add(v ^ 1)
                for e in self.out_edges(v ^ 1):
                    stack.append(e.v)
            elif ind > 1 and outd > 1:
                # junction node, full read (type 4, ctg.c:107-132)
                results.append(([(v, None)], None, 4))
                visited.add(v)
                for e in self.out_edges(v):
                    stack.append(e.v)
                visited.add(v ^ 1)
                for e in self.out_edges(v ^ 1):
                    stack.append(e.v)
            elif outd > 1:
                # branch with id<=1: successors start their own contigs
                # (ctg.c:133-141; the node itself is claimed as the end
                # node of whatever chain runs into it)
                for e in self.out_edges(v):
                    stack.append(e.v)
            else:
                # od == 1: linear path start (ctg.c:142-243)
                path = [(v, None)]
                visited.add(v)
                visited.add(v ^ 1)
                for e2 in self.out_edges(v ^ 1):
                    stack.append(e2.v)
                e = self.out_edges(v)[0]
                n = e.v
                while True:
                    ind, outd = self.degree(n)
                    if not (ind == 1 and outd == 1) or n in visited:
                        break
                    visited.add(n)
                    visited.add(n ^ 1)
                    path.append((n, e))
                    e = self.out_edges(n)[0]
                    n = e.v
                ind, outd = self.degree(n)
                if ind > 1 or n in visited:
                    # open end at a junction/visited node: excluded, but
                    # its edge bounds the last node (ctg.c:204-210)
                    results.append((path, e, 1))
                else:
                    path.append((n, e))
                    visited.add(n)
                    visited.add(n ^ 1)
                    results.append((path, None, 1))
                    for e2 in self.out_edges(n):
                        stack.append(e2.v)
        # pure cycles (ctg.c:245-295), ascending creation order
        for v in self.node_order:
            if v in visited:
                continue
            ind, outd = self.degree(v)
            if ind + outd == 0 or not (ind == 1 and outd == 1):
                continue
            path = [(v, None)]
            visited.add(v)
            visited.add(v ^ 1)
            e = self.out_edges(v)[0]
            n = e.v
            while n != v and n not in visited:
                ind, outd = self.degree(n)
                if not (ind == 1 and outd == 1):
                    break
                visited.add(n)
                visited.add(n ^ 1)
                path.append((n, e))
                e = self.out_edges(n)[0]
                n = e.v
            results.append((path, e if n == path[0][0] else None, 2))
        return results

    def _max_pair_score(self, v: int, out_side: bool) -> int:
        """Best sco*ide over v's live out-edges (out_side) or in-edges
        (ng/ctg.c:48-64 get_max_score)."""
        es = self.out_edges(v) if out_side else self.in_edges(v)
        return max((e.sco * e.ide for e in es), default=0) or 1

    def contig_node_meta(self, path, seg_lens) -> List[dict]:
        """Per-node quality records matching the reference's contig header
        qv tags (ng/out.c:487-499 packs off<<32|ide<<20|ort<<10|irt per
        node; ng/ctg.c:184-186 computes ide=e.ide/10, ort/irt = the edge's
        sco*ide as permille of the best alternative at its tail/head).
        lq mirrors MFLAG_LQ-marked support (generate_ctg is called with
        l=MFLAG_LQ, ng/main.c:283) via our surviving chim marks."""
        meta = []
        off = 0
        for (vtx, e), seg in zip(path, seg_lens):
            if e is None:
                ide = ort = irt = 1000
                lq = 0
            else:
                s = e.sco * e.ide
                ide = min(1000, e.ide // 10)
                ort = min(1000, s * 1000 // self._max_pair_score(e.u, True))
                irt = min(1000, s * 1000 // self._max_pair_score(e.v, False))
                lq = 1 if e.chim else 0
            meta.append(dict(off=off, seg=seg, ide=ide, ort=ort, irt=irt,
                             lq=lq))
            off += seg
        return meta

    def _node_slice(self, vtx: int, s: int, e: int, get_read):
        """Emit one contig node's bases per the reference's out_ctg_fasta
        (ng/out.c:504-509): endpoints are sorted (re_cal_len ng/out.c:23-27),
        then a forward node contributes read[s+1 .. e] inclusive and a
        reverse node revcomp(read[s .. e-1]) — both exactly e-s bases."""
        L = self.reads[vtx // 2].length
        s = max(0, min(s, L - 1))
        e = max(0, min(e, L - 1))
        if e < s:
            s, e = e, s
        if vtx & 1:
            seg = get_read(vtx // 2)[s:e]
            return (seg ^ 3)[::-1]
        return get_read(vtx // 2)[s + 1:e + 1]

    def contig_sequences(self, get_read, with_paths: bool = False,
                         with_meta: bool = False):
        """Emit contig base arrays.  get_read(rid) -> codes (fwd).

        Exact port of the reference's node slicing (generate_ctg
        ctg.c:142-243 + out_ctg_fasta out.c:469-519): junctions cut at the
        stored per-edge alignment endpoints — each middle node contributes
        [in_edge.oe, out_edge.ie] in its own fwd-frame coords, a linear
        path's first node its full head up to out_edge.ie, its last node
        the full tail from in_edge.oe (or, when the walk ends at a
        junction, up to the dangling edge's ie), single/junction nodes the
        full forward read; endpoints are swapped when inverted
        (re_cal_len out.c:17-31) and forward nodes emit read[s+1..e]
        inclusive, reverse nodes revcomp(read[s..e-1])."""
        seqs, metas, all_paths, types = [], [], [], []
        for path, dangling, ctype in self.contigs():
            parts = []
            seg_lens = []
            n = len(path)
            for i, (vtx, e_in) in enumerate(path):
                L = self.reads[vtx // 2].length
                e_out = path[i + 1][1] if i + 1 < n else dangling
                if ctype in (3, 4):
                    # full forward read, l=0 (ctg.c:95-99,116-120)
                    parts.append(get_read(vtx // 2)[1:L])
                    seg_lens.append(L - 1)
                    continue
                if i == 0:
                    s = (L - 1) if (vtx & 1) else 0
                    e = e_out.ie if e_out is not None else \
                        (0 if (vtx & 1) else L - 1)
                elif e_out is None:
                    s = e_in.oe
                    e = 0 if (vtx & 1) else (L - 1)
                else:
                    s, e = e_in.oe, e_out.ie
                seg = self._node_slice(vtx, s, e, get_read)
                parts.append(seg)
                seg_lens.append(len(seg))
            seqs.append(np.concatenate(parts) if parts
                        else np.zeros(0, np.uint8))
            all_paths.append(path)
            types.append(ctype)
            if with_meta:
                metas.append(self.contig_node_meta(path, seg_lens))
        self.last_types = types
        if with_meta:
            return seqs, all_paths, metas
        if with_paths:
            return seqs, all_paths
        return seqs


def _native_build_clean(g: "StringGraph", ovl, alt_ctg: bool) -> bool:
    """Run build + clean through the native packed-array port
    (native/graph.cpp; pass-for-pass parity proven in
    tests/test_native_graph.py) and materialize the surviving edges back
    into `g` for extraction/output.  Only alive edges are materialized —
    the Python Edge-object representation is the scale bottleneck this
    port removes (VERDICT r2: one dataclass per edge blows up at the
    10^6-10^7 reads of a real genome)."""
    try:
        from ..native import graph_run
    except Exception:
        return False
    reads = g.reads
    n_reads = (max(reads.keys()) + 1) if reads else 0
    rinfo = np.zeros((n_reads, 10), np.int64)
    for rid, r in reads.items():
        rinfo[rid] = [r.length, r.s, r.e, r.con, r.lim, r.rim, r.llm,
                      r.rlm, r.lc, r.rc]
    recs = g.build_records(ovl)
    ip = dict(max_hang_len=g.p["max_hang_len"],
              min_node_count=g.p["min_node_count"],
              min_con_count=g.p["min_con_count"], fuzz_len=g.p["fuzz_len"],
              sbranch_len=g.p["sbranch_len"],
              out_spath_len=g.p["out_spath_len"], sloop_len=g.p["sloop_len"],
              end_loop_len=g.p["end_loop_len"],
              zbranch_len=g.p["zbranch_len"],
              min_edge_cov=g.p["min_edge_cov"],
              min_ide_i=int(g.p["min_ide"] * 10000), alt_ctg=alt_ctg,
              bubble_len=g.p["bubble_len"],
              cpath_len=g.p.get("cpath_len", 20),
              keep_comp_path=g.p.get("keep_comp_path", 1),
              keep_chimera_edge=g.p.get("keep_chimera_edge", 0))
    fp = dict(min_ide_ratio=g.p["min_ide_ratio"],
              min_sco_ratio=g.p["min_sco_ratio"],
              max_sco_ratio=g.p["max_sco_ratio"],
              min_depth_ratio=g.p["min_depth_ratio"],
              min_depth_multi=g.p.get("min_depth_multi", 1.5),
              max_depth_multi=g.p.get("max_depth_multi", 2000.0),
              min_mat_ratio=g.p.get("min_mat_ratio", 0.9))
    edges, flags, con, norder = graph_run(recs, rinfo, ip, fp, mode=0)
    for rid, r in reads.items():
        r.con = int(con[rid])
    g.node_order = [int(x) for x in norder]
    g._known_nodes = {v // 2 for v in g.node_order}
    alive = (flags & 3) == 0
    ea, fa = edges[alive], flags[alive]
    for (u, v, h, s, i, iec, oec), fl in zip(ea.tolist(), fa.tolist()):
        e = Edge(u, v, h, s, i, iec, oec,
                 mfl=(M_CN if fl & 4 else 0) | (M_REP1 if fl & 8 else 0))
        g.edges.append(e)
        g.einfo[(u, v)] = len(g.edges) - 1
        g.out.setdefault(u, []).append(len(g.edges) - 1)
        g.inn.setdefault(v, []).append(len(g.edges) - 1)
    return True


def assemble(ovl, read_lens: Dict[int, int], bl_info: Optional[dict] = None,
             get_read=None, min_ctg_len: int = 1000, alt_ctg: bool = False,
             use_native: Optional[bool] = None, **params):
    """High-level: overlaps (+ blacklist info) -> contig sequences.

    bl_info: optional dict rid -> dict(con, le, re, lim, rim, llm, rlm,
    lc, rc).  alt_ctg mirrors nextgraph -A (output alternative contigs).

    When bl_info is given, ONLY reads present in it join the graph — the
    reference's update_graph skips records whose reads are absent from
    the .bl ovlinfo hash (ng/asg.c:1488-1494), so contained/chimeric
    reads filtered by init_os never contribute edges or vote state.

    use_native: build + clean through native/graph.cpp (default when the
    native lib is available; pass False to force the Python oracle).
    """
    reads = {}
    rids = bl_info.keys() if bl_info is not None else read_lens.keys()
    for rid in rids:
        L = read_lens[rid]
        info = (bl_info or {}).get(rid, {})
        reads[rid] = ReadInfo(
            length=L, s=info.get("le", 0), e=L - info.get("re", 0),
            con=info.get("con", 0), lim=info.get("lim", 0),
            rim=info.get("rim", 0), llm=info.get("llm", 0),
            rlm=info.get("rlm", 0), lc=info.get("lc", 0),
            rc=info.get("rc", 0))
    g = StringGraph(reads, **params)
    done = False
    if use_native is not False:
        done = _native_build_clean(g, ovl, alt_ctg)
        if not done and use_native:
            raise RuntimeError("native graph requested but unavailable")
    if not done:
        g.build(ovl)
        g.clean(alt_ctg=alt_ctg)
    if get_read is None:
        return g, []
    seqs, paths, metas = g.contig_sequences(get_read, with_meta=True)
    keep = [(s, p, m) for s, p, m in zip(seqs, paths, metas)
            if len(s) >= min_ctg_len]
    keep.sort(key=lambda sp: len(sp[0]), reverse=True)
    g.last_paths = [p for _, p, _ in keep]
    g.last_node_meta = [m for _, _, m in keep]
    return g, [s for s, _, _ in keep]
