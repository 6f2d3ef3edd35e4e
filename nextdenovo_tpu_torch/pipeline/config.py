"""run.cfg-compatible configuration.

Parses the reference's INI-ish `key = value` format (lib/config_parser.py:111)
and derives the same options (seed cutoff, sort depth cap, per-read-type
presets) so existing NextDenovo configs drop in.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

_UNIT = {"k": 1e3, "m": 1e6, "g": 1e9}


def parse_num_unit(v) -> int:
    """'1k'/'10m'/'3g' -> int (lib/kit.py:131)."""
    if isinstance(v, (int, float)):
        return int(v)
    m = re.match(r"^\s*([\d.]+)\s*([kmgKMG]?)", str(v))
    if not m:
        raise ValueError(f"bad numeric value: {v}")
    x = float(m.group(1))
    if m.group(2):
        x *= _UNIT[m.group(2).lower()]
    return int(x)


@dataclass
class Config:
    # [General]
    task: str = "all"
    input_fofn: str = ""
    input_type: str = "raw"
    read_type: str = "ont"     # clr | ont | hifi
    workdir: str = "./01_rundir"
    rewrite: bool = True
    rerun: int = 3             # bounded stage rerun (nextDenovo:652-661)
    # use_mesh = N > 1 (one host): run the heavy stages as the mesh path,
    # N shards over the visible cards (parallel/dist_pipeline.py) — the
    # collective form of the reference's job-matrix parallelism
    # (nextDenovo:426-467).  Its stage files equal the JAX package's
    # use_mesh = N run (tests/test_torch_pipeline_mesh.py).
    use_mesh: int = 0
    # [correct_option]
    read_cutoff: int = 1000
    genome_size: int = 0
    seed_cutoff: int = 0
    seed_depth: int = 45
    min_len_aln: int = 500
    min_cov_seed: int = 10
    max_cov_aln: int = 130
    min_cov_base: int = 4
    max_lq_length: int = 10000
    min_error_corrected_ratio: float = 0.8
    sort_max_depth: int = 40
    # corrected-seed splitting at uncorrected regions is OFF by default,
    # matching the reference (`-s` store_true default=False,
    # lib/nextcorrect.py:294; correction_options default '-p 10',
    # config_parser.py:92).  Splitting fragments reads at weak loci: on a
    # 500 kb golden run it alone broke the assembly 1 contig -> 2 (the
    # reference joined through an unsplit lowercase-region read).
    split_corrected: bool = False
    fast_correct: bool = False  # correction_options -fast (skip lq windows)
    # sketch presets (minimap2 ava analogues; config_parser.py:202-232)
    raw_k: int = 15
    raw_w: int = 5
    cns_k: int = 17
    cns_w: int = 17
    # [assemble_option]
    maxhan1: int = 5000
    maxhan2: int = 500
    cns_min_span: int = 2000
    min_ctg_len: int = 1000
    alt_ctg: bool = False      # nextgraph -A (output alternative contigs)
    ctg_split: bool = True     # ctg_cns -sp (split at unsupported joins)
    polish: bool = True
    graph_params: dict = field(default_factory=dict)  # nextgraph_options
    raw: dict = field(default_factory=dict)

    @property
    def read_type_code(self) -> int:
        return {"ont": 1, "clr": 2, "clr-rs": 2, "hifi": 3, "ccs": 3}[self.read_type]

    def derive(self, total_bases: int, lengths) -> None:
        """db_stat-time derivations (ConfigParser.update:24-47 +
        seq_stat's auto seed_cutoff, util/seq_stat.c:41-52)."""
        import numpy as np
        if self.genome_size <= 0 and self.seed_cutoff <= 0:
            raise ValueError("genome_size or seed_cutoff must be set")
        if self.seed_cutoff <= 0:
            ls = np.sort(np.asarray(lengths))[::-1]
            target = self.seed_depth * self.genome_size
            cum = np.cumsum(ls)
            idx = int(np.searchsorted(cum, target))
            idx = min(idx, len(ls) - 1)
            self.seed_cutoff = int(ls[idx])
            # reference floor + re-adjust (seq_stat.c:103, recal_seed_cutoff
            # :41-52): if the depth-derived cutoff lands under 10 kb, seeds
            # become all reads >= 10 kb, extended further only when those
            # carry < 20x (to 25x) — short marginal seeds are mostly
            # contained in longer reads and would be blacklisted anyway.
            MIN_SEED_CUTOFF, MIN_SEED_DEPTH = 10_000, 20
            if self.seed_cutoff < MIN_SEED_CUTOFF and self.genome_size > 0:
                i = int(np.searchsorted(-ls, -MIN_SEED_CUTOFF, side="right"))
                cov = int(cum[i - 1]) if i else 0
                if cov // self.genome_size < MIN_SEED_DEPTH:
                    lim = self.genome_size * (MIN_SEED_DEPTH + 5)
                    while i < len(ls) and cov < lim:
                        cov += int(ls[i])
                        i += 1
                self.seed_cutoff = int(ls[i - 1]) if i else int(ls[0])
        if self.genome_size > 0:
            total_depth = total_bases // self.genome_size
            self.sort_max_depth = (total_depth - 2) if total_depth <= 30 \
                else min(total_depth - 5, 40)
            self.sort_max_depth = max(self.sort_max_depth, 3)
        if self.read_type == "hifi":
            # -k51 -w51 long-kmer raw sketch (sketch.c:283 via ava-hifi);
            # cns stage keeps the -k17 -w17 preset (config_parser.py:49-65)
            self.raw_k, self.raw_w = 51, 51
        # _set_minlen analogues (config_parser.py:49-65)
        self.cns_min_span = min(2000, self.seed_cutoff // 10) or 2000
        self.maxhan1 = min(5000, self.seed_cutoff // 2) or 5000
        if self.max_lq_length == 10000 and self.read_type != "ont":
            self.max_lq_length = 1000

    @property
    def min_len_seed(self) -> int:
        return max(1000, self.seed_cutoff // 2)


def load_config(path: str) -> Config:
    cfg = Config()
    raw = {}
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("["):
                continue
            m = re.search(r"([^;\s]+)\s*[=:]\s*([^;#\n]+)", line)
            if not m or not m.group(2).strip():
                continue
            raw[m.group(1)] = m.group(2).strip()
    cfg.raw = raw
    if "task" in raw:
        cfg.task = raw["task"].split()[0]
    if "input_fofn" in raw:
        p = raw["input_fofn"]
        cfg.input_fofn = p if p.startswith("/") else os.path.join(base, p)
    if "input_type" in raw:
        cfg.input_type = raw["input_type"].split()[0]
    if "read_type" in raw:
        cfg.read_type = raw["read_type"].split()[0]
        if cfg.read_type == "ccs":
            cfg.read_type = "hifi"
    if "workdir" in raw:
        p = raw["workdir"]
        cfg.workdir = p if p.startswith("/") else os.path.join(base, p)
    if "rewrite" in raw:
        cfg.rewrite = raw["rewrite"].split()[0].lower() not in ("no", "0", "false")
    if "rerun" in raw:
        # capped at 10 like the reference (config_parser.py:263)
        cfg.rerun = min(10, max(0, int(raw["rerun"].split()[0])))
    if "use_mesh" in raw:
        cfg.use_mesh = int(raw["use_mesh"].split()[0])
    if "correction_options" in raw:
        if "-fast" in raw["correction_options"]:
            cfg.fast_correct = True
        if "-s" in raw["correction_options"].split():
            cfg.split_corrected = True
    # nextgraph_options passthrough (ng/main.c:85-140 getopt table): every
    # graph tunable the reference CLI exposes maps onto a StringGraph
    # param; unknown switches are ignored like the reference's permissive
    # option surgery (lib/kit.py:114 parse_options_value)
    if "nextgraph_options" in raw:
        toks = raw["nextgraph_options"].split()
        if "-A" in toks:
            cfg.alt_ctg = True
        val_opts = {
            "-i": ("min_ide", float), "-I": ("min_ide_ratio", float),
            "-S": ("min_sco_ratio", float), "-r": ("max_sco_ratio", float),
            "-M": ("min_mat_ratio", float), "-T": ("min_depth_ratio", float),
            "-m": ("min_depth_multi", float), "-n": ("max_depth_multi", float),
            "-N": ("min_node_count", int), "-u": ("min_con_count", int),
            "-w": ("min_edge_cov", int), "-D": ("bfs_depth", int),
            "-B": ("bubble_len", int), "-e": ("end_loop_len", int),
            "-z": ("zbranch_len", int), "-l": ("sbranch_len", int),
            "-L": ("sloop_len", int), "-t": ("max_hang_len", int),
            "-F": ("fuzz_len", int), "-q": ("out_spath_len", int),
            "-E": ("out_ctg_len", int),
        }
        i = 0
        while i < len(toks):
            opt = toks[i]
            if opt in val_opts and i + 1 < len(toks):
                name, typ = val_opts[opt]
                try:
                    cfg.graph_params[name] = typ(toks[i + 1])
                except ValueError:
                    pass
                i += 2
                continue
            i += 1
        if "out_ctg_len" in cfg.graph_params:
            cfg.min_ctg_len = int(cfg.graph_params["out_ctg_len"])
    # ctg_cns -sp disables split-at-unsupported (lib/ctg_cns.py:243
    # store_false, default on)
    if "ctg_cns_options" in raw and "-sp" in raw["ctg_cns_options"].split():
        cfg.ctg_split = False
    for key, attr in [("read_cutoff", "read_cutoff"),
                      ("genome_size", "genome_size"),
                      ("seed_cutoff", "seed_cutoff"),
                      ("seed_depth", "seed_depth")]:
        if key in raw:
            setattr(cfg, attr, parse_num_unit(raw[key].split()[0]))
    return cfg
