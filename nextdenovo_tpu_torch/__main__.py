"""CLI of the PyTorch/CUDA port: ``python -m nextdenovo_tpu_torch <cmd> ...``.

The same sub-commands as the JAX package's CLI, which stand in for the
reference's separate binaries (`nextDenovo`, `bin/seq_stat`, `bin/seq_bit`,
`bin/ovl_cvt`; SURVEY §2.5):

  run <run.cfg> [--device cpu]     pipeline driver (task = all | correct |
                                   assemble, stages 00-06)
  <run.cfg> [--device cpu]         the same, `run` may be left out (an
                                   existing file)
  launch <run.cfg> --hosts N ...   multi-host run: one host (--host-id K) or
                                   all N (--submit local|slurm|sge|pbs|lsf)
                                   sharing the workdir; [--device cpu]
  seq_stat -f fofn -g SZ           read stats + suggested seed_cutoff
  seq_bit  <in> <out>              fasta <-> SeqStore .npz <-> reference 2bit
  ovl_cvt  <in> <out>              .ovl.npz <-> text <-> reference .ovl
  stat     <fasta> [-g SZ]         N10..N90 table

`run` and `launch` run on the GPU unless `--device cpu` is given; the
other sub-commands are host code.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _iter_fofn(fofn: str):
    with open(fofn) as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield line


def cmd_seq_stat(argv) -> int:
    from .io.fastx import read_fastx
    from .pipeline.config import Config, parse_num_unit

    p = argparse.ArgumentParser(prog="seq_stat")
    p.add_argument("-f", "--fofn", required=True, help="fofn of fasta/fastq[.gz]")
    p.add_argument("-g", "--genome_size", default="0")
    p.add_argument("-d", "--seed_depth", type=int, default=45)
    p.add_argument("-c", "--read_cutoff", type=parse_num_unit, default=1000,
                   help="min read length, k/m/g units accepted (default 1k)")
    a = p.parse_args(argv)

    lengths = []
    for path in _iter_fofn(a.fofn):
        for _name, codes in read_fastx(path):
            lengths.append(len(codes))
    lengths = np.asarray(lengths, np.int64)
    raw_total, raw_count = int(lengths.sum()), len(lengths)
    lengths = lengths[lengths >= a.read_cutoff]
    st = _n50_dict(lengths)

    print(f"[Read length stat]")
    print(f"{'Types':<12}{'Count (#)':>14}{'Length (bp)':>16}")
    edges = [1_000, 5_000, 10_000, 15_000, 20_000, 30_000, 40_000]
    prev = 0
    for e in edges:
        sel = (lengths >= prev) & (lengths < e)
        print(f"{prev//1000}-{e//1000} kb{'':<4}{int(sel.sum()):>14}"
              f"{int(lengths[sel].sum()):>16}")
        prev = e
    sel = lengths >= prev
    print(f">={prev//1000} kb{'':<5}{int(sel.sum()):>14}{int(lengths[sel].sum()):>16}")
    print()
    print(f"[Read length cutoff] {a.read_cutoff}")
    print(f"raw reads: {raw_count}  bases: {raw_total}")
    print(f"clean reads: {st['count']}  bases: {st['total']}")
    for frac in range(10, 100, 10):
        L, c = st[f"N{frac}"]
        print(f"N{frac:<4}{L:>14}{c:>14}")
    gs = parse_num_unit(a.genome_size)
    if gs > 0 and len(lengths):
        cfg = Config(genome_size=gs, seed_depth=a.seed_depth)
        cfg.derive(st["total"], lengths)
        print(f"genome size: {gs}  depth: {st['total'] // gs}x")
        print(f"[suggested seed_cutoff] {cfg.seed_cutoff}")
    elif gs > 0:
        print("no reads survive the cutoff; no seed_cutoff suggestion")
    return 0


def _n50_dict(lengths):
    from .io.seqstore import stat_n50
    if len(lengths) == 0:
        return {"total": 0, "count": 0, "mean": 0, "max": 0, "min": 0,
                **{f"N{f}": (0, 0) for f in range(10, 100, 10)}}
    return stat_n50(lengths)


def cmd_seq_bit(argv) -> int:
    from .io.fastx import read_fastx, write_fasta, codes_to_str
    from .io.seqstore import SeqStore

    p = argparse.ArgumentParser(prog="seq_bit")
    p.add_argument("input", help="fasta/fastq[.gz], SeqStore .npz, or a "
                                 "reference 2bit DB (.2bit)")
    p.add_argument("output", help=".npz / .2bit (pack) or .fa/.fasta "
                                  "(unpack)")
    a = p.parse_args(argv)
    from .io.refformats import MAGIC_2BIT, read_2bit, write_2bit
    if not a.input.endswith(".npz") and \
            open(a.input, "rb").read(2) == MAGIC_2BIT:
        seqs, names = read_2bit(a.input)
        if a.output.endswith(".npz"):
            SeqStore.from_codes(seqs, names=[str(n) for n in names]
                                ).save(a.output)
        else:
            write_fasta(a.output, ((str(n), s)
                                   for n, s in zip(names, seqs)))
        print(f"unpacked {len(seqs)} reads from reference 2bit -> {a.output}")
        return 0
    if a.output.endswith(".2bit"):
        if a.input.endswith(".npz"):
            store = SeqStore.load(a.input)
            seqs = [store.get(i) for i in range(len(store))]
            names = [int(n) for n in (store.names or range(len(store)))]
        else:
            seqs, names = [], []
            for name, codes in read_fastx(a.input):
                names.append(int(name))
                seqs.append(codes)
        write_2bit(a.output, seqs, names=names)
        print(f"packed {len(seqs)} reads -> reference 2bit {a.output}")
        return 0
    if a.input.endswith(".npz"):
        store = SeqStore.load(a.input)
        names = store.names if store.names is not None else \
            [str(i) for i in range(len(store))]
        write_fasta(a.output, ((str(names[i]), store.get(i))
                               for i in range(len(store))))
        print(f"unpacked {len(store)} reads -> {a.output}")
    else:
        seqs, names = [], []
        for name, codes in read_fastx(a.input):
            names.append(name)
            seqs.append(codes)
        store = SeqStore.from_codes(seqs, names=names)
        store.save(a.output)
        print(f"packed {len(store)} reads ({store.total_bases} bp) -> {a.output}")
    return 0


def cmd_ovl_cvt(argv) -> int:
    from .overlap.records import OvlBlock

    p = argparse.ArgumentParser(prog="ovl_cvt")
    p.add_argument("input", help=".ovl.npz, text, or a reference binary "
                                 ".ovl (mode 8/10 varint)")
    p.add_argument("output", help="text, .ovl.npz, or reference .ovl "
                                  "(use a .refovl suffix to emit binary)")
    a = p.parse_args(argv)
    from .io.refformats import read_ovl, write_ovl

    def _load(path):
        if path.endswith(".npz"):
            return OvlBlock.load(path)
        head = open(path, "rb").read(64)
        try:
            head.decode("ascii")
            is_text = True
        except UnicodeDecodeError:
            is_text = False
        if is_text:
            return OvlBlock.from_text(open(path).read())
        return read_ovl(path)[0]

    blk = _load(a.input)
    if a.output.endswith(".npz"):
        blk.save(a.output)
    elif a.output.endswith(".refovl"):
        write_ovl(a.output, blk, mode=8)
    else:
        with open(a.output, "w") as fh:
            fh.write(blk.to_text())
    print(f"{a.input} -> {a.output} ({len(blk)} records)")
    return 0


def cmd_stat(argv) -> int:
    from .graph.output import stat_table
    from .io.fastx import read_fastx
    from .pipeline.config import parse_num_unit

    p = argparse.ArgumentParser(prog="stat")
    p.add_argument("fasta")
    p.add_argument("-g", "--genome_size", default="0")
    a = p.parse_args(argv)
    seqs = [codes for _n, codes in read_fastx(a.fasta)]
    gs = parse_num_unit(a.genome_size)
    sys.stdout.write(stat_table(seqs, gs or None))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmds = {
        "seq_stat": cmd_seq_stat,
        "seq_bit": cmd_seq_bit,
        "ovl_cvt": cmd_ovl_cvt,
        "stat": cmd_stat,
    }
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "launch":
        from .parallel.launcher import main as launch_main
        return launch_main(rest) or 0
    if cmd in cmds:
        return cmds[cmd](rest)
    if cmd != "run" and not os.path.isfile(cmd):
        print(f"unknown command: {cmd}\n{__doc__}", file=sys.stderr)
        return 2
    rest = rest if cmd == "run" else argv
    if not rest:
        print("usage: python -m nextdenovo_tpu_torch run <run.cfg> "
              "[--device cpu]", file=sys.stderr)
        return 1
    from .pipeline.run import main as run_main
    return run_main(rest) or 0


if __name__ == "__main__":
    sys.exit(main())
