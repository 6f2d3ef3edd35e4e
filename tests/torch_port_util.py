"""Shared helpers of the tests/test_torch_*.py files: inputs made from a
seed with numpy, and exact comparison of aligner results."""
import numpy as np
import torch

from nextdenovo_tpu.io.fastx import write_fasta
from nextdenovo_tpu.io.simulate import (mutate_read, simulate_genome,
                                        simulate_reads)

# The port's plain PyTorch versions are Python loops of small tensor ops:
# more intra-op threads gain nothing there, and with several test workers on
# one machine they cost a lot.  Every worker imports this module when it
# collects the tests, so the setting holds for the whole run.
torch.set_num_threads(1)

# at a few tens of kb the string graph needs short branches kept to give a
# contig
GRAPH_SMALL = "nextgraph_options = -l 2\n"


def rand_pair(rng, n, err):
    t = rng.integers(0, 4, n).astype(np.int8)
    q = mutate_read(t.astype(np.uint8), err, rng).astype(np.int8)
    return q, t


def assert_same_results(ref, got):
    """Exact equality of {dist, reached, ok, ops} per pair."""
    assert len(ref) == len(got)
    for i, (x, y) in enumerate(zip(ref, got)):
        assert x["dist"] == y["dist"], (i, x["dist"], y["dist"])
        assert bool(x["reached"]) == bool(y["reached"]), i
        assert bool(x["ok"]) == bool(y["ok"]), i
        assert np.array_equal(np.asarray(x["ops"]), np.asarray(y["ops"])), i


def write_correct_cfg(d, name, glen, workdir, task="correct", extra="",
                      read_type="ont"):
    p = d / f"run_{name}.cfg"
    p.write_text(f"""
[General]
task = {task}
input_type = raw
read_type = {read_type}
input_fofn = ./input.fofn
workdir = ./{workdir}
{extra}
[correct_option]
read_cutoff = 500
genome_size = {glen}
seed_cutoff = 1500
""")
    return str(p)


def write_reads(d, glen, seed, repeat_len=0, **kw):
    """reads.fa and input.fofn under d from a simulated genome; repeat_len
    > 0 gives the genome one duplicated segment of that length."""
    g = simulate_genome(glen, seed=seed, repeat_frac=2 * repeat_len / glen,
                        repeat_len=repeat_len or 5000)
    sim = simulate_reads(g, seed=seed + 1, **kw)
    write_fasta(str(d / "reads.fa"),
                [(f"r{i}", r) for i, r in enumerate(sim.reads)])
    (d / "input.fofn").write_text("reads.fa\n")
    return g


def assert_same_npz(x, y, what):
    """Two .npz files hold the same arrays."""
    x, y = np.load(x, allow_pickle=True), np.load(y, allow_pickle=True)
    assert sorted(x.files) == sorted(y.files), what
    for k in x.files:
        assert np.array_equal(x[k], y[k]), (what, k)
