"""The port's CLI sub-commands against the JAX package's on the same inputs
(tests/test_cli.py's 20 kb reads): seq_stat, seq_bit (fasta, SeqStore .npz
and reference 2bit, both directions), ovl_cvt (text, .ovl.npz, reference
.refovl) and stat print the same and write the same (text files byte for
byte, .npz files array for array).  Also the help and unknown-command
return codes and the launcher's batch-queue dry run."""
import os

import numpy as np
import pytest

from nextdenovo_tpu.__main__ import main as jmain
from nextdenovo_tpu.io.fastx import read_fastx, write_fasta
from nextdenovo_tpu.io.simulate import simulate_genome, simulate_reads
from nextdenovo_tpu.overlap.records import OvlBlock
from nextdenovo_tpu_torch import __main__ as tcli
from nextdenovo_tpu_torch.__main__ import main as tmain


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    g = simulate_genome(20_000, seed=11)
    sim = simulate_reads(g, coverage=8, mean_len=4000, error_rate=0.05,
                         seed=12, min_len=1500)
    write_fasta(str(d / "reads.fa"),
                [(f"r{i}", r) for i, r in enumerate(sim.reads)])
    # integer names: what the reference's 2bit DB stores
    write_fasta(str(d / "ints.fa"),
                [(str(i + 1), r) for i, r in enumerate(sim.reads)])
    (d / "input.fofn").write_text(str(d / "reads.fa") + "\n")
    rng = np.random.default_rng(4)
    n = 50
    qs, ts = rng.integers(0, 5000, n), rng.integers(0, 5000, n)
    aln = rng.integers(500, 3000, n)
    OvlBlock.from_arrays(
        qname=np.sort(rng.integers(1, 40, n)), tname=rng.integers(1, 40, n),
        qs=qs, qe=qs + aln, ts=ts, te=ts + aln + rng.integers(-50, 50, n),
        rev=rng.integers(0, 2, n), match=rng.integers(100, 2000, n),
        qlen=qs + aln + 100, tlen=ts + aln + 200).save(str(d / "a.ovl.npz"))
    return d


def _same_file(a, b):
    if a.endswith(".npz"):
        x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert np.array_equal(x[k], y[k]), k
    else:
        assert open(a, "rb").read() == open(b, "rb").read()


def _both(capsys, argv, out=None):
    """Run argv through both CLIs; the output file `out` (an argument of
    argv) is written by each in turn.  Returns the printed text."""
    res = []
    for tag, main in (("jax", jmain), ("torch", tmain)):
        assert main(list(argv)) == 0, tag
        res.append(capsys.readouterr().out)
        if out:
            os.replace(out, f"{out}.{tag}")
            if os.path.exists(out + ".idx"):
                os.replace(out + ".idx", f"{out}.{tag}.idx")
    assert res[0] and res[0] == res[1]
    if out:
        _same_file(f"{out}.jax", f"{out}.torch")
    return res[1]


@pytest.mark.parametrize("gs", ["20k", "0"])
def test_seq_stat(inputs, capsys, gs):
    out = _both(capsys, ["seq_stat", "-f", str(inputs / "input.fofn"),
                         "-g", gs, "-d", "5"])
    assert "N50" in out
    assert ("[suggested seed_cutoff]" in out) == (gs != "0")


@pytest.mark.parametrize("src,dst", [
    ("reads.fa", "seqs.npz"), ("seqs.npz", "back.fa"),
    ("ints.fa", "ints.2bit"), ("ints.npz", "from_npz.2bit"),
    ("ints.2bit", "from_2bit.fa"), ("ints.2bit", "from_2bit.npz")])
def test_seq_bit(inputs, tmp_path, capsys, src, dst):
    # the inputs other cases write: made here by the JAX package's CLI
    for s, o in (("reads.fa", "seqs.npz"), ("ints.fa", "ints.npz"),
                 ("ints.fa", "ints.2bit")):
        if not (inputs / o).exists():
            assert jmain(["seq_bit", str(inputs / s), str(inputs / o)]) == 0
    capsys.readouterr()
    out = str(tmp_path / dst)
    printed = _both(capsys, ["seq_bit", str(inputs / src), out], out)
    n_reads = sum(1 for _ in read_fastx(str(inputs / "reads.fa")))
    assert f" {n_reads} reads" in printed


@pytest.mark.parametrize("src,dst", [
    ("a.ovl.npz", "a.txt"), ("a.txt", "b.ovl.npz"),
    ("a.ovl.npz", "a.refovl"), ("a.refovl", "c.txt")])
def test_ovl_cvt(inputs, tmp_path, capsys, src, dst):
    for s, o in (("a.ovl.npz", "a.txt"), ("a.ovl.npz", "a.refovl")):
        if not (inputs / o).exists():
            assert jmain(["ovl_cvt", str(inputs / s), str(inputs / o)]) == 0
    capsys.readouterr()
    out = str(tmp_path / dst)
    # the printed line names the paths: run both in the same place
    printed = _both(capsys, ["ovl_cvt", str(inputs / src), out], out)
    assert "(50 records)" in printed


@pytest.mark.parametrize("gs", ["20k", "0"])
def test_stat(inputs, capsys, gs):
    out = _both(capsys, ["stat", str(inputs / "reads.fa"), "-g", gs])
    assert "Total" in out and "N50" in out


def test_help_and_unknown(capsys):
    for main in (jmain, tmain):
        assert main([]) == 0
        assert main(["--help"]) == 0
        assert main(["nope"]) == 2
    text = capsys.readouterr().out
    for cmd in ("run", "launch", "seq_stat", "seq_bit", "ovl_cvt", "stat"):
        assert cmd in tcli.__doc__, cmd
    assert "launch" in text


@pytest.mark.parametrize("device", [None, "cpu"])
def test_launcher_submit_dry_run(tmp_path, capsys, monkeypatch, device):
    """--submit writes one job script per host, each running the port's
    launcher, and --dry-run prints the scheduler's commands."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "run.cfg").write_text(
        "[General]\nworkdir = ./wd\ninput_fofn = ./in.fofn\n")
    (tmp_path / "in.fofn").write_text("")
    argv = ["launch", "run.cfg", "--hosts", "3", "--submit", "slurm",
            "--submit-opts", "-p gpu", "--dry-run"]
    assert tmain(argv + (["--device", device] if device else [])) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3
    assert out[0].startswith("sbatch -J ndtpu_h0")
    assert "-p gpu" in out[0] and "host_2.sh" in out[2]
    jobs = sorted((tmp_path / "wd" / ".jobs").glob("host_*.sh"))
    assert len(jobs) == 3
    for k, job in enumerate(jobs):
        body = job.read_text()
        assert "-m nextdenovo_tpu_torch.parallel.launcher" in body
        assert f"--hosts 3 --host-id {k}" in body
        assert ("--device cpu" in body) == (device == "cpu")
    with pytest.raises(SystemExit):
        tmain(["launch", "run.cfg", "--hosts", "2",
               "--coordinator", "localhost:1234"])


def test_launcher_local_stops_hosts_when_one_fails(tmp_path):
    """--submit local: when one host fails, the launcher stops the others
    (which would wait on its barrier files) and returns its exit code."""
    import subprocess
    import sys
    import time
    (tmp_path / "run.cfg").write_text(
        "[General]\nworkdir = ./wd\ninput_fofn = ./missing.fofn\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "nextdenovo_tpu_torch", "launch", "run.cfg",
         "--hosts", "2", "--submit", "local", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    # host 0 cannot read the input; host 1 waits for its stage 00 until
    # the launcher stops it
    assert r.returncode == 1, r.stderr[-2000:]
    assert "missing.fofn" in r.stderr
    assert "stopping the others" in r.stderr
    assert time.time() - t0 < 100
    assert not (tmp_path / "wd" / "00.db" / ".done").exists()
