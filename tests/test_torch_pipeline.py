"""The first slice as a whole: task = correct (stages 00-03) through the port's
run_pipeline on the CPU against the JAX package's run_pipeline with its
TPU path on the CPU (interpret=True), from the same reads.  Tolerance:
exact equality of raw.ovl, sorted.ovl, bl.json and the corrected store."""
import json
import os

import numpy as np
import pytest

from nextdenovo_tpu.io.fastx import write_fasta
from nextdenovo_tpu.io.simulate import simulate_genome, simulate_reads
from nextdenovo_tpu.pipeline.config import load_config as jload
from nextdenovo_tpu.pipeline.run import run_pipeline as jrun
from nextdenovo_tpu_torch.pipeline.config import load_config as tload
from nextdenovo_tpu_torch.pipeline import run as trun_mod
from nextdenovo_tpu_torch.pipeline.run import run_pipeline as trun

from torch_port_util import write_correct_cfg

GLEN = 12_000


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    g = simulate_genome(GLEN, seed=11)
    sim = simulate_reads(g, coverage=30, mean_len=2000, error_rate=0.10,
                         seed=12)
    write_fasta(str(d / "reads.fa"),
                [(f"r{i}", r) for i, r in enumerate(sim.reads)])
    (d / "input.fofn").write_text("reads.fa\n")
    jcfg = write_correct_cfg(d, "j", GLEN, "wd_j")
    tcfg = write_correct_cfg(d, "t", GLEN, "wd_t")
    ref = jrun(jload(jcfg), interpret=True)
    got = trun(tload(tcfg), device="cpu")
    return d, tcfg, ref, got


@pytest.mark.parametrize("rel", ["01.raw_align/raw.ovl.npz",
                                 "02.sort_align/sorted.ovl.npz"])
def test_overlap_blocks_equal(runs, rel):
    d, _, _, _ = runs
    x = np.load(str(d / "wd_j" / rel))
    y = np.load(str(d / "wd_t" / rel))
    assert sorted(x.files) == sorted(y.files)
    assert len(x["qname"]) > 0
    for k in x.files:
        assert np.array_equal(x[k], y[k]), (rel, k)


def test_blacklist_equal(runs):
    d, _, _, _ = runs
    rel = os.path.join("02.sort_align", "bl.json")
    assert json.load(open(d / "wd_j" / rel)) == json.load(open(d / "wd_t" / rel))


def test_corrected_store_identical(runs):
    d, _, ref, got = runs
    a, b = ref["cns"], got["cns"]
    assert len(b) > 0
    assert a.names == b.names
    assert np.array_equal(a.length, b.length)
    assert np.array_equal(a.words, b.words)
    assert open(d / "wd_j" / "03.seed_cns" / "cns.fasta").read() == \
        open(d / "wd_t" / "03.seed_cns" / "cns.fasta").read()


def test_done_markers_and_resume(runs, monkeypatch):
    d, tcfg, _, got = runs
    for st in ("00.db", "01.raw_align", "02.sort_align", "03.seed_cns"):
        assert os.path.exists(d / "wd_t" / st / ".done")
    # a finished run resumes from its markers: no stage body runs again
    def boom(*a, **k):
        raise AssertionError("stage re-ran despite its .done marker")
    for name in ("build_index", "find_overlaps", "sort_filter_overlaps",
                 "run_correction"):
        monkeypatch.setattr(trun_mod, name, boom)
    again = trun(tload(tcfg), device="cpu")
    assert again["cns"].names == got["cns"].names
    # dropping stage 03's marker and store redoes that stage only
    monkeypatch.undo()
    os.unlink(d / "wd_t" / "03.seed_cns" / ".done")
    os.unlink(d / "wd_t" / "03.seed_cns" / "cns.npz")
    for name in ("build_index", "find_overlaps", "sort_filter_overlaps"):
        monkeypatch.setattr(trun_mod, name, boom)
    redo = trun(tload(tcfg), device="cpu")
    assert np.array_equal(redo["cns"].words, got["cns"].words)


@pytest.mark.parametrize("task,extra,what", [
    ("all", "use_mesh = 2", "hifi"),
    ("assemble", "use_mesh = 4", "hifi"),
    ("correct", "use_mesh = 8", "hifi"),
])
def test_unported_configurations_raise(tmp_path, task, extra, what):
    """Raw HiFi reads on the mesh path are refused before any work: the
    reference's mesh raw_align sketches at raw_k = 51, which its sketch
    cannot pack (k <= 31)."""
    (tmp_path / "input.fofn").write_text("reads.fa\n")
    cfg = tload(write_correct_cfg(tmp_path, "x", GLEN, "wd_x", task=task,
                                  extra=extra, read_type=what))
    with pytest.raises(NotImplementedError,
                       match="use_mesh > 1 with read_type = hifi") as ei:
        trun(cfg, device="cpu")
    assert "k <= 31" in str(ei.value)
    assert not os.path.exists(tmp_path / "wd_x" / "00.db")
    # corrected HiFi reads skip stage 01 and are admitted
    cfg.input_type = "corrected"
    assert trun_mod.check_ported(cfg) is None


def test_hifi_and_corrected_input_raise(tmp_path):
    """read_type = hifi, corrected input and multi-host runs are admitted:
    a second host gets past the check and waits for host 0's stage 00."""
    (tmp_path / "input.fofn").write_text("reads.fa\n")
    cfg = tload(write_correct_cfg(tmp_path, "h", GLEN, "wd_h",
                                  read_type="hifi"))
    assert cfg.read_type == "hifi" and cfg.read_type_code == 3
    for task in ("all", "correct", "assemble"):
        cfg.task = task
        assert trun_mod.check_ported(cfg) is None
    assert not os.path.exists(tmp_path / "wd_h")
    # corrected input is admitted (stages 01-03 are skipped)
    cfg.read_type, cfg.input_type, cfg.task = "ont", "corrected", "assemble"
    assert trun_mod.check_ported(cfg) is None
    # a multi-host run is admitted
    assert trun_mod.check_ported(cfg, n_hosts=2) is None
    from nextdenovo_tpu_torch.parallel.launcher import HostContext
    hs = HostContext(2, 1, cfg.workdir, poll_s=0.01, timeout_s=0.05)
    with pytest.raises(TimeoutError, match="host 1: timed out on stage 00.db"):
        trun(cfg, device="cpu", hosts=hs)
    assert os.path.isdir(tmp_path / "wd_h" / ".sync")
    assert not os.path.exists(tmp_path / "wd_h" / "00.db" / "reads.npz")


@pytest.mark.parametrize("use_mesh,n_hosts", [(1, 1), (8, 1), (4, 2)])
def test_use_mesh_admitted(runs, tmp_path, monkeypatch, use_mesh, n_hosts):
    """use_mesh = 8 on one host takes the mesh path (stage 01 reaches
    mesh_raw_align, not the single-device engine); use_mesh = 1, and any
    use_mesh in a multi-host run, take the single-device path, as in the
    reference; use_mesh = 1 runs (here from the finished run's markers) to
    the same corrected reads."""
    from nextdenovo_tpu_torch.parallel import dist_pipeline
    _, tcfg, _, got = runs
    cfg = tload(tcfg)
    cfg.use_mesh = use_mesh
    assert trun_mod.check_ported(cfg, n_hosts=n_hosts) is None
    assert trun_mod.mesh_shards(cfg, n_hosts) == \
        (use_mesh if use_mesh > 1 and n_hosts == 1 else 0)
    if use_mesh == 1:
        again = trun(cfg, device="cpu")
        assert np.array_equal(again["cns"].words, got["cns"].words)
    elif n_hosts == 1:
        class Taken(Exception):
            pass

        def taken(*a, **k):
            raise Taken(k.get("k"))

        def boom(*a, **k):
            raise AssertionError("the single-device engine ran")
        monkeypatch.setattr(dist_pipeline, "mesh_raw_align", taken)
        for name in ("build_index", "find_overlaps"):
            monkeypatch.setattr(trun_mod, name, boom)
        cfg.workdir, cfg.rerun = str(tmp_path / "wd_mesh"), 0
        with pytest.raises(Taken):
            trun(cfg, device="cpu")
        assert os.path.exists(tmp_path / "wd_mesh" / "00.db" / ".done")


@pytest.mark.parametrize("read_type", ["clr", "hifi", "ccs"])
def test_load_config_derived_fields_equal(tmp_path, read_type):
    """The same config file gives the same read-type code and the same
    db_stat-time derivations (raw_k, raw_w, max_lq_length, seed_cutoff) in
    both packages."""
    (tmp_path / "input.fofn").write_text("reads.fa\n")
    p = write_correct_cfg(tmp_path, read_type, GLEN, "wd",
                          read_type=read_type)
    text = open(p).read().replace("seed_cutoff = 1500\n", "")
    open(p, "w").write(text)
    lens = np.random.default_rng(3).integers(500, 9000, 400)
    got = []
    for cfg in (jload(p), tload(p)):
        cfg.derive(int(lens.sum()), lens)
        got.append((cfg.read_type, cfg.read_type_code, cfg.raw_k, cfg.raw_w,
                    cfg.max_lq_length, cfg.seed_cutoff, cfg.sort_max_depth,
                    cfg.min_len_seed))
    assert got[0] == got[1]
    code = {"clr": 2, "hifi": 3, "ccs": 3}[read_type]
    assert got[1][1] == code and got[1][4] == 1000 and got[1][5] > 0
    assert got[1][2:4] == ((51, 51) if code == 3 else (15, 5))


def test_cli_routes(tmp_path, capsys):
    from nextdenovo_tpu_torch.__main__ import main
    assert main([]) == 0
    # the host sub-commands are admitted (tests/test_torch_cli.py holds
    # them against the JAX package's CLI)
    (tmp_path / "reads.fa").write_text(">r0\nACGTACGTAC\n")
    (tmp_path / "seq.fofn").write_text(str(tmp_path / "reads.fa") + "\n")
    assert main(["seq_stat", "-f", str(tmp_path / "seq.fofn"),
                 "-c", "1"]) == 0
    assert "clean reads: 1  bases: 10" in capsys.readouterr().out
    (tmp_path / "input.fofn").write_text("reads.fa\n")
    # task = all is admitted; what is still refused is refused through
    # every spelling of the command, before any work
    assert trun_mod.check_ported(tload(write_correct_cfg(
        tmp_path, "a", GLEN, "wd_a", task="all"))) is None
    cfgp = write_correct_cfg(tmp_path, "c", GLEN, "wd_c", task="all",
                             extra="use_mesh = 4", read_type="hifi")
    refused = "use_mesh > 1 with read_type = hifi"
    with pytest.raises(NotImplementedError, match=refused):
        main(["run", cfgp, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match=refused):
        main([cfgp, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match=refused):
        main(["launch", cfgp, "--device", "cpu"])
    assert not os.path.exists(tmp_path / "wd_c")
