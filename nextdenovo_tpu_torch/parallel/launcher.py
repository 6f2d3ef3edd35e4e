"""Multi-host pipeline launcher (shared-filesystem SPMD), PyTorch/CUDA port
of nextdenovo_tpu/parallel/launcher.py.

The reference scales out by tiling stages into shell-script jobs that
Paralleltask submits to cluster nodes, with all dataflow through a shared
filesystem (nextDenovo:426-467).  Here N identical host processes run THIS
pipeline: every host executes the same `run_pipeline`, the embarrassingly
parallel stages (raw_align overlap queries, seed_cns correction jobs,
cns_align candidates and realignment, ctg_align read mapping, ctg_cns
contigs) are round-robin sharded by host id, and the sequential stages
(db, sort, graph) run on host 0 while the others wait on the stage's
durable `.done` marker.  Synchronization is by barrier files under
`<workdir>/.sync/`, with the same crash-safe, resumable semantics as the
stages' `.done` markers.  Each host drives the CUDA device its process
sees (or the CPU with --device cpu); several hosts may share one card.

No collective operation is used, so no process group is formed: the JAX
package's `init_distributed` / `--coordinator` (which wire
`jax.distributed` for a TPU pod) have no counterpart here, and
`--coordinator` is rejected.  Launch:

    python -m nextdenovo_tpu_torch launch run.cfg --hosts N --host-id K \
        [--device cpu]
    python -m nextdenovo_tpu_torch launch run.cfg --hosts N \
        --submit local|slurm|sge|pbs|lsf [--dry-run] [--device cpu]

or programmatically: run_pipeline(cfg, hosts=HostContext(N, K, workdir)).
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np

log = logging.getLogger("nextdenovo_tpu_torch")


class HostContext:
    """Identity + synchronization for one host of an N-host run."""

    def __init__(self, n_hosts: int, host_id: int, workdir: str,
                 poll_s: float = 0.25, timeout_s: float = 24 * 3600):
        assert 0 <= host_id < n_hosts
        self.n_hosts = int(n_hosts)
        self.host_id = int(host_id)
        self.workdir = workdir
        self.poll_s = poll_s
        self.timeout_s = timeout_s
        self.sync_dir = os.path.join(workdir, ".sync")
        os.makedirs(self.sync_dir, exist_ok=True)

    # -- identity ---------------------------------------------------------
    def is_main(self) -> bool:
        return self.host_id == 0

    def shard(self, n: int) -> np.ndarray:
        """Round-robin indices owned by this host (deterministic)."""
        return np.arange(self.host_id, int(n), self.n_hosts)

    def tag(self, name: str) -> str:
        return f"{name}.h{self.host_id}"

    # -- synchronization --------------------------------------------------
    def barrier(self, name: str) -> None:
        """All hosts write `<name>.h<K>` then wait for all N files."""
        open(os.path.join(self.sync_dir, self.tag(name)), "w").close()
        want = [os.path.join(self.sync_dir, f"{name}.h{k}")
                for k in range(self.n_hosts)]
        self._poll(lambda: all(os.path.exists(p) for p in want),
                   f"barrier {name}")

    def wait_done(self, stage) -> None:
        """Wait until another host marks the stage's `.done`."""
        self._poll(stage.done, f"stage {os.path.basename(stage.dir)}")

    def _poll(self, pred, what: str) -> None:
        t0 = time.time()
        warned = 0.0
        while not pred():
            dt = time.time() - t0
            if dt > self.timeout_s:
                raise TimeoutError(f"host {self.host_id}: timed out on {what}")
            if dt - warned > 60:
                log.info("host %d: waiting on %s (%.0fs)",
                         self.host_id, what, dt)
                warned = dt
            time.sleep(self.poll_s)


class SingleHost(HostContext):
    """Degenerate 1-host context: shard = identity, sync = no-op."""

    def __init__(self):
        self.n_hosts, self.host_id = 1, 0
        self.poll_s = self.timeout_s = 0

    def shard(self, n: int) -> np.ndarray:
        return np.arange(int(n))

    def barrier(self, name: str) -> None:
        pass

    def wait_done(self, stage) -> None:
        raise RuntimeError("single-host wait_done should be unreachable")


# batch-queue submission commands (the reference delegates these to
# Paralleltask's submit templates, doc/OPTION.rst:107-121); {script} is the
# generated per-host job script, {name}/{log} its job name / log path.
SUBMIT_CMDS = {
    "slurm": "sbatch -J {name} -o {log} {opts} {script}",
    "sge": "qsub -N {name} -o {log} -j y {opts} {script}",
    "pbs": "qsub -N {name} -o {log} {opts} {script}",
    "lsf": "bsub -J {name} -o {log} {opts} < {script}",
}


def _run_local(scripts) -> int:
    """Run every host's job script here, each in its own process group.
    When one host fails the others are stopped: they would otherwise wait
    on its barrier files until their timeout."""
    import signal
    import subprocess

    procs = [subprocess.Popen(["/bin/sh", sp], start_new_session=True)
             for sp in scripts]
    try:
        while True:
            rcs = [p.poll() for p in procs]
            failed = [rc for rc in rcs if rc not in (None, 0)]
            if failed:
                log.error("a host exited with %d: stopping the others",
                          failed[0])
                return failed[0]
            if all(rc == 0 for rc in rcs):
                return 0
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
            p.wait()


def submit_hosts(cfg_path: str, n_hosts: int, scheduler: str,
                 submit_opts: str = "", dry_run: bool = False,
                 device: str | None = None) -> int:
    """Generate one job script per host and submit the N-host run to a
    batch queue (or run all hosts here with scheduler='local').

    This is the thin boundary to cluster schedulers: each job is a full
    host process of the shared-filesystem launcher; scheduling, placement
    and restarts belong to the queue, resumability to the pipeline's
    durable stage markers.  device, when given, is passed on to each host
    (`--device`).
    """
    import shlex
    import subprocess
    import sys

    from ..pipeline.config import load_config

    cfg = load_config(cfg_path)
    jobdir = os.path.join(cfg.workdir, ".jobs")
    os.makedirs(jobdir, exist_ok=True)
    cfg_abs = os.path.abspath(cfg_path)
    scripts = []
    for k in range(n_hosts):
        cmd = (f"{sys.executable} -m nextdenovo_tpu_torch.parallel.launcher "
               f"{shlex.quote(cfg_abs)} --hosts {n_hosts} --host-id {k}")
        if device:
            cmd += f" --device {shlex.quote(str(device))}"
        sp = os.path.join(jobdir, f"host_{k}.sh")
        with open(sp, "w") as fh:
            fh.write("#!/bin/sh\nset -e\n"
                     f"cd {shlex.quote(os.getcwd())}\n{cmd}\n")
        os.chmod(sp, 0o755)
        scripts.append(sp)
    if scheduler == "local":
        return _run_local(scripts)
    if scheduler not in SUBMIT_CMDS:
        raise ValueError(f"unknown scheduler {scheduler!r} "
                         f"(known: local {' '.join(SUBMIT_CMDS)})")
    for k, sp in enumerate(scripts):
        sub = SUBMIT_CMDS[scheduler].format(
            script=shlex.quote(sp), name=f"ndtpu_h{k}",
            log=shlex.quote(os.path.join(jobdir, f"host_{k}.log")),
            opts=submit_opts)
        if dry_run:
            print(sub)
            continue
        subprocess.run(sub, shell=True, check=True)
    return 0


def main(argv=None) -> int:
    import argparse

    from ..pipeline.config import load_config
    from ..pipeline.run import run_pipeline

    p = argparse.ArgumentParser(
        prog="python -m nextdenovo_tpu_torch launch",
        description="multi-host shared-filesystem pipeline launcher")
    p.add_argument("cfg")
    p.add_argument("--hosts", type=int, default=1)
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device of every host; default: the GPU "
                        "(cuda). 'cpu' runs the plain PyTorch versions of "
                        "the kernels")
    p.add_argument("--submit", default=None,
                   help="submit all N hosts via a batch queue instead of "
                        "running one host: local|slurm|sge|pbs|lsf")
    p.add_argument("--submit-opts", default="",
                   help="extra scheduler options (quoted)")
    p.add_argument("--dry-run", action="store_true",
                   help="with --submit: print submission commands only")
    a = p.parse_args(argv)
    if a.submit:
        return submit_hosts(a.cfg, a.hosts, a.submit, a.submit_opts,
                            a.dry_run, a.device)
    cfg = load_config(a.cfg)
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s h{a.host_id} %(levelname)s %(message)s")
    hosts = (HostContext(a.hosts, a.host_id, cfg.workdir)
             if a.hosts > 1 else None)
    run_pipeline(cfg, device=a.device, hosts=hosts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
