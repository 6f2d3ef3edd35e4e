#!/usr/bin/env python3
"""Where the device time of the port's main path goes.

Runs chip_smoke.py's main path (task = all, stages 00-06, through the CLI
entry on a simulated genome) under torch.profiler and prints the device-busy share of
the wall time and the device time summed by kernel name.  Needs one CUDA
device; the profiler slows the host side, so read shares, not walls.

    python3 chip_profile.py [genome_size]      (default 300000)
"""
from __future__ import annotations

import json
import shutil
import sys
import tempfile
import time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    genome_size = int(sys.argv[1]) if len(sys.argv) > 1 else 300_000
    dev = torch.device("cuda")
    card = chip_smoke.phase_env()
    chip_smoke.phase_build()
    workdir = tempfile.mkdtemp(prefix="chip_profile_")
    try:
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            chip_smoke.phase_main_path(dev, genome_size, workdir)
            torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"[profile] genome {genome_size} bp, profiled wall {wall:.1f}s "
          f"(simulation, run and checks), device kernel time "
          f"{busy_ms / 1e3:.2f}s, {sum(r[2] for r in rows)} kernel launches")
    for name, ms, cnt in rows[:25]:
        print(f"[profile] {ms:10.1f} ms {cnt:8d} x  {name[:90]}")
    print(json.dumps({"profile": {
        "genome_size": genome_size, "wall_s": wall,
        "device_kernel_s": busy_ms / 1e3,
        "device_busy_share": busy_ms / 1e3 / wall,
        "top": [dict(name=n[:90], ms=ms, count=c) for n, ms, c in rows[:25]]}}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
