"""CLI of the PyTorch/CUDA port: ``python -m nextdenovo_tpu_torch ...``.

  run <run.cfg> [--device cpu]    pipeline driver (task = all | correct |
                                  assemble, stages 00-06)
  <run.cfg> [--device cpu]        the same, `run` may be left out

Runs on the GPU unless `--device cpu` is given.  The other sub-commands of
the JAX package's CLI (launch, seq_stat, seq_bit, ovl_cvt, stat) are not
ported yet.
"""
from __future__ import annotations

import sys

NOT_PORTED = ("launch", "seq_stat", "seq_bit", "ovl_cvt", "stat")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    if argv[0] in NOT_PORTED:
        raise NotImplementedError(
            f"not ported yet: the `{argv[0]}` sub-command")
    rest = argv[1:] if argv[0] == "run" else argv
    if not rest:
        print("usage: python -m nextdenovo_tpu_torch run <run.cfg> "
              "[--device cpu]", file=sys.stderr)
        return 1
    from .pipeline.run import main as run_main
    return run_main(rest) or 0


if __name__ == "__main__":
    sys.exit(main())
