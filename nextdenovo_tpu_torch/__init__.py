"""nextdenovo_tpu_torch — the PyTorch/CUDA port of nextdenovo_tpu.

Same sub-packages and module names as the JAX package, so every function
has its counterpart at the same place (ops/myers.py, ops/align.py,
overlap/engine.py, ...).  It imports torch and numpy, never jax, and
nothing from nextdenovo_tpu.  Entry points take an explicit `device`
argument: None means the GPU (and raises without one); "cpu" runs the
plain PyTorch versions of the hand-written CUDA kernels.

Ported so far: task = all | correct | assemble — read correction (stages
00.db, 01.raw_align, 02.sort_align, 03.seed_cns) and assembly (04.cns_align,
05.ctg_graph, 06.ctg_cns) — for ont/clr/hifi reads, on one device or as
several host processes sharing a workdir (parallel/launcher.py, the
`launch` sub-command); the mesh path of use_mesh > 1, its shards on one
device (parallel/mesh.py, parallel/dist_*.py); the host sub-commands
seq_stat, seq_bit, ovl_cvt and stat; and every kernel of the JAX package
(ops/myers.py, ops/align.py, ops/extend.py).
"""

__version__ = "0.1.0"
