"""Scale-out of the PyTorch/CUDA port: the multi-host launcher
(`launcher.py`).  The multi-device stages of the JAX package (`use_mesh > 1`:
mesh.py and the dist_*.py modules) are not ported yet."""
