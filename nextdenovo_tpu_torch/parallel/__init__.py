"""Scale-out of the PyTorch/CUDA port: the multi-host launcher
(`launcher.py`) and the mesh path of `use_mesh > 1` (`mesh.py` and the
`dist_*.py` modules), whose n shards run over the visible cards."""
