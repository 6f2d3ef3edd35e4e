"""Shards of the mesh path on one device (PyTorch/CUDA port of
nextdenovo_tpu/parallel/mesh.py).

The JAX package runs `use_mesh = n` as SPMD programs over an n-device mesh:
read rows are data-parallel across devices, the minimizer index is sharded
by hash range, and records move between devices with all_to_all.  The port
runs the same n shards on ONE device.  A shard is a block of rows; every
block lives on the mesh's device, and each collective becomes its
one-device equivalent:

  * all_to_all over a stack of per-source buckets (n_src, n_dst, ...) is a
    swap of its first two axes (`all_to_all`);
  * psum is a sum over shards (`psum`).

Buckets hold compacted rows: `bucketize` hands destination d, for each
source in order, the first `cap` selected rows (the rows the reference's
`jnp.nonzero(size=cap)` keeps) and counts the rest as drops, so no array of
the reference's padded caps is built.  Results equal the JAX package's,
shard for shard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ..device import resolve_device

AXIS = "shard"


@dataclass(frozen=True)
class Mesh:
    """n_shards shards, all on one torch device."""
    n_shards: int
    device: torch.device


def make_mesh(n_devices: int, device=None) -> Mesh:
    """A mesh of n_devices shards on `device` (None = the GPU)."""
    if int(n_devices) < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    return Mesh(int(n_devices), resolve_device(device))


def _tensor(arr) -> torch.Tensor:
    if torch.is_tensor(arr):
        return arr
    a = np.asarray(arr)
    if a.dtype == np.uint32:    # torch has no general uint32: hashes -> int64
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a))


def shard_rows(mesh: Mesh, arr) -> torch.Tensor:
    """Move to the mesh's device and view the leading axis as
    (n_shards, rows): shard s owns rows [s * rows, (s + 1) * rows)."""
    t = _tensor(arr).to(mesh.device)
    return t.reshape(mesh.n_shards, -1, *t.shape[1:])


def replicate(mesh: Mesh, arr) -> torch.Tensor:
    """One copy that every shard reads."""
    return _tensor(arr).to(mesh.device)


def all_to_all(buckets: Sequence[Sequence]) -> List[List]:
    """buckets[src][dst] -> received[dst][src]: the one-device all_to_all."""
    return [list(col) for col in zip(*buckets)]


def psum(values) -> int:
    """Sum of a per-shard count over the shards."""
    return int(sum(int(v) for v in values))


def bucketize(fields, dest: torch.Tensor, valid: torch.Tensor,
              n_shards: int, cap: int):
    """Route rows to destinations: bucket d holds, in row order, the first
    `cap` rows with valid & (dest == d), one tensor per field.  Returns
    (buckets, dropped-row count): rows beyond a bucket's cap are counted,
    never silently lost."""
    out, n_drop = [], 0
    for d in range(n_shards):
        idx = torch.nonzero(valid & (dest == d))[:, 0]
        n_drop += max(int(idx.shape[0]) - cap, 0)
        idx = idx[:cap]
        out.append(tuple(f[idx] for f in fields))
    return out, n_drop


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def partition_index(idx, n_shards: int, min_rows: int = 64):
    """Hash-range partition of a hash-sorted minimizer index into per-shard
    row blocks (shard d owns hashes with top bits == d, the ownership rule
    of distributed_overlap_step's minimizer routing).

    Returns (ih, irid, ipos, istr) as flattened (n_shards * H,) arrays
    where H pads every shard to the largest shard's entry count.
    """
    h = _np(idx.h)
    shift_bits = 32 - max(1, (n_shards - 1).bit_length()) if n_shards > 1 \
        else 32
    owner = (h >> shift_bits) % n_shards if n_shards > 1 \
        else np.zeros(len(h), np.int64)
    H = max(int(np.bincount(owner, minlength=n_shards).max()), min_rows)
    ih = np.full((n_shards, H), 0xFFFFFFFF, np.uint32)
    irid = np.full((n_shards, H), -1, np.int32)
    ipos = np.zeros((n_shards, H), np.int32)
    istr = np.zeros((n_shards, H), np.int32)
    pos_u, str_u = idx.unpack()
    rid = _np(idx.rid)
    for d in range(n_shards):
        sel = np.nonzero(owner == d)[0]      # hash-sorted -> contiguous
        ih[d, : len(sel)] = h[sel]
        irid[d, : len(sel)] = rid[sel]
        ipos[d, : len(sel)] = pos_u[sel]
        istr[d, : len(sel)] = str_u[sel]
    return (ih.reshape(-1), irid.reshape(-1), ipos.reshape(-1),
            istr.reshape(-1))
