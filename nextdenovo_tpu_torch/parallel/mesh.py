"""Shards of the mesh path over one or several devices (PyTorch/CUDA port
of nextdenovo_tpu/parallel/mesh.py).

The JAX package runs `use_mesh = n` as SPMD programs over an n-device mesh:
read rows are data-parallel across devices, the minimizer index is sharded
by hash range, and records move between devices with all_to_all.  The port
spreads the same n shards over k <= n devices, the mesh's "cards": shard s
lives on devices[s * k // n], contiguous blocks of shards, the layout that
NamedSharding(P(AXIS)) gives.  Each card's shards run on a host thread of
their own (`Mesh.for_each_card`), so the cards work at once as the JAX
package's SPMD programs do, and the collectives are the joins between
those phases:

  * all_to_all hands destination d, for each source in order, the bucket
    that source made for d, copied to d's card (`all_to_all`);
  * psum is a sum over shards on the host (`psum`).

A device may be named more than once (`[cpu, cpu]`, `[cuda:0, cuda:0]`):
the shards then form groups, each on its own thread, on one device.

Buckets hold compacted rows: `bucketize` hands destination d, for each
source in order, the first `cap` selected rows (the rows the reference's
`jnp.nonzero(size=cap)` keeps) and counts the rest as drops, so no array of
the reference's padded caps is built.  Results equal the JAX package's,
shard for shard, on any number of cards.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import logging
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils import span

AXIS = "shard"

log = logging.getLogger("nextdenovo_tpu_torch")


@dataclass(frozen=True)
class Mesh:
    """n_shards shards over `devices`, k <= n_shards torch devices (repeats
    allowed): shard s lives on devices[s * k // n_shards]."""
    n_shards: int
    devices: Tuple[torch.device, ...]

    @property
    def device(self) -> torch.device:
        """devices[0], for the work that the JAX package also runs on one
        device, outside its shard_map programs: the minimizer index's build,
        cns_align's extend_overlap_ends (dist_pipeline.mesh_cns_align) and
        run_polish's own work (dist_polish.distributed_polish)."""
        return self.devices[0]

    def card_of(self, s: int) -> int:
        """The index in `devices` of shard s's card."""
        return s * len(self.devices) // self.n_shards

    def device_of(self, s: int) -> torch.device:
        return self.devices[self.card_of(s)]

    def shards_of(self, card: int) -> range:
        """The shards of devices[card]: s with s * k // n == card."""
        k, n = len(self.devices), self.n_shards
        return range(-(-card * n // k), -(-(card + 1) * n // k))

    def for_each_card(self, name: str, fn: Callable) -> list:
        """fn(device, shards) for every card, each card on a host thread of
        its own inside torch.cuda.device(card) (one card: inline, no
        thread); fn returns one result per shard of `shards`.  Returns the
        results of all shards in shard order, whatever order the threads
        end in.  Once every thread has ended, the first card's exception,
        if any, is raised here.  Spans: `name` around the whole, and
        `name/card` around each card's part."""
        k = len(self.devices)

        def run(card):
            dev, shards = self.devices[card], self.shards_of(card)
            with span(name + "/card", card=f"{card}:{dev}",
                      shards=len(shards)), _on(dev):
                out = list(fn(dev, shards))
            if len(out) != len(shards):
                raise RuntimeError(f"{name}: card {card} returned "
                                   f"{len(out)} results for {len(shards)} "
                                   f"shards")
            return out

        with span(name, shards=self.n_shards, cards=k):
            if k == 1:
                return run(0)
            with cf.ThreadPoolExecutor(k, thread_name_prefix="mesh-card") \
                    as ex:
                futs = [ex.submit(run, card) for card in range(k)]
                cf.wait(futs)
            bad = [(c, f.exception()) for c, f in enumerate(futs)
                   if f.exception() is not None]
            for c, e in bad[1:]:
                log.error("%s: card %d failed too: %r", name, c, e)
            if bad:
                raise bad[0][1]
            return [r for f in futs for r in f.result()]


def _on(dev: torch.device):
    """The card's context: a CUDA thread's allocations and launches go to
    its current device."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def make_mesh(n_devices: int, device=None, devices=None) -> Mesh:
    """A mesh of n_devices shards.  devices: the cards, taken as given
    (repeats make groups on one device).  Else an explicit `device` ("cpu",
    "cuda:1") holds every shard.  Else (device=None) the GPU: the visible
    cards cuda:0 .. cuda:min(n, device_count()) - 1; raises without CUDA."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
        if not 1 <= len(devs) <= n:
            raise ValueError(f"a mesh of {n} shards takes 1 to {n} devices, "
                             f"got {len(devs)}")
    elif device is not None:
        devs = (resolve_device(device),)
    else:
        resolve_device(None)
        devs = tuple(torch.device("cuda", i)
                     for i in range(min(n, torch.cuda.device_count())))
    mesh = Mesh(n, devs)
    blocks = [mesh.shards_of(c) for c in range(len(devs))]
    log.info("mesh: %d shards on %d card(s): %s", n, len(devs), "; ".join(
        f"shards {r.start}-{r.stop - 1} on {d}" for r, d in zip(blocks, devs)))
    return mesh


def _tensor(arr) -> torch.Tensor:
    if torch.is_tensor(arr):
        return arr
    a = np.asarray(arr)
    if a.dtype == np.uint32:    # torch has no general uint32: hashes -> int64
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a))


def shard_rows(mesh: Mesh, arr, dtype=None) -> List[torch.Tensor]:
    """The leading axis as (n_shards, rows): entry s is shard s's block,
    rows [s * rows, (s + 1) * rows), on its card.  Each card is sent its
    own shards' rows only, in one copy; `dtype` converts there."""
    t = _tensor(arr)
    t = t.reshape(mesh.n_shards, -1, *t.shape[1:])
    out = []
    for card, dev in enumerate(mesh.devices):
        r = mesh.shards_of(card)
        blk = t[r.start:r.stop].to(dev)
        out.extend((blk if dtype is None else blk.to(dtype)).unbind(0))
    return out


def replicate(mesh: Mesh, arr) -> Dict[torch.device, torch.Tensor]:
    """One copy on each card, keyed by its device."""
    t = _tensor(arr)
    return {dev: t.to(dev) for dev in dict.fromkeys(mesh.devices)}


def all_to_all(mesh: Mesh, buckets: Sequence[Sequence]) -> List[List]:
    """buckets[src][dst], a tuple of tensors on src's card ->
    received[dst][src], each tensor copied to dst's card.  Tensor.to between
    two cards queues the copy on the source's current stream after a
    barrier with the destination's, and makes the destination's stream wait
    for it; the caching allocator ties the bucket's memory to that same
    source stream, so the source may free a bucket while its copy is in
    flight, and no host sync is needed."""
    n = mesh.n_shards
    return [[tuple(f.to(mesh.device_of(d)) for f in buckets[s][d])
             for s in range(n)] for d in range(n)]


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
