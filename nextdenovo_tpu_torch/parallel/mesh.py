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
the reference's padded caps is built.  On the card it is two kernels around
one host sync: route_count, whose totals the host reads, then
route_scatter, which writes each row straight into its bucket, allocated at
its kept size.  Results equal the JAX package's, shard for shard, on any
number of cards.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import ctypes
import logging
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..device import check_tensor, resolve_device
from ..utils import span

AXIS = "shard"
# what the routing kernels (csrc/route.cu) take: rows a tile (records a
# tile of the seed route), fields, destinations (their shared memory grows
# with it), rows
ROUTE_TILE = 2048
ROUTE_SEED_TILE = 512
ROUTE_MAX_FIELDS = 8
ROUTE_MAX_DEST = 8192
ROUTE_MAX_ROWS = 2**31 - 1

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


def bucketize_plain(fields, dest: torch.Tensor, valid, n_shards: int,
                    cap: int):
    """Plain version of bucketize (any device): one torch.nonzero a
    destination."""
    sel = torch.ones_like(dest, dtype=torch.bool) if valid is None else valid
    out = []
    counts = np.zeros(n_shards + 1, np.int64)
    for d in range(n_shards):
        idx = torch.nonzero(sel & (dest == d))[:, 0]
        counts[d] = idx.shape[0]
        idx = idx[:cap]
        out.append(tuple(f[idx] for f in fields))
    counts[n_shards] = int((sel & ((dest < 0) | (dest >= n_shards))).sum())
    return out, counts


def bucketize(fields, dest: torch.Tensor, valid, n_shards: int, cap: int):
    """Route rows to destinations: bucket d holds, in row order, the first
    `cap` rows with valid & (dest == d), one tensor per field (fields: up to
    8 (N,) int64 tensors; dest (N,) int64; valid (N,) bool, or None for
    every row).  Returns (buckets, counts): counts (n_shards + 1,) int64 on
    the host, counts[d] the valid rows bound for d before the cap (rows
    beyond it are counted, never silently lost), counts[n_shards] the valid
    rows bound outside [0, n_shards).

    CPU tensors run the plain version; CUDA tensors launch route_count,
    read its totals (one host sync), allocate each bucket at its kept size
    and launch route_scatter, which writes the rows into them (csrc/
    route.cu).  A bucket's fields are rows of one (F, kept) tensor."""
    if dest.device.type == "cpu":
        return bucketize_plain(fields, dest, valid, n_shards, cap)
    dev = dest.device
    N, F = dest.shape[0], len(fields)
    check_tensor("dest", dest, (N,), torch.int64, dev)
    for i, f in enumerate(fields):
        check_tensor(f"fields[{i}]", f, (N,), torch.int64, dev)
    if valid is not None:
        check_tensor("valid", valid, (N,), torch.bool, dev)
    if not 1 <= F <= ROUTE_MAX_FIELDS:
        raise ValueError(f"route_scatter: {F} fields (1..{ROUTE_MAX_FIELDS})")
    check_route(N, n_shards)
    if N == 0:
        empty = tuple(f[:0] for f in fields)
        return [empty] * n_shards, np.zeros(n_shards + 1, np.int64)
    return route_call(dev, bucket_launches(_build.kernels(), fields, dest,
                                           valid, n_shards, cap))


class RouteLaunches(NamedTuple):
    """A routing call's two launches on checked inputs: `count(scratch,
    ticket, stream)` launches `name`_count, `scatter(scratch, addresses,
    stream)` launches `name`_scatter; each returns the C entry's error
    code.  `rows` key rows in `tiles` tiles to n destinations, F fields a
    bucket."""
    name: str
    rows: int
    tiles: int
    n: int
    cap: int
    F: int
    count: Callable
    scatter: Callable


def bucket_launches(lib, fields, dest, valid, n_shards: int,
                    cap: int) -> RouteLaunches:
    """bucketize's launches of route_count and route_scatter from `lib`."""
    N, F = dest.shape[0], len(fields)
    ptrs = (ctypes.c_void_p * F)(*[f.data_ptr() for f in fields])
    return RouteLaunches(
        "route", N, -(-N // ROUTE_TILE), n_shards, cap, F,
        lambda sc, ticket, stream: lib.ndt_route_count(
            dest.data_ptr(), None if valid is None else valid.data_ptr(), N,
            n_shards, sc.keys, sc.blk, ticket, sc.counts.data_ptr(), stream),
        lambda sc, dst, stream: lib.ndt_route_scatter(
            ptrs, F, sc.keys, sc.blk, sc.counts.data_ptr(), N, n_shards,
            min(cap, N), dst, sc.table, stream))


def route_call(dev, rl: RouteLaunches):
    """A call of the routing kernels: the count, the host reads its totals
    (the call's one sync), each bucket is allocated at its kept size, and
    the scatter into them.  Returns (buckets, counts) as bucketize does."""
    with torch.cuda.device(dev):
        sc = route_scratch(dev, rl.rows, rl.tiles, rl.n)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check_launch(f"{rl.name}_count",
                            rl.count(sc, route_ticket(dev), stream))
        _build.count_launch(f"{rl.name}_count", dev)
        counts = sc.counts.cpu().numpy()
        out, dst = route_buckets(counts, rl.n, rl.cap, rl.F, dev)
        _build.check_launch(f"{rl.name}_scatter", rl.scatter(sc, dst, stream))
        _build.count_launch(f"{rl.name}_scatter", dev)
    return [b.unbind(0) for b in out], counts


def check_route(rows: int, n_shards: int) -> None:
    """Raise where the routing kernels do not take `rows` rows to
    `n_shards` destinations."""
    if not 1 <= n_shards <= ROUTE_MAX_DEST:
        raise ValueError(f"the routing kernels take 1..{ROUTE_MAX_DEST} "
                         f"destinations, not {n_shards}")
    if rows > ROUTE_MAX_ROWS:
        raise ValueError(f"the routing kernels take at most "
                         f"{ROUTE_MAX_ROWS} rows, not {rows}")


class RouteScratch(NamedTuple):
    """A routing call's device scratch: `buf` holds the tiles' counts
    (int32, at `blk`), the rows' 2-byte keys (at `keys`, 16-byte aligned) and
    the buckets' pointer table (at `table`, read past 64 destinations);
    `counts` (n + 1,) int64 receives the totals."""
    buf: torch.Tensor
    counts: torch.Tensor
    blk: int
    keys: int
    table: int


def route_scratch(dev, rows: int, tiles: int, n: int) -> RouteScratch:
    """The scratch of a routing call of `rows` key rows in `tiles` tiles to
    n destinations, in one allocation."""
    blk_words = -(-tiles * (n + 1) // 4) * 2    # int64 words, even
    key_words = -(-rows // 4)
    buf = torch.empty(blk_words + key_words + n, dtype=torch.int64,
                      device=dev)
    counts = torch.empty(n + 1, dtype=torch.int64, device=dev)
    p = buf.data_ptr()
    return RouteScratch(buf, counts, p, p + 8 * blk_words,
                        p + 8 * (blk_words + key_words))


_tickets: Dict[Tuple[int, int], torch.Tensor] = {}
_ticket_lock = threading.Lock()


def route_ticket(dev) -> int:
    """The address of the count kernels' ticket for dev's current stream:
    a word that is 0 between launches (the last block of a launch sets it
    back), one a stream, since the launches of one stream run one after
    the other.  Made (zeroed on that stream) at the stream's first call."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    t = _tickets.get(key)
    if t is None:
        with _ticket_lock:
            t = _tickets.setdefault(
                key, torch.zeros(4, dtype=torch.int32, device=dev))
    return t.data_ptr()


def route_buckets(counts: np.ndarray, n: int, cap: int, F: int, dev):
    """Each destination's bucket at its kept size, (F, min(counts[d], cap))
    int64, and the table of their addresses that route_scatter takes."""
    kept = np.minimum(counts[:n], cap)
    out = [torch.empty((F, int(k)), dtype=torch.int64, device=dev)
           for k in kept]
    return out, (ctypes.c_void_p * n)(*[o.data_ptr() for o in out])


def bucket_drops(counts: np.ndarray, cap: int) -> int:
    """The valid rows bucketize did not hand on: those past a bucket's cap
    and those bound outside the mesh."""
    return int(np.maximum(counts[:-1] - cap, 0).sum() + counts[-1])


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
