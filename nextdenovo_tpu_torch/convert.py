"""State carried across from the JAX package, given as numpy arrays.

There are no weights in this system; the state is data: the 2-bit read
store, the minimizer index, overlap-record blocks and the per-read
statistics of the cns-overlap filter.  These functions take
plain numpy arrays (never nextdenovo_tpu objects), so this module imports
nothing of the JAX package; a caller that holds the JAX package's objects
unpacks them with np.asarray first.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .io.seqstore import SeqStore
from .overlap.cns import CnsInfo
from .overlap.engine import MiniIndex
from .overlap.records import OvlBlock


def seqstore_from_arrays(words, offsets, lengths,
                         names: Optional[Sequence[str]] = None) -> SeqStore:
    """SeqStore from its packed word pool (uint32, 16 bases per word), the
    per-read word offsets and base lengths."""
    lengths = np.asarray(lengths, np.int64)
    return SeqStore(np.asarray(words, np.uint32),
                    np.asarray(offsets, np.int64), lengths,
                    list(names) if names is not None
                    else [str(i) for i in range(len(lengths))])


def index_from_arrays(h, rid, pos, n, lens, device=None) -> MiniIndex:
    """MiniIndex on `device` from the five fields of the JAX package's
    index: uint32 sorted hashes, int32 read ids, int32 pos|strand<<30, the
    valid-entry count and the read-length table.  The sentinel rows that
    pad the JAX table to a shape bucket (h = 0xFFFFFFFF, rid = -1) are
    kept as they are: lookups never match them."""
    dev = resolve_device(device)
    h = np.asarray(h).astype(np.uint32).astype(np.int64)
    return MiniIndex(torch.from_numpy(h).to(dev),
                     torch.from_numpy(np.array(rid, np.int32)).to(dev),
                     torch.from_numpy(np.array(pos, np.int32)).to(dev),
                     int(n),
                     torch.from_numpy(np.array(lens, np.int32)).to(dev))


def ovlblock_from_arrays(data: Dict[str, np.ndarray]) -> OvlBlock:
    """OvlBlock from a dict of equally long integer columns."""
    return OvlBlock({k: np.asarray(v, np.int32) for k, v in data.items()})


def cnsinfo_from_arrays(st, touched, alns, lens) -> CnsInfo:
    """CnsInfo from its four arrays (the contents of stage 04's
    cnsinfo.npz): per-read stats (n, 9) int32, touched (n,) bool, covered
    intervals (m, 3) int32 and read lengths (n,) int32."""
    return CnsInfo(st=np.asarray(st, np.int32),
                   touched=np.asarray(touched, bool),
                   alns=np.asarray(alns, np.int32).reshape(-1, 3),
                   lens=np.asarray(lens, np.int32))
