"""Segmented-array utilities (PyTorch).

Counterpart of nextdenovo_tpu/ops/segment.py: arrays sorted by a segment
key, with per-segment reductions broadcast back to every element.  Each
reduction runs on segment ids (`cumsum(starts) - 1`): one `index_add_` or
`scatter_reduce` over the segments, then a gather back, a handful of tensor
ops whatever the length.  The overlap engine's plain versions use them
(the CPU path; on the card the engine runs its kernels instead).
"""
from __future__ import annotations

import torch


def segment_starts(keys: torch.Tensor) -> torch.Tensor:
    """Bool mask: True where a new segment begins (keys must be sorted)."""
    first = torch.ones((min(1, keys.shape[0]),), dtype=torch.bool,
                       device=keys.device)
    return torch.cat([first, keys[1:] != keys[:-1]])


def segment_ids(starts: torch.Tensor):
    """(segment id of each element, number of segments)."""
    sid = torch.cumsum(starts.to(torch.int64), 0) - 1
    return sid, (int(sid[-1]) + 1 if sid.shape[0] else 0)


def _reduce(values, starts, op):
    sid, n = segment_ids(starts)
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    if op == "sum":
        out.index_add_(0, sid, values)
    else:
        out.scatter_reduce_(0, sid, values, op, include_self=False)
    return out[sid]


def segment_sum(values, starts):
    return _reduce(values, starts, "sum")


def segment_max(values, starts):
    return _reduce(values, starts, "amax")


def segment_min(values, starts):
    return _reduce(values, starts, "amin")


def segment_broadcast_last(values, starts):
    """Give every element its segment's LAST value."""
    n = values.shape[0]
    idx = torch.arange(n, device=values.device)
    return values[_reduce(idx, starts, "amax")]


def segment_argmax(scores, payload, starts):
    """Per segment, the payload of the max-score element (first on ties),
    broadcast to every element of the segment: the max of the scores,
    then the least index among the elements that reach it."""
    best = segment_max(scores, starts)
    n = scores.shape[0]
    idx = torch.arange(n, device=scores.device)
    first = segment_min(torch.where(scores == best, idx, n), starts)
    return best, payload[first]
