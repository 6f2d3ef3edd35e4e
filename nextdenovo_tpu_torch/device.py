"""Device selection shared by every entry point of the package.

`device=None` means the GPU: it resolves to `torch.device("cuda")` and
raises when no CUDA device is present.  Only an explicit `"cpu"` runs the
plain PyTorch versions of the kernels — there is no silent CPU detour.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nextdenovo_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch versions on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def check_tensor(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless `t` is what a kernel takes: contiguous, of this shape
    and dtype, on this device."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def row_pitch(name: str, t: torch.Tensor, shape, dtype, device) -> int:
    """Elements between two rows of `t`'s last dimension, for a kernel that
    moves rows 16 bytes a piece.  Admits the narrow view `buf[..., :shape[-1]]`
    of a contiguous tensor whose last dimension was padded, as a kernel's
    wrapper allocates it, and a contiguous tensor (pitch = shape[-1]); either
    way every row must start on a 16-byte boundary."""
    shape = tuple(shape)
    ok = (t.device == device and t.dtype == dtype and tuple(t.shape) == shape
          and t.dim() >= 2)
    pitch = t.stride(-2) if ok else 0
    if ok and shape[-1] > 1:
        ok = t.stride(-1) == 1
    want, acc = [], 1
    for d in reversed(shape[:-1]):
        want.append(pitch * acc)
        acc *= d
    aligned = ok and (pitch * t.element_size() % 16 == 0
                      and t.data_ptr() % 16 == 0)
    if not aligned or pitch < shape[-1] or list(t.stride()[:-1]) != want[::-1]:
        raise ValueError(
            f"{name}: expected {dtype} {shape} on {device}, contiguous or "
            f"with a padded last dimension, rows 16-byte aligned, got "
            f"{t.dtype} {tuple(t.shape)} strides {tuple(t.stride())} on "
            f"{t.device}")
    return pitch
