"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128, 256)


def require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def same_device_contiguous(what: str, **tensors) -> torch.device:
    """All tensors on one device and contiguous; returns that device."""
    dev = None
    for name, t in tensors.items():
        require(t.is_contiguous(), what, f"{name} must be contiguous")
        require(dev is None or t.device == dev, what,
                f"{name} is on {t.device}, expected {dev}")
        dev = t.device
    require(dev.type in ("cpu", "cuda"), what,
            f"tensors on {dev.type} are not supported")
    return dev
