"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 96, 128, 256)
# (q/k, v) head dims of flash attention where they differ: MLA's prefill
SPLIT_HEAD_DIMS = ((192, 128),)


def require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def same_device_contiguous(what: str, **tensors) -> torch.device:
    """All tensors on one device and contiguous, and none that autograd
    would need a backward for; returns that device.

    No kernel has a backward, and a kernel's output is written through a
    raw pointer, so it carries no ``grad_fn``: under grad mode an input
    that requires grad would have its gradient dropped without a word.
    That raises here, on the CPU too (where the wrapper would run its
    differentiable plain version), so that no path relies on it."""
    if torch.is_grad_enabled():
        for name, t in tensors.items():
            if t.is_floating_point() and t.requires_grad:
                raise RuntimeError(
                    f"{what}: {name} requires grad, but the {what} kernel "
                    "has no backward; call it under torch.no_grad() or "
                    "torch.inference_mode(), or train through impl='plain'")
    dev = None
    for name, t in tensors.items():
        require(t.is_contiguous(), what, f"{name} must be contiguous")
        require(dev is None or t.device == dev, what,
                f"{name} is on {t.device}, expected {dev}")
        dev = t.device
    require(dev.type in ("cpu", "cuda"), what,
            f"tensors on {dev.type} are not supported")
    return dev
