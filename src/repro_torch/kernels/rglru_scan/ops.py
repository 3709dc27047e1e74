"""Dispatch for the RG-LRU scan kernel.

A CUDA tensor launches the hand-written Hopper kernel (``rglru_scan.cu``),
whatever the sequence length and width.  A CPU tensor runs the plain
PyTorch version (``ref.reference``); the two compute the same function in
the same order.  What the kernel does not take raises on either device:
a, bx or h0 other than float32, shapes that disagree, non-contiguous or
empty inputs.  There is no quiet fallback.

``rglru_scan.launches`` counts kernel launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._checks import require, same_device_contiguous
from . import ref

_WHAT = "rglru_scan"


def _entry():
    lib = _build.library(_WHAT)
    fn = lib.rglru_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    return lib, fn


def rglru_scan(a, bx, h0=None):
    """a, bx: [B, S, W] float32; h0: [B, W] float32, or None for zeros.
    Returns (hs [B, S, W], h_final [B, W]), float32."""
    named = dict(a=a, bx=bx)
    if h0 is not None:
        named["h0"] = h0
    dev = same_device_contiguous(_WHAT, **named)
    require(a.dim() == 3, _WHAT, "a must be [B, S, W]")
    B, S, W = a.shape
    require(bx.shape == a.shape, _WHAT,
            f"bx {tuple(bx.shape)} must equal a {tuple(a.shape)}")
    require(B > 0 and S > 0 and W > 0, _WHAT, "empty input")
    require(a.dtype == torch.float32 and bx.dtype == torch.float32, _WHAT,
            "a and bx must be float32")
    if h0 is not None:
        require(h0.shape == (B, W) and h0.dtype == torch.float32, _WHAT,
                f"h0 must be float32 {(B, W)}, got {h0.dtype} "
                f"{tuple(h0.shape)}")
    if dev.type == "cpu":
        return ref.reference(a, bx, h0)

    require(B <= 65535, _WHAT, f"B = {B} exceeds the grid")
    hs = torch.empty_like(a)
    h_final = torch.empty((B, W), dtype=torch.float32, device=dev)
    lib, fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), bx.data_ptr(),
                 None if h0 is None else h0.data_ptr(), hs.data_ptr(),
                 h_final.data_ptr(), B, S, W, stream)
    _build.check_launch(lib, _WHAT, err)
    rglru_scan.launches += 1
    return hs, h_final


rglru_scan.launches = 0
