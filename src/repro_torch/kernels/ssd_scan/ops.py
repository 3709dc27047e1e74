"""Dispatch for the SSD-scan kernel.

A CUDA tensor launches the hand-written Hopper kernel (``ssd_scan.cu``),
which walks the sequence in fixed chunks of its own and masks the ragged
last one, so every sequence length runs on it.  A CPU tensor runs the
plain PyTorch version (``ref.reference``) with the reference's chunk rule
at ``chunk``; both compute the same function, up to rounding.  What the
kernel does not take raises on either device: a head dim outside
8/16/32/64, a state dim outside 8/16/32/128, xs/B/C other than one dtype
of float32/bfloat16, dt/A/D/init_state other than float32, shapes that
disagree, non-contiguous inputs.  There is no quiet fallback.

``ssd_scan.launches`` counts kernel launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._checks import DTYPES, require, same_device_contiguous
from . import ref

_WHAT = "ssd_scan"
HEAD_DIMS = (8, 16, 32, 64)
STATE_DIMS = (8, 16, 32, 128)


def _entry():
    lib = _build.library(_WHAT)
    fn = lib.ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    return lib, fn


def ssd_scan(xs, dt, A, B_mat, C_mat, D, *, chunk: int = 256,
             init_state=None):
    """xs: [B, S, nh, hd]; dt: [B, S, nh] float32 (post-softplus); A, D:
    [nh] float32 (A negative); B_mat, C_mat: [B, S, ns] in xs's dtype;
    init_state: [B, nh, hd, ns] float32, or None for zeros.  ``chunk`` is
    the plain version's chunk length (the kernel chooses its own).
    Returns (y [B, S, nh, hd], final state [B, nh, hd, ns]), float32."""
    named = dict(xs=xs, dt=dt, A=A, B_mat=B_mat, C_mat=C_mat, D=D)
    if init_state is not None:
        named["init_state"] = init_state
    dev = same_device_contiguous(_WHAT, **named)
    require(xs.dim() == 4, _WHAT, "xs must be [B, S, nh, hd]")
    Bb, S, nh, hd = xs.shape
    require(Bb > 0 and S > 0 and nh > 0, _WHAT, "empty input")
    require(dt.shape == (Bb, S, nh), _WHAT,
            f"dt {tuple(dt.shape)} must be {(Bb, S, nh)}")
    require(A.shape == (nh,) and D.shape == (nh,), _WHAT,
            f"A {tuple(A.shape)} and D {tuple(D.shape)} must be ({nh},)")
    require(B_mat.dim() == 3 and B_mat.shape[:2] == (Bb, S)
            and C_mat.shape == B_mat.shape, _WHAT,
            f"B {tuple(B_mat.shape)} and C {tuple(C_mat.shape)} must be "
            f"[{Bb}, {S}, ns]")
    ns = B_mat.shape[-1]
    require(hd in HEAD_DIMS, _WHAT, f"head dim {hd} not in {HEAD_DIMS}")
    require(ns in STATE_DIMS, _WHAT, f"state dim {ns} not in {STATE_DIMS}")
    require(xs.dtype in DTYPES and B_mat.dtype == xs.dtype
            and C_mat.dtype == xs.dtype, _WHAT,
            "xs, B and C must share one dtype, float32 or bfloat16")
    require(all(t.dtype == torch.float32 for t in (dt, A, D)), _WHAT,
            "dt, A and D must be float32")
    if init_state is not None:
        require(init_state.shape == (Bb, nh, hd, ns)
                and init_state.dtype == torch.float32, _WHAT,
                f"init_state must be float32 {(Bb, nh, hd, ns)}, got "
                f"{init_state.dtype} {tuple(init_state.shape)}")
    if dev.type == "cpu":
        return ref.reference(xs, dt, A, B_mat, C_mat, D, chunk=chunk,
                             init_state=init_state)

    require(Bb <= 65535 and nh <= 65535, _WHAT,
            f"B = {Bb} or nh = {nh} exceeds the grid")
    y = torch.empty((Bb, S, nh, hd), dtype=torch.float32, device=dev)
    state = torch.empty((Bb, nh, hd, ns), dtype=torch.float32, device=dev)
    lib, fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xs.data_ptr(), dt.data_ptr(), A.data_ptr(),
                 B_mat.data_ptr(), C_mat.data_ptr(), D.data_ptr(),
                 None if init_state is None else init_state.data_ptr(),
                 y.data_ptr(), state.data_ptr(), Bb, S, nh, hd, ns,
                 DTYPES[xs.dtype], stream)
    _build.check_launch(lib, _WHAT, err)
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
