"""Dispatch for the flash-attention kernel.

A CUDA tensor launches the hand-written Hopper kernel
(``flash_attention.cu``), whatever the sequence lengths: the kernel masks
the ragged edges itself.  Its C entry point dispatches on the input's
dtype, and both bodies compute the same function to the JAX kernel's bars:
bfloat16 runs the tensor-core body (``wgmma`` for Q K^T and for P V, f32
accumulators, P rounded to bf16 as the Pallas kernel rounds it); float32
runs the CUDA-core body in full f32, since a float32 ``wgmma`` is TF32 and
could not meet the f32 bar of 2e-5.  A CPU tensor runs the plain PyTorch
version (``ref.reference``).  Q and K share one head dim, and V's is the
same (16, 64, 96, 128 or 256) or, for multi-head latent attention's prefill,
128 beside Q's 192 (``_checks.SPLIT_HEAD_DIMS``); the output's head dim
follows V.  What the kernel does not take raises on either device:
``H % KV != 0``, any other pair of head dims, a dtype other than
float32/bfloat16, non-contiguous inputs.  There is no quiet fallback.

``flash_attention.launches`` counts kernel launches (CPU calls do not
count).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .._checks import (DTYPES, HEAD_DIMS, SPLIT_HEAD_DIMS, require,
                       same_device_contiguous)
from . import ref

_WHAT = "flash_attention"


def _entry():
    lib = _build.library(_WHAT)
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib, fn


def flash_attention(q, k, v, *, q_positions, k_positions, causal=True,
                    window=0, logit_softcap=0.0):
    """q: [B, Sq, H, hd]; k: [B, Skv, KV, hd]; v: [B, Skv, KV, dv];
    q_positions: [Sq] int32; k_positions: [Skv] int32 (-1 marks an empty
    slot).  Returns [B, Sq, H, dv]."""
    dev = same_device_contiguous(_WHAT, q=q, k=k, v=v,
                                 q_positions=q_positions,
                                 k_positions=k_positions)
    require(q.dim() == 4 and k.dim() == 4, _WHAT,
            "q must be [B, Sq, H, hd] and k, v [B, Skv, KV, hd]")
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    dv = v.shape[-1]
    require(v.shape[:3] == k.shape[:3] and k.shape[0] == B, _WHAT,
            f"k {tuple(k.shape)} and v {tuple(v.shape)} disagree with q "
            f"{tuple(q.shape)}")
    require(k.shape[-1] == hd, _WHAT,
            f"k head dim {k.shape[-1]} must equal q's {hd}")
    require(H % KV == 0, _WHAT, f"{H} query heads do not group over {KV} "
            "KV heads")
    if dv == hd:
        require(hd in HEAD_DIMS, _WHAT, f"head dim {hd} not in {HEAD_DIMS}")
    else:
        require((hd, dv) in SPLIT_HEAD_DIMS, _WHAT,
                f"q/k head dim {hd} with v head dim {dv}: the kernel takes "
                f"equal head dims or (q/k, v) in {SPLIT_HEAD_DIMS}")
    require(q.dtype in DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
            _WHAT, "q, k, v must share one dtype, float32 or bfloat16")
    require(q_positions.shape == (Sq,) and k_positions.shape == (Skv,),
            _WHAT, "q_positions must be [Sq] and k_positions [Skv]")
    require(q_positions.dtype == torch.int32
            and k_positions.dtype == torch.int32, _WHAT,
            "positions must be int32")
    require(Sq > 0 and Skv > 0, _WHAT, "empty sequence")
    if dev.type == "cpu":
        return ref.reference(q, k, v, q_positions=q_positions,
                             k_positions=k_positions, causal=causal,
                             window=window, logit_softcap=logit_softcap)

    require(B * H <= 65535, _WHAT, f"B * H = {B * H} exceeds the grid")
    if q.dtype == torch.bfloat16:
        # the bf16 body's TMA reads tiles from 16-byte-aligned addresses:
        # an input that starts elsewhere (a view into a larger buffer) is
        # copied to a fresh allocation first
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = q.new_empty((B, Sq, H, dv))
    lib, fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 q_positions.data_ptr(), k_positions.data_ptr(),
                 out.data_ptr(), B, Sq, Skv, H, KV, hd, dv,
                 1.0 / math.sqrt(hd),
                 int(bool(causal)), int(window), float(logit_softcap),
                 DTYPES[q.dtype], stream)
    _build.check_launch(lib, _WHAT, err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
