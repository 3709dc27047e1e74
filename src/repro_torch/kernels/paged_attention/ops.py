"""Dispatch for the paged-attention decode kernel.

A CUDA tensor launches the hand-written Hopper kernel
(``paged_attention.cu``); a CPU tensor runs the plain PyTorch version
(``ref.reference``).  What the kernel does not take raises on either
device: ``H % KV != 0``, a head dim outside 16/64/128/256, a dtype other
than float32/bfloat16, non-contiguous inputs.  There is no quiet fallback.

``paged_attention.launches`` counts kernel launches (CPU calls do not
count), so a caller can show that a run went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .._checks import DTYPES, HEAD_DIMS, require, same_device_contiguous
from . import ref

_WHAT = "paged_attention"


def _entry():
    lib = _build.library(_WHAT)
    fn = lib.paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    return lib, fn


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    logit_softcap=0.0, window=0):
    """Single-token decode attention through a block table.

    q: [B, H, hd]; k_pages/v_pages: [n_pages, block_size, KV, hd];
    block_tables: [B, max_blocks] int32; context_lens: [B] int32 (resident
    rows per lane, including the one written this step); window: sliding
    window width (0 = global).  Returns [B, H, hd]."""
    dev = same_device_contiguous(
        _WHAT, q=q, k_pages=k_pages, v_pages=v_pages,
        block_tables=block_tables, context_lens=context_lens)
    require(q.dim() == 3 and k_pages.dim() == 4, _WHAT,
            "q must be [B, H, hd] and pages [n_pages, bs, KV, hd]")
    B, H, hd = q.shape
    n_pages, bs, KV, hd_k = k_pages.shape
    require(v_pages.shape == k_pages.shape, _WHAT,
            f"v_pages {tuple(v_pages.shape)} != k_pages "
            f"{tuple(k_pages.shape)}")
    require(hd_k == hd, _WHAT, f"page head dim {hd_k} != q head dim {hd}")
    require(H % KV == 0, _WHAT, f"{H} query heads do not group over {KV} "
            "KV heads")
    require(hd in HEAD_DIMS, _WHAT, f"head dim {hd} not in {HEAD_DIMS}")
    require(q.dtype in DTYPES and k_pages.dtype == q.dtype
            and v_pages.dtype == q.dtype, _WHAT,
            "q and pages must share one dtype, float32 or bfloat16")
    require(block_tables.dim() == 2 and block_tables.shape[0] == B
            and context_lens.shape == (B,), _WHAT,
            "block_tables must be [B, max_blocks] and context_lens [B]")
    require(block_tables.dtype == torch.int32
            and context_lens.dtype == torch.int32, _WHAT,
            "block_tables and context_lens must be int32")
    if dev.type == "cpu":
        return ref.reference(
            q[:, None], k_pages, v_pages, block_tables, context_lens,
            q_positions=(context_lens - 1)[:, None],
            logit_softcap=logit_softcap, window=window)[:, 0]

    out = torch.empty_like(q)
    lib, fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), context_lens.data_ptr(),
                 out.data_ptr(), B, H, KV, hd, bs, block_tables.shape[1],
                 1.0 / math.sqrt(hd), float(logit_softcap), int(window),
                 DTYPES[q.dtype], stream)
    _build.check_launch(lib, _WHAT, err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
