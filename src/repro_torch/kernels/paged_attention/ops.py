"""Dispatch for the paged-attention decode kernel.

A CUDA tensor launches the hand-written Hopper kernel
(``paged_attention.cu``) once per call; a CPU tensor runs the plain
PyTorch version (``ref.reference``, or ``ref.split_reference`` when
``n_split`` is given).  What the kernel does not take raises on either
device: ``H % KV != 0``, a head dim outside 16/64/96/128/256, more query
heads per KV head than ``max_group(hd)``, a dtype other than
float32/bfloat16, non-contiguous inputs, an ``n_split`` that is not a
positive int.  There is no quiet fallback.

The kernel splits each lane's context over at most ``n_split`` CTAs, each
taking at least ``ref.min_split_blocks`` blocks, and combines the partial
softmaxes in the same launch.  Unless the caller forces it, ``n_split`` is
``ceil(SMs / (B * KV))``, cut to the splits that the blocks the table can
reach inside the window make, and to ``AUTO_SPLIT_CAP``: the table's width
bounds the largest context of the batch without reading ``context_lens``
back from the card.  With ``n_split > 1`` the wrapper allocates the
partials' scratch with ``torch.empty`` and keeps one zeroed int32 ticket
counter per (lane, KV head) on each device, which every launch leaves at
zero; two launches on one device must therefore not run at the same time
on different streams.

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


MAX_SPLIT = 256
# The last CTA of a (lane, KV head) combines every live split's partial
# (G x hd floats) alone, so the wrapper's own choice stays at or below this.
AUTO_SPLIT_CAP = 32
_tickets: dict = {}
_sm_count: dict = {}


def _entry():
    lib = _build.library(_WHAT)
    fn = lib.paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    return lib, fn


def max_group(hd):
    """The most query heads per KV head the kernel takes at head dim
    ``hd``: each of its 256 threads owns 2 columns of at most 8 heads in
    P V."""
    return 256 // (hd // 2) * 8


def choose_split(B, H, KV, max_blocks, block_size, window, n_sm):
    """CTAs per (lane, KV head): enough to give every SM one, no more than
    the splits of ``ref.min_split_blocks`` that the blocks a lane can hold
    inside the window make, and at most ``AUTO_SPLIT_CAP``."""
    reach = max_blocks
    if window:
        reach = min(reach, -(-window // block_size) + 1)
    splits = -(-reach // ref.min_split_blocks(H // KV, block_size))
    return max(1, min(splits, -(-n_sm // (B * KV)), AUTO_SPLIT_CAP))


def _tickets_for(dev, n):
    buf = _tickets.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _tickets[dev] = buf
    return buf


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    logit_softcap=0.0, window=0, n_split=None):
    """Single-token decode attention through a block table.

    q: [B, H, hd]; k_pages/v_pages: [n_pages, block_size, KV, hd];
    block_tables: [B, max_blocks] int32; context_lens: [B] int32 (resident
    rows per lane, including the one written this step); window: sliding
    window width (0 = global); n_split: CTAs per (lane, KV head), None for
    the wrapper's choice.  Returns [B, H, hd]."""
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
    require(H // KV <= max_group(hd), _WHAT,
            f"{H // KV} query heads per KV head exceed the kernel's "
            f"{max_group(hd)} at head dim {hd}")
    require(q.dtype in DTYPES and k_pages.dtype == q.dtype
            and v_pages.dtype == q.dtype, _WHAT,
            "q and pages must share one dtype, float32 or bfloat16")
    require(block_tables.dim() == 2 and block_tables.shape[0] == B
            and context_lens.shape == (B,), _WHAT,
            "block_tables must be [B, max_blocks] and context_lens [B]")
    require(block_tables.dtype == torch.int32
            and context_lens.dtype == torch.int32, _WHAT,
            "block_tables and context_lens must be int32")
    require(n_split is None or (type(n_split) is int
                                and 1 <= n_split <= MAX_SPLIT), _WHAT,
            f"n_split must be None or an int in [1, {MAX_SPLIT}], "
            f"got {n_split!r}")
    if dev.type == "cpu":
        if n_split is not None:
            return ref.split_reference(
                q, k_pages, v_pages, block_tables, context_lens,
                n_split=n_split, logit_softcap=logit_softcap, window=window)
        return ref.reference(
            q[:, None], k_pages, v_pages, block_tables, context_lens,
            q_positions=(context_lens - 1)[:, None],
            logit_softcap=logit_softcap, window=window)[:, 0]

    max_blocks = block_tables.shape[1]
    if n_split is None:
        n_sm = _sm_count.get(dev)
        if n_sm is None:
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            _sm_count[dev] = n_sm
        n_split = choose_split(B, H, KV, max_blocks, bs, window, n_sm)
    out = torch.empty_like(q)
    part_ml = part_acc = tickets = 0
    if n_split > 1:
        n_part = B * H * n_split          # (lane, KV head, split, head)
        scratch = torch.empty(n_part * (hd + 2), dtype=torch.float32,
                              device=dev)
        part_acc = scratch.data_ptr()          # [n_part, hd], then
        part_ml = part_acc + n_part * hd * 4   # [n_part] (m, l) pairs
        tickets = _tickets_for(dev, B * KV).data_ptr()
    lib, fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), context_lens.data_ptr(),
                 out.data_ptr(), part_ml, part_acc, tickets, B, H, KV, hd,
                 bs, max_blocks, 1.0 / math.sqrt(hd), float(logit_softcap),
                 int(window), n_split, DTYPES[q.dtype], stream)
    _build.check_launch(lib, _WHAT, err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
