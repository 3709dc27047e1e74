"""Dispatch for the RG-LRU scan kernel.

A CUDA tensor launches the hand-written Hopper kernel (``rglru_scan.cu``),
whatever the sequence length and width: a two-pass scan over ``n_chunks``
chunks of the sequence per CTA, ``choose_chunks`` unless forced.  A CPU
tensor runs the plain PyTorch version (``ref.reference``), or with a forced
``n_chunks`` the plain version in the kernel's order
(``ref.chunked_reference``); all compute the same function, up to
rounding.  What the kernel does not take raises on either device: a, bx or
h0 other than float32, shapes that disagree, non-contiguous or empty
inputs, an ``n_chunks`` outside [1, ``MAX_CHUNKS``].  There is no quiet
fallback.

``rglru_scan.launches`` counts kernel launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._checks import require, same_device_contiguous
from . import ref

_WHAT = "rglru_scan"
CHANNELS = 16           # channels per CTA (the kernel's kChannels)
MAX_CHUNKS = 32         # chunks per CTA (kMaxChunks)
MIN_ROWS = 8            # rows a chunk should have at least
THREADS_PER_SM = 1024   # threads in flight an SM should get
_sm_count: dict = {}


def _entry():
    lib = _build.library(_WHAT)
    fn = lib.rglru_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    return lib, fn


def choose_chunks(B, S, W, n_sm):
    """Chunks of the sequence per CTA, a power of two (whole warps): about
    enough that the grid of ``B * ceil(W / CHANNELS)`` CTAs holds
    ``THREADS_PER_SM`` threads per SM, no more than give each chunk
    ``MIN_ROWS`` rows, at most ``MAX_CHUNKS``."""
    ctas = B * -(-W // CHANNELS)
    fill = -(-n_sm * THREADS_PER_SM // (ctas * CHANNELS))
    k = max(1, min(fill, -(-S // MIN_ROWS), MAX_CHUNKS))
    return 1 << (k.bit_length() - 1)


def rglru_scan(a, bx, h0=None, *, n_chunks=None):
    """a, bx: [B, S, W] float32; h0: [B, W] float32, or None for zeros;
    n_chunks: chunks of the sequence per CTA, None for the wrapper's
    choice.  Returns (hs [B, S, W], h_final [B, W]), float32."""
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
    require(n_chunks is None or (type(n_chunks) is int
                                 and 1 <= n_chunks <= MAX_CHUNKS), _WHAT,
            f"n_chunks must be None or an int in [1, {MAX_CHUNKS}], "
            f"got {n_chunks!r}")
    if dev.type == "cpu":
        if n_chunks is not None:
            return ref.chunked_reference(a, bx, h0, n_chunks=n_chunks)
        return ref.reference(a, bx, h0)

    require(B <= 65535, _WHAT, f"B = {B} exceeds the grid")
    if n_chunks is None:
        n_sm = _sm_count.get(dev)
        if n_sm is None:
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            _sm_count[dev] = n_sm
        n_chunks = choose_chunks(B, S, W, n_sm)
    hs = torch.empty_like(a)
    h_final = torch.empty((B, W), dtype=torch.float32, device=dev)
    lib, fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), bx.data_ptr(),
                 None if h0 is None else h0.data_ptr(), hs.data_ptr(),
                 h_final.data_ptr(), B, S, W, n_chunks, stream)
    _build.check_launch(lib, _WHAT, err)
    rglru_scan.launches += 1
    return hs, h_final


rglru_scan.launches = 0
