"""Plain PyTorch versions of the RG-LRU scan kernel.

``reference`` is a port of ``repro.kernels.rglru_scan.ref.reference``:
``h_t = a_t * h_{t-1} + bx_t`` per channel, in float32.  An initial state
``h0`` is folded into the first row (``bx[:, 0] += a[:, 0] * h0``), as the
reference oracle and the model's ``_lru_scan`` fold it; the recurrence then
starts from zeros.  The reference runs an associative scan; this version
walks the sequence in order, so its sums differ from the reference's by
rounding only.

``chunked_reference`` computes the same function in the Hopper kernel's
order (a two-pass scan over chunks of the sequence), which the kernel equals
bit for bit; it differs from ``reference`` only in the order in which each
chunk's incoming state is summed.
"""

from __future__ import annotations

from typing import Optional

import torch


def reference(a: torch.Tensor, bx: torch.Tensor,
              h0: Optional[torch.Tensor] = None) -> tuple:
    """a, bx: [B, S, W]; h0: [B, W] or None (zeros).  Returns (hs
    [B, S, W], h_final [B, W]), both float32."""
    a, bx = a.float(), bx.float()
    if h0 is not None:
        first = bx[:, :1] + a[:, :1] * h0.float()[:, None]
        bx = torch.cat([first, bx[:, 1:]], dim=1)
    h = torch.zeros_like(bx[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


MAX_ROWS = 16   # rows a kernel thread holds per super-chunk


def chunk_rows(S: int, n_chunks: int) -> int:
    """Rows of one chunk: the sequence over ``n_chunks``, at most
    ``MAX_ROWS`` (a longer sequence is walked in super-chunks of
    ``n_chunks * rows`` rows)."""
    return min(MAX_ROWS, -(-S // n_chunks))


def chunked_reference(a: torch.Tensor, bx: torch.Tensor,
                      h0: Optional[torch.Tensor] = None, *,
                      n_chunks: int) -> tuple:
    """The two-pass scan of the kernel: the sequence in super-chunks of
    ``n_chunks`` chunks of ``chunk_rows`` rows (padded with a = 1, bx = 0,
    which change nothing); per chunk the product of a and the end state
    from zero; a carry over the chunks in order, ``h_in[k] = h; h = prod_k
    * h + end_k``; then each chunk re-walked from its ``h_in``.  Every step
    rounds the product and the sum apart.  Returns (hs [B, S, W], h_final
    [B, W]), both float32."""
    a, bx = a.float(), bx.float()
    B, S, W = a.shape
    rows = chunk_rows(S, n_chunks)
    span = n_chunks * rows
    n_super = -(-S // span)
    pad = n_super * span - S
    a = torch.cat([a, a.new_ones((B, pad, W))], dim=1)
    bx = torch.cat([bx, bx.new_zeros((B, pad, W))], dim=1)
    a = a.reshape(B, n_super, n_chunks, rows, W)
    bx = bx.reshape(B, n_super, n_chunks, rows, W)
    carry = a.new_zeros((B, W)) if h0 is None else h0.float()
    out = []
    for s in range(n_super):
        av, bv = a[:, s], bx[:, s]                    # [B, K, rows, W]
        prod = a.new_ones((B, n_chunks, W))
        end = a.new_zeros((B, n_chunks, W))
        for t in range(rows):
            end = av[:, :, t] * end + bv[:, :, t]
            prod = prod * av[:, :, t]
        h_in = []
        for k in range(n_chunks):
            h_in.append(carry)
            carry = prod[:, k] * carry + end[:, k]
        h = torch.stack(h_in, dim=1)                  # [B, K, W]
        hs = []
        for t in range(rows):
            h = av[:, :, t] * h + bv[:, :, t]
            hs.append(h)
        out.append(torch.stack(hs, dim=2).reshape(B, span, W))
    return torch.cat(out, dim=1)[:, :S], carry
