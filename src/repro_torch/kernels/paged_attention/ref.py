"""Plain PyTorch version of the paged-attention kernel (a port of
``repro.kernels.paged_attention.ref``).

Gathers each lane's logical K/V rows through its block table and runs the
same masked softmax as ``repro_torch.models.blocks._attn_block``.  Rows at
or past ``context_lens[b]``, rows past the query's own position and, with a
window, rows at or below ``q_pos - window`` are forced to -1e30 before the
f32 softmax, so they contribute exact zeros: over a gathered view of the
same length the result equals dense attention bit for bit, which the
engines' token identity rests on.

* ``q``: [B, Sq, H, hd] (decode: Sq == 1)
* ``k_pages/v_pages``: [n_pages, block_size, KV, hd]
* ``block_tables``: [B, max_blocks] int; ``context_lens``: [B] int
* ``q_positions``: [B, Sq] absolute positions of the query rows
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def reference(q, k_pages, v_pages, block_tables, context_lens, *,
              q_positions, logit_softcap=0.0, window=0):
    """Gather-based paged attention. Returns [B, Sq, H, hd]."""
    B, Sq, H, hd = q.shape
    _, block_size, n_kv, _ = k_pages.shape
    L = block_tables.shape[1] * block_size
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, L, n_kv, hd)
    v = v_pages[idx].reshape(B, L, n_kv, hd)
    if n_kv != H:
        k = k.repeat_interleave(H // n_kv, dim=2)
        v = v.repeat_interleave(H // n_kv, dim=2)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    j = torch.arange(L, dtype=torch.int32, device=q.device)
    mask = (j[None, None, :] < context_lens[:, None, None]) & \
        (j[None, None, :] <= q_positions[:, :, None])            # [B, Sq, L]
    if window:
        mask &= j[None, None, :] > q_positions[:, :, None] - window
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
