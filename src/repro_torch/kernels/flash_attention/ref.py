"""Plain PyTorch version of the flash-attention kernel (a port of
``repro.kernels.flash_attention.ref``).

GQA, position-based causal and sliding-window masks, optional logit
softcap; scores and softmax in f32, probabilities rounded to the input
type before the product with V (as the reference does).  V's head dim may
differ from Q's; the scale is ``1/sqrt`` of Q's and the output follows
V's.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def reference(q, k, v, *, q_positions, k_positions, causal=True, window=0,
              logit_softcap=0.0):
    """q: [B, Sq, H, hd]; k: [B, Skv, KV, hd]; v: [B, Skv, KV, dv] ->
    [B, Sq, H, dv]."""
    H, hd = q.shape[2], q.shape[3]
    n_kv = k.shape[2]
    if n_kv != H:
        k = k.repeat_interleave(H // n_kv, dim=2)
        v = v.repeat_interleave(H // n_kv, dim=2)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    mask = k_positions[None, :] >= 0
    if causal:
        mask = mask & (k_positions[None, :] <= q_positions[:, None])
    if window:
        mask = mask & (k_positions[None, :] > q_positions[:, None] - window)
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
