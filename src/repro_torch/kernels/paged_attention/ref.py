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


def min_split_blocks(group, block_size):
    """The fewest blocks a split takes: at least ``4 * group`` rows (group =
    query heads per KV head), so that the partial a split writes (group x
    hd floats) stays small beside the K/V rows it reads."""
    return -(-4 * group // block_size)


def split_bounds(context_lens, *, block_size, max_blocks, n_split,
                 window=0, min_blocks=1):
    """The kernel's partition of each lane's rows over ``n_split`` CTAs:
    ``(begin, end)``, each [B, n_split] int64.  The lane's resident rows
    inside the window, ``[first, n_rows)``, are cut by whole blocks into
    contiguous ranges of ``max(ceil(n_blocks / n_split), min_blocks)``
    blocks; the ranges past the lane's last block are empty (``begin >=
    end``), so the non-empty ones come first."""
    lens = context_lens.long()
    n_rows = lens.clamp(max=max_blocks * block_size)
    first = (lens - window).clamp(min=0) if window else torch.zeros_like(lens)
    blk_first = first // block_size
    n_blk = (-(-n_rows // block_size) - blk_first).clamp(min=0)
    per = (-(-n_blk // n_split)).clamp(min=min_blocks)
    s = torch.arange(n_split, device=lens.device)
    begin = torch.maximum(first[:, None],
                          (blk_first[:, None] + s * per[:, None]) * block_size)
    end = torch.minimum(n_rows[:, None],
                        (blk_first[:, None] + (s + 1) * per[:, None])
                        * block_size)
    return begin, end


def combine_partials(m, l, acc):
    """Combine per-split softmax partials as the kernel's last CTA does.

    m, l: [..., n_split] f32 (running max and sum of each split; an empty
    split has m = -inf and l = 0); acc: [..., n_split, hd] f32 (the split's
    unnormalised sum of p * v).  Returns [..., hd] f32:
    ``sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30)`` with
    ``w_s = exp(m_s - max m)`` over the non-empty splits; empty splits, and
    a lane with no rows at all, contribute exact zeros (no NaN)."""
    live = l > 0
    top = torch.where(live, m, torch.full_like(m, -math.inf)).amax(
        -1, keepdim=True)
    w = torch.where(live, torch.exp(m - top), torch.zeros_like(m))
    total = (w * l).sum(-1, keepdim=True)
    acc = torch.where(live[..., None], acc, torch.zeros_like(acc))
    return (w[..., None] * acc).sum(-2) / total.clamp(min=1e-30)


def split_reference(q, k_pages, v_pages, block_tables, context_lens, *,
                    n_split, logit_softcap=0.0, window=0):
    """One-token decode attention computed as the kernel splits it: each
    lane's rows partitioned by ``split_bounds``, a partial (m, l, acc) per
    split (scores and sums in f32, exp(s - m) rounded to the input type
    before the product with V), then ``combine_partials``.

    q: [B, H, hd]; pools, tables and lens as in ``reference``.  Returns
    [B, H, hd] in q's dtype."""
    B, H, hd = q.shape
    _, block_size, n_kv, _ = k_pages.shape
    max_blocks = block_tables.shape[1]
    L = max_blocks * block_size
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, L, n_kv, hd)
    v = v_pages[idx].reshape(B, L, n_kv, hd)
    if n_kv != H:
        k = k.repeat_interleave(H // n_kv, dim=2)
        v = v.repeat_interleave(H // n_kv, dim=2)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    begin, end = split_bounds(context_lens, block_size=block_size,
                              max_blocks=max_blocks, n_split=n_split,
                              window=window,
                              min_blocks=min_split_blocks(H // n_kv,
                                                          block_size))
    j = torch.arange(L, device=q.device)
    ms, ls, accs = [], [], []
    for s in range(n_split):
        rows = (j >= begin[:, s, None]) & (j < end[:, s, None])   # [B, L]
        sc = scores.masked_fill(~rows[:, None], -math.inf)
        m = sc.amax(-1)                                            # [B, H]
        live = rows.any(-1)[:, None].expand_as(m)
        p = torch.exp(sc - torch.where(live, m, 0.0)[..., None])
        p = torch.where(rows[:, None], p, 0.0)
        ms.append(torch.where(live, m, -math.inf))
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhk,bkhd->bhd", p.to(q.dtype).float(),
                                 v.float()))
    out = combine_partials(torch.stack(ms, -1), torch.stack(ls, -1),
                           torch.stack(accs, -2))
    return out.to(q.dtype)
