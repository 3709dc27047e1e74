"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434).

A port of ``repro.models.mla``.  The cache keeps only the compressed
latent ``ckv`` [kv_lora_rank] and the shared RoPE key ``krope``
[qk_rope_dim] of each token.  Prefill expands them to per-head keys
(``qk_nope_dim + qk_rope_dim`` wide) and values (``v_head_dim`` wide) and
runs ``blocks.attention``, whose kernel path is the flash-attention
kernel with a V head dim of its own.  Decode and paged chunk rows use the
absorbed form instead: W_uk folds into the query and W_uv into the output
side, so attention runs over the latents themselves, in plain einsums (the
reference runs them outside any Pallas kernel, and the paged kernel reads
K/V heads, not latents).

Cache writes happen in place, as in ``blocks``: the functions return the
cache dict they were given, updated.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .blocks import apply_rope, attention, dense_init, paged_write, rms_norm
from .config import ModelConfig

NEG_INF = -1e30


def init_mla(gen: torch.Generator, cfg: ModelConfig, repeats: int, dtype,
             device) -> dict:
    d, nh = cfg.d_model, cfg.n_heads
    qk = cfg.qk_rope_dim + cfg.qk_nope_dim
    r = cfg.kv_lora_rank
    return {
        "ln": torch.zeros((repeats, d), dtype=dtype, device=device),
        "wq": dense_init(gen, (repeats, d, nh * qk), dtype, device),
        "wkv_down": dense_init(gen, (repeats, d, r + cfg.qk_rope_dim), dtype,
                               device),
        "kv_ln": torch.zeros((repeats, r), dtype=dtype, device=device),
        "wk_up": dense_init(gen, (repeats, r, nh * cfg.qk_nope_dim), dtype,
                            device),
        "wv_up": dense_init(gen, (repeats, r, nh * cfg.v_head_dim), dtype,
                            device),
        "wo": dense_init(gen, (repeats, nh * cfg.v_head_dim, d), dtype,
                         device),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, kv_len: int, dtype,
                   device) -> dict:
    """Dense latent cache: ``ckv`` [B, kv_len, kv_lora_rank], ``krope``
    [B, kv_len, qk_rope_dim] and the absolute position of each slot
    (-1 = empty)."""
    return {
        "ckv": torch.zeros((batch, kv_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, kv_len, cfg.qk_rope_dim), dtype=dtype,
                             device=device),
        "pos": torch.full((kv_len,), -1, dtype=torch.int32, device=device),
    }


def init_paged_mla_cache(cfg: ModelConfig, n_pages: int, block_size: int,
                         dtype, device) -> dict:
    """Latent page pools shared by every decode lane: a token's ``ckv`` and
    ``krope`` rows page through the global block tables as attention K/V
    rows do, in two pools of different row widths.  ``n_pages`` includes
    the trailing null (scratch) page."""
    return {
        "ckv_pages": torch.zeros((n_pages, block_size, cfg.kv_lora_rank),
                                 dtype=dtype, device=device),
        "krope_pages": torch.zeros((n_pages, block_size, cfg.qk_rope_dim),
                                   dtype=dtype, device=device),
    }


def _project(cfg: ModelConfig, p: dict, h: torch.Tensor,
             positions: torch.Tensor) -> tuple:
    """Shared projections; returns (q_nope, q_rope, ckv, krope) with the
    RoPE applied to q_rope and krope at ``positions`` ([S] or [B, S])."""
    B, S, _ = h.shape
    nh = cfg.n_heads
    q = (h @ p["wq"]).reshape(B, S, nh, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    down = h @ p["wkv_down"]
    ckv, krope = down.split([cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    ckv = rms_norm(ckv, p["kv_ln"], cfg.norm_eps)
    krope = apply_rope(krope[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, krope


def mla_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              positions: torch.Tensor, cache: Optional[dict] = None,
              impl: str = "kernel",
              paged_tables: Optional[torch.Tensor] = None) -> tuple:
    """Pre-norm MLA block; returns (residual output, cache).

    A paged cache (``ckv_pages``/``krope_pages`` with ``paged_tables``)
    goes to ``_mla_paged``; a dense cache with one row to ``_mla_decode``.
    Otherwise (no cache, or a prefill filling one; ``positions`` = [S])
    the latents expand to per-head keys and values and ``blocks.attention``
    runs causally over them, its output ``v_head_dim`` wide; a prefill
    cache takes the prompt's latent rows (the last ``kv_len`` of them) in
    slots 0.."""
    B, S, _ = x.shape
    nh = cfg.n_heads
    h = rms_norm(x, p["ln"], cfg.norm_eps)

    if cache is not None and "ckv_pages" in cache:
        if paged_tables is None:
            raise ValueError("a paged MLA cache needs block tables")
        return _mla_paged(cfg, p, x, h, positions, cache, paged_tables)
    if cache is not None and S == 1:
        return _mla_decode(cfg, p, x, h, positions, cache)

    q_nope, q_rope, ckv, krope = _project(cfg, p, h, positions)
    k_nope = (ckv @ p["wk_up"]).reshape(B, S, nh, cfg.qk_nope_dim)
    v = (ckv @ p["wv_up"]).reshape(B, S, nh, cfg.v_head_dim)
    k_rope = krope[:, :, None, :].expand(B, S, nh, cfg.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    o = attention(q, k, v, q_positions=positions, k_positions=positions,
                  causal=True, impl=impl)
    out = o.reshape(B, S, nh * cfg.v_head_dim) @ p["wo"]

    if cache is not None:
        n = min(S, cache["ckv"].shape[1])
        cache["ckv"][:, :n] = ckv[:, -n:]
        cache["krope"][:, :n] = krope[:, -n:]
        cache["pos"][:n] = positions[-n:].to(torch.int32)
    return x + out, cache


def _absorbed(cfg: ModelConfig, p: dict, x, q_nope, q_rope, ckv_c, krope_c,
              valid) -> torch.Tensor:
    """Attention in the latent space: W_uk folded into the query, W_uv
    into the output side.  ``ckv_c`` [B, L, r], ``krope_c`` [B, L, rope],
    ``valid`` broadcastable to [B, S, 1, L]; returns the residual output."""
    B, S = q_nope.shape[:2]
    nh, r = cfg.n_heads, cfg.kv_lora_rank
    wk = p["wk_up"].reshape(r, nh, cfg.qk_nope_dim)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wk)
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    scores = (torch.einsum("bshr,bkr->bshk", q_lat, ckv_c) +
              torch.einsum("bshd,bkd->bshk", q_rope, krope_c)).float()
    scores = (scores * scale).masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bshk,bkr->bshr", probs, ckv_c)
    wv = p["wv_up"].reshape(r, nh, cfg.v_head_dim)
    o = torch.einsum("bshr,rhd->bshd", o_lat, wv)
    return x + o.reshape(B, S, nh * cfg.v_head_dim) @ p["wo"]


def _mla_paged(cfg: ModelConfig, p: dict, x, h, positions, cache,
               tables) -> tuple:
    """Absorbed attention over block-table-paged latents.

    Batched decode: x is [B, 1, D] and ``positions`` [B], one row per
    lane.  Chunk prefill: x is [1, C, D] and ``positions`` the chunk's [C]
    rows of one lane.  The rows are written through the tables first, then
    each lane's logical view is gathered back in position order (slot ==
    position, as the dense cache holds it), so with ``kv_len ==
    max_blocks * block_size`` a decode row computes ``_mla_decode``'s
    arithmetic on the same operands."""
    B, S, _ = x.shape
    pos = positions.reshape(-1)                  # [B] decode, [S] chunk
    if S == 1:
        q_nope, q_rope, ckv_t, krope_t = _project(cfg, p, h, pos[:, None])
        ctx = pos + 1              # resident incl. the token just written
        q_pos = pos[:, None]                                     # [B, 1]
    else:
        q_nope, q_rope, ckv_t, krope_t = _project(cfg, p, h, pos)
        ctx = pos[-1:] + 1
        q_pos = pos[None]                                        # [1, S]
    ckv_pages, krope_pages = paged_write(
        cache["ckv_pages"], cache["krope_pages"], tables, pos, ckv_t,
        krope_t)
    L = tables.shape[1] * ckv_pages.shape[1]
    idx = tables.long()
    ckv_c = ckv_pages[idx].reshape(B, L, cfg.kv_lora_rank)
    krope_c = krope_pages[idx].reshape(B, L, cfg.qk_rope_dim)
    j = torch.arange(L, dtype=torch.int32, device=x.device)
    pos_c = torch.where(j[None] < ctx[:, None], j[None], -1)     # [B, L]
    valid = (pos_c[:, None, :] >= 0) & \
        (pos_c[:, None, :] <= q_pos[:, :, None])                 # [B, S, L]
    out = _absorbed(cfg, p, x, q_nope, q_rope, ckv_c, krope_c,
                    valid[:, :, None, :])
    return out, cache


def _mla_decode(cfg: ModelConfig, p: dict, x, h, positions, cache) -> tuple:
    """Absorbed decode of one row over the dense latent cache (``positions``
    a 0-d tensor, or [1]); the row's latents are written in place first."""
    pos = positions.reshape(())
    q_nope, q_rope, ckv_t, krope_t = _project(cfg, p, h, pos[None])
    slot = pos.clamp(max=cache["ckv"].shape[1] - 1).long().reshape(1)
    cache["ckv"].index_copy_(1, slot, ckv_t)
    cache["krope"].index_copy_(1, slot, krope_t)
    cache["pos"].index_copy_(0, slot, pos.to(torch.int32).reshape(1))
    pos_c = cache["pos"]
    valid = (pos_c >= 0) & (pos_c <= pos)
    out = _absorbed(cfg, p, x, q_nope, q_rope, cache["ckv"], cache["krope"],
                    valid[None, None, None, :])
    return out, cache
