"""Model assembly for decoder-only, global-attention, dense-FFN archs:
parameter init, caches (dense and paged) and ``forward`` in prefill and
decode modes.

A port of the matching subset of ``repro.models.lm``.  Parameters and
caches keep the reference's tree — ``seg{i}/c{j}/{attn,ffn}/...`` with a
stacked leading layer axis per segment — and ``_run_segment`` walks that
axis with a Python loop where the reference scans.  Cache writes happen in
place (see ``blocks``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.device import resolve_device

from . import blocks
from .blocks import rms_norm, softcap
from .config import LayerSpec, ModelConfig, Segment

# serving cache group per mixer kind (the reference's mapping)
_MIXER_GROUP = {"global": "paged", "mla": "paged", "local": "window",
                "ssd": "recurrent", "rglru": "recurrent"}


def unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    """Why the port cannot run ``cfg`` yet, or None: it runs decoder-only
    stacks of global attention and dense FFN layers."""
    if cfg.n_enc_layers:
        return "encoder-decoder archs are not ported yet"
    if cfg.frontend:
        return "modality-frontend archs are not ported yet"
    other = sorted({s.key for s in cfg.layers()} - {"global+dense"})
    if other:
        return f"layer kinds {other} are not ported yet"
    return None


def _check_supported(cfg: ModelConfig) -> None:
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: {reason}")


# =============================================================================
# init
# =============================================================================

def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=torch.bfloat16) -> dict:
    """Random parameters with the reference's distributions: embed
    N(0, 0.02^2), dense weights N(0, 1/d_in), norm scales zero.  ``device``
    defaults to the CUDA card (and must be that of ``generator``)."""
    _check_supported(cfg)
    device = resolve_device(device)
    d = cfg.d_model
    embed = torch.randn((cfg.padded_vocab, d), generator=generator,
                        device=device, dtype=torch.float32) * 0.02
    params: dict = {
        "embed": embed.to(dtype),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = blocks.dense_init(
            generator, (d, cfg.padded_vocab), dtype, device)
    for si, seg in enumerate(cfg.segments()):
        params[f"seg{si}"] = {
            f"c{ci}": {
                "attn": blocks.init_attention(generator, cfg, seg.repeats,
                                              dtype, device),
                "ffn": blocks.init_ffn(generator, cfg, seg.repeats, dtype,
                                       device),
            } for ci, _ in enumerate(seg.cycle)}
    return params


def _stacked(leaf: dict, repeats: int) -> dict:
    return {k: v.expand((repeats,) + v.shape).clone()
            for k, v in leaf.items()}


def init_cache(cfg: ModelConfig, batch: int, kv_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Dense decode/prefill cache mirroring the segment structure of the
    params: per layer ``{"attn": {"k", "v": [B, kv_len, KV, hd],
    "pos": [kv_len]}}``, stacked along a leading layer axis."""
    _check_supported(cfg)
    device = resolve_device(device)
    return {f"seg{si}": {
        f"c{ci}": {"attn": _stacked(blocks.init_attn_cache(
            cfg, batch, kv_len, dtype, device), seg.repeats)}
        for ci, _ in enumerate(seg.cycle)}
        for si, seg in enumerate(cfg.segments())}


def serve_groups(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Per-layer serving report: cache group -> layer indices ("paged":
    global attention behind block tables; "window" and "recurrent" are
    not served by the port yet)."""
    out: dict[str, list[int]] = {"paged": [], "window": [], "recurrent": []}
    for li, spec in enumerate(cfg.layers()):
        out[_MIXER_GROUP[spec.mixer]].append(li)
    return {k: tuple(v) for k, v in out.items()}


def init_paged_caches(cfg: ModelConfig, n_pages: int, block_size: int,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Paged decode cache: per global-attention layer a pair of
    ``[n_pages, block_size, KV, hd]`` K/V pools (no slot axis: lanes are
    carved out by block tables), stacked to ``[repeats, ...]``."""
    _check_supported(cfg)
    device = resolve_device(device)
    return {f"seg{si}": {
        f"c{ci}": {"attn": _stacked(blocks.init_paged_attn_cache(
            cfg, n_pages, block_size, dtype, device), seg.repeats)}
        for ci, _ in enumerate(seg.cycle)}
        for si, seg in enumerate(cfg.segments())}


def _cache_entries(cfg: ModelConfig, caches: dict):
    for si, seg in enumerate(cfg.segments()):
        for ci, spec in enumerate(seg.cycle):
            yield spec, caches[f"seg{si}"][f"c{ci}"]


def paged_cache_leaves(cfg: ModelConfig, caches: dict) -> list[tuple]:
    """(group, (a_key, b_key), leaf) for every physical pool leaf, in a
    fixed order; the engine binds one ``PagedKVStore`` per leaf."""
    return [("global", ("k_pages", "v_pages"), entry["attn"])
            for _, entry in _cache_entries(cfg, caches)]


def _scatter_rows(pages, row_tbl, cpos, rows, *, block_size: int,
                  null_block: int) -> None:
    """Write per-position rows into a page pool through one table row, in
    place.  ``pages``: [repeats, n_pages, bs, ...]; ``row_tbl``: [W];
    ``cpos``: [S] positions (-1 = invalid); ``rows``: [repeats, S, ...].
    Invalid rows and rows past the table go to the null page."""
    width = row_tbl.shape[0]
    cpos = cpos.long()
    blk = torch.where(cpos >= 0, cpos // block_size, 0).clamp(0, width - 1)
    ok = (cpos >= 0) & ((cpos // block_size) < width)
    phys = torch.where(ok, row_tbl.long()[blk], null_block)
    off = torch.where(cpos >= 0, cpos % block_size, 0)
    pages[:, phys, off] = rows


def insert_paged_prompt(cfg: ModelConfig, caches: dict, single: dict,
                        tables: dict, *, block_size: int,
                        null_block: int) -> dict:
    """Scatter a dense single-request prefill cache (``init_cache(cfg, 1,
    kv_len)`` after a prefill) into the paged pools, in place: every row is
    written to the physical block its group's table row
    (``tables["global"]``, [W]) names, at its absolute position; rows whose
    position is -1 go to the null page.  Other lanes' blocks are untouched.
    Returns ``caches``."""
    for (_, entry), (_, one) in zip(_cache_entries(cfg, caches),
                                    _cache_entries(cfg, single)):
        leaf, sl = entry["attn"], one["attn"]
        cpos = sl["pos"][0]                 # identical across repeats
        for pool, rows in (("k_pages", sl["k"]), ("v_pages", sl["v"])):
            _scatter_rows(leaf[pool], tables["global"], cpos, rows[:, 0],
                          block_size=block_size, null_block=null_block)
    return caches


# =============================================================================
# forward
# =============================================================================

def _index(tree: dict, r: int) -> dict:
    """Layer ``r`` of a stacked tree (views, so writes reach the stack)."""
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _apply_layer(cfg: ModelConfig, spec: LayerSpec, p: dict, h, *,
                 positions, cache: Optional[dict], impl: str,
                 paged_tables=None):
    """One global-attention + dense-FFN layer; returns the new residual."""
    h, _ = blocks.attn_layer(cfg, p["attn"], h, local=False,
                             positions=positions,
                             cache=cache["attn"] if cache else None,
                             impl=impl, paged_tables=paged_tables)
    return blocks.ffn_layer(cfg, p["ffn"], h)


def _run_segment(cfg: ModelConfig, seg: Segment, seg_p: dict, h, *,
                 positions, seg_cache, impl: str, paged_tables=None):
    for r in range(seg.repeats):
        for ci, spec in enumerate(seg.cycle):
            lc = _index(seg_cache[f"c{ci}"], r) if seg_cache else None
            h = _apply_layer(cfg, spec, _index(seg_p[f"c{ci}"], r), h,
                             positions=positions, cache=lc, impl=impl,
                             paged_tables=paged_tables)
    return h


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None, mode: str = "prefill",
            impl: str = "kernel",
            paged_tables: Optional[torch.Tensor] = None) -> tuple:
    """Returns (logits [B, S, padded_vocab], cache).

    tokens: [B, S] (decode: [B, 1]).  positions: [S] int32 absolute
    positions (default ``arange(S)``); decode: a 0-d tensor with a dense
    cache, or [B] per-lane positions with a paged cache from
    ``init_paged_caches`` and its ``paged_tables`` [B, max_blocks].
    ``cache`` is updated in place and returned."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    _check_supported(cfg)
    S = tokens.shape[1]
    h = params["embed"][tokens.long()]
    if cfg.emb_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    if positions is None:
        positions = (torch.arange(S, dtype=torch.int32, device=h.device)
                     if mode == "prefill"
                     else torch.zeros((), dtype=torch.int32, device=h.device))

    for si, seg in enumerate(cfg.segments()):
        h = _run_segment(cfg, seg, params[f"seg{si}"], h,
                         positions=positions,
                         seg_cache=cache[f"seg{si}"] if cache else None,
                         impl=impl, paged_tables=paged_tables)

    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = h @ unembed.to(h.dtype)
    if cfg.padded_vocab != cfg.vocab_size:          # mask the pad ids
        pad = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    if cfg.final_logit_softcap:
        logits = softcap(logits.float(), cfg.final_logit_softcap).to(h.dtype)
    return logits, cache
