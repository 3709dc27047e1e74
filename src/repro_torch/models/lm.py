"""Model assembly for stacks of global- or sliding-window-attention
layers with a dense FFN, Mamba-2 SSD layers, RG-LRU layers with a dense
FFN and multi-head latent attention layers with a dense or a
mixture-of-experts FFN, decoder-only, behind a modality frontend (a
``frontend="vision"`` config: projected frontend rows prepend the decoder
sequence) or under a bidirectional encoder (enc-dec: every decoder layer
cross-attends to the encoder's output): parameter init, caches (dense,
per-slot dense lanes and paged, with enc-dec cross K/V as a dense leaf or
a static per-lane cross block set) and ``forward`` in prefill,
chunk-prefill, decode and train modes, with ``layer_cap`` for the
truncated draft pass of self-speculative decoding.

A port of the matching subset of ``repro.models.lm``.  Parameters and
caches keep the reference's tree —
``seg{i}/c{j}/{attn,mla,ssd,rglru,xattn,ffn,moe}/...`` (and
``frontend_proj``, or ``enc_frontend``, ``enc`` and ``enc_final_norm``)
with a stacked leading layer axis per segment — and ``_run_segment`` walks
that axis with a Python loop where the reference scans.  Cache writes
happen in place (see ``blocks``); recurrent (SSD, RG-LRU) layers return
their new conv tail and state, and this module writes them into the cache
tree (or, in a paged decode step, hands them to ``freeze_state_lanes``).
The reference's functional lane updates (``write_slot_cache``,
``lane_view``/``lane_merge``, ``write_state_lanes``) become views and
in-place writes: a forward through a ``lane_view`` or a ``slot_cache``
writes the lane itself, so nothing needs merging back; for the same
reason ``snapshot_state_lanes`` copies a lane's state rather than keeping
a view of it.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map

from . import blocks, mla, rglru, ssm
from .blocks import rms_norm, softcap
from .config import LayerSpec, ModelConfig, Segment

# serving cache group per mixer kind (the reference's mapping)
_MIXER_GROUP = {"global": "paged", "mla": "paged", "local": "window",
                "ssd": "recurrent", "rglru": "recurrent"}
# layer kinds the port runs
_PORTED = frozenset({"global+dense", "local+dense", "local+moe",
                     "ssd+none", "rglru+dense", "mla+dense", "mla+moe"})
_STATE_MIXERS = ("ssd", "rglru")
MODES = ("prefill", "decode", "train")


def unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    """Why the port cannot run ``cfg``, or None: it runs stacks of global-
    attention and RG-LRU layers (each with a dense FFN), sliding-window
    attention and MLA layers (with a dense or an MoE FFN) and SSD layers,
    decoder-only, behind a modality frontend or under an encoder: every
    arch of the reference's registry.  Other layer kinds, such as global
    attention with an MoE FFN, are refused."""
    other = sorted({s.key for s in cfg.layers()} - _PORTED)
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

def _init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                repeats: int, dtype, device, cross: bool = False) -> dict:
    """One cycle entry's parameters, stacked to ``[repeats, ...]``; with
    ``cross`` (an enc-dec decoder layer) also its cross attention
    ``xattn``, which has the same leaves as ``attn`` (its K and V project
    the encoder's output)."""
    p: dict = {}
    if spec.mixer in ("global", "local"):
        p["attn"] = blocks.init_attention(gen, cfg, repeats, dtype, device)
    elif spec.mixer == "mla":
        p["mla"] = mla.init_mla(gen, cfg, repeats, dtype, device)
    elif spec.mixer == "ssd":
        p["ssd"] = ssm.init_ssd(gen, cfg, repeats, dtype, device)
    elif spec.mixer == "rglru":
        p["rglru"] = rglru.init_rglru(gen, cfg, repeats, dtype, device)
    if cross:
        p["xattn"] = blocks.init_attention(gen, cfg, repeats, dtype, device)
    if spec.ffn == "dense":
        p["ffn"] = blocks.init_ffn(gen, cfg, repeats, dtype, device)
    elif spec.ffn == "moe":
        p["moe"] = blocks.init_moe(gen, cfg, repeats, dtype, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=torch.bfloat16) -> dict:
    """Random parameters with the reference's distributions: embed
    N(0, 0.02^2), dense weights N(0, 1/d_in), norm scales zero (SSD and
    RG-LRU leaves as ``ssm.init_ssd`` and ``rglru.init_rglru``; an MoE
    router f32 whatever ``dtype``).  A modality-frontend arch adds
    ``frontend_proj`` [frontend_dim, d_model]; an enc-dec arch adds
    ``xattn`` to every decoder layer, ``enc_frontend`` [frontend_dim,
    d_model], the encoder stack ``enc`` (``{"attn", "ffn"}`` stacked to
    ``[n_enc_layers, ...]``) and ``enc_final_norm``.
    ``device`` defaults to the CUDA card (and must be that of
    ``generator``)."""
    _check_supported(cfg)
    device = resolve_device(device)
    d = cfg.d_model
    params: dict = {
        "embed": blocks.normal_init(generator, (cfg.padded_vocab, d), 0.02,
                                    dtype, device),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = blocks.dense_init(
            generator, (d, cfg.padded_vocab), dtype, device)
    if cfg.prepended_rows:
        params["frontend_proj"] = blocks.dense_init(
            generator, (cfg.frontend_dim, d), dtype, device)
    cross = bool(cfg.n_enc_layers)
    for si, seg in enumerate(cfg.segments()):
        params[f"seg{si}"] = {
            f"c{ci}": _init_layer(generator, cfg, spec, seg.repeats, dtype,
                                  device, cross=cross)
            for ci, spec in enumerate(seg.cycle)}
    if cross:
        params["enc_frontend"] = blocks.dense_init(
            generator, (cfg.frontend_dim, d), dtype, device)
        params["enc"] = _init_layer(generator, cfg,
                                    LayerSpec("global", "dense"),
                                    cfg.n_enc_layers, dtype, device)
        params["enc_final_norm"] = torch.zeros((d,), dtype=dtype,
                                               device=device)
    return params


def _stacked(leaf: dict, repeats: int) -> dict:
    return {k: v.expand((repeats,) + v.shape).clone()
            for k, v in leaf.items()}


def init_cache(cfg: ModelConfig, batch: int, kv_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Dense decode/prefill cache mirroring the segment structure of the
    params, stacked along a leading layer axis: per attention layer
    ``{"attn": {"k", "v": [B, size, KV, hd], "pos": [size]}}`` (size
    ``kv_len``, or ``min(kv_len, window)`` for a sliding-window layer), per
    MLA layer ``{"mla": {"ckv", "krope", "pos"}}`` (``mla.init_mla_cache``),
    per SSD or RG-LRU layer ``{mixer: {"conv", "state"}}``
    (``ssm.init_ssd_cache``, ``rglru.init_rglru_cache``); an enc-dec
    decoder layer also ``{"xattn": {"k", "v": [B, frontend_tokens, KV,
    hd]}}``, the cross K/V a prefill projects from the encoder's output
    and decode reads."""
    _check_supported(cfg)
    device = resolve_device(device)

    def layer_cache(spec: LayerSpec) -> dict:
        if spec.mixer == "ssd":
            c = {"ssd": ssm.init_ssd_cache(cfg, batch, dtype, device)}
        elif spec.mixer == "rglru":
            c = {"rglru": rglru.init_rglru_cache(cfg, batch, dtype, device)}
        elif spec.mixer == "mla":
            c = {"mla": mla.init_mla_cache(cfg, batch, kv_len, dtype,
                                           device)}
        else:
            c = {"attn": blocks.init_attn_cache(
                cfg, batch, kv_len, dtype, device,
                local=spec.mixer == "local")}
        if cfg.n_enc_layers:
            shape = (batch, cfg.frontend_tokens, cfg.n_kv_heads,
                     cfg.head_dim)
            c["xattn"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}
        return c

    return {f"seg{si}": {
        f"c{ci}": {k: _stacked(v, seg.repeats)
                   for k, v in layer_cache(spec).items()}
        for ci, spec in enumerate(seg.cycle)}
        for si, seg in enumerate(cfg.segments())}


def init_slot_caches(cfg: ModelConfig, n_slots: int, kv_len: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    """Per-slot dense caches of dense-lane continuous batching: every leaf
    of the single-request cache (``init_cache(cfg, 1, kv_len)``) gains a
    leading slot axis, so each lane is an independent single-request
    cache with its own ``pos`` rows.  ``slot_cache`` gives one lane."""
    single = init_cache(cfg, 1, kv_len, dtype, device)
    return tree_map(lambda t: t.expand((n_slots,) + t.shape).clone(),
                    single)


def slot_cache(caches: dict, slot: int) -> dict:
    """Lane ``slot`` of ``init_slot_caches`` output: a single-request cache
    of views, so a forward that writes it writes the lane in place."""
    return _index(caches, slot)


def write_slot_cache(caches: dict, single: dict, slot: int) -> dict:
    """Copy a single-request cache into lane ``slot``, in place; the whole
    lane is replaced, so a new request never sees its predecessor's rows
    or state.  Returns ``caches``."""
    tree_map(lambda full, one: full[slot].copy_(one), caches, single)
    return caches


def serve_groups(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Per-layer serving report: cache group -> layer indices ("paged":
    global attention behind growing block tables; "window": sliding-window
    attention behind per-slot block rings; "recurrent": O(1) per-slot scan
    state).  Those three partition the layers; "cross" is an overlay
    naming every decoder layer of an enc-dec stack, whose cross K/V sits
    in a static per-slot cross block set.  A modality frontend has no
    group: its projected rows page through the self-attention groups."""
    out: dict[str, list[int]] = {"paged": [], "window": [], "recurrent": []}
    for li, spec in enumerate(cfg.layers()):
        out[_MIXER_GROUP[spec.mixer]].append(li)
    groups = {k: tuple(v) for k, v in out.items()}
    groups["cross"] = tuple(range(cfg.n_layers)) if cfg.n_enc_layers else ()
    return groups


def prefix_sharable_reason(cfg: ModelConfig) -> Optional[str]:
    """Why prefix-cache block sharing across requests is unavailable for
    ``cfg``, or None when it is sound (the reference's reasons, word for
    word).  A block's content must be a function of the token prefix it
    covers alone: causal global attention's K/V rows are, but any
    per-request state (encoder frames, frontend rows, window rings,
    recurrent slabs) disqualifies the whole arch."""
    if cfg.n_enc_layers:
        return ("enc-dec cross-attention mixes per-request encoder frames "
                "into every decoder layer, so block content is not a "
                "function of the token prefix")
    if cfg.frontend:
        return ("modality-frontend rows prepend per-request embeddings, so "
                "every self-attention block depends on the request's "
                "frontend content, not just its tokens")
    groups = serve_groups(cfg)
    if groups["window"]:
        return ("sliding-window layers keep per-request block rings whose "
                "entries are freed and recycled in place, never "
                "content-stable")
    if groups["recurrent"]:
        return ("recurrent-state layers carry per-request scan state "
                "slabs, not content-addressable blocks")
    return None


def prompt_block_hashes(prompt, block_size: int) -> tuple[str, ...]:
    """Content-addressed hash chain over a prompt's full cache blocks:
    ``h_i = blake2b(h_{i-1} | tokens_i)``, so equal hashes mean equal
    prefixes and a chain lookup stops at the first miss.  The partial tail
    block is never hashed (it stays private to its request).  The
    reference's chain, string for string."""
    toks = [int(t) for t in prompt]
    chain: list[str] = []
    parent = b""
    for i in range(len(toks) // block_size):
        block = toks[i * block_size:(i + 1) * block_size]
        payload = parent + b"|" + b",".join(b"%d" % t for t in block)
        h = hashlib.blake2b(payload, digest_size=16).hexdigest()
        chain.append(h)
        parent = h.encode()
    return tuple(chain)


def init_paged_caches(cfg: ModelConfig, n_slots: int, n_pages: int,
                      block_size: int, dtype=torch.bfloat16,
                      device=None) -> dict:
    """Paged decode cache, stacked to ``[repeats, ...]`` like
    ``init_cache``: per attention layer a pair of ``[n_pages, block_size,
    KV, hd]`` K/V pools (no slot axis: lanes are carved out by block
    tables, a sliding-window layer's by window ring tables), per MLA layer
    a ``[n_pages, block_size, kv_lora_rank]`` latent pool and a
    ``[n_pages, block_size, qk_rope_dim]`` RoPE-key pool, per SSD or
    RG-LRU layer slot-stacked recurrent state ``[repeats, n_slots, ...]``
    (one lane per slot, no blocks), and per enc-dec decoder layer an
    ``xattn`` K/V pool pair addressed through per-slot static cross tables
    (written once at admission, never extended)."""
    _check_supported(cfg)
    device = resolve_device(device)

    def leaf(spec: LayerSpec) -> dict:
        if spec.mixer == "ssd":
            c = {"ssd": ssm.init_ssd_cache(cfg, n_slots, dtype, device)}
        elif spec.mixer == "rglru":
            c = {"rglru": rglru.init_rglru_cache(cfg, n_slots, dtype,
                                                 device)}
        elif spec.mixer == "mla":
            c = {"mla": mla.init_paged_mla_cache(cfg, n_pages, block_size,
                                                 dtype, device)}
        else:
            c = {"attn": blocks.init_paged_attn_cache(cfg, n_pages,
                                                      block_size, dtype,
                                                      device)}
        if cfg.n_enc_layers:
            c["xattn"] = blocks.init_paged_attn_cache(cfg, n_pages,
                                                      block_size, dtype,
                                                      device)
        return c

    return {f"seg{si}": {
        f"c{ci}": {k: _stacked(v, seg.repeats)
                   for k, v in leaf(spec).items()}
        for ci, spec in enumerate(seg.cycle)}
        for si, seg in enumerate(cfg.segments())}


def _cache_entries(cfg: ModelConfig, caches: dict):
    for si, seg in enumerate(cfg.segments()):
        for ci, spec in enumerate(seg.cycle):
            yield spec, caches[f"seg{si}"][f"c{ci}"]


def paged_cache_leaves(cfg: ModelConfig, caches: dict) -> list[tuple]:
    """(group, (a_key, b_key), leaf) for every physical pool leaf, in a
    fixed order: group "global" for global attention and MLA latents,
    "window" for sliding-window attention, "cross" for an enc-dec layer's
    cross K/V (after its layer's self-attention leaf); the engine binds
    one ``PagedKVStore`` per leaf, tagged with its group.  Recurrent state
    leaves are not listed (see ``state_cache_leaves``)."""
    out = []
    for spec, entry in _cache_entries(cfg, caches):
        if spec.mixer in ("global", "local"):
            out.append(("window" if spec.mixer == "local" else "global",
                        ("k_pages", "v_pages"), entry["attn"]))
        elif spec.mixer == "mla":
            out.append(("global", ("ckv_pages", "krope_pages"),
                        entry["mla"]))
        if "xattn" in entry:
            out.append(("cross", ("k_pages", "v_pages"), entry["xattn"]))
    return out


def state_cache_leaves(cfg: ModelConfig, caches: dict) -> list[dict]:
    """Slot-stacked recurrent state leaves ([repeats, n_slots, ...]
    tensors), in a fixed order."""
    return [entry[spec.mixer] for spec, entry in _cache_entries(cfg, caches)
            if spec.mixer in _STATE_MIXERS]


def state_bytes_per_slot(cfg: ModelConfig, caches: dict) -> int:
    """Device bytes one decode lane pins in recurrent state leaves."""
    return sum(t.numel() // t.shape[1] * t.element_size()
               for leaf in state_cache_leaves(cfg, caches)
               for t in leaf.values())


def _scatter_state(full: dict, one: dict, slot: int) -> None:
    """Copy a batch-1 state leaf (``[repeats, 1, ...]`` tensors) into lane
    ``slot`` of the slot-stacked leaf (``[repeats, n_slots, ...]``), in
    place."""
    for k, t in full.items():
        t[:, slot].copy_(one[k][:, 0])


def lane_view(cfg: ModelConfig, caches: dict, slot: int) -> dict:
    """Chunk-prefill view of the paged tree for one lane: recurrent state
    leaves narrowed to lane ``slot`` (batch 1, views, so the forward's
    state write-back carries the lane's scan state from chunk to chunk in
    place); pool leaves pass through whole."""
    out: dict = {}
    for si, seg in enumerate(cfg.segments()):
        out[f"seg{si}"] = seg_view = {}
        for ci, spec in enumerate(seg.cycle):
            entry = caches[f"seg{si}"][f"c{ci}"]
            if spec.mixer in _STATE_MIXERS:
                entry = {**entry, spec.mixer: {
                    k: t[:, slot:slot + 1]
                    for k, t in entry[spec.mixer].items()}}
            seg_view[f"c{ci}"] = entry
    return out


def snapshot_state_lanes(cfg: ModelConfig, caches: dict, slot: int) -> list:
    """Copies (not views) of lane ``slot``'s recurrent state leaves in the
    paged tree, in ``state_cache_leaves`` order: the pre-draft snapshot of
    a speculative round.  Only the O(1) lane state is kept; the draft and
    verify passes write the tree in place, so a view would follow them."""
    return [{k: t[:, slot].clone() for k, t in leaf.items()}
            for leaf in state_cache_leaves(cfg, caches)]


def restore_state_lanes(cfg: ModelConfig, caches: dict, snapshot: list,
                        slot: int) -> dict:
    """Write a ``snapshot_state_lanes`` capture back into lane ``slot``, in
    place: the rewind after a draft pass advanced the lane's state, or a
    verify pass advanced it past the accepted tokens.  Returns
    ``caches``."""
    for leaf, snap in zip(state_cache_leaves(cfg, caches), snapshot):
        for k, t in leaf.items():
            t[:, slot].copy_(snap[k])
    return caches


def zero_state_lane(cfg: ModelConfig, caches: dict, slot: int) -> dict:
    """Zero lane ``slot``'s recurrent state leaves in the paged tree, in
    place (the reference writes a zeroed single-request cache into the
    lane with ``write_state_lanes``): a reused lane's state is reset before
    chunked prefill starts carrying state into it.  Returns ``caches``."""
    for leaf in state_cache_leaves(cfg, caches):
        for t in leaf.values():
            t[:, slot].zero_()
    return caches


def mask_cache_positions(cache: dict, true_len: int) -> dict:
    """Mark every dense-cache slot holding a position ``>= true_len`` empty
    (-1), in place: after a bucketed prefill the pad rows' K/V can never
    be attended.  Recurrent state needs no masking: the forward's
    ``valid_len`` froze it at the real prompt.  Returns ``cache``."""
    for key, val in cache.items():
        if key == "pos":
            val.masked_fill_(val >= true_len, -1)
        elif isinstance(val, dict):
            mask_cache_positions(val, true_len)
    return cache


def freeze_state_lanes(cfg: ModelConfig, caches: dict, updates: dict,
                       active: torch.Tensor) -> dict:
    """Write a batched paged decode step's new recurrent state into the
    slot-stacked slabs, for the active lanes only, in place.

    ``updates`` maps ``(segment, cycle entry, repeat)`` to the new leaves
    (``{"conv": [n_slots, ...], "state": [n_slots, ...]}``) a layer computed
    for every lane; ``active``: [n_slots] bool on the device.  The batched
    step runs every lane, retired ones included, and a recurrent layer
    would fold those lanes' garbage tokens into their slabs (attention
    lanes are safe: their writes go through null table rows).  Each slab
    is read and written through the same view, by one select on the
    device: no slab is copied aside and the host never waits.  Returns
    ``caches``."""
    segs = cfg.segments()
    for (si, ci, r), new in updates.items():
        mixer = segs[si].cycle[ci].mixer
        leaf = caches[f"seg{si}"][f"c{ci}"][mixer]
        for k, t in new.items():
            slab = leaf[k][r]
            keep = active.reshape((-1,) + (1,) * (slab.dim() - 1))
            torch.where(keep, t.to(slab.dtype), slab, out=slab)
    return caches


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
                        tables: dict, slot: int, *, block_size: int,
                        null_block: int, skip_below: int = 0) -> dict:
    """Scatter a dense single-request prefill cache (``init_cache(cfg, 1,
    kv_len)`` after a prefill) into the paged tree, in place: attention
    and MLA latent rows go to the physical blocks the lane's table row
    names (``tables["global"]``, or ``tables["window"]`` for a
    sliding-window layer, [W] each), at their absolute positions (rows
    whose position is
    -1, or whose block the table does not cover, as behind a window ring,
    go to the null page); SSD and RG-LRU conv tail and state go into lane
    ``slot``; an enc-dec layer's cross K/V rows go to the lane's static
    cross block set (``tables["cross"]``) at positions ``0..F-1``.  Other
    lanes are untouched.

    ``skip_below`` masks the attention writes below that position (their
    position becomes -1, so they land on the null page): on a prefix-cache
    hit those rows are already resident in shared blocks, which other
    slots read, and must not be written again.  The prefill still computed
    them.  Returns ``caches``."""
    for (spec, entry), (_, one) in zip(_cache_entries(cfg, caches),
                                       _cache_entries(cfg, single)):
        if "xattn" in entry:
            _insert_cross_leaf(entry["xattn"], one["xattn"], tables["cross"],
                               block_size, null_block)
        if spec.mixer in _STATE_MIXERS:
            _scatter_state(entry[spec.mixer], one[spec.mixer], slot)
            continue
        if spec.mixer == "mla":
            leaf, sl = entry["mla"], one["mla"]
            pools = (("ckv_pages", sl["ckv"]), ("krope_pages", sl["krope"]))
        else:
            leaf, sl = entry["attn"], one["attn"]
            pools = (("k_pages", sl["k"]), ("v_pages", sl["v"]))
        cpos = sl["pos"][0]                 # identical across repeats
        if skip_below:
            cpos = cpos.masked_fill(cpos < skip_below, -1)
        row = tables["window" if spec.mixer == "local" else "global"]
        for pool, rows in pools:
            _scatter_rows(leaf[pool], row, cpos, rows[:, 0],
                          block_size=block_size, null_block=null_block)
    return caches


def _insert_cross_leaf(leaf: dict, one: dict, row, block_size: int,
                       null_block: int) -> None:
    """A batch-1 cross K/V leaf (``{"k", "v": [repeats, 1, F, KV, hd]}``)
    into a cross pool pair through the lane's static cross table row, at
    positions ``0..F-1``, in place."""
    fpos = torch.arange(one["k"].shape[2], dtype=torch.int32,
                        device=row.device)
    for pool, key in (("k_pages", "k"), ("v_pages", "v")):
        _scatter_rows(leaf[pool], row, fpos, one[key][:, 0],
                      block_size=block_size, null_block=null_block)


def encode_cross_single(cfg: ModelConfig, params: dict,
                        frontend_emb: torch.Tensor) -> dict:
    """Encode at admission (chunked prefill): run the encoder once over one
    request's frame embeddings ([1, F, frontend_dim]) and project every
    decoder layer's cross K/V.  Returns the dense single-request cache tree
    restricted to its ``xattn`` leaves (``{"k", "v": [repeats, 1, F, KV,
    hd]}``), which ``insert_cross_rows`` scatters into the lane's static
    cross block set."""
    enc_out = _encode(cfg, params, frontend_emb)
    out: dict = {}
    for si, seg in enumerate(cfg.segments()):
        seg_p = params[f"seg{si}"]
        out[f"seg{si}"] = {}
        for ci in range(len(seg.cycle)):
            xp = seg_p[f"c{ci}"]["xattn"]
            kv = [_cross_kv(cfg, _index(xp, r), enc_out)
                  for r in range(seg.repeats)]
            out[f"seg{si}"][f"c{ci}"] = {"xattn": {
                "k": torch.stack([k for k, _ in kv]),
                "v": torch.stack([v for _, v in kv])}}
    return out


def insert_cross_rows(cfg: ModelConfig, caches: dict, cross_single: dict,
                      row: torch.Tensor, *, block_size: int,
                      null_block: int) -> dict:
    """Scatter one request's projected cross K/V rows
    (``encode_cross_single``) into the cross pools through its static cross
    table row [W], in place.  Returns ``caches``."""
    for (_, entry), (_, one) in zip(_cache_entries(cfg, caches),
                                    _cache_entries(cfg, cross_single)):
        _insert_cross_leaf(entry["xattn"], one["xattn"], row, block_size,
                           null_block)
    return caches


def embed_prompt_rows(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                      frontend_emb: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """One request's decoder input rows as ``forward`` embeds them: token
    embeddings (emb-scaled), after the projected frontend rows for a
    modality-frontend arch.  ``tokens``: [S]; ``frontend_emb``: [F,
    frontend_dim].  Returns [F + S, d_model] ([S, d_model] otherwise):
    chunked prefill slices these rows, so a chunk may straddle the
    frontend/token boundary."""
    h = embed_tokens(cfg, params, tokens)
    if cfg.prepended_rows:
        if frontend_emb is None:
            raise ValueError(f"{cfg.name}: a modality-frontend prompt needs "
                             "frontend_emb")
        fe = frontend_emb.to(h.dtype) @ params["frontend_proj"]
        h = torch.cat([fe, h], dim=0)
    return h


def copy_paged_block(cfg: ModelConfig, caches: dict, src: int,
                     dst: int) -> dict:
    """Copy physical page ``src`` onto ``dst`` in every global-group pool
    leaf (attention K/V and MLA latents), in place: the physical half of a
    prefix-cache copy-on-write fork.  Window pools and recurrent state are
    never shared, so they are untouched.  Returns ``caches``."""
    for spec, entry in _cache_entries(cfg, caches):
        if spec.mixer in ("global", "mla"):
            for pool in entry["attn" if spec.mixer == "global"
                              else "mla"].values():
                pool[:, dst].copy_(pool[:, src])
    return caches


# =============================================================================
# forward
# =============================================================================

StateSink = Callable[[tuple, dict], None]


def _index(tree: dict, r: int) -> dict:
    """Layer ``r`` of a stacked tree (views, so writes reach the stack)."""
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Token embeddings, times sqrt(d_model) where the config says so."""
    h = params["embed"][tokens.long()]
    if cfg.emb_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def _cross_kv(cfg: ModelConfig, xp: dict, enc_out: torch.Tensor) -> tuple:
    """One decoder layer's cross K/V [B, F, KV, hd] projected from the
    encoder's output [B, F, d_model] (no RoPE)."""
    he = rms_norm(enc_out, xp["ln"], cfg.norm_eps)
    B, F, _ = he.shape
    shape = (B, F, cfg.n_kv_heads, cfg.head_dim)
    return (he @ xp["wk"]).reshape(shape), (he @ xp["wv"]).reshape(shape)


def _encode(cfg: ModelConfig, params: dict,
            frontend_emb: torch.Tensor) -> torch.Tensor:
    """The bidirectional encoder (non-causal self-attention with RoPE, then
    the FFN, per layer) over stub frame embeddings [B, F, frontend_dim];
    returns [B, F, d_model].  Its attention is the plain one whatever the
    caller's ``impl``, as the reference runs its own plain (``chunked``)
    attention here."""
    enc_p = params["enc_frontend"]
    he = frontend_emb.to(enc_p.dtype) @ enc_p
    B, F = he.shape[0], he.shape[1]
    e_pos = torch.arange(F, dtype=torch.int32, device=he.device)
    for r in range(cfg.n_enc_layers):
        pa = _index(params["enc"]["attn"], r)
        hn = rms_norm(he, pa["ln"], cfg.norm_eps)
        q = (hn @ pa["wq"]).reshape(B, F, cfg.n_heads, cfg.head_dim)
        k = (hn @ pa["wk"]).reshape(B, F, cfg.n_kv_heads, cfg.head_dim)
        v = (hn @ pa["wv"]).reshape(B, F, cfg.n_kv_heads, cfg.head_dim)
        q = blocks.apply_rope(q, e_pos, cfg.rope_theta)
        k = blocks.apply_rope(k, e_pos, cfg.rope_theta)
        o = blocks.attention(q, k, v, q_positions=e_pos, k_positions=e_pos,
                             causal=False, impl="plain")
        he = he + o.reshape(B, F, cfg.q_dim) @ pa["wo"]
        he = blocks.ffn_layer(cfg, _index(params["enc"]["ffn"], r), he)
    return rms_norm(he, params["enc_final_norm"], cfg.norm_eps)


def _cross_attend(cfg: ModelConfig, p: dict, h, *, positions,
                  cache: Optional[dict], enc_out, cross_tables, impl: str):
    """An enc-dec decoder layer's cross attention (non-causal, no RoPE)
    over one of three K/V sources, as the reference's ``_apply_layer``
    picks them: the lane's static cross block set gathered through
    ``cross_tables`` [B, W] (rows past F, on the null page, take position
    -1 and add exact zeros); K/V projected from ``enc_out``, also written
    into a dense cache's ``xattn`` leaf; or that leaf, cached."""
    F = cfg.frontend_tokens
    xc = cache.get("xattn") if cache else None
    k_pos = None
    if xc is not None and "k_pages" in xc:
        if cross_tables is None:
            raise ValueError("paged cross K/V needs cross tables")
        kp, vp = xc["k_pages"], xc["v_pages"]
        B_l, W = cross_tables.shape
        Lc = W * kp.shape[1]
        idx = cross_tables.long()
        xk = kp[idx].reshape((B_l, Lc) + tuple(kp.shape[2:]))
        xv = vp[idx].reshape((B_l, Lc) + tuple(vp.shape[2:]))
        j = torch.arange(Lc, dtype=torch.int32, device=h.device)
        k_pos = torch.where(j < F, j, -1).to(torch.int32)
    elif enc_out is not None:
        xk, xv = _cross_kv(cfg, p, enc_out)
        if xc is not None:
            xc["k"].copy_(xk)
            xc["v"].copy_(xv)
    elif xc is not None:
        xk, xv = xc["k"], xc["v"]
    else:
        raise ValueError(f"{cfg.name}: enc-dec cross attention needs "
                         "frontend_emb or a populated cross K/V cache")
    if k_pos is None:
        k_pos = torch.arange(xk.shape[1], dtype=torch.int32,
                             device=h.device)
    h, _ = blocks.attn_layer(cfg, p, h, local=False, positions=positions,
                             impl=impl, kv_override=(xk, xv, k_pos))
    return h


def _apply_layer(cfg: ModelConfig, spec: LayerSpec, p: dict, h, *,
                 positions, cache: Optional[dict], impl: str,
                 paged_tables=None, window_tables=None, key: tuple = (),
                 state_sink: Optional[StateSink] = None, valid_len=None,
                 moe_kw: Optional[dict] = None, enc_out=None,
                 cross_tables=None):
    """One layer (global or sliding-window attention, MLA, SSD or RG-LRU,
    then an enc-dec layer's cross attention, then its dense or MoE FFN);
    returns (the new residual, the MoE layer's router aux loss, or None
    for a layer without one).  ``moe_kw``: the MoE layer's
    ``capacity_factor``, ``n_groups`` and ``lossless``."""
    if spec.mixer in _STATE_MIXERS:
        layer = ssm.ssd_layer if spec.mixer == "ssd" else rglru.rglru_layer
        sc = cache[spec.mixer] if cache else None
        h, new = layer(cfg, p[spec.mixer], h, cache=sc, impl=impl,
                       valid_len=valid_len)
        if new is not None:
            if state_sink is not None and h.shape[1] == 1:
                state_sink(key, new)
            else:
                for k, t in new.items():
                    sc[k].copy_(t)
    elif spec.mixer == "mla":
        h, _ = mla.mla_layer(cfg, p["mla"], h, positions=positions,
                             cache=cache["mla"] if cache else None,
                             impl=impl, paged_tables=paged_tables)
    else:
        local = spec.mixer == "local"
        h, _ = blocks.attn_layer(cfg, p["attn"], h, local=local,
                                 positions=positions,
                                 cache=cache["attn"] if cache else None,
                                 impl=impl,
                                 paged_tables=(window_tables if local
                                               else paged_tables),
                                 valid_len=valid_len)
    if "xattn" in p:
        h = _cross_attend(cfg, p["xattn"], h, positions=positions,
                          cache=cache, enc_out=enc_out,
                          cross_tables=cross_tables, impl=impl)
    aux = None
    if spec.ffn == "dense":
        h = blocks.ffn_layer(cfg, p["ffn"], h)
    elif spec.ffn == "moe":
        h, aux = blocks.moe_layer(cfg, p["moe"], h, **(moe_kw or {}))
    return h, aux


def _add_aux(total, aux):
    """The running aux total plus one more (None: no MoE layer yet)."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _run_segment(cfg: ModelConfig, si: int, seg: Segment, seg_p: dict, h,
                 *, positions, seg_cache, impl: str, paged_tables=None,
                 window_tables=None,
                 state_sink: Optional[StateSink] = None, valid_len=None,
                 remat: bool = False, repeats: Optional[int] = None,
                 moe_kw: Optional[dict] = None, enc_out=None,
                 cross_tables=None):
    """The segment's first ``repeats`` repeats (default all) in order; the
    others, and their cache rows, are left alone.  Returns (h, the sum of
    its MoE layers' aux losses or None).  ``remat``: each repeat's
    activations are recomputed in the backward pass instead of kept, as
    ``jax.checkpoint`` around the reference's scan body does."""
    total = None
    for r in range(seg.repeats if repeats is None else repeats):
        def body(h, r=r):
            aux = None
            for ci, spec in enumerate(seg.cycle):
                lc = _index(seg_cache[f"c{ci}"], r) if seg_cache else None
                h, a = _apply_layer(cfg, spec, _index(seg_p[f"c{ci}"], r), h,
                                    positions=positions, cache=lc, impl=impl,
                                    paged_tables=paged_tables,
                                    window_tables=window_tables,
                                    key=(si, ci, r), state_sink=state_sink,
                                    valid_len=valid_len, moe_kw=moe_kw,
                                    enc_out=enc_out,
                                    cross_tables=cross_tables)
                aux = _add_aux(aux, a)
            return h, aux

        h, aux = (checkpoint(body, h, use_reentrant=False,
                             preserve_rng_state=False) if remat else body(h))
        total = _add_aux(total, aux)
    return h, total


def forward(cfg: ModelConfig, params: dict,
            tokens: Optional[torch.Tensor], *,
            positions: Optional[torch.Tensor] = None,
            frontend_emb: Optional[torch.Tensor] = None,
            input_embeds: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None, mode: str = "prefill",
            impl: str = "kernel",
            paged_tables: Optional[torch.Tensor] = None,
            window_tables: Optional[torch.Tensor] = None,
            cross_tables: Optional[torch.Tensor] = None,
            state_sink: Optional[StateSink] = None,
            valid_len: Optional[int] = None,
            remat: Optional[bool] = None,
            layer_cap: Optional[int] = None,
            n_groups: int = 1, capacity_factor: float = 1.25,
            moe_lossless: Optional[bool] = None) -> tuple:
    """Returns (logits [B, S, padded_vocab], cache, aux) in every mode:
    ``aux`` is the f32 sum of the MoE layers' router aux losses (0 without
    MoE layers), which serving discards and the train step adds to the
    loss.

    tokens: [B, S] (decode: [B, 1]).  positions: [S] int32 absolute
    positions (default ``arange`` over the decoder sequence, a modality
    frontend's rows first); decode: a 0-d tensor with a dense
    cache, or [B] per-lane positions with a paged cache from
    ``init_paged_caches`` and its ``paged_tables`` [B, max_blocks] (global
    layers) and ``window_tables`` [B, max_blocks] (sliding-window layers:
    window ring tables, entries behind the window null).  ``cache`` is
    updated in place and returned.  ``state_sink(key,
    leaves)``, when given, receives each recurrent layer's new decode state
    instead of the cache (``key`` = (segment, cycle entry, repeat)): a
    paged decode step passes it on to ``freeze_state_lanes``.

    ``frontend_emb`` [B, F, frontend_dim] (prefill and train): a
    modality-frontend arch projects it and prepends the F rows to the
    token rows; an enc-dec arch runs the encoder over it, and each decoder
    layer cross-attends to the encoder's output (and writes its cross K/V
    into a dense cache's ``xattn`` leaves).  Decode reads cached cross
    K/V, or with a paged cache the lanes' static cross block sets through
    ``cross_tables`` [B, W]; an enc-dec prefill without ``frontend_emb``
    must carry ``cross_tables`` (the serving chunk path), anything else
    raises.  ``input_embeds`` [B, S, d_model] replaces the embedding
    lookup (``embed_prompt_rows`` slices; ``tokens`` is then ignored).

    Paged chunk prefill: tokens [1, C], positions the chunk's [C] rows,
    ``paged_tables``/``window_tables`` the lane's [1, max_blocks] rows and
    ``cache`` a ``lane_view``.  ``valid_len`` (prefill only): rows at or
    past it are padding (a bucketed prompt's tail, a final chunk's); they
    never displace real window-ring rows and the recurrent state freezes
    past them.

    ``layer_cap``: run only the first ``layer_cap`` layers, rounded up to
    whole cycle repeats within a segment (a cycle is never split), before
    the final norm and unembedding: the truncated draft pass of
    self-speculative decoding.  The layers not run, and their cache rows,
    are left as they are.

    MoE layers dispatch in ``n_groups`` groups with ``capacity_factor`` per
    expert, or drop nothing with ``moe_lossless`` (None: lossless in decode
    mode only, the reference's default).  Serving passes
    ``moe_lossless=True`` everywhere, as the reference's engines do: what a
    capacity drops depends on how many rows share the pass, so a chunk or a
    bucket would change tokens.

    Train mode (``mode="train"``): no cache, positions ``arange(S)``, and
    ``impl="plain"`` only, since no kernel of this package or of the
    reference has a backward; the plain layers run under autograd.
    ``remat`` (train mode only; None means on) recomputes each segment
    repeat's activations in the backward pass.  Returns (logits, None,
    aux)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    train = mode == "train"
    remat = train if remat is None else remat
    if train:
        if impl != "plain":
            raise ValueError(
                f"train mode runs impl='plain', got {impl!r}: no kernel "
                "of this package or of the reference has a backward")
        if (cache is not None or paged_tables is not None
                or window_tables is not None or valid_len is not None):
            raise ValueError("train mode takes no cache, tables or "
                             "valid_len")
    elif remat:
        raise ValueError("remat applies to train mode only")
    _check_supported(cfg)
    if moe_lossless is None:
        moe_lossless = mode == "decode"
    moe_kw = {"capacity_factor": capacity_factor, "n_groups": n_groups,
              "lossless": moe_lossless}
    decode = mode == "decode"
    enc_out = None
    if cfg.n_enc_layers and not decode:
        if frontend_emb is not None:
            enc_out = _encode(cfg, params, frontend_emb)
        elif cross_tables is None:
            # only the serving chunk path, which reads the cross block
            # set, may prefill without the encoder: anything else would
            # cross-attend to a zeroed cache
            raise ValueError(f"{cfg.name}: enc-dec train/prefill needs "
                             "frontend_emb")
    if input_embeds is not None:
        h = input_embeds
    else:
        h = embed_tokens(cfg, params, tokens)
        if cfg.prepended_rows and not decode:
            if frontend_emb is None:
                raise ValueError(f"{cfg.name}: a modality-frontend prefill "
                                 "needs frontend_emb")
            fe = frontend_emb.to(h.dtype) @ params["frontend_proj"]
            h = torch.cat([fe, h], dim=1)
    S = h.shape[1]
    if positions is None:
        positions = (torch.arange(S, dtype=torch.int32, device=h.device)
                     if mode != "decode"
                     else torch.zeros((), dtype=torch.int32, device=h.device))

    remaining = None if layer_cap is None else max(int(layer_cap), 1)
    aux_total = None
    for si, seg in enumerate(cfg.segments()):
        repeats = None
        if remaining is not None:
            clen = len(seg.cycle)
            repeats = (min(seg.repeats, -(-remaining // clen))
                       if remaining > 0 else 0)
            remaining -= repeats * clen
        h, aux = _run_segment(cfg, si, seg, params[f"seg{si}"], h,
                              positions=positions,
                              seg_cache=cache[f"seg{si}"] if cache else None,
                              impl=impl, paged_tables=paged_tables,
                              window_tables=window_tables,
                              state_sink=state_sink, valid_len=valid_len,
                              remat=remat, repeats=repeats, moe_kw=moe_kw,
                              enc_out=enc_out, cross_tables=cross_tables)
        aux_total = _add_aux(aux_total, aux)

    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = h @ unembed.to(h.dtype)
    if cfg.padded_vocab != cfg.vocab_size:          # mask the pad ids
        pad = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    if cfg.final_logit_softcap:
        logits = softcap(logits.float(), cfg.final_logit_softcap).to(h.dtype)
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    return logits, cache, aux_total
