"""Serving: step factories, the static-batch ``Engine`` and the
continuous-batching ``ContinuousEngine``.

A port of ``repro.serve.engine``: dense and paged lanes; whole, bucketed
and chunked prefill; per-request sampling; self-speculative decoding;
worst-case or lazy admission pricing with youngest-slot preemption; the
content-addressed prefix cache and the block export and import of the
prefill -> decode handoff.  ``ContinuousEngine`` admits queued requests
into free decode lanes mid-stream (``SlotScheduler`` + ``BlockAllocator``)
and serves them in one of two regimes:

* ``paged=True`` — each prompt is prefilled whole into a dense
  single-request cache and scattered into the shared page pools (global
  layers through the lane's block table, sliding-window layers through its
  window block ring) and, for recurrent (SSD, RG-LRU) layers, into the
  lane's state slabs (``lm.insert_paged_prompt``); or, with
  ``prefill_chunk=C``, it is prefilled C rows per engine step straight
  into the pools and slabs, interleaved with the decode of running lanes,
  the recurrent state carried from chunk to chunk.  All decoding lanes
  then run one batched step that writes each lane's row through its table
  and attends with the paged kernel, and advances the state slabs of the
  decoding lanes only (``lm.freeze_state_lanes``).  Before each step a
  window ring slides forward and frees the blocks that fell fully behind
  the window.
* ``paged=False`` — dense lanes: per-slot dense caches
  (``lm.init_slot_caches``), each prompt's prefill copied into its lane,
  and each decoding lane stepped as a B=1 decode on its own cache (the
  reference vmaps the same step over the lanes).

Sampling (``submit(..., sampling=SamplingParams(...))``): each lane keeps
its base key and parameters on the device, and a step samples every lane
at once (``sampling.sample_lanes``) when any decoding lane samples; when
all are greedy the steps keep their fused argmax, which the sampler would
pick bitwise.  ``speculate=K`` (paged only) drafts up to K tokens per lane
and step with the first ``draft_layers`` layers (``lm.forward(layer_cap=)``),
scores them in one chunk-shaped verify pass of the full model, accepts by
rejection sampling (``sampling.speculative_accept``; token-identical to
greedy decoding under greedy) and rewinds the lane's table, window ring
and recurrent state past the first rejection.  ``pricing="lazy"``
reserves only a request's prefill at admission; a mid-decode
``CacheExhausted`` then preempts the youngest slot and requeues its
request at the head of the queue (``cache_blocks=`` undersizes the pool).

``prefix_cache=True`` (paged, and only for archs whose cache content is a
function of the token prefix, ``lm.prefix_sharable_reason``) shares the
blocks of a prompt's longest committed prefix read-only at admission.
Chunked prefill starts at the first uncached position; whole prefill
still computes the whole prompt and masks the writes below it
(``insert_paged_prompt(skip_below=)``).  At least the last prompt position
is recomputed, for the first token's logits; when it falls inside a
shared block (a block-aligned whole hit), that block is forked
copy-on-write (``lm.copy_paged_block``) before anything writes it.  A
finished prefill commits its full prompt blocks to the index.

``bucket_prompts=True`` right-pads whole prefills to power-of-two buckets
(``bucket_length``): pad rows are position-masked in the cache and freeze
the recurrent state (``valid_len``).  Each lane computes exactly the B=1
decode path, so its tokens match ``Engine.generate`` on that request alone:
the gathered paged view has exactly ``kv_len`` rows (``kv_len %
block_size == 0`` is enforced when a paged model has attention layers) and
masked rows add exact zeros.

``impl="kernel"`` (default) launches the hand-written Hopper kernels on
CUDA tensors (their plain versions on CPU tensors); ``impl="plain"`` is
the plain PyTorch reference path.  Every serving forward dispatches MoE
layers lossless (``lm.forward(moe_lossless=True)``), as the reference's
engines do: capacity drops depend on the rows sharing a pass, so a bucket,
a chunk or a batch of lanes would otherwise change a request's tokens.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.runtime.telemetry import ServeTelemetry

from . import sampling as sampling_mod
from .cache import (BlockAllocator, CacheConfig, CacheExhausted, CacheLayout,
                    PagedKVStore)
from .sampling import GREEDY, SamplingParams
from .scheduler import ActiveSlot, Request, SlotScheduler

PREFILL_BUCKET_FLOOR = 8


def bucket_length(n: int, cap: int, floor: int = PREFILL_BUCKET_FLOOR) -> int:
    """Smallest power-of-two bucket >= n (>= floor), clamped to cap."""
    b = max(floor, 1 << max(0, (n - 1).bit_length()))
    return min(max(b, n), cap)


def _pick_token(row: torch.Tensor, sample_args) -> torch.Tensor:
    """Next token from ``[B, vocab]`` last-position logits: the fused
    argmax when ``sample_args`` is None, else the sample of a B == 1 lane,
    ``sample_args = (key [2], temperature, top_k, top_p)`` (the sampler
    picks the argmax bitwise at temperature 0)."""
    if sample_args is None:
        return row.argmax(dim=-1).to(torch.int32)
    key, temp, topk, topp = sample_args
    return sampling_mod.sample_token(row[0], key, temp, topk, topp)[None]


def make_prefill_step(cfg: ModelConfig, impl: str = "kernel"):
    """prefill(params, cache, tokens [B, S], frontend_emb=None,
    sample_args=None) -> (next_tok [B], cache); ``frontend_emb`` [B, F,
    frontend_dim] for a modality-frontend or enc-dec arch."""
    def prefill_step(params, cache, tokens, frontend_emb=None,
                     sample_args=None):
        logits, cache, _ = lm.forward(cfg, params, tokens, cache=cache,
                                      frontend_emb=frontend_emb,
                                      mode="prefill", impl=impl,
                                      moe_lossless=True)
        return _pick_token(logits[:, -1, :cfg.vocab_size], sample_args), \
            cache
    return prefill_step


def make_serve_step(cfg: ModelConfig, impl: str = "kernel"):
    """decode(params, cache, tokens [B, 1], pos 0-d, sample_args=None) ->
    (next_tok, cache)."""
    def serve_step(params, cache, tokens, pos, sample_args=None):
        logits, cache, _ = lm.forward(cfg, params, tokens, positions=pos,
                                      cache=cache, mode="decode", impl=impl,
                                      moe_lossless=True)
        return _pick_token(logits[:, -1, :cfg.vocab_size], sample_args), \
            cache
    return serve_step


def make_bucketed_prefill_step(cfg: ModelConfig, impl: str = "kernel"):
    """prefill(params, cache, tokens [B, Sb], true_len, frontend_emb=None,
    sample_args=None) -> (next_tok [B], cache).  The prompt is
    right-padded to a bucket length Sb; causality makes the logits at
    ``true_len - 1`` exact, ``valid_len=true_len`` freezes the recurrent
    state at the real prompt (and keeps pad rows out of window rings), and
    the pad rows' cache slots are marked empty
    (``lm.mask_cache_positions``), so decode never attends them.  A
    modality frontend's F rows come first, so each of those boundaries
    moves F rows on (the frontend rows are never padding)."""
    F = cfg.prepended_rows

    def prefill_step(params, cache, tokens, true_len, frontend_emb=None,
                     sample_args=None):
        logits, cache, _ = lm.forward(cfg, params, tokens, cache=cache,
                                      frontend_emb=frontend_emb,
                                      mode="prefill", impl=impl,
                                      valid_len=true_len + F,
                                      moe_lossless=True)
        tok = _pick_token(logits[:, F + true_len - 1, :cfg.vocab_size],
                          sample_args)
        return tok, lm.mask_cache_positions(cache, true_len + F)
    return prefill_step


def make_chunk_prefill_step(cfg: ModelConfig, chunk: int,
                            impl: str = "kernel"):
    """chunk(params, caches, piece [1, C], start, rows {"global": [W],
    "window": [W], "cross": [Wc]}, last_idx, slot, valid,
    sample_args=None) -> (candidate_tok [1], caches).

    One C-row slice of a prompt, straight against the paged tree: its rows
    are written through the lane's tables (global blocks, window ring),
    the lane's recurrent state slabs carry the scan across slices
    (``lm.lane_view``), attention reads everything resident so far, and
    the token is read at ``last_idx`` (meaningful on the final slice
    only).  ``valid`` counts the slice's real rows: a final slice's pad
    rows freeze the recurrent state, and their K/V rows land past the
    lane's context (on the null page where the table does not reach),
    where no query reads them.  An enc-dec arch also cross-attends to the
    lane's static cross block set, written at admission.

    A modality-frontend arch's ``piece`` is a [1, C, d_model] slice of
    the request's decoder input rows (``lm.embed_prompt_rows``), so a
    chunk may straddle the frontend/token boundary."""
    embeds = bool(cfg.prepended_rows)

    def chunk_step(params, caches, piece, start, rows, last_idx, slot,
                   valid, sample_args=None):
        positions = start + torch.arange(chunk, dtype=torch.int32,
                                         device=piece.device)
        logits, _, _ = lm.forward(
            cfg, params, None if embeds else piece,
            input_embeds=piece if embeds else None, positions=positions,
            cache=lm.lane_view(cfg, caches, slot), mode="prefill",
            impl=impl, moe_lossless=True, valid_len=valid,
            **_lane_tables(rows))
        return _pick_token(logits[:, last_idx, :cfg.vocab_size],
                           sample_args), caches
    return chunk_step


def _lane_tables(rows: dict) -> dict:
    """One lane's table rows ({group: [W]}) as ``lm.forward``'s table
    arguments ([1, W] each, None for a group the model does not have)."""
    return {arg: None if rows.get(g) is None else rows[g][None]
            for arg, g in (("paged_tables", "global"),
                           ("window_tables", "window"),
                           ("cross_tables", "cross"))}


def make_paged_decode_step(cfg: ModelConfig, impl: str = "kernel"):
    """decode(params, caches, toks [B], pos [B], tables {"global": [B, W],
    "window": [B, W], "cross": [B, Wc]} (each present when the model has
    such layers),
    active [B] bool, sample_args=None) -> (next_toks [B], caches).  One
    batched step over every lane; each lane writes its row through its
    table (inactive lanes hold null rows, so their writes land in the
    scratch page), and ``active`` confines the recurrent state update to
    the lanes actually decoding: every recurrent layer's new state goes
    through ``lm.freeze_state_lanes`` as soon as it is computed.
    ``sample_args = (base_keys [B, 2], temperature [B], top_k [B], top_p
    [B])`` turns the fused argmax into the per-lane sampler (the token
    decided this step sits at ``pos + 1``, which derives its key).  The
    step waits on nothing from the device."""
    def decode_step(params, caches, toks, pos, tables, active,
                    sample_args=None):
        def freeze(key, new):
            lm.freeze_state_lanes(cfg, caches, {key: new}, active)

        logits, caches, _ = lm.forward(cfg, params, toks[:, None],
                                       positions=pos, cache=caches,
                                       mode="decode", impl=impl,
                                       moe_lossless=True,
                                       paged_tables=tables.get("global"),
                                       window_tables=tables.get("window"),
                                       cross_tables=tables.get("cross"),
                                       state_sink=freeze)
        row = logits[:, -1, :cfg.vocab_size]
        if sample_args is None:
            return row.argmax(dim=-1).to(torch.int32), caches
        keys, temp, topk, topp = sample_args
        tkeys = sampling_mod.token_key(keys, pos.long() + 1)
        return sampling_mod.sample_lanes(row, tkeys, temp, topk, topp), \
            caches
    return decode_step


def make_draft_decode_step(cfg: ModelConfig, draft_layers: int,
                           impl: str = "kernel"):
    """draft(params, caches, tok [1], pos [1], rows, slot) -> (logits
    [vocab], caches).

    One decode step of a single lane through its first ``draft_layers``
    layers (``layer_cap``): the self-speculative draft pass.  The draft
    token's K/V rows land through the lane's tables where the verify pass
    rewrites them (a rejected row sits past the lane's rewound position,
    so no query reads it before the next accepted token overwrites it);
    the lane's recurrent state advances in place and the engine snapshots
    and restores it around the draft window.  The engine picks the draft
    token from the logits (the reference's step samples inside; the
    port's round draws its drafts' noise at once and skips the sampler on
    a greedy lane)."""
    def draft_step(params, caches, tok, pos, rows, slot):
        logits, _, _ = lm.forward(
            cfg, params, tok.reshape(1, 1), positions=pos.reshape(1),
            cache=lm.lane_view(cfg, caches, slot), mode="decode", impl=impl,
            moe_lossless=True, layer_cap=draft_layers, **_lane_tables(rows))
        return logits[0, -1, :cfg.vocab_size], caches
    return draft_step


def make_verify_step(cfg: ModelConfig, width: int, impl: str = "kernel"):
    """verify(params, caches, toks [width], start, rows, slot, valid) ->
    (logits [width, vocab], caches).

    One chunk-shaped pass of the full model over ``[x_t, d_1..d_k]``
    (padded to ``width = speculate + 1``) against the paged tree: the
    verification step of self-speculative decoding.  Row i's logits are
    the full model's distribution for draft slot i (row k the bonus
    token).  ``valid = k + 1`` masks the pad tail: recurrent state freezes
    past it, and pad-row K/V writes land past the lane's position, where
    the per-query causal mask keeps them unread until overwritten.  A
    modality-frontend arch's rows are embedded here (its frontend rows
    are long resident), as ``forward``'s own token branch embeds them."""
    use_embeds = bool(cfg.prepended_rows)

    def verify_step(params, caches, toks, start, rows, slot, valid):
        positions = start + torch.arange(width, dtype=torch.int32,
                                         device=toks.device)
        embeds = (lm.embed_tokens(cfg, params, toks)[None] if use_embeds
                  else None)
        logits, _, _ = lm.forward(
            cfg, params, None if use_embeds else toks[None],
            input_embeds=embeds, positions=positions,
            cache=lm.lane_view(cfg, caches, slot), mode="prefill",
            impl=impl, moe_lossless=True, valid_len=valid,
            **_lane_tables(rows))
        return logits[0, :, :cfg.vocab_size], caches
    return verify_step


def _check_servable(cfg: ModelConfig) -> None:
    reason = lm.unsupported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: {reason}")


@dataclass
class Engine:
    """Batched greedy decoding over a dense cache: the token-identity
    oracle of ``ContinuousEngine``."""

    cfg: ModelConfig
    params: dict
    kv_len: int
    dtype: torch.dtype = torch.float32
    impl: str = "kernel"
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        _check_servable(self.cfg)
        self._prefill = make_prefill_step(self.cfg, self.impl)
        self._decode = make_serve_step(self.cfg, self.impl)

    @torch.no_grad()
    def generate(self, prompts, max_new_tokens: int,
                 frontend_emb=None) -> torch.Tensor:
        """prompts: [B, S] token ids -> [B, max_new_tokens] int32 tokens
        (the prefill's token first).  ``frontend_emb`` [B, F,
        frontend_dim]: a modality-frontend or enc-dec arch's embeddings (a
        modality frontend's F rows come first in the cache, which holds
        ``kv_len + F`` rows)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        if frontend_emb is not None:
            frontend_emb = torch.as_tensor(frontend_emb, device=self.device)
        B, S = prompts.shape
        F = self.cfg.prepended_rows
        cache = lm.init_cache(self.cfg, B, self.kv_len + F, self.dtype,
                              self.device)
        tok, cache = self._prefill(self.params, cache, prompts, frontend_emb)
        out = [tok]
        for t in range(max_new_tokens - 1):
            pos = torch.full((), S + F + t, dtype=torch.int32,
                             device=self.device)
            tok, cache = self._decode(self.params, cache, tok[:, None], pos)
            out.append(tok)
        return torch.stack(out, dim=1)


@dataclass
class ContinuousEngine:
    """Continuous-batching engine, dense lanes or a physical paged KV
    cache.

    Requests are ``submit()``-ed with an arrival step (and optionally
    their ``SamplingParams``), then ``run()`` drives the loop: admit
    arrived requests into free slots (priced by ``pricing``; with
    ``paged=True`` also a window ring for a model with sliding-window
    layers and a state slot for a recurrent model), prefill each (whole,
    bucketed, or in chunks of ``prefill_chunk`` rows, one chunk per engine
    step), run one decode step over the decoding lanes (or, with
    ``speculate``, one speculative round per lane), retire finished slots
    and reclaim their blocks, rings and state slots (with ``prefix_cache``,
    committed prompt blocks stay cached for later admissions to share).

    ``pricing="worst"`` (default) reserves each request's worst case at
    admission, so decode never exhausts the pool; ``"lazy"`` reserves the
    prefill only and, on a mid-decode ``CacheExhausted``, preempts the
    youngest slot and requeues its request at the head of the queue (FCFS
    and per-position keys keep every request's tokens those of an
    uninterrupted run).  ``cache_blocks`` overrides the self-sized pool.
    ``speculate=K`` (paged only) drafts up to K tokens per lane and step
    with the first ``draft_layers`` layers (default half the stack,
    rounded up to whole cycle repeats).

    ``plan=`` takes a compiled plan (``repro_torch.core.CompiledPlan``) for
    the served decode shape (``decode_shape_for(kv_len, n_slots)``): the
    engine takes its cache length and lane count from it, and ``kv_len`` or
    ``n_slots`` given beside it must agree with it.  Without a plan,
    ``n_slots`` defaults to 4.
    """

    cfg: ModelConfig
    params: dict
    kv_len: int = 0
    n_slots: Optional[int] = None
    dtype: torch.dtype = torch.float32
    impl: str = "kernel"
    block_size: int = 16
    paged: bool = False
    bucket_prompts: bool = False
    prefill_chunk: int = 0
    prefix_cache: bool = False
    pricing: str = "worst"
    cache_blocks: Optional[int] = None
    speculate: int = 0
    draft_layers: Optional[int] = None
    device: Optional[object] = None
    telemetry: Optional[ServeTelemetry] = None
    # the compiled plan of the served decode shape; it sizes the cache
    # length and lane count, and is the plan --adapt rebalances
    plan: Optional[object] = field(default=None, repr=False)
    _next_rid: int = field(default=0, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        _check_servable(self.cfg)
        if self.plan is not None:
            # full-config equality, not name equality: cfg.reduced() keeps
            # the name, and a plan for the full model must not size (or
            # later adapt) an engine serving the reduced one
            if self.plan.cfg != self.cfg:
                raise ValueError(
                    f"plan was compiled for {self.plan.cfg.name!r} "
                    f"(dims differ or different arch), engine serves "
                    f"{self.cfg.name!r}")
            pshape = self.plan.shape
            # explicit sizing must agree with the plan, never contradict
            # it: the attached plan is what --adapt rebalances
            if self.kv_len > 0 and self.kv_len != int(pshape.seq_len):
                raise ValueError(
                    f"plan models seq_len={pshape.seq_len} but "
                    f"kv_len={self.kv_len} was passed; drop kv_len= or "
                    "compile the plan for the served decode shape")
            if (self.n_slots is not None
                    and self.n_slots != int(pshape.global_batch)):
                raise ValueError(
                    f"plan models global_batch={pshape.global_batch} but "
                    f"n_slots={self.n_slots} was passed; drop n_slots= or "
                    "compile the plan for the served decode shape")
            self.kv_len = int(pshape.seq_len)
            self.n_slots = int(pshape.global_batch)
        if self.n_slots is None:
            self.n_slots = 4
        if self.kv_len <= 0:
            raise ValueError("kv_len must be positive (set it directly or "
                             "pass a CompiledPlan via plan=)")
        if self.prefill_chunk and not self.paged:
            raise ValueError("prefill_chunk requires paged=True (chunks are "
                             "written straight into the page pools)")
        if self.prefix_cache:
            if not self.paged:
                raise ValueError("prefix_cache requires paged=True (block "
                                 "reuse shares physical pages)")
            reason = lm.prefix_sharable_reason(self.cfg)
            if reason is not None:
                raise ValueError(f"{self.cfg.name}: prefix cache "
                                 f"unavailable — {reason}")
        if self.speculate < 0:
            raise ValueError("speculate must be >= 0")
        if self.speculate and not self.paged:
            raise ValueError("speculate requires paged=True (the rewind "
                             "path truncates block tables and window rings)")
        if self.draft_layers is None:
            self.draft_layers = max(1, self.cfg.n_layers // 2)
        elif self.draft_layers < 1:
            raise ValueError("draft_layers must be >= 1")
        if self.cache_blocks is not None and self.cache_blocks < 1:
            raise ValueError("cache_blocks must be >= 1")
        groups = lm.serve_groups(self.cfg)
        self._has_global = bool(groups["paged"])
        self._has_window = bool(groups["window"])
        self._has_state = bool(groups["recurrent"])
        self._has_cross = bool(groups["cross"])
        # a modality frontend's projected rows share the decoder's cache:
        # every lane holds F rows ahead of its prompt (an enc-dec arch's
        # frames live in the cross block set instead)
        self._frontend_extra = self.cfg.prepended_rows
        self._kv_total = self.kv_len + self._frontend_extra
        if self.paged:
            self._init_paged()
        else:
            # dense lanes: the allocator only accounts, a block per
            # block_size physical rows of a lane
            n_blocks = self.n_slots * -(-self._kv_total // self.block_size)
            self.allocator = BlockAllocator(CacheConfig(
                block_size=self.block_size,
                n_blocks=self.cache_blocks or n_blocks))
            self._caches = lm.init_slot_caches(self.cfg, self.n_slots,
                                               self._kv_total, self.dtype,
                                               self.device)
            self._decode = make_serve_step(self.cfg, self.impl)
        self.scheduler = SlotScheduler(self.n_slots, self.allocator,
                                       self.kv_len, pricing=self.pricing)
        if self.telemetry is None:
            self.telemetry = ServeTelemetry()
        self._prefill = make_prefill_step(self.cfg, self.impl)
        self._prefill_b = make_bucketed_prefill_step(self.cfg, self.impl)
        # per-lane state, written in place at admission and by each step
        dev = self.device
        self._toks = torch.zeros(self.n_slots, dtype=torch.int32, device=dev)
        self._pos = torch.zeros(self.n_slots, dtype=torch.int32, device=dev)
        # per-lane sampling state: base keys and the (temperature, top_k,
        # top_p) lanes the batched steps sample with (greedy defaults)
        self._skeys = torch.zeros((self.n_slots, 2), dtype=torch.int64,
                                  device=dev)
        self._temp = torch.zeros(self.n_slots, dtype=torch.float32,
                                 device=dev)
        self._topk = torch.zeros(self.n_slots, dtype=torch.int64, device=dev)
        self._topp = torch.ones(self.n_slots, dtype=torch.float32, device=dev)
        self._samp: dict[int, SamplingParams] = {}
        self._now = 0
        self._rids: set = set()
        # slot -> [prompt, chunks done, skip] while chunk-prefilling (skip:
        # the prefix-cache positions not recomputed)
        self._prefilling: dict[int, list] = {}
        # (preemptions, hit_tokens, lookup_tokens) at the last recorded
        # step: _record_step reports each step's deltas
        self._stats_last = (0, 0, 0)

    @staticmethod
    def decode_shape_for(kv_len: int, n_slots: int) -> ShapeConfig:
        """The planning shape of a serving configuration: the one
        constructor every call site shares, so that compiled plans key
        identically (the reference's name and fields)."""
        return ShapeConfig(f"serve_decode_{kv_len}", kv_len, n_slots,
                           "decode")

    def decode_shape(self) -> ShapeConfig:
        """The decode traffic this engine serves: cache length x lane
        count, the shape adaptation plans for."""
        return self.decode_shape_for(self.kv_len, self.n_slots)

    def _init_paged(self) -> None:
        """Page pools, per-group block tables, recurrent state slabs,
        static cross block sets and the stores bound to the allocator."""
        has_blocks = self._has_global or self._has_window
        if has_blocks and self._kv_total % self.block_size:
            raise ValueError(
                f"paged mode needs kv_len + frontend rows ({self._kv_total})"
                f" divisible by block_size ({self.block_size}) so the "
                "gathered KV view matches the dense oracle's shape (token "
                "identity)")
        # a published table (global or window ring) spans the full context
        self._max_blocks = (self._kv_total // self.block_size if has_blocks
                            else 0)
        self._cross_width = (-(-self.cfg.frontend_tokens // self.block_size)
                             if self._has_cross else 0)
        # per-slot block budget: a global table grows to the full context;
        # a window ring is capped at O(window) blocks; a cross block set is
        # its static size; recurrent layers hold state slots, no blocks
        per_slot = (self._max_blocks if self._has_global else 0) + \
            self._window_cap_blocks() + self._cross_width
        cache_cfg = CacheConfig(
            block_size=self.block_size,
            n_blocks=(self.cache_blocks if self.cache_blocks is not None
                      else self.n_slots * per_slot))
        self.allocator = BlockAllocator(cache_cfg)
        self._caches = lm.init_paged_caches(
            self.cfg, self.n_slots, cache_cfg.n_blocks + 1, self.block_size,
            self.dtype, self.device)
        for group, keys, leaf in lm.paged_cache_leaves(self.cfg,
                                                       self._caches):
            self.allocator.attach_store(PagedKVStore.from_pools(
                cache_cfg, leaf[keys[0]], leaf[keys[1]]), group=group)
        self.allocator.set_layout(CacheLayout(
            has_global=self._has_global,
            window=(min(self._kv_total, self.cfg.window_size)
                    if self._has_window else 0),
            window_cap_blocks=self._window_cap_blocks(),
            state_slots=self.n_slots if self._has_state else 0,
            state_bytes_per_slot=lm.state_bytes_per_slot(self.cfg,
                                                         self._caches),
            prefill_chunk=self.prefill_chunk,
            cross_tokens=self.cfg.frontend_tokens if self._has_cross else 0,
            cross_cap_blocks=self._cross_width,
            frontend_extra=self._frontend_extra,
            sharable=self.prefix_cache))
        null = cache_cfg.null_block
        self._null_rows = {
            group: torch.full((width,), null, dtype=torch.int32,
                              device=self.device)
            for group, width in (("global", self._max_blocks),
                                 ("window", self._max_blocks),
                                 ("cross", self._cross_width))}
        # one published [n_slots, W] table per block group
        self._tables = {group: self._null_rows[group].repeat(self.n_slots, 1)
                        for group, has in (("global", self._has_global),
                                           ("window", self._has_window),
                                           ("cross", self._has_cross))
                        if has}
        # lanes holding a decoding request, kept on the device so the
        # decode step never reads it back; a lane mid chunked prefill
        # stays out, so the decode step leaves its carried state alone
        self._active = torch.zeros(self.n_slots, dtype=torch.bool,
                                   device=self.device)
        self._decode_p = make_paged_decode_step(self.cfg, self.impl)
        if self.prefill_chunk:
            self._chunk = make_chunk_prefill_step(
                self.cfg, self.prefill_chunk, self.impl)
        if self.speculate:
            self._draft_step = make_draft_decode_step(
                self.cfg, self.draft_layers, self.impl)
            self._verify_step = make_verify_step(
                self.cfg, self.speculate + 1, self.impl)
        self._rows: dict[int, dict] = {}       # prefilling slot -> rows
        self._host_pos: dict[int, int] = {}

    @property
    def now(self) -> int:
        """The engine step; ``submit`` arrivals are absolute against it."""
        return self._now

    def _global_stores(self) -> list:
        """The stores of the global-attention pools, in leaf order."""
        return [s for s, g in zip(self.allocator.stores,
                                  self.allocator.store_groups)
                if g == "global"]

    def export_prefix_blocks(self, block_hashes) -> list[tuple]:
        """The pages of the committed blocks backing the longest resident
        prefix of ``block_hashes``: the export side of a prefill -> decode
        handoff (``serve.cache.BlockTransferBuffer``).  Each entry is
        ``(hash, payload)``, the payload one ``(k_page, v_page)`` pair per
        global pool leaf in ``lm.paged_cache_leaves`` order (the same on
        every replica of a config; an MLA leaf's pair is its latent and
        RoPE-key pages).  The pages are copies: the pools are
        written in place, and this replica may evict and reuse a block
        while its payload waits in the buffer.  The blocks stay this
        replica's."""
        if not self.prefix_cache:
            raise ValueError("export_prefix_blocks requires prefix_cache "
                             "(the handoff is keyed by the content index)")
        out: list[tuple] = []
        for h in block_hashes or ():
            block = self.allocator.lookup_block(h)
            if block is None:
                break
            out.append((h, tuple((s.k_pages[:, block].clone(),
                                  s.v_pages[:, block].clone())
                                 for s in self._global_stores())))
        return out

    def import_prefix_blocks(self, entries) -> int:
        """Install exported ``(hash, payload)`` chain entries into this
        replica's pool as committed refcount-0 cached blocks (the import
        side of the handoff), writing the pages in place on this engine's
        device; admitting a request whose chain they cover is then an
        ordinary prefix hit.  Hashes already resident are skipped, and a
        pool too full for the whole chain takes a prefix of it (the rest
        is recomputed).  Returns how many blocks were installed."""
        if not self.prefix_cache:
            raise ValueError("import_prefix_blocks requires prefix_cache")
        pairs = self.allocator.inject_cached([h for h, _ in entries])
        by_hash = dict(entries)
        for h, block in pairs:
            for store, (k_page, v_page) in zip(self._global_stores(),
                                               by_hash[h]):
                store.k_pages[:, block].copy_(k_page)
                store.v_pages[:, block].copy_(v_page)
        return len(pairs)

    def submit(self, prompt, max_new_tokens: int, *, rid=None,
               arrival: int = 0, eos_id: Optional[int] = None,
               frontend_emb=None,
               sampling: Optional[SamplingParams] = None) -> object:
        """Queue a request; returns its id.  ``prompt`` is a 1-D sequence
        of token ids; ``arrival`` the engine step at which it becomes
        admissible; ``frontend_emb`` a modality-frontend or enc-dec
        request's precomputed embeddings [frontend_tokens, frontend_dim]
        (required there, refused elsewhere; projected or encoded once, at
        admission); ``sampling`` its ``SamplingParams`` (None is exact
        greedy)."""
        if sampling is not None and not isinstance(sampling, SamplingParams):
            raise ValueError(
                f"sampling must be a SamplingParams, got {type(sampling)}")
        if self.cfg.frontend or self.cfg.n_enc_layers:
            want = (self.cfg.frontend_tokens, self.cfg.frontend_dim)
            if frontend_emb is None:
                raise ValueError(
                    f"{self.cfg.name}: requests must carry frontend_emb "
                    f"{list(want)} (precomputed modality-frontend "
                    "embeddings)")
            frontend_emb = torch.as_tensor(frontend_emb, device=self.device)
            if tuple(frontend_emb.shape) != want:
                raise ValueError(
                    f"{self.cfg.name}: frontend_emb shape "
                    f"{tuple(frontend_emb.shape)} != {want}")
        elif frontend_emb is not None:
            raise ValueError(f"{self.cfg.name} is a decoder-only token LM; "
                             "it takes no frontend_emb")
        prompt = [int(t) for t in prompt]
        if rid is None:
            while self._next_rid in self._rids:
                self._next_rid += 1
            rid = self._next_rid
            self._next_rid += 1
        elif rid in self._rids:
            raise ValueError(f"duplicate request id {rid!r}")
        hashes = (lm.prompt_block_hashes(prompt, self.block_size)
                  if self.prefix_cache else None)
        self.scheduler.submit(Request(rid=rid, prompt=prompt,
                                      max_new_tokens=max_new_tokens,
                                      arrival=arrival, eos_id=eos_id,
                                      frontend_emb=frontend_emb,
                                      block_hashes=hashes,
                                      sampling=sampling))
        self._rids.add(rid)
        return rid

    def _full_prefill(self, prompt: torch.Tensor, fe1,
                      sample_args) -> tuple:
        """Whole-prompt prefill, right-padded to its bucket with
        ``bucket_prompts``, into a fresh dense single-request cache (a
        fresh one each time: the prefill writes it in place); ``fe1`` the
        request's [1, F, frontend_dim] embeddings or None."""
        cache = lm.init_cache(self.cfg, 1, self._kv_total, self.dtype,
                              self.device)
        if not self.bucket_prompts:
            return self._prefill(self.params, cache, prompt[None], fe1,
                                 sample_args)
        n = prompt.shape[0]
        padded = torch.zeros((1, bucket_length(n, self.kv_len)),
                             dtype=torch.int32, device=self.device)
        padded[0, :n] = prompt
        return self._prefill_b(self.params, cache, padded, n, fe1,
                               sample_args)

    def _window_cap_blocks(self) -> int:
        """Most blocks one lane's window ring can pin at once: the blocks
        covering the window span plus one of block-alignment slack, plus
        the in-flight chunk's during chunked prefill, never more than a
        full-context table."""
        if not self._has_window:
            return 0
        bf = lambda n: -(-n // self.block_size)          # noqa: E731
        wc = min(self._kv_total, self.cfg.window_size)
        cap = bf(wc) + 1 + (bf(self.prefill_chunk) if self.prefill_chunk
                            else 0)
        return min(bf(self._kv_total), cap)

    def _refresh_row(self, slot: int, group: str) -> torch.Tensor:
        """``slot``'s table row for ``group`` from the allocator's tables."""
        if group == "global":
            row = self.allocator.padded_table(slot, self._max_blocks)
        elif group == "cross":
            row = self.allocator.padded_cross_table(slot, self._cross_width)
        else:
            row = self.allocator.padded_window_table(slot, self._max_blocks)
        return torch.tensor(row, dtype=torch.int32, device=self.device)

    def _set_lane_sampling(self, slot: int, act: ActiveSlot) -> None:
        """Publish the admitted request's sampling configuration to lane
        ``slot``, in place: its base key and parameters on the device, and
        its ``SamplingParams`` on the host."""
        sp = act.request.sampling or GREEDY
        self._samp[slot] = sp
        self._skeys[slot] = sp.base_key(self.device)
        self._temp[slot] = sp.temperature
        self._topk[slot] = sp.top_k
        self._topp[slot] = sp.top_p

    def _first_token_args(self, slot: int, position: int):
        """Sampling arguments of the token a prefill emits at cache
        ``position`` (the key depends on seed and position only, so whole,
        bucketed and chunked prefills of a request draw the same token);
        None for a greedy lane, which keeps the fused argmax."""
        sp = self._samp[slot]
        if sp.is_greedy:
            return None
        return (sampling_mod.token_key(self._skeys[slot], position),
                sp.temperature, sp.top_k, sp.top_p)

    def _lanes_sample(self, lanes) -> bool:
        return any(not self._samp[s].is_greedy for s in lanes)

    def _admit_one(self, act: ActiveSlot) -> None:
        slot = act.slot
        prompt = torch.tensor(act.request.prompt, dtype=torch.int32,
                              device=self.device)
        fe = act.request.frontend_emb
        fe1 = None if fe is None else fe[None]
        # the lane decodes past everything resident: the prompt, after a
        # modality frontend's rows
        start_pos = self._frontend_extra + act.request.prompt_len
        self._set_lane_sampling(slot, act)
        if not self.paged:
            tok, cache = self._full_prefill(
                prompt, fe1, self._first_token_args(slot, start_pos))
            lm.write_slot_cache(self._caches, cache, slot)
            self._toks[slot] = tok[0]
            self._pos[slot] = start_pos
            act.first_token_step = self._now
            act.tokens.append(int(tok[0]))
            return
        # prefix-cache hit: positions below ``skip`` are resident in shared
        # blocks.  At least the last prompt position is recomputed (for the
        # first token's logits); when that pulls the first recomputed
        # position back into a shared block (a block-aligned whole hit),
        # the block is forked copy-on-write before anything writes it
        skip = 0
        if self.prefix_cache:
            matched = self.allocator.matched_tokens.get(slot, 0)
            skip = min(matched, start_pos - 1)
            if matched > skip:
                pair = self.allocator.ensure_private(
                    slot, skip // self.block_size)
                if pair is not None:
                    lm.copy_paged_block(self.cfg, self._caches, *pair)
        rows = {group: self._refresh_row(slot, group)
                for group in self._tables}
        if self.prefill_chunk:
            # one chunk per engine step from the next one on, interleaved
            # with decode; a reused lane still holds its previous
            # occupant's state, reset before the chunks carry state in
            if self._has_state:
                lm.zero_state_lane(self.cfg, self._caches, slot)
            if self._has_cross:
                # encode at admission: the lane's cross block set is
                # written once, here, and only read afterwards
                lm.insert_cross_rows(
                    self.cfg, self._caches,
                    lm.encode_cross_single(self.cfg, self.params, fe1),
                    rows["cross"], block_size=self.block_size,
                    null_block=self.allocator.config.null_block)
            # a modality frontend's rows ride the chunks as embedding rows
            item = (lm.embed_prompt_rows(self.cfg, self.params, prompt, fe)
                    if self._frontend_extra else prompt)
            self._rows[slot] = rows
            self._prefilling[slot] = [item, 0, skip]
            return
        tok, cache = self._full_prefill(
            prompt, fe1, self._first_token_args(slot, start_pos))
        # whole-prompt admission overwrites the lane's state slabs, so a
        # reused lane needs no reset; it recomputes the whole prompt and
        # writes the rows from ``skip`` on (the shared ones stay read-only)
        lm.insert_paged_prompt(self.cfg, self._caches, cache, rows, slot,
                               block_size=self.block_size,
                               null_block=self.allocator.config.null_block,
                               skip_below=skip)
        if self.prefix_cache:
            self.allocator.commit_slot(slot)
        self._activate_lane(slot, tok[0], start_pos, rows)
        act.first_token_step = self._now
        act.tokens.append(int(tok[0]))

    def _activate_lane(self, slot: int, tok, start_pos: int,
                       rows: dict) -> None:
        """Bring a prefilled request online in paged decode lane
        ``slot``: its token, position and table rows."""
        self._toks[slot] = tok
        self._pos[slot] = start_pos
        for group, row in rows.items():
            self._tables[group][slot] = row
        self._active[slot] = True
        self._host_pos[slot] = start_pos

    def _run_chunk(self, slot: int) -> bool:
        """Advance ``slot``'s chunked prefill by one chunk; returns True,
        with the decode lane activated, once the prompt is resident.  The
        chunks slice token ids, or a modality-frontend arch's embedding
        rows (``total`` then counts the frontend rows)."""
        item, done, skip = self._prefilling[slot]
        C = self.prefill_chunk
        start = skip + done * C                # past the cached positions
        total = item.shape[0]
        piece = item[start:start + C]
        valid = piece.shape[0]                 # real rows in this slice
        if valid < C:                          # pad the final chunk to C
            piece = torch.cat([piece,
                               piece.new_zeros((C - valid,) + piece.shape[1:])])
        if self._has_window:
            # slide the ring over this slice; rows behind the slice's
            # first query keep their window (freed once fully behind)
            fresh, freed = self.allocator.extend_window(
                slot, min(start + C, total), first_query_pos=start)
            if fresh or freed:
                self._rows[slot]["window"] = self._refresh_row(slot,
                                                               "window")
        last = total - 1 - start               # meaningful on the last one
        final = start + C >= total
        tok, self._caches = self._chunk(
            self.params, self._caches, piece[None], start, self._rows[slot],
            min(max(last, 0), C - 1), slot, valid,
            self._first_token_args(slot, total) if final else None)
        self._prefilling[slot][1] = done + 1
        if not final:
            return False
        del self._prefilling[slot]
        if self.prefix_cache:
            self.allocator.commit_slot(slot)
        self._activate_lane(slot, tok[0], total, self._rows.pop(slot))
        act = self.scheduler.active[slot]
        act.first_token_step = self._now
        act.tokens.append(int(tok[0]))
        return True

    def _release_lane(self, slot: int) -> None:
        """Forget a lane the scheduler has let go (finished or preempted):
        its sampling state and, paged, its table rows (so no step touches
        freed pages), its state slabs' updates and its prefill."""
        self._samp.pop(slot, None)
        self._prefilling.pop(slot, None)
        if self.paged:
            for group, table in self._tables.items():
                table[slot] = self._null_rows[group]
            self._active[slot] = False
            self._host_pos.pop(slot, None)
            self._rows.pop(slot, None)

    def _finish(self, slot: int) -> list:
        """Retire ``slot``: reclaim its blocks and state slot and release
        its lane."""
        act = self.scheduler.finish(slot)
        self._release_lane(slot)
        return act.tokens

    def _pick_victim(self) -> Optional[int]:
        """The youngest active slot (latest admission, slot id breaking
        ties): preempting it drops the least work, and requeueing it at the
        head of the queue keeps completion order and tokens those of an
        uninterrupted run.  None when at most one slot is active: evicting
        the only lane frees nothing its own re-admission could use, so the
        caller lets ``CacheExhausted`` propagate."""
        if len(self.scheduler.active) <= 1:
            return None
        return max(self.scheduler.active.values(),
                   key=lambda a: (a.admitted_at, a.slot)).slot

    def _preempt_for(self, exc: CacheExhausted) -> int:
        """Preempt the youngest slot after ``exc`` (re-raised when there
        is no victim); returns the victim's slot."""
        victim = self._pick_victim()
        if victim is None:
            raise exc
        self.scheduler.preempt(victim)
        self._release_lane(victim)
        return victim

    def _grow_tables(self, decoding: list) -> list:
        """Claim the block backing each lane's next write before the
        decode step runs (the write needs a physical destination; a model
        without attention layers never claims one).  Window rings also
        free every block that has fallen fully behind ``pos - window``.
        Under lazy pricing a growth that finds the pool exhausted preempts
        the youngest slot and retries (growth is idempotent for the lanes
        already grown).  Returns the lanes still decoding."""
        while True:
            try:
                for slot in decoding:
                    self._grow(slot, self._host_pos[slot] + 1)
                return decoding
            except CacheExhausted as exc:
                victim = self._preempt_for(exc)
                decoding = [s for s in decoding if s != victim]

    def _grow(self, slot: int, n_res: int, first_query_pos=None) -> None:
        """Grow ``slot``'s table and slide its ring to cover ``n_res``
        resident rows, republishing the rows that changed."""
        if self._has_global and self.allocator.extend(slot, n_res):
            self._tables["global"][slot] = self._refresh_row(slot, "global")
        if self._has_window:
            kw = ({} if first_query_pos is None
                  else {"first_query_pos": first_query_pos})
            fresh, freed = self.allocator.extend_window(slot, n_res, **kw)
            if fresh or freed:
                self._tables["window"][slot] = self._refresh_row(slot,
                                                                 "window")

    def _decode_lanes(self, decoding: list) -> None:
        """Dense lanes: one B=1 decode step per decoding lane on its own
        cache (lanes that hold no decoding request are not run); each new
        token is written into ``_toks`` in place."""
        for slot in decoding:
            sample_args = None
            if not self._samp[slot].is_greedy:
                # the token decided this step sits at pos + 1
                sp = self._samp[slot]
                sample_args = (
                    sampling_mod.token_key(self._skeys[slot],
                                           self._pos[slot].long() + 1),
                    sp.temperature, sp.top_k, sp.top_p)
            tok, _ = self._decode(self.params,
                                  lm.slot_cache(self._caches, slot),
                                  self._toks[slot].reshape(1, 1),
                                  self._pos[slot], sample_args)
            self._toks[slot] = tok[0]

    def _speculative_round(self, slot: int) -> Optional[tuple]:
        """One self-speculative round of decode lane ``slot``.

        Grow the lane's table and ring over the draft window; snapshot its
        recurrent state; draft up to ``speculate`` tokens with the
        truncated-layer step (each lands its K/V through the lane's
        tables); restore the state and verify all drafts in one
        chunk-shaped full-model pass; accept by rejection sampling (exact
        argmax agreement under greedy); then rewind: truncate the table
        tail and the ring past the accepted window and, on a partial
        acceptance, restore the snapshot again and settle the state with
        a ``valid = accepted + 1`` pass.

        Returns ``(emitted tokens, n_drafted, n_accepted)``, or None when
        the lane itself was preempted while growing (lazy pricing)."""
        act = self.scheduler.active[slot]
        sp = self._samp[slot]
        pos = self._host_pos[slot]
        budget = act.request.max_new_tokens - len(act.tokens)
        k_r = max(0, min(self.speculate, budget - 1,
                         self._kv_total - pos - 1))
        while True:
            try:
                self._grow(slot, pos + k_r + 1, first_query_pos=pos)
                break
            except CacheExhausted as exc:
                if self._preempt_for(exc) == slot:
                    return None
        rows = {g: t[slot] for g, t in self._tables.items()}
        base = self._skeys[slot]
        temp, topk, topp = sp.temperature, sp.top_k, sp.top_p
        dev = self.device
        snap = None
        if self._has_state and k_r:
            snap = lm.snapshot_state_lanes(self.cfg, self._caches, slot)
        width = self.speculate + 1
        toks = torch.zeros(width, dtype=torch.int32, device=dev)
        toks[0] = act.tokens[-1]
        probs = torch.zeros((self.speculate, self.cfg.vocab_size),
                            dtype=torch.float32, device=dev)
        if k_r and not sp.is_greedy:
            # each draft's noise depends on its key only: draw all at once
            noise = sampling_mod.gumbel(sampling_mod.token_key(
                base, torch.arange(pos + 1, pos + k_r + 1, device=dev),
                sampling_mod.STREAM_DRAFT), self.cfg.vocab_size)
        tok = toks[:1]
        for i in range(k_r):
            row, self._caches = self._draft_step(
                self.params, self._caches, tok,
                torch.full((1,), pos + i, dtype=torch.int32, device=dev),
                rows, slot)
            if sp.is_greedy:           # the sampler's pick at temperature 0
                toks[i + 1] = row.argmax()
            else:
                toks[i + 1], probs[i] = sampling_mod.sample_with_probs(
                    row, noise[i], temp, topk, topp)
            tok = toks[i + 1:i + 2]
        if snap is not None:
            # the draft advanced the lane's recurrent state k_r tokens;
            # the verify pass starts from the pre-draft state
            lm.restore_state_lanes(self.cfg, self._caches, snap, slot)
        logits, self._caches = self._verify_step(
            self.params, self._caches, toks, pos, rows, slot, k_r + 1)
        if sp.is_greedy:
            n_acc, nxt = sampling_mod.greedy_accept(logits, toks[1:], k_r)
        else:
            akey = sampling_mod.token_key(base, pos + 1,
                                          sampling_mod.STREAM_ACCEPT)
            n_acc, nxt = sampling_mod.speculative_accept(
                logits, probs, toks[1:], k_r, akey, temp, topk, topp)
        # one device->host transfer for the round
        *drafted_host, a, e = torch.cat([
            toks[1:1 + k_r], n_acc.to(torch.int32).reshape(1),
            nxt.reshape(1)]).tolist()
        if snap is not None and a < k_r:
            # partial acceptance: the verify pass advanced the state over
            # all k_r + 1 rows; rerun it from the snapshot with only the
            # accepted rows valid to settle the post-accept state
            lm.restore_state_lanes(self.cfg, self._caches, snap, slot)
            _, self._caches = self._verify_step(
                self.params, self._caches, toks, pos, rows, slot, a + 1)
        final_res = pos + a + 1
        if a < k_r:
            if self._has_global and self.allocator.truncate(slot, final_res):
                self._tables["global"][slot] = self._refresh_row(slot,
                                                                 "global")
            if self._has_window and self.allocator.truncate_window(
                    slot, final_res):
                self._tables["window"][slot] = self._refresh_row(slot,
                                                                 "window")
        self._host_pos[slot] = final_res
        return drafted_host[:a] + [e], k_r, a

    @torch.no_grad()
    def run(self, max_steps: Optional[int] = None) -> dict:
        """Serve every queued request to completion; returns {rid: [token
        ids]} (the prefill's token first).  The engine clock persists
        across calls, so a ``max_steps``-bounded run can be resumed."""
        results: dict = {}
        steps = 0
        while self.scheduler.has_work():
            if max_steps is not None and steps >= max_steps:
                break
            now = self._now
            t0 = time.perf_counter()
            prefills = 0                       # completed (one token each)
            chunks = 0                         # chunk work units
            for act in self.scheduler.admit(now):
                self._admit_one(act)
                if act.slot in self._prefilling:
                    continue                   # chunked: no token yet
                prefills += 1
                if act.is_finished():          # max_new == 1 or prompt-EOS
                    results[act.request.rid] = self._finish(act.slot)
            # chunked prefills: one chunk per prefilling slot per step,
            # interleaved with the decode of the running lanes below
            t_chunk = time.perf_counter()
            for slot in sorted(self._prefilling):
                chunks += 1
                if self._run_chunk(slot):      # the last chunk: a token
                    prefills += 1
                    act = self.scheduler.active[slot]
                    if act.is_finished():
                        results[act.request.rid] = self._finish(slot)
            t1 = time.perf_counter()
            t_chunk = t1 - t_chunk
            t_prefill = t1 - t0

            decoding = sorted(s for s in self.scheduler.active
                              if s not in self._prefilling)
            if not decoding:
                if prefills or chunks:         # all work this step prefilled
                    self._record_step(now, t0, (), prefills, chunks, 0,
                                      t_prefill, 0.0, t_chunk)
                    self._now = now + 1
                    steps += 1
                    continue
                nxt = self.scheduler.next_arrival()
                if nxt is None:
                    break
                if nxt <= now and not self.scheduler.active:
                    # the head has arrived, nothing runs that could free
                    # blocks, and admission still refused it
                    head = self.scheduler._pending[0]
                    raise CacheExhausted(
                        f"request {head.rid!r} (prompt {head.prompt_len} + "
                        f"max_new {head.max_new_tokens}) can never be "
                        f"admitted into {self.allocator.n_blocks} blocks")
                self._now = max(now + 1, nxt)  # idle: jump to next arrival
                continue

            if self.speculate:
                # one speculative round per lane: draft, verify in one
                # chunk-shaped pass, accept, rewind (each lane grows its
                # own tables inside its round)
                drafted = accepted = rewound = new_tokens = 0
                ran = []
                for slot in decoding:
                    act = self.scheduler.active.get(slot)
                    if act is None:
                        continue       # preempted by an earlier round
                    out = self._speculative_round(slot)
                    if out is None:
                        continue       # the lane itself was preempted
                    ran.append(slot)
                    emitted, k_r, a = out
                    drafted += k_r
                    accepted += a
                    rewound += k_r - a
                    for t in emitted:
                        act.tokens.append(t)
                        new_tokens += 1
                        if act.is_finished():
                            break      # EOS inside the accepted window
                    if act.is_finished():
                        results[act.request.rid] = self._finish(slot)
                self._record_step(now, t0, ran, prefills, chunks,
                                  new_tokens, t_prefill,
                                  time.perf_counter() - t1, t_chunk,
                                  drafted=drafted, accepted=accepted,
                                  rewound=rewound)
                self._now = now + 1
                steps += 1
                continue

            if self.paged:
                decoding = self._grow_tables(decoding)
                if not decoding:           # every decoding lane was evicted
                    self._record_step(now, t0, (), prefills, chunks, 0,
                                      t_prefill, 0.0, t_chunk)
                    self._now = now + 1
                    steps += 1
                    continue
                sample_args = ((self._skeys, self._temp, self._topk,
                                self._topp)
                               if self._lanes_sample(decoding) else None)
                toks, self._caches = self._decode_p(
                    self.params, self._caches, self._toks, self._pos,
                    self._tables, self._active, sample_args)
                self._toks.copy_(toks)
            else:
                self._decode_lanes(decoding)
            self._pos += 1
            toks_host = self._toks.tolist()    # one device->host transfer
            t_decode = time.perf_counter() - t1
            new_tokens = 0
            for slot in decoding:
                act = self.scheduler.active.get(slot)
                if act is None:
                    continue                   # preempted by a later lane
                act.tokens.append(toks_host[slot])
                new_tokens += 1
                if self.paged:
                    self._host_pos[slot] += 1
                elif not self._extend_dense(slot, act):
                    new_tokens -= 1            # its token was dropped
                    continue
                if act.is_finished():
                    results[act.request.rid] = self._finish(slot)
            self._record_step(now, t0, decoding, prefills, chunks,
                              new_tokens, t_prefill, t_decode, t_chunk)
            self._now = now + 1
            steps += 1
        return results

    def _extend_dense(self, slot: int, act: ActiveSlot) -> bool:
        """Dense lanes: account the rows resident after this step (the
        prompt and every decode write so far; the new token is not
        written yet), preempting the youngest slot while the pool is
        exhausted.  False when ``slot`` itself was preempted."""
        while True:
            try:
                self.allocator.extend(slot, act.position - 1)
                return True
            except CacheExhausted as exc:
                if self._preempt_for(exc) == slot:
                    return False

    def _record_step(self, now: int, t0: float, active_slots, prefills: int,
                     chunks: int, new_tokens: int, prefill_seconds: float,
                     decode_seconds: float, chunk_seconds: float,
                     drafted: int = 0, accepted: int = 0,
                     rewound: int = 0) -> None:
        # per-step deltas of the cumulative ledgers
        stats = self.allocator.stats
        cur = (self.scheduler.preemptions, stats["hit_tokens"],
               stats["lookup_tokens"])
        prev, self._stats_last = self._stats_last, cur
        self.telemetry.record_step(
            step=now, seconds=time.perf_counter() - t0,
            active_slots=active_slots, n_slots=self.n_slots,
            blocks_in_use=self.allocator.n_in_use,
            n_blocks=self.allocator.n_blocks, prefills=prefills,
            prefill_chunks=chunks, new_tokens=new_tokens,
            resident_bytes=self.allocator.resident_bytes(),
            resident_by_group=(self.allocator.resident_bytes_by_group()
                               if self.paged else None),
            capacity_bytes=self.allocator.capacity_bytes(),
            prefill_seconds=prefill_seconds,
            decode_seconds=decode_seconds, chunk_seconds=chunk_seconds,
            preemptions=cur[0] - prev[0],
            prefix_hit_tokens=cur[1] - prev[1],
            prefix_lookup_tokens=cur[2] - prev[2],
            shared_saved_bytes=self.allocator.shared_saved_bytes(),
            cached_blocks=self.allocator.cached_blocks(),
            drafted=drafted, accepted=accepted, rewound_tokens=rewound)
