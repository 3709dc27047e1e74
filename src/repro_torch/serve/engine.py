"""Greedy serving: step factories, the static-batch ``Engine`` and the
continuous-batching ``ContinuousEngine``.

A port of the greedy subset of ``repro.serve.engine``: dense and paged
lanes, whole, bucketed and chunked prefill.  ``ContinuousEngine`` admits
queued requests into free decode lanes mid-stream (``SlotScheduler`` +
``BlockAllocator``) and serves them in one of two regimes:

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

``bucket_prompts=True`` right-pads whole prefills to power-of-two buckets
(``bucket_length``): pad rows are position-masked in the cache and freeze
the recurrent state (``valid_len``).  Each lane computes exactly the B=1
decode path, so its tokens match ``Engine.generate`` on that request alone:
the gathered paged view has exactly ``kv_len`` rows (``kv_len %
block_size == 0`` is enforced when a paged model has attention layers) and
masked rows add exact zeros.

``impl="kernel"`` (default) launches the hand-written Hopper kernels on
CUDA tensors (their plain versions on CPU tensors); ``impl="plain"`` is
the plain PyTorch reference path.
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

from .cache import (BlockAllocator, CacheConfig, CacheExhausted, CacheLayout,
                    PagedKVStore)
from .scheduler import ActiveSlot, Request, SlotScheduler

PREFILL_BUCKET_FLOOR = 8


def bucket_length(n: int, cap: int, floor: int = PREFILL_BUCKET_FLOOR) -> int:
    """Smallest power-of-two bucket >= n (>= floor), clamped to cap."""
    b = max(floor, 1 << max(0, (n - 1).bit_length()))
    return min(max(b, n), cap)


def _greedy(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Next token per row from the last position's logits (pad ids cut)."""
    return logits[:, -1, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, impl: str = "kernel"):
    """prefill(params, cache, tokens [B, S]) -> (next_tok [B], cache)."""
    def prefill_step(params, cache, tokens):
        logits, cache = lm.forward(cfg, params, tokens, cache=cache,
                                   mode="prefill", impl=impl)
        return _greedy(logits, cfg), cache
    return prefill_step


def make_serve_step(cfg: ModelConfig, impl: str = "kernel"):
    """decode(params, cache, tokens [B, 1], pos 0-d) -> (next_tok, cache)."""
    def serve_step(params, cache, tokens, pos):
        logits, cache = lm.forward(cfg, params, tokens, positions=pos,
                                   cache=cache, mode="decode", impl=impl)
        return _greedy(logits, cfg), cache
    return serve_step


def make_bucketed_prefill_step(cfg: ModelConfig, impl: str = "kernel"):
    """prefill(params, cache, tokens [B, Sb], true_len) -> (next_tok [B],
    cache).  The prompt is right-padded to a bucket length Sb; causality
    makes the logits at ``true_len - 1`` exact, ``valid_len=true_len``
    freezes the recurrent state at the real prompt (and keeps pad rows out
    of window rings), and the pad rows' cache slots are marked empty
    (``lm.mask_cache_positions``), so decode never attends them."""
    def prefill_step(params, cache, tokens, true_len):
        logits, cache = lm.forward(cfg, params, tokens, cache=cache,
                                   mode="prefill", impl=impl,
                                   valid_len=true_len)
        tok = _greedy(logits[:, true_len - 1:true_len], cfg)
        return tok, lm.mask_cache_positions(cache, true_len)
    return prefill_step


def make_chunk_prefill_step(cfg: ModelConfig, chunk: int,
                            impl: str = "kernel"):
    """chunk(params, caches, piece [1, C], start, rows {"global": [W],
    "window": [W]}, last_idx, slot, valid) -> (candidate_tok [1], caches).

    One C-row slice of a prompt, straight against the paged tree: its rows
    are written through the lane's tables (global blocks, window ring),
    the lane's recurrent state slabs carry the scan across slices
    (``lm.lane_view``), attention reads everything resident so far, and
    the greedy token is read at ``last_idx`` (meaningful on the final
    slice only).  ``valid`` counts the slice's real rows: a final slice's
    pad rows freeze the recurrent state, and their K/V rows land past the
    lane's context (on the null page where the table does not reach),
    where no query reads them."""
    def chunk_step(params, caches, piece, start, rows, last_idx, slot,
                   valid):
        positions = start + torch.arange(chunk, dtype=torch.int32,
                                         device=piece.device)
        g_row, w_row = rows.get("global"), rows.get("window")
        logits, _ = lm.forward(
            cfg, params, piece, positions=positions,
            cache=lm.lane_view(cfg, caches, slot), mode="prefill",
            impl=impl,
            paged_tables=None if g_row is None else g_row[None],
            window_tables=None if w_row is None else w_row[None],
            valid_len=valid)
        return _greedy(logits[:, last_idx:last_idx + 1], cfg), caches
    return chunk_step


def make_paged_decode_step(cfg: ModelConfig, impl: str = "kernel"):
    """decode(params, caches, toks [B], pos [B], tables {"global": [B, W],
    "window": [B, W]} (each present when the model has such layers),
    active [B] bool) -> (next_toks [B], caches).  One batched step over
    every lane; each lane writes its row through its table (inactive lanes
    hold null rows, so their writes land in the scratch page), and
    ``active`` confines the recurrent state update to the lanes actually
    decoding: every recurrent layer's new state goes through
    ``lm.freeze_state_lanes`` as soon as it is computed.  The step waits
    on nothing from the device."""
    def decode_step(params, caches, toks, pos, tables, active):
        def freeze(key, new):
            lm.freeze_state_lanes(cfg, caches, {key: new}, active)

        logits, caches = lm.forward(cfg, params, toks[:, None],
                                    positions=pos, cache=caches,
                                    mode="decode", impl=impl,
                                    paged_tables=tables.get("global"),
                                    window_tables=tables.get("window"),
                                    state_sink=freeze)
        return _greedy(logits, cfg), caches
    return decode_step


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
    def generate(self, prompts, max_new_tokens: int) -> torch.Tensor:
        """prompts: [B, S] token ids -> [B, max_new_tokens] int32 tokens
        (the prefill's token first)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        B, S = prompts.shape
        cache = lm.init_cache(self.cfg, B, self.kv_len, self.dtype,
                              self.device)
        tok, cache = self._prefill(self.params, cache, prompts)
        out = [tok]
        for t in range(max_new_tokens - 1):
            pos = torch.tensor(S + t, dtype=torch.int32, device=self.device)
            tok, cache = self._decode(self.params, cache, tok[:, None], pos)
            out.append(tok)
        return torch.stack(out, dim=1)


@dataclass
class ContinuousEngine:
    """Continuous-batching greedy engine, dense lanes or a physical paged
    KV cache.

    Requests are ``submit()``-ed with an arrival step, then ``run()``
    drives the loop: admit arrived requests into free slots (worst-case
    block reservation; with ``paged=True`` also a window ring for a model
    with sliding-window layers and a state slot for a recurrent model),
    prefill each (whole, bucketed, or in chunks of ``prefill_chunk`` rows,
    one chunk per engine step), run one decode step over the decoding
    lanes, retire finished slots and reclaim their blocks, rings and state
    slots.  The prefix cache, speculation and sampling raise
    ``NotImplementedError``.

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
    speculate: int = 0
    device: Optional[object] = None
    telemetry: Optional[ServeTelemetry] = None
    # the compiled plan of the served decode shape; it sizes the cache
    # length and lane count, and is the plan --adapt rebalances
    plan: Optional[object] = field(default=None, repr=False)
    _next_rid: int = field(default=0, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for name in ("prefix_cache", "speculate"):
            if getattr(self, name):
                raise NotImplementedError(f"{name} is not ported yet")
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
        groups = lm.serve_groups(self.cfg)
        self._has_global = bool(groups["paged"])
        self._has_window = bool(groups["window"])
        self._has_state = bool(groups["recurrent"])
        if self.paged:
            self._init_paged()
        else:
            # dense lanes: the allocator only accounts, a block per
            # block_size rows of a lane
            self.allocator = BlockAllocator(CacheConfig(
                block_size=self.block_size,
                n_blocks=self.n_slots * -(-self.kv_len // self.block_size)))
            self._caches = lm.init_slot_caches(self.cfg, self.n_slots,
                                               self.kv_len, self.dtype,
                                               self.device)
            self._decode = make_serve_step(self.cfg, self.impl)
        self.scheduler = SlotScheduler(self.n_slots, self.allocator,
                                       self.kv_len)
        if self.telemetry is None:
            self.telemetry = ServeTelemetry()
        self._prefill = make_prefill_step(self.cfg, self.impl)
        self._prefill_b = make_bucketed_prefill_step(self.cfg, self.impl)
        self._toks = torch.zeros(self.n_slots, dtype=torch.int32,
                                 device=self.device)
        self._pos = torch.zeros(self.n_slots, dtype=torch.int32,
                                device=self.device)
        self._now = 0
        self._rids: set = set()
        # slot -> [prompt, chunks done] while chunk-prefilling
        self._prefilling: dict[int, list] = {}

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
        """Page pools, per-group block tables, recurrent state slabs and
        the stores bound to the allocator."""
        has_blocks = self._has_global or self._has_window
        if has_blocks and self.kv_len % self.block_size:
            raise ValueError(
                f"paged mode needs kv_len ({self.kv_len}) divisible by "
                f"block_size ({self.block_size}) so the gathered KV view "
                "matches the dense oracle's shape (token identity)")
        # a published table (global or window ring) spans the full context
        self._max_blocks = (self.kv_len // self.block_size if has_blocks
                            else 0)
        # per-slot block budget: a global table grows to the full context;
        # a window ring is capped at O(window) blocks; recurrent layers
        # hold state slots, no blocks
        per_slot = (self._max_blocks if self._has_global else 0) + \
            self._window_cap_blocks()
        cache_cfg = CacheConfig(block_size=self.block_size,
                                n_blocks=self.n_slots * per_slot)
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
            window=(min(self.kv_len, self.cfg.window_size)
                    if self._has_window else 0),
            window_cap_blocks=self._window_cap_blocks(),
            state_slots=self.n_slots if self._has_state else 0,
            state_bytes_per_slot=lm.state_bytes_per_slot(self.cfg,
                                                         self._caches),
            prefill_chunk=self.prefill_chunk))
        self._null_row = torch.full((self._max_blocks,),
                                    cache_cfg.null_block, dtype=torch.int32,
                                    device=self.device)
        # one published [n_slots, W] table per block group
        self._tables = {group: self._null_row.repeat(self.n_slots, 1)
                        for group, has in (("global", self._has_global),
                                           ("window", self._has_window))
                        if has}
        # lanes holding a decoding request, kept on the device so the
        # decode step never reads it back; a lane mid chunked prefill
        # stays out, so the decode step leaves its carried state alone
        self._active = torch.zeros(self.n_slots, dtype=torch.bool,
                                   device=self.device)
        self._decode_p = make_paged_decode_step(self.cfg, self.impl)
        if self.prefill_chunk:
            self._chunk = make_chunk_prefill_step(self.cfg,
                                                  self.prefill_chunk,
                                                  self.impl)
        self._rows: dict[int, dict] = {}       # prefilling slot -> rows
        self._host_pos: dict[int, int] = {}

    def submit(self, prompt, max_new_tokens: int, *, rid=None,
               arrival: int = 0, eos_id: Optional[int] = None,
               sampling=None) -> object:
        """Queue a request; returns its id.  ``prompt`` is a 1-D sequence
        of token ids; ``arrival`` the engine step at which it becomes
        admissible."""
        if sampling is not None:
            raise NotImplementedError("sampling is not ported yet")
        prompt = [int(t) for t in prompt]
        if rid is None:
            while self._next_rid in self._rids:
                self._next_rid += 1
            rid = self._next_rid
            self._next_rid += 1
        elif rid in self._rids:
            raise ValueError(f"duplicate request id {rid!r}")
        self.scheduler.submit(Request(rid=rid, prompt=prompt,
                                      max_new_tokens=max_new_tokens,
                                      arrival=arrival, eos_id=eos_id))
        self._rids.add(rid)
        return rid

    def _full_prefill(self, prompt: torch.Tensor) -> tuple:
        """Whole-prompt prefill, right-padded to its bucket with
        ``bucket_prompts``, into a fresh dense single-request cache (a
        fresh one each time: the prefill writes it in place)."""
        cache = lm.init_cache(self.cfg, 1, self.kv_len, self.dtype,
                              self.device)
        if not self.bucket_prompts:
            return self._prefill(self.params, cache, prompt[None])
        n = prompt.shape[0]
        padded = torch.zeros((1, bucket_length(n, self.kv_len)),
                             dtype=torch.int32, device=self.device)
        padded[0, :n] = prompt
        return self._prefill_b(self.params, cache, padded, n)

    def _window_cap_blocks(self) -> int:
        """Most blocks one lane's window ring can pin at once: the blocks
        covering the window span plus one of block-alignment slack, plus
        the in-flight chunk's during chunked prefill, never more than a
        full-context table."""
        if not self._has_window:
            return 0
        bf = lambda n: -(-n // self.block_size)          # noqa: E731
        wc = min(self.kv_len, self.cfg.window_size)
        cap = bf(wc) + 1 + (bf(self.prefill_chunk) if self.prefill_chunk
                            else 0)
        return min(bf(self.kv_len), cap)

    def _refresh_row(self, slot: int, group: str) -> torch.Tensor:
        """``slot``'s table row for ``group`` from the allocator's tables."""
        if group == "global":
            row = self.allocator.padded_table(slot, self._max_blocks)
        else:
            row = self.allocator.padded_window_table(slot, self._max_blocks)
        return torch.tensor(row, dtype=torch.int32, device=self.device)

    def _admit_one(self, act: ActiveSlot) -> None:
        slot = act.slot
        prompt = torch.tensor(act.request.prompt, dtype=torch.int32,
                              device=self.device)
        if not self.paged:
            tok, cache = self._full_prefill(prompt)
            lm.write_slot_cache(self._caches, cache, slot)
            self._toks[slot] = tok[0]
            self._pos[slot] = act.request.prompt_len
            act.first_token_step = self._now
            act.tokens.append(int(tok[0]))
            return
        rows = {group: self._refresh_row(slot, group)
                for group in self._tables}
        if self.prefill_chunk:
            # one chunk per engine step from the next one on, interleaved
            # with decode; a reused lane still holds its previous
            # occupant's state, reset before the chunks carry state in
            if self._has_state:
                lm.zero_state_lane(self.cfg, self._caches, slot)
            self._rows[slot] = rows
            self._prefilling[slot] = [prompt, 0]
            return
        tok, cache = self._full_prefill(prompt)
        # whole-prompt admission overwrites the lane's state slabs, so a
        # reused lane needs no reset
        lm.insert_paged_prompt(self.cfg, self._caches, cache, rows, slot,
                               block_size=self.block_size,
                               null_block=self.allocator.config.null_block)
        self._activate_lane(slot, tok[0], act.request.prompt_len, rows)
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
        with the decode lane activated, once the prompt is resident."""
        prompt, done = self._prefilling[slot]
        C = self.prefill_chunk
        start = done * C
        total = prompt.shape[0]
        piece = prompt[start:start + C]
        valid = piece.shape[0]                 # real rows in this slice
        if valid < C:                          # pad the final chunk to C
            piece = torch.cat([piece, piece.new_zeros(C - valid)])
        if self._has_window:
            # slide the ring over this slice; rows behind the slice's
            # first query keep their window (freed once fully behind)
            fresh, freed = self.allocator.extend_window(
                slot, min(start + C, total), first_query_pos=start)
            if fresh or freed:
                self._rows[slot]["window"] = self._refresh_row(slot,
                                                               "window")
        last = total - 1 - start               # meaningful on the last one
        tok, self._caches = self._chunk(
            self.params, self._caches, piece[None], start, self._rows[slot],
            min(max(last, 0), C - 1), slot, valid)
        self._prefilling[slot][1] = done + 1
        if start + C < total:
            return False
        del self._prefilling[slot]
        self._activate_lane(slot, tok[0], total, self._rows.pop(slot))
        act = self.scheduler.active[slot]
        act.first_token_step = self._now
        act.tokens.append(int(tok[0]))
        return True

    def _finish(self, slot: int) -> list:
        """Retire ``slot``: reclaim its blocks and state slot and, paged,
        unmap its table rows and freeze its state slabs."""
        act = self.scheduler.finish(slot)
        if self.paged:
            for table in self._tables.values():
                table[slot] = self._null_row
            self._active[slot] = False
            self._host_pos.pop(slot, None)
        return act.tokens

    def _grow_tables(self, decoding: list) -> None:
        """Claim the block backing each lane's next write before the
        decode step runs (the write needs a physical destination; a model
        without attention layers never claims one).  Window rings also
        free every block that has fallen fully behind ``pos - window``."""
        for slot in decoding:
            n_res = self._host_pos[slot] + 1
            if self._has_global and self.allocator.extend(slot, n_res):
                self._tables["global"][slot] = self._refresh_row(slot,
                                                                 "global")
            if self._has_window:
                fresh, freed = self.allocator.extend_window(slot, n_res)
                if fresh or freed:
                    self._tables["window"][slot] = self._refresh_row(
                        slot, "window")

    def _decode_lanes(self, decoding: list) -> torch.Tensor:
        """Dense lanes: one B=1 decode step per decoding lane on its own
        cache (lanes that hold no decoding request are not run)."""
        toks = self._toks.clone()
        for slot in decoding:
            tok, _ = self._decode(self.params,
                                  lm.slot_cache(self._caches, slot),
                                  self._toks[slot].reshape(1, 1),
                                  self._pos[slot])
            toks[slot] = tok[0]
        return toks

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

            if self.paged:
                self._grow_tables(decoding)
                toks, self._caches = self._decode_p(
                    self.params, self._caches, self._toks, self._pos,
                    self._tables, self._active)
            else:
                toks = self._decode_lanes(decoding)
            self._toks = toks
            self._pos = self._pos + 1
            toks_host = toks.tolist()          # one device->host transfer
            t_decode = time.perf_counter() - t1
            new_tokens = 0
            for slot in decoding:
                act = self.scheduler.active[slot]
                act.tokens.append(toks_host[slot])
                new_tokens += 1
                if self.paged:
                    self._host_pos[slot] += 1
                else:
                    # rows resident after this step: the prompt and every
                    # decode write so far (the new token is not written)
                    self.allocator.extend(slot, act.position - 1)
                if act.is_finished():
                    results[act.request.rid] = self._finish(slot)
            self._record_step(now, t0, decoding, prefills, chunks,
                              new_tokens, t_prefill, t_decode, t_chunk)
            self._now = now + 1
            steps += 1
        return results

    def _record_step(self, now: int, t0: float, active_slots, prefills: int,
                     chunks: int, new_tokens: int, prefill_seconds: float,
                     decode_seconds: float, chunk_seconds: float) -> None:
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
            decode_seconds=decode_seconds, chunk_seconds=chunk_seconds)
