"""Model blocks: RMSNorm, RoPE, GQA attention (global or sliding-window)
over no cache, a dense cache or a paged block pool, the gated FFN and the
capacity-bounded mixture-of-experts FFN.

A port of ``repro.models.blocks`` (the attention, FFN and MoE subset).
Parameters are plain dicts of tensors under the reference's keys.  Attention
has two implementations, chosen by ``impl``:

* ``"kernel"`` (default) — the hand-written Hopper kernels through their
  ``ops`` wrappers (on CPU tensors the wrappers run the plain version);
* ``"plain"``  — plain PyTorch, the reference path the kernels are held
  against.

Conventions follow the reference: q/k/v are [B, S, H, hd]; caches hold
post-RoPE keys.  Unlike the reference, whose functions return new arrays,
cache writes here happen in place (``_prefill_cache``, the dense decode
slot write and ``paged_write``): the functions return the cache dict they
were given, updated.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref

from .config import ModelConfig

NEG_INF = -1e30
IMPLS = ("kernel", "plain")


# =============================================================================
# initializers / norms / rope
# =============================================================================

def normal_init(gen: torch.Generator, shape: tuple, std: float, dtype,
                device) -> torch.Tensor:
    """N(0, std^2) values of ``shape`` in ``dtype``, drawn in f32 one
    leading index at a time (a stacked leaf's layer; a single matrix's
    block of an eighth of its rows) and rounded into the leaf, so that no
    leaf needs an f32 copy of itself: a full-width stack in f32 is tens of
    GB beside its bf16 leaf."""
    w = torch.empty(shape, dtype=dtype, device=device)
    rows = w.view(-1, shape[-1]) if w.dim() > 1 else w.view(1, -1)
    step = (rows.shape[0] // shape[0] if w.dim() > 2 and shape[0] > 1
            else -(-rows.shape[0] // 8))
    for part in rows.split(max(step, 1)):
        part.copy_(torch.randn(part.shape, generator=gen, device=device,
                               dtype=torch.float32).mul_(std))
    return w


def dense_init(gen: torch.Generator, shape: tuple, dtype,
               device) -> torch.Tensor:
    """Normal / sqrt(d_in) weights of ``shape`` (..., d_in, d_out)
    (``normal_init``)."""
    return normal_init(gen, shape, 1.0 / math.sqrt(shape[-2]), dtype, device)


class _RMSNorm(torch.autograd.Function):
    """The reference's ``custom_vjp``: f32 math both ways, cotangents
    returned in the input dtypes (d_x in x's, d_scale in scale's)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        xf = x.float()
        rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, scale, rstd)
        return (xf * rstd * (1.0 + scale.float())).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale, rstd = ctx.saved_tensors
        gf = g.float()
        xhat = x.float() * rstd
        d_scale = (gf * xhat).sum(dim=tuple(range(g.dim() - 1)))
        gx = gf * (1.0 + scale.float())
        d_x = rstd * (gx - xhat * (gx * xhat).mean(dim=-1, keepdim=True))
        return d_x.to(x.dtype), d_scale.to(scale.dtype), None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 internals and a ``(1 + scale)`` gain; its backward
    (``_RMSNorm``) keeps the math in f32 and returns low-precision
    cotangents, as the reference's custom VJP does."""
    return _RMSNorm.apply(x, scale, eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [S] or [B, S] absolute positions.
    Rotates split halves (not interleaved pairs)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# =============================================================================
# attention core
# =============================================================================

def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, KV, hd] -> [B, S, H, hd], each KV head repeated H/KV times."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // n_kv, dim=2)


def _scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                 window: int) -> torch.Tensor:
    """[Sq, Skv] validity from absolute positions (k_pos -1 = empty slot)."""
    m = k_pos[None, :] >= 0
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if window:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m


def attention(q, k, v, *, q_positions, k_positions, causal: bool = True,
              window: int = 0, logit_softcap: float = 0.0,
              impl: str = "kernel") -> torch.Tensor:
    """Softmax attention with GQA, optional sliding window and softcap.

    q: [B, Sq, H, hd]; k: [B, Skv, KV, hd]; v: [B, Skv, KV, dv]; positions
    are absolute int32.  Returns [B, Sq, H, dv]: the output head dim
    follows V's, which MLA sets apart from Q's (the kernel takes dv != hd
    only for hd 192 with dv 128, and raises on any other such pair)."""
    if impl == "kernel":
        return fa_ops.flash_attention(
            q, k, v, q_positions=q_positions, k_positions=k_positions,
            causal=causal, window=window, logit_softcap=logit_softcap)
    if impl != "plain":
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    n_heads = q.shape[2]
    k = _expand_kv(k, n_heads)
    v = _expand_kv(v, n_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return _attn_block(q, k, v, q_positions, k_positions, scale, causal,
                       window, logit_softcap)


def _attn_block(q, k, v, q_pos, k_pos, scale, causal, window, cap):
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = softcap(scores, cap)
    mask = _scores_mask(q_pos, k_pos, causal=causal, window=window)
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# =============================================================================
# attention layer (projections + cache handling)
# =============================================================================

def init_attention(gen: torch.Generator, cfg: ModelConfig, repeats: int,
                   dtype, device) -> dict:
    d = cfg.d_model
    return {
        "ln": torch.zeros((repeats, d), dtype=dtype, device=device),
        "wq": dense_init(gen, (repeats, d, cfg.q_dim), dtype, device),
        "wk": dense_init(gen, (repeats, d, cfg.kv_dim), dtype, device),
        "wv": dense_init(gen, (repeats, d, cfg.kv_dim), dtype, device),
        "wo": dense_init(gen, (repeats, cfg.q_dim, d), dtype, device),
    }


def init_attn_cache(cfg: ModelConfig, batch: int, kv_len: int, dtype,
                    device, local: bool = False) -> dict:
    """Dense K/V cache; a sliding-window layer holds only ``min(kv_len,
    window)`` rows, filled as a ring (slot = position % size)."""
    size = min(kv_len, cfg.window_size) if (local and cfg.window_size) \
        else kv_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # absolute position held by each slot; -1 = empty
        "pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def init_paged_attn_cache(cfg: ModelConfig, n_pages: int, block_size: int,
                          dtype, device) -> dict:
    """K/V page pools shared by every decode lane; ``n_pages`` includes the
    trailing null (scratch) page inactive lanes write into."""
    shape = (n_pages, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def paged_write(k_pages, v_pages, tables, positions, k, v) -> tuple:
    """Scatter per-token rows into a pair of page pools through block
    tables, in place.

    tables: [B, max_blocks]; positions: [B] (decode: one row per lane) or
    [S] with B == 1; k, v: [B, S, KV, hd].  Rows whose table entry is the
    null page, and rows past the table's reach, land in the last (scratch)
    page, which reads never see (they are masked by ``context_lens``)."""
    bs = k_pages.shape[1]
    width = tables.shape[1]
    null = k_pages.shape[0] - 1
    blk = positions.long() // bs
    safe = blk.clamp(max=width - 1)
    off = positions.long() % bs
    if k.shape[0] == positions.shape[0]:          # decode: one row per lane
        phys = tables.gather(1, safe[:, None])[:, 0]
        rows_k, rows_v = k[:, 0], v[:, 0]
    else:                                          # one lane, S rows
        phys = tables[0, safe]
        rows_k, rows_v = k[0], v[0]
    phys = torch.where(blk < width, phys.long(), null)
    k_pages[phys, off] = rows_k
    v_pages[phys, off] = rows_v
    return k_pages, v_pages


def attn_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, *, local: bool,
               positions: torch.Tensor, cache: Optional[dict] = None,
               impl: str = "kernel",
               paged_tables: Optional[torch.Tensor] = None,
               valid_len: Optional[int] = None,
               kv_override: Optional[tuple] = None) -> tuple:
    """Pre-norm attention block, global or (``local``) sliding-window over
    ``cfg.window_size``.  Returns (residual output, cache).

    No cache or a prefill cache: ``positions`` = [S].  Dense decode: x is
    [B, 1, D] and ``positions`` a 0-d tensor of the current position.
    Paged decode (cache holds ``k_pages``/``v_pages``, ``paged_tables`` is
    [B, max_blocks]): x is [B, 1, D] and ``positions`` = [B] per-lane
    positions; each lane's row is written through its table, then the
    paged kernel attends over the lane's resident rows.  Paged chunk
    prefill: x is [1, C, D] and ``positions`` = [C], the chunk's rows of
    one lane; they are written through its table (rows past the table's
    reach to the null page), then the plain gather
    (``paged_attention.ref.reference``) attends causally over everything
    resident, as the reference does: no kernel computes a multi-row paged
    read.  A local layer's table is its lane's window ring (entries behind
    the window are the null page) and the window mask keeps rows behind
    ``pos - window`` out.  ``valid_len`` (dense prefill only): rows at
    positions >= ``valid_len`` are padding and never displace real rows of
    a window ring.

    Cross attention (``kv_override = (k [B, Skv, KV, hd], v, k_positions
    [Skv])``): the queries, without RoPE, attend non-causally over the
    given K/V (rows at position -1 are empty) through the flash kernel,
    whatever the cache; a decode step's [B] lanes are one launch of Sq =
    1, the queries' positions being immaterial without a causal mask."""
    B, S, _ = x.shape
    window = cfg.window_size if local else 0
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if kv_override is not None:
        k, v, k_pos = kv_override
        o = attention(q, k, v, q_positions=positions.reshape(-1)[:S],
                      k_positions=k_pos, causal=False, impl=impl)
        return x + o.reshape(B, S, cfg.q_dim) @ p["wo"], cache
    k = (h @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    cap = cfg.attn_logit_softcap

    if cache is not None and "k_pages" in cache:
        if paged_tables is None:
            raise ValueError("a paged cache needs block tables")
        pos = positions.reshape(-1)              # [B] decode, [C] chunk
        rope_pos = pos[:, None] if S == 1 else pos
        q = apply_rope(q, rope_pos, cfg.rope_theta)
        k = apply_rope(k, rope_pos, cfg.rope_theta)
        paged_write(cache["k_pages"], cache["v_pages"], paged_tables, pos,
                    k, v)
        if S == 1:
            ctx = pos + 1              # resident incl. the token just written
            q_pos = pos[:, None]
        else:                          # one lane's chunk: its last row's
            ctx = pos[-1:] + 1         # context, each row its own position
            q_pos = pos[None]
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if S == 1 and impl == "kernel":
            o = pa_ops.paged_attention(
                q[:, 0], cache["k_pages"], cache["v_pages"], paged_tables,
                ctx, logit_softcap=cap, window=window)[:, None]
        else:
            o = pa_ref.reference(
                q, cache["k_pages"], cache["v_pages"], paged_tables, ctx,
                q_positions=q_pos, logit_softcap=cap, window=window)
    elif cache is None or S > 1:       # no cache, or prefill filling one
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = attention(q, k, v, q_positions=positions, k_positions=positions,
                      causal=True, window=window, logit_softcap=cap,
                      impl=impl)
        if cache is not None:
            _prefill_cache(cache, k, v, positions, window, valid_len)
    else:                              # dense decode step
        pos = positions.reshape(())
        q = apply_rope(q, pos[None], cfg.rope_theta)
        k = apply_rope(k, pos[None], cfg.rope_theta)
        # index_copy_ keeps the slot on the device (no host round trip)
        size = cache["k"].shape[1]
        slot = (torch.remainder(pos, size) if window
                else pos.clamp(max=size - 1)).long().reshape(1)
        cache["k"].index_copy_(1, slot, k)
        cache["v"].index_copy_(1, slot, v)
        cache["pos"].index_copy_(0, slot, pos.to(torch.int32).reshape(1))
        o = attention(q, cache["k"], cache["v"], q_positions=pos[None],
                      k_positions=cache["pos"], causal=True, window=window,
                      logit_softcap=cap, impl=impl)

    out = o.reshape(B, S, cfg.q_dim) @ p["wo"]
    return x + out, cache


def _prefill_cache(cache: dict, k, v, positions, window: int = 0,
                   valid_len: Optional[int] = None) -> dict:
    """The prompt's rows into the dense cache, in place.  Global layers,
    and window layers whose prompt fits: the rows (the last ``size`` of
    them when the prompt is longer than the cache) fill slots 0.. (a
    bucketed prompt's pad rows land in slots of their own, which
    ``lm.mask_cache_positions`` then marks empty).  A window layer's
    longer prompt: its last ``size`` real rows go to their ring slots,
    position % size; with ``valid_len`` the real rows end there, and where
    the ``size``-row slice still holds pad rows (a short prompt) the slots
    keep what they held: a pad row at position p would alias the slot of
    p - size."""
    size = cache["k"].shape[1]
    S = k.shape[1]
    if not window or S <= size:
        n = min(S, size)
        cache["k"][:, :n] = k[:, -n:]
        cache["v"][:, :n] = v[:, -n:]
        cache["pos"][:n] = positions[-n:].to(torch.int32)
        return cache
    start = S - size if valid_len is None else \
        min(max(valid_len - size, 0), S - size)
    tail_k, tail_v = k[:, start:start + size], v[:, start:start + size]
    tail_pos = positions[start:start + size].to(torch.int32)
    slots = torch.remainder(tail_pos, size).long()
    if valid_len is not None:
        keep = tail_pos < valid_len
        tail_k = torch.where(keep[None, :, None, None], tail_k,
                             cache["k"][:, slots])
        tail_v = torch.where(keep[None, :, None, None], tail_v,
                             cache["v"][:, slots])
        tail_pos = torch.where(keep, tail_pos, cache["pos"][slots])
    cache["k"][:, slots] = tail_k
    cache["v"][:, slots] = tail_v
    cache["pos"][slots] = tail_pos
    return cache


# =============================================================================
# FFN (SwiGLU / GeGLU) and MoE
# =============================================================================

def init_ffn(gen: torch.Generator, cfg: ModelConfig, repeats: int, dtype,
             device, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "ln": torch.zeros((repeats, d), dtype=dtype, device=device),
        "w_gate": dense_init(gen, (repeats, d, f), dtype, device),
        "w_up": dense_init(gen, (repeats, d, f), dtype, device),
        "w_down": dense_init(gen, (repeats, f, d), dtype, device),
    }


def _act_fn(name: str):
    if name == "gelu":   # jax.nn.gelu's default is the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    return F.silu


def ffn_layer(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    act = _act_fn(cfg.ffn_act)
    out = (act(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]
    return x + out



def init_moe(gen: torch.Generator, cfg: ModelConfig, repeats: int, dtype,
             device) -> dict:
    """Routed experts ``[repeats, E, D, F]`` / ``[repeats, E, F, D]``, the
    router ``[repeats, D, E]`` in f32 whatever ``dtype`` (the reference
    keeps it so), and the shared experts as one gated FFN of width
    ``n_shared_experts * d_ff_expert`` without a norm of its own (it reads
    the MoE's pre-norm)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p = {
        "ln": torch.zeros((repeats, d), dtype=dtype, device=device),
        "router": dense_init(gen, (repeats, d, E), torch.float32, device),
        "w_gate": dense_init(gen, (repeats, E, d, f), dtype, device),
        "w_up": dense_init(gen, (repeats, E, d, f), dtype, device),
        "w_down": dense_init(gen, (repeats, E, f, d), dtype, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(gen, cfg, repeats, dtype, device,
                               d_ff=cfg.n_shared_experts * cfg.d_ff_expert)
        del p["shared"]["ln"]
    return p


def moe_route(cfg: ModelConfig, p: dict, flat: torch.Tensor, *,
              capacity_factor: float, lossless: bool) -> tuple:
    """Routing of ``moe_layer`` over the pre-normed tokens ``flat`` [G, Tg,
    D]: returns (probs [G, Tg, E] f32, renormalised gates [G, Tg, k], expert
    ids [G, Tg, k], each slot's position within its expert [G, Tg, k],
    keep [G, Tg, k], capacity).  Positions count the expert's earlier
    slots in token-major order, so the capacity keeps the first arrivals
    (which slots drop decides tokens: ``torch.topk`` sorts the k choices
    as ``lax.top_k`` does)."""
    G, Tg, _ = flat.shape
    E, topk = cfg.n_experts, cfg.experts_per_token
    logits = flat.float() @ p["router"]                      # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, topk, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    capacity = (Tg * topk if lossless
                else max(1, int(Tg * topk * capacity_factor / E)))
    flat_oh = F.one_hot(gate_idx, E).reshape(G, Tg * topk, E)
    pos_in_e = (flat_oh.cumsum(dim=1) - flat_oh).reshape(G, Tg, topk, E)
    pos = pos_in_e.gather(-1, gate_idx[..., None])[..., 0]   # [G, Tg, k]
    return probs, gate_vals, gate_idx, pos, pos < capacity, capacity


def moe_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              capacity_factor: float = 1.25, n_groups: int = 1,
              lossless: bool = False) -> tuple:
    """Capacity-bounded top-k MoE with the reference's grouped dispatch;
    returns (residual output, router aux loss).

    The ``B * S`` tokens split into ``n_groups`` dispatch groups (one when
    the count does not divide).  Per group: f32 router softmax, top-k with
    the gates renormalised, each (token, slot) placed at its exclusive
    cumsum position within its expert in token-major order, and kept when
    that position is under the capacity ``max(1, int(Tg * k * cf / E))``
    (``Tg * k`` when ``lossless``: nothing drops).  Kept rows scatter into
    ``[G, E, C, D]`` (dropped ones into a sentinel row), every expert runs
    its gated FFN over its C rows, and the rows gather back weighted by
    their gates.  The shared experts read the same pre-norm.  The aux loss
    is the Switch load-balancing term over the top-1 choices, times
    ``router_aux_coef``."""
    B, S, D = x.shape
    E, topk = cfg.n_experts, cfg.experts_per_token
    T = B * S
    G = n_groups if T % n_groups == 0 else 1
    Tg = T // G
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    flat = h.reshape(G, Tg, D)
    probs, gate_vals, gate_idx, pos, keep, capacity = moe_route(
        cfg, p, flat, capacity_factor=capacity_factor, lossless=lossless)

    density = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(density * mean_prob) * cfg.router_aux_coef

    dest = torch.where(keep, gate_idx * capacity + pos, E * capacity)
    dest = dest.reshape(G, Tg * topk)
    src = flat[:, :, None, :].expand(G, Tg, topk, D).reshape(G, Tg * topk, D)
    dispatched = flat.new_zeros((G, E * capacity + 1, D))
    dispatched.scatter_(1, dest[..., None].expand(-1, -1, D), src)
    dispatched = dispatched[:, :-1].reshape(G, E, capacity, D)

    act = _act_fn(cfg.ffn_act)
    hidden = act(torch.einsum("gecd,edf->gecf", dispatched, p["w_gate"])) * \
        torch.einsum("gecd,edf->gecf", dispatched, p["w_up"])
    expert_out = torch.einsum("gecf,efd->gecd", hidden, p["w_down"])

    flat_out = torch.cat([expert_out.reshape(G, E * capacity, D),
                          expert_out.new_zeros((G, 1, D))], dim=1)
    gathered = flat_out.gather(1, dest[..., None].expand(-1, -1, D)) \
        .reshape(G, Tg, topk, D)
    weights = gate_vals.to(flat.dtype) * keep.to(flat.dtype)
    combined = torch.einsum("gtkd,gtk->gtd", gathered, weights)

    out = combined.reshape(B, S, D)
    if "shared" in p:
        sh = p["shared"]
        out = out + (act(h @ sh["w_gate"]) * (h @ sh["w_up"])) @ sh["w_down"]
    return x + out, aux
