"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427): the
port of ``repro.models.rglru``.

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    a_t = exp(-c * softplus(Λ) * r_t),   r_t, i_t = sigmoid(W x_t)

Block layout is the Griffin recurrent block: two input branches
(recurrence + GeLU gate), temporal conv on the recurrence branch,
multiplicative merge, output projection.  Prefill runs the linear
recurrence over the sequence; decode is the O(1) step in plain PyTorch.
The prefill scan has two implementations, chosen by ``impl``:

* ``"kernel"`` (default) — the hand-written Hopper RG-LRU scan kernel
  through ``kernels.rglru_scan.ops`` (its plain version on CPU tensors).
  It takes the cache's state as its initial state, so every prefill runs
  on it, with a cache or without;
* ``"plain"`` — ``_lru_scan``, the plain PyTorch reference path.

Like the reference, these functions leave the cache alone and return the
new cache leaves; ``models.lm`` writes them into the cache tree.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rglru_scan import ref as rglru_ref

from .blocks import IMPLS, dense_init, rms_norm
from .config import ModelConfig

_C = 8.0  # Griffin's fixed gate sharpness


def init_rglru(gen: torch.Generator, cfg: ModelConfig, repeats: int, dtype,
               device) -> dict:
    """The reference's leaves and distributions, stacked to ``[repeats,
    ...]``: ``a_param`` in float32 with ``a = exp(-c softplus(a_param))``
    uniform in (0.9, 0.999) (Griffin's appendix), a temporal conv kernel
    N(0, 1/lru_block_width), dense weights N(0, 1/d_in), norm scale
    zero."""
    w, d, R = cfg.lru_width, cfg.d_model, repeats
    u = torch.rand((R, w), generator=gen, device=device,
                   dtype=torch.float32) * (0.999 - 0.9) + 0.9
    a_param = torch.log(torch.expm1(-torch.log(u) / _C))
    conv_w = torch.randn((R, cfg.lru_block_width, w), generator=gen,
                         device=device, dtype=torch.float32)
    return {
        "ln": torch.zeros((R, d), dtype=dtype, device=device),
        "w_x": dense_init(gen, (R, d, w), dtype, device),
        "w_g": dense_init(gen, (R, d, w), dtype, device),
        "conv_w": (conv_w / math.sqrt(cfg.lru_block_width)).to(dtype),
        "w_rg": dense_init(gen, (R, w, w), dtype, device),
        "w_ig": dense_init(gen, (R, w, w), dtype, device),
        "a_param": a_param,
        "w_out": dense_init(gen, (R, w, d), dtype, device),
    }


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """Conv-input tail ``[B, lru_block_width - 1, lru_width]`` and the f32
    recurrence state ``[B, lru_width]``."""
    w = cfg.lru_width
    return {
        "conv": torch.zeros((batch, cfg.lru_block_width - 1, w),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, w), dtype=torch.float32,
                             device=device),
    }


def _conv(x: torch.Tensor, w: torch.Tensor,
          state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal temporal conv. x: [B, S, W], w: [K, W]; the ``K - 1`` rows
    before x come from ``state`` (zeros when None)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    return sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))


def _lru_scan(a: torch.Tensor, bx: torch.Tensor,
              h0: Optional[torch.Tensor] = None) -> tuple:
    """h_t = a_t h_{t-1} + bx_t over axis 1 (f32), ``h0`` folded into the
    first row.  Returns (hs, h_final)."""
    return rglru_ref.reference(a, bx, h0)


def rglru_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                cache: Optional[dict] = None, impl: str = "kernel",
                valid_len: Optional[int] = None) -> tuple:
    """Returns (residual output, new cache leaves or None).

    Prefill with a cache continues from the cache's recurrence and conv
    state (zeros for a fresh cache) and returns the new conv tail and final
    state; with a cache and a single row it takes the recurrent decode
    step.  ``valid_len`` (prefill only) freezes the recurrence past that
    many rows: pad rows get (a, bx) = (1, 0), the scan's identity, and the
    conv tail is read from the last real rows."""
    B, S, _ = x.shape
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    xb = h @ p["w_x"]
    gate = F.gelu(h @ p["w_g"], approximate="tanh")
    decode = cache is not None and S == 1

    if decode:
        conv_in = torch.cat([cache["conv"].to(x.dtype), xb], dim=1)
        new_conv = conv_in[:, 1:]
        xc = torch.einsum("bkc,kc->bc", conv_in, p["conv_w"])[:, None]
        h0 = cache["state"]
    else:
        conv_state = cache["conv"] if cache is not None else None
        xc = _conv(xb, p["conv_w"], state=conv_state)
        h0 = cache["state"] if cache is not None else None
        if cache is not None:
            pad = cfg.lru_block_width - 1
            full = torch.cat([conv_state.to(x.dtype), xb], dim=1)
            # the last ``pad`` real rows: positions [end - pad, end)
            end = S if valid_len is None else valid_len
            new_conv = full[:, end:end + pad]

    r = torch.sigmoid((xc @ p["w_rg"]).float())
    i = torch.sigmoid((xc @ p["w_ig"]).float())
    log_a = -_C * F.softplus(p["a_param"]) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) with a numerical floor
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bx = beta * i * xc.float()

    if not decode and valid_len is not None and S > 1:
        real = torch.arange(S, device=a.device)[None, :, None] < valid_len
        a = torch.where(real, a, 1.0)        # (1, 0), the scan's identity:
        bx = torch.where(real, bx, 0.0)      # pad rows pass the state on

    if decode:
        state = a[:, 0] * h0 + bx[:, 0]
        hs = state[:, None]
    elif impl == "kernel":
        hs, state = rglru_ops.rglru_scan(a, bx, h0)
    else:
        hs, state = _lru_scan(a, bx, h0)

    y = (hs.to(x.dtype) * gate) @ p["w_out"]
    new_cache = ({"conv": new_conv, "state": state}
                 if cache is not None else None)
    return x + y, new_cache
