"""Mamba-2 SSD layer (state-space duality, arXiv:2405.21060): the port of
``repro.models.ssm``.

Prefill uses the chunked dual form (quadratic intra-chunk attention plus a
linear inter-chunk state recurrence); decode is the O(1) recurrent step.
``ngroups=1``: the B/C projections are shared by all SSD heads (the 370M
config).  The chunked core has two implementations, chosen by ``impl``:

* ``"kernel"`` (default) — the hand-written Hopper SSD-scan kernel through
  ``kernels.ssd_scan.ops`` (its plain version on CPU tensors).  Unlike the
  reference's Pallas scan it takes the cache's state as its initial state,
  so every prefill runs on it, with a cache or without;
* ``"plain"`` — ``_ssd_chunked_core``, the plain PyTorch reference path.

Like the reference, these functions leave the cache alone and return the
new cache leaves; ``models.lm`` writes them into the cache tree.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

from .blocks import IMPLS, dense_init, rms_norm
from .config import ModelConfig


def init_ssd(gen: torch.Generator, cfg: ModelConfig, repeats: int, dtype,
             device) -> dict:
    """The reference's leaves and distributions, stacked to ``[repeats,
    ...]``: separate in-projections, a depthwise conv kernel N(0,
    1/d_conv), ``A_log``/``dt_bias`` zeros and ``D`` ones in float32, norm
    scales zero."""
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    d, R = cfg.d_model, repeats
    conv_w = torch.randn((R, cfg.d_conv, di + 2 * ns), generator=gen,
                         device=device, dtype=torch.float32)
    return {
        "ln": torch.zeros((R, d), dtype=dtype, device=device),
        "w_z": dense_init(gen, (R, d, di), dtype, device),
        "w_xbc": dense_init(gen, (R, d, di + 2 * ns), dtype, device),
        "w_dt": dense_init(gen, (R, d, nh), dtype, device),
        "conv_w": (conv_w / math.sqrt(cfg.d_conv)).to(dtype),
        "A_log": torch.zeros((R, nh), dtype=torch.float32, device=device),
        "D": torch.ones((R, nh), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((R, nh), dtype=torch.float32, device=device),
        "out_ln": torch.zeros((R, di), dtype=dtype, device=device),
        "w_out": dense_init(gen, (R, di, d), dtype, device),
    }


def init_ssd_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """Raw conv-input tail ``[B, d_conv - 1, d_inner + 2 ns]`` and the f32
    scan state ``[B, nh, hd, ns]``."""
    di, ns = cfg.d_inner, cfg.ssm_state
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di + 2 * ns),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, hd, ns), dtype=torch.float32,
                             device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d then SiLU. x: [B, S, C], w: [K, C]; the
    ``K - 1`` rows before x come from ``state`` (zeros when None)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return F.silu(out)


def _ssd_chunked_core(xs, dt, A, B_mat, C_mat, D, chunk: int,
                      init_state: Optional[torch.Tensor] = None):
    """Chunked SSD. xs: [B, S, nh, hd], dt: [B, S, nh] (post-softplus), A:
    [nh] (negative), B_mat/C_mat: [B, S, ns].  Returns (y, final_state)."""
    return ssd_ref.reference(xs, dt, A, B_mat, C_mat, D, chunk=chunk,
                             init_state=init_state)


def ssd_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              cache: Optional[dict] = None, impl: str = "kernel",
              valid_len: Optional[int] = None) -> tuple:
    """Full Mamba-2 block: in_proj -> conv -> SSD -> gated norm ->
    out_proj.  Returns (residual output, new cache leaves or None).

    Prefill with a cache continues from the cache's conv tail and state
    (zeros for a fresh cache) and returns the new tail and final state;
    with a cache and a single row it takes the recurrent decode step.
    ``valid_len`` (prefill only) freezes the recurrence past that many
    rows: pad rows (a bucketed prompt's tail, a final prefill chunk's) get
    dt = 0, so they neither decay nor feed the state, and the conv tail is
    read from the last real rows."""
    B, S, _ = x.shape
    di, ns = cfg.d_inner, cfg.ssm_state
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z = h @ p["w_z"]
    xBC = h @ p["w_xbc"]
    dt_raw = h @ p["w_dt"]

    if cache is not None and S == 1:
        return _ssd_decode(cfg, p, x, z, xBC, dt_raw, cache)

    conv_state = cache["conv"] if cache is not None else None
    init_state = cache["state"] if cache is not None else None
    xBC_raw = xBC
    xBC = _causal_conv(xBC, p["conv_w"], state=conv_state)
    xs, B_mat, C_mat = torch.split(xBC, [di, ns, ns], dim=-1)
    xs = xs.reshape(B, S, nh, hd)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    if valid_len is not None:
        real = torch.arange(S, device=dt.device)[None, :, None] < valid_len
        dt = torch.where(real, dt, 0.0)
    A = -torch.exp(p["A_log"])

    if impl == "kernel":
        # the split leaves strided views; the kernel takes dense rows
        y, final_state = ssd_ops.ssd_scan(
            xs.contiguous(), dt, A, B_mat.contiguous(), C_mat.contiguous(),
            p["D"], chunk=cfg.ssm_chunk, init_state=init_state)
    else:
        y, final_state = _ssd_chunked_core(xs, dt, A, B_mat, C_mat, p["D"],
                                           cfg.ssm_chunk,
                                           init_state=init_state)

    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_ln"], cfg.norm_eps)
    out = y @ p["w_out"]

    new_cache = None
    if cache is not None:  # raw-conv-input tail + final state
        pad = cfg.d_conv - 1
        full = torch.cat([conv_state.to(x.dtype), xBC_raw], dim=1)
        # the last ``pad`` real rows: positions [end - pad, end)
        end = S if valid_len is None else valid_len
        new_cache = {"conv": full[:, end:end + pad], "state": final_state}
    return x + out, new_cache


def _ssd_decode(cfg, p, x, z, xBC, dt_raw, cache):
    """Single-token recurrent step (plain PyTorch, as in the reference)."""
    B = x.shape[0]
    di, ns = cfg.d_inner, cfg.ssm_state
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    conv_in = torch.cat([cache["conv"].to(x.dtype), xBC], dim=1)
    new_conv = conv_in[:, 1:]
    xBC_t = F.silu(torch.einsum("bkc,kc->bc", conv_in, p["conv_w"]))
    xs, B_mat, C_mat = torch.split(xBC_t, [di, ns, ns], dim=-1)
    xs = xs.reshape(B, nh, hd).float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])      # [B, nh]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)
    Bf, Cf = B_mat.float(), C_mat.float()
    state = cache["state"] * dA[:, :, None, None] + \
        torch.einsum("bh,bs,bhp->bhps", dt, Bf, xs)
    y = torch.einsum("bs,bhps->bhp", Cf, state) + p["D"][None, :, None] * xs
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_ln"], cfg.norm_eps)
    out = y @ p["w_out"]
    return x + out, {"conv": new_conv, "state": state}
