"""Plain PyTorch versions of the SSD-scan kernel, with an optional initial
state.

``reference`` is a port of ``repro.kernels.ssd_scan.ref.reference``.  It
keeps the reference's chunk rule (the largest ``L <= chunk`` that divides
``S``) and its order of work: the intra-chunk dual form, the per-chunk
states, the inter-chunk recurrence over chunks, the inter-chunk output.
With ``init_state`` it is ``repro.models.ssm._ssd_chunked_core``.

``chunked_reference`` computes in the Hopper kernel's order instead: fixed
chunks from the start with a ragged last one, the state carried chunk by
chunk, and, when asked, the f32 operands of the tensor-core products
rounded to bf16 as the kernel's bf16 body feeds them.
"""

from __future__ import annotations

from typing import Optional

import torch


def reference(xs, dt, A, B_mat, C_mat, D, *, chunk: int = 64,
              init_state: Optional[torch.Tensor] = None):
    """xs: [B, S, nh, hd]; dt: [B, S, nh] (post-softplus); A: [nh]
    (negative); B_mat/C_mat: [B, S, ns]; D: [nh]; init_state: [B, nh, hd,
    ns] or None (zeros).  Returns (y [B, S, nh, hd], final state [B, nh,
    hd, ns]), both float32."""
    Bb, S, nh, hd = xs.shape
    ns = B_mat.shape[-1]
    L = min(chunk, S)
    while S % L:
        L -= 1
    N = S // L

    xs_f = xs.float().reshape(Bb, N, L, nh, hd)
    dt_c = dt.float().reshape(Bb, N, L, nh)
    Bc = B_mat.float().reshape(Bb, N, L, ns)
    Cc = C_mat.float().reshape(Bb, N, L, ns)

    seg = torch.cumsum(dt_c * A, dim=2)                # within-chunk
    total = seg[:, :, -1]                              # [B, N, nh]

    # intra-chunk: M[i, j] = C_i.B_j exp(seg_i - seg_j) dt_j  (j <= i).
    # The upper triangle is masked before the exp, where the reference
    # masks after it: the values are the same (exp(-inf) = 0), but there
    # seg_i - seg_j > 0 grows with the chunk and its exp overflows to inf
    # (a chunk of 256 rows at dt ~ 0.7), and the backward of a mask after
    # the exp multiplies that inf by a zero cotangent: NaN gradients
    G = torch.einsum("bnis,bnjs->bnij", Cc, Bc)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=xs.device))
    diff = (seg[:, :, :, None, :] - seg[:, :, None, :, :]).masked_fill(
        ~mask[None, None, :, :, None], float("-inf"))
    M = G[..., None] * torch.exp(diff) * dt_c[:, :, None, :, :]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", M, xs_f)

    # chunk states: sum_j exp(total - seg_j) dt_j B_j (x) x_j
    w = torch.exp(total[:, :, None, :] - seg) * dt_c
    states = torch.einsum("bnjs,bnjh,bnjhp->bnhps", Bc, w, xs_f)

    # inter-chunk recurrence h_n = exp(total_n) h_{n-1} + S_n
    h = (torch.zeros((Bb, nh, hd, ns), dtype=torch.float32,
                     device=xs.device)
         if init_state is None else init_state.float())
    h_prevs = []
    for n in range(N):
        h_prevs.append(h)
        h = torch.exp(total[:, n])[:, :, None, None] * h + states[:, n]
    h_prev = torch.stack(h_prevs, dim=1)               # [B, N, nh, hd, ns]

    y_inter = torch.einsum("bnis,bnih,bnhps->bnihp", Cc, torch.exp(seg),
                           h_prev)
    y = (y_intra + y_inter).reshape(Bb, S, nh, hd)
    y = y + D.float()[None, None, :, None] * xs.float()
    return y, h


def _bf16_terms(t: torch.Tensor, terms: int) -> torch.Tensor:
    """``t`` as the sum of ``terms`` bf16 numbers, each the bf16 rounding
    of what the earlier ones leave (1: bf16(t); 2: hi + bf16(t - hi))."""
    out = torch.zeros_like(t)
    for _ in range(terms):
        out = out + (t - out).to(torch.bfloat16).float()
    return out


def chunked_reference(xs, dt, A, B_mat, C_mat, D, *, chunk: int = 64,
                      split_operands: bool = False, terms: int = 2,
                      init_state: Optional[torch.Tensor] = None):
    """The SSD scan in the kernel's order: chunks of ``chunk`` rows from the
    start, the last one ragged (padded with zero rows and dt = 0, which add
    nothing), and per chunk, from the state h before it:
    ``y = M x + exp(seg) (C h^T) + D x`` and ``h <- exp(total) h + (w x)^T
    B``.  With ``split_operands`` the f32 operands M, h and ``w x`` of those
    products enter as ``terms`` bf16 terms (the kernel's bf16 body feeds two,
    hi and lo); x, B and C enter as given.  Shapes as in ``reference``;
    returns (y [B, S, nh, hd], final state [B, nh, hd, ns]), both float32."""
    Bb, S, nh, hd = xs.shape
    ns = B_mat.shape[-1]
    op = ((lambda t: _bf16_terms(t, terms)) if split_operands
          else (lambda t: t))
    n = -(-S // chunk)
    pad = n * chunk - S
    xs_f = torch.nn.functional.pad(xs.float(), (0, 0, 0, 0, 0, pad))
    dt_f = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    Bc = torch.nn.functional.pad(B_mat.float(), (0, 0, 0, pad))
    Cc = torch.nn.functional.pad(C_mat.float(), (0, 0, 0, pad))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xs.device))[None, :, :, None]
    h = (torch.zeros((Bb, nh, hd, ns), dtype=torch.float32,
                     device=xs.device)
         if init_state is None else init_state.float())
    ys = []
    for c in range(n):
        rows = slice(c * chunk, (c + 1) * chunk)
        x, d, Bm, Cm = xs_f[:, rows], dt_f[:, rows], Bc[:, rows], Cc[:, rows]
        seg = torch.cumsum(d * A, dim=1)               # [B, L, nh]
        total = seg[:, -1]                             # [B, nh]
        G = torch.einsum("bis,bjs->bij", Cm, Bm)
        diff = (seg[:, :, None, :] - seg[:, None, :, :]).masked_fill(
            ~mask, float("-inf"))                      # exp only for j <= i
        M = G[..., None] * torch.exp(diff) * d[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", op(M), x)
        y_inter = torch.einsum("bis,bhps->bihp", Cm, op(h))
        ys.append(y_intra + torch.exp(seg)[..., None] * y_inter
                  + D.float()[None, None, :, None] * x)
        wx = (torch.exp(total[:, None] - seg) * d)[..., None] * x
        h = (torch.exp(total)[:, :, None, None] * h
             + torch.einsum("bjhp,bjs->bhps", op(wx), Bm))
    return torch.cat(ys, dim=1)[:, :S], h
