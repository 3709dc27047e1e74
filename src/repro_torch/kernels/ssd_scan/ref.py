"""Plain PyTorch version of the SSD-scan kernel (a port of
``repro.kernels.ssd_scan.ref.reference``), with an optional initial state.

It keeps the reference's chunk rule (the largest ``L <= chunk`` that
divides ``S``) and its order of work: the intra-chunk dual form, the
per-chunk states, the inter-chunk recurrence over chunks, the inter-chunk
output.  With ``init_state`` it is ``repro.models.ssm._ssd_chunked_core``.
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

    # intra-chunk: M[i, j] = C_i.B_j exp(seg_i - seg_j) dt_j  (j <= i)
    G = torch.einsum("bnis,bnjs->bnij", Cc, Bc)
    decay = torch.exp(seg[:, :, :, None, :] - seg[:, :, None, :, :])
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=xs.device))
    M = G[..., None] * torch.where(mask[None, None, :, :, None], decay,
                                   0.0) * dt_c[:, :, None, :, :]
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
