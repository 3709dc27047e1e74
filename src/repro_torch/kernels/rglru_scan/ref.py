"""Plain PyTorch version of the RG-LRU scan kernel: a port of
``repro.kernels.rglru_scan.ref.reference``.

``h_t = a_t * h_{t-1} + bx_t`` per channel, in float32.  An initial state
``h0`` is folded into the first row (``bx[:, 0] += a[:, 0] * h0``), as the
reference oracle and the model's ``_lru_scan`` fold it; the recurrence then
starts from zeros.  The reference runs an associative scan; this version
walks the sequence in order, so its sums round in the Hopper kernel's
order (the two agree bit for bit) and differ from the reference's by
rounding only.
"""

from __future__ import annotations

from typing import Optional

import torch


def reference(a: torch.Tensor, bx: torch.Tensor,
              h0: Optional[torch.Tensor] = None) -> tuple:
    """a, bx: [B, S, W]; h0: [B, W] or None (zeros).  Returns (hs
    [B, S, W], h_final [B, W]), both float32."""
    a, bx = a.float(), bx.float()
    if h0 is not None:
        first = bx[:, :1] + a[:, :1] * h0.float()[:, None]
        bx = torch.cat([first, bx[:, 1:]], dim=1)
    h = torch.zeros_like(bx[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
