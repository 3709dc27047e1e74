"""RG-LRU linear recurrence: ``rglru_scan(a, bx, h0=None)`` with a/bx
[B, S, W] and h0 [B, W] -> (hs [B, S, W], h_final [B, W]), h_t = a_t *
h_{t-1} + bx_t per channel, in float32."""

from .ops import rglru_scan
from .ref import reference
