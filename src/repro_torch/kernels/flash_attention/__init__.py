"""Flash attention forward: ``flash_attention(q, k, v, q_positions=,
k_positions=, ...)`` with q [B, Sq, H, hd], k/v [B, Skv, KV, hd]; GQA,
position-based causal and sliding-window masks, logit softcap."""

from .ops import flash_attention
from .ref import reference
