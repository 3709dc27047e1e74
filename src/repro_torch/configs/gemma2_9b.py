"""Gemma-2 9B — local+global alternating attention, logit softcaps [arXiv:2408.00118; hf].

42L d_model=3584 16H (GQA kv=8, head_dim=256) d_ff=14336 vocab=256000.
Sliding window 4096 on local layers; attn softcap 50, final softcap 30; GeGLU.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14_336,
    vocab_size=256_000,
    layer_cycle=(("local", "dense"), ("global", "dense")),
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    ffn_act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    emb_scale=True,
)
