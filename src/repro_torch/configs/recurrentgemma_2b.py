"""RecurrentGemma-2B — RG-LRU + local attention, 2:1 [arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000.
Griffin pattern: (recurrent, recurrent, local-attention) repeating; window 2048.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    layer_cycle=(("rglru", "dense"), ("rglru", "dense"), ("local", "dense")),
    window_size=2048,
    lru_width=2560,
    lru_block_width=4,
    ffn_act="gelu",
    tie_embeddings=True,
    emb_scale=True,
)
