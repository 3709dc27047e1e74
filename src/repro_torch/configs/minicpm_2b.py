"""MiniCPM-2B — WSD schedule, llama-like arch [arXiv:2404.06395; hf].

40L d_model=2304 36H (kv=36, i.e. MHA) d_ff=5760 vocab=122753. Tied embeddings.
The WSD (warmup-stable-decay) schedule lives in repro.optim.schedules.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122_753,
    layer_cycle=(("global", "dense"),),
    ffn_act="silu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
