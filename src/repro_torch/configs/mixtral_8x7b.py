"""Mixtral 8x7B — 8 experts top-2, sliding-window attention [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2, SWA 4096.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    layer_cycle=(("local", "moe"),),
    window_size=4096,
    n_experts=8,
    experts_per_token=2,
    d_ff_expert=14_336,
    router_aux_coef=0.02,
    ffn_act="silu",
    rope_theta=1_000_000.0,
)
