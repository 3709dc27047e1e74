"""Mamba-2 370M — SSD (state-space duality) [arXiv:2405.21060; unverified].

48L d_model=1024, attention-free, vocab=50280, ssm_state=128.
d_inner = 2*d_model = 2048, head_dim 64 => 32 SSD heads. No MLP (pure Mamba stack).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    layer_cycle=(("ssd", "none"),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    d_conv=4,
    tie_embeddings=True,
)
