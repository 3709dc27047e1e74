"""SeamlessM4T-medium — enc-dec multimodal backbone [arXiv:2308.11596; hf].

12L encoder + 12L decoder, d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
The speech frontend (conformer feature extractor) is a STUB per the brief:
``input_specs()`` feeds precomputed frame embeddings to the encoder.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,          # decoder layers
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    layer_cycle=(("global", "dense"),),
    ffn_act="gelu",
    frontend="audio",
    frontend_tokens=1024,  # encoder frames per sample delivered by the stub
    frontend_dim=1024,
)
