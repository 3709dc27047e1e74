"""Phi-3-Vision 4.2B — phi3-mini backbone + CLIP frontend STUB
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L d_model=3072 32H (kv=32, MHA) d_ff=8192 vocab=32064.
The CLIP vision tower is a STUB per the brief: ``input_specs()`` feeds
precomputed patch embeddings (frontend_tokens x frontend_dim) which the model
projects and prepends to the token sequence.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32_064,
    layer_cycle=(("global", "dense"),),
    ffn_act="silu",
    rope_theta=10_000.0,
    frontend="vision",
    frontend_tokens=576,   # 24x24 patches from the CLIP-L/14 tower @336px
    frontend_dim=1024,     # CLIP-L hidden size delivered by the stub
)
