"""Command-R 35B — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000. Tied embeddings.
(The HF model uses parallel attn+FFN blocks; we keep the sequential residual
form shared by the rest of the zoo — FLOPs/params identical, noted in DESIGN.md.)
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_528,
    vocab_size=256_000,
    layer_cycle=(("global", "dense"),),
    ffn_act="silu",
    rope_theta=8_000_000.0,
    tie_embeddings=True,
)
