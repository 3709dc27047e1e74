"""DeepSeek-V2-Lite 16B — MLA + fine-grained MoE [arXiv:2405.04434; hf].

27L d_model=2048 16H, MLA kv_lora=512, MoE 64 routed experts top-6 + 2 shared,
expert d_ff=1408, vocab=102400. First layer uses a dense FFN (d_ff=10944).

Note: the assignment line reads "2 shared+160 routed top-6"; 160 routed is the
*full* V2 config — V2-**Lite** (this arch id, and the same line's "MoE 64e
top-6") has 64 routed experts. We follow 64 (documented in DESIGN.md).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,          # unused by MLA (per-head dims below); kept for bookkeeping
    d_ff=10_944,           # dense FFN width for the first_k_dense layers
    vocab_size=102_400,
    layer_cycle=(("mla", "moe"),),
    first_k_dense=1,
    n_experts=64,
    experts_per_token=6,
    n_shared_experts=2,
    d_ff_expert=1408,
    router_aux_coef=0.003,
    # MLA dims (V2-Lite: no q compression)
    q_lora_rank=0,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    ffn_act="silu",
    rope_theta=10_000.0,
)
