"""The paper's own setting: a generic DNN dataflow graph.

The 2019 paper's running example is "a large DNN trained with model
parallelism on multi-GPU"; this small dense transformer (8 layers,
d_model 512, MHA with 8 heads of hd 64) is its end-to-end demo config and
the config of the planner's engine-sizing tests.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-mlp",
    family="dense",
    n_layers=8,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=32_000,
    layer_cycle=(("global", "dense"),),
)
