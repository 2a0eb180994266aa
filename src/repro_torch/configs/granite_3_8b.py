"""granite-3-8b [dense]: GQA.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155
[hf:ibm-granite/granite-3.0 family].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=1e4,
    notes="vocab 49155 padded to 49408 for 16-way vocab sharding.",
))
