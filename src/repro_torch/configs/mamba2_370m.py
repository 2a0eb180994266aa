"""mamba2-370m [ssm]: SSD (state-space duality), attention-free.

48L d_model=1024 vocab=50280, ssm_state=128 [arXiv:2405.21060].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    notes="vocab 50280 padded to 50432 for 16-way vocab sharding.",
))
