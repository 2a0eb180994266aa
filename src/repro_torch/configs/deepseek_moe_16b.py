"""deepseek-moe-16b [moe]: fine-grained experts, 2 shared + 64 routed top-6.

28L d_model=2048 16H (GQA kv=16) routed d_ff=1408 vocab=102400
[arXiv:2401.06066]. First layer is a dense FFN (d_ff=10944) per the paper.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    dense_d_ff=10944,
    rope_theta=1e4,
))
