"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242]. The shared transformer block (full attention + dense FFN
weights reused at every application) is applied every 6 Mamba2 layers, per the
Zamba/Zamba2 shared-block design.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    shared_attn_every=6,
    rope_theta=1e4,
    notes="shared attn block reused across its 9 applications; Zamba2's "
          "per-application LoRA deltas are omitted (noted simplification).",
))
