"""gemma3-4b [dense, 5:1 local:global]: sliding-window + periodic global attn.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, 128k context
[hf:google/gemma-3 family]. 5 local (window 1024) layers per 1 global layer.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    family="local_global",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    sliding_window=1024,
    local_global_ratio=5,
    rope_theta=1e6,
    notes="sub-quadratic eligible for long_500k: local layers keep a "
          "window-sized KV ring; global layers decode against the full "
          "sharded 512k KV (decode is O(S) per token).",
))
