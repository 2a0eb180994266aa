"""llama-3.2-vision-90b [vlm]: cross-attention image layers.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[hf:meta-llama/Llama-3.2-*-Vision]. Every 5th layer cross-attends to
precomputed image-patch embeddings; the vision tower is a stub per the
assignment (input_specs() supplies patch embeddings).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    num_image_tokens=1600,
    rope_theta=5e5,
))
