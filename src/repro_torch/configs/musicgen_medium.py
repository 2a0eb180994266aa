"""musicgen-medium [audio]: decoder-only over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048 [arXiv:2306.05284].
The EnCodec frontend is a stub: input_specs() provides frame token ids (the
4-codebook delay-pattern interleave is frontend-side).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    rope_theta=1e4,
))
