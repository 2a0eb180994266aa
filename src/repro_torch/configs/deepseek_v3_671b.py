"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed top-8, MTP.

61L d_model=7168 128H routed d_ff=2048 vocab=129280 [arXiv:2412.19437].
First 3 layers dense (d_ff=18432); MLA q_lora=1536 kv_lora=512
nope/rope/v head dims 128/64/128; one MTP module (depth 1).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    vocab_size=129280,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=256,
    num_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    dense_d_ff=18432,
    mtp_depth=1,
    rope_theta=1e4,
    opt_dtype="bfloat16",
    notes="bf16 AdamW moments (fp32 moments would not fit 512 v5e chips; "
          "DeepSeek-V3 itself trains with low-precision states).",
))
