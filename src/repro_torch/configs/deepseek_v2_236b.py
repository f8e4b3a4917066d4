"""deepseek-v2-236b: the reference's ``repro.configs.deepseek_v2_236b``, field for field."""

from .base import ModelConfig, register

# — [moe] MLA kv_lora=512, 2 shared + 160 routed top-6 --------------------
DEEPSEEK_V2_236B = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,               # the single dense first layer
    vocab_size=102400,
    head_dim=128,
    attn_type="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
))
