"""granite-moe-1b-a400m: the reference's ``repro.configs.granite_moe_1b_a400m``, field for field."""

from .base import ModelConfig, register

# — [moe] 32 experts top-8 -------------------------------------------------
GRANITE_MOE_1B = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,                 # per-expert ffn width
    vocab_size=49155,
    num_experts=32,
    top_k=8,
    moe_d_ff=512,
))
