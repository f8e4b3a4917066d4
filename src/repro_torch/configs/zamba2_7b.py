"""zamba2-7b: Mamba-2 blocks with a shared attention block (the reference's
``repro.configs.zamba2_7b``)."""

from .base import ModelConfig, register

ZAMBA2_7B = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_period=6,
    subquadratic=True,
))
