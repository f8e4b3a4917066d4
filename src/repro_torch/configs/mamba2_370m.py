"""mamba2-370m: the reference's ``repro.configs.mamba2_370m``, field for field."""

from .base import ModelConfig, register

# — [ssm] SSD, attention-free ---------------------------------------------------
MAMBA2_370M = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attn_type="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    subquadratic=True,
    tie_embeddings=True,
))
