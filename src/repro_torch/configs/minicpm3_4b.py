"""minicpm3-4b: the reference's ``repro.configs.minicpm3_4b``, field for field."""

from .base import ModelConfig, register

# — [dense] MLA ------------------------------------------------------------
MINICPM3_4B = register(ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    kv_lora_rank=256,
    q_lora_rank=768,
    rope_head_dim=32,
    head_dim=64,
))
