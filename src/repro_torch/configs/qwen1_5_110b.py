"""qwen1.5-110b: the reference's ``repro.configs.qwen1_5_110b``, field for field."""

from .base import ModelConfig, register

# — [dense] QKV bias ---------------------------------------------------------
QWEN1_5_110B = register(ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
))
