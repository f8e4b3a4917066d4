"""llama3.2-1b: the reference's ``repro.configs.llama3_2_1b``, field for field."""

from .base import ModelConfig, register

# — [dense] small llama3 ----------------------------------------------------
LLAMA3_2_1B = register(ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
))
