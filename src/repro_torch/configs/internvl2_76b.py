"""internvl2-76b: the reference's ``repro.configs.internvl2_76b``, field for field."""

from .base import ModelConfig, register

# — [vlm] InternViT frontend stubbed; InternLM2-style backbone -------------
INTERNVL2_76B = register(ModelConfig(
    name="internvl2-76b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision",
))
