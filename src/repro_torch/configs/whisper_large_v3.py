"""whisper-large-v3: the reference's ``repro.configs.whisper_large_v3``, field for field."""

from .base import ModelConfig, register

# — [audio] enc-dec, conv frontend stubbed to frame embeddings ------------
WHISPER_LARGE_V3 = register(ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,            # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    attn_type="gqa",
    pos_embedding="learned",
    activation="gelu",
    norm="layernorm",
    qkv_bias=True,
    frontend="audio",
    encoder_seq=1500,
))
