"""command-r-plus-104b: the reference's ``repro.configs.command_r_plus_104b``, field for field."""

from .base import ModelConfig, register

# — [dense] GQA, no-bias ------------------------------------------------------
COMMAND_R_PLUS = register(ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
))
