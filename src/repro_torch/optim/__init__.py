"""Optimizers, schedules, clipping and gradient compression — the
counterparts of ``repro.optim`` (no optax there, no ``torch.optim`` here:
the same updates over the same trees, in the reference's leaf order).

Every ``update`` donates its inputs, as the reference's jitted train step
donates the parameters and the optimizer state: the moments are updated
in place and each parameter is overwritten with its new value (computed in
f32 and cast to the parameter's dtype, as the reference casts)."""

from .adafactor import AdafactorState, adafactor
from .adam import AdamState, adam, adamw
from .clipping import clip_by_global_norm, global_norm
from .compression import compressed_psum, int8_compress, int8_decompress
from .schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "AdafactorState",
    "AdamState",
    "adafactor",
    "adam",
    "adamw",
    "clip_by_global_norm",
    "compressed_psum",
    "constant",
    "cosine_decay",
    "global_norm",
    "int8_compress",
    "int8_decompress",
    "linear_warmup_cosine",
]
