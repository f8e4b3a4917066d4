"""LM serving: the zamba2 hybrid (Mamba-2 + shared attention) with its
layers, attention and Mamba-2 blocks."""

from .model import ModelBundle, build_model, make_prefill_step, make_serve_step

__all__ = ["ModelBundle", "build_model", "make_prefill_step", "make_serve_step"]
