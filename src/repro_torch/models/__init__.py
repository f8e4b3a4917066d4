"""LM serving for every family of the reference's zoo: the dense and MoE
transformer (GQA and MLA), the Mamba-2 LM, the whisper encoder–decoder and
the zamba2 hybrid, with their layers, attention, MoE and Mamba-2 blocks."""

from .model import ModelBundle, build_model, make_prefill_step, make_serve_step

__all__ = ["ModelBundle", "build_model", "make_prefill_step", "make_serve_step"]
